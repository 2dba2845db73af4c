#!/usr/bin/env python
"""Benchmark: path-trace throughput on the built-in Cornell scene.

Headline metric matches the reference's own (BASELINE.md): path samples
per second per device at 1440x1440 on Cornell box + monkey plinth. Runs
on a GPU only: with no GPU it exits non-zero and prints no result.

Prints ONE JSON line: {"metric", "value", "unit", "platform",
"device_kind", "device_count"}.

Env knobs: BENCH_SIZE (1440), BENCH_SPP (64), BENCH_CHUNK (131072),
BENCH_INTERSECTOR (auto), BENCH_REPS (3).
"""

import json
import os
import sys
import time


def main() -> int:
    size = int(os.environ.get("BENCH_SIZE", 1440))
    spp = int(os.environ.get("BENCH_SPP", 64))
    chunk = int(os.environ.get("BENCH_CHUNK", 1 << 17))
    intersector = os.environ.get("BENCH_INTERSECTOR", "auto")
    reps = int(os.environ.get("BENCH_REPS", 3))

    import jax

    from ipu_ray_lib_tpu.runtime.config import (NoGpuError, require_gpu,
                                                setup_compilation_cache)

    setup_compilation_cache()
    try:
        require_gpu()
    except NoGpuError as e:
        sys.stderr.write(f"bench.py: {e}\n")
        return 1

    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene

    mesh_file = os.path.join(os.path.dirname(__file__), "assets", "monkey_bust.glb")
    if not os.path.exists(mesh_file):
        mesh_file = None
    scene = make_cornell_box_scene(mesh_file, box_only=False)
    arrays, params, _ = build_scene(
        scene, image_width=size, image_height=size, samples_per_pixel=spp,
        intersector=intersector,
    )

    def one_run():
        return render(arrays, params, mode="path-trace", chunk_size=chunk).rgb

    one_run()  # warm-up / compile with identical static shapes

    dt = float("inf")
    for _ in range(reps):
        t0 = time.time()
        rgb = one_run()
        dt = min(dt, time.time() - t0)

    paths = size * size * spp
    devices = jax.devices()
    sys.stderr.write(f"# {dt:.2f}s, image mean {float(rgb.mean()):.4f}, "
                     f"intersector {params.intersector}\n")
    print(json.dumps({
        "metric": "path_samples_per_second_per_device_cornell1440",
        "value": round(paths / dt, 1),
        "unit": "paths/s",
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
