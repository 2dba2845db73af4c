#!/usr/bin/env python
"""Literate verification walk-through (LITERATE_TEST.ipynb analogue).

Runs the reference's integration-test methodology end to end and prints
the statistics the notebook plots (ref LITERATE_TEST.ipynb: AOV parity vs
the independent reference renderer with abs-error stats, then
path-traced colour-histogram comparison between renderers whose RNG
streams differ):

  1. build the Cornell scene (with the monkey plinth if available),
  2. shadow-trace AOV parity (normals / hitpoints / ids) vs the oracle,
  3. path-trace two independent seeds and compare colour histograms,
  4. Collada scene load + render smoke.

Usage: python examples/verify_all.py [--size 96] [--spp 16]
(on the CPU: JAX_PLATFORMS=cpu python examples/verify_all.py ...)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--spp", type=int, default=16)
    args = ap.parse_args()

    import dataclasses

    from ipu_ray_lib_tpu.cpu.reference import oracle_shadow_trace
    from ipu_ray_lib_tpu.ops.camera import generate_camera_rays, pixel_grid
    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene
    from ipu_ray_lib_tpu.utils.image import mse

    size, spp = args.size, args.spp
    mesh = "assets/monkey_bust.glb" if os.path.exists("assets/monkey_bust.glb") else None
    scene = make_cornell_box_scene(mesh, box_only=False)
    arrays, params, bvh = build_scene(
        scene, image_width=size, image_height=size, samples_per_pixel=spp
    )
    print(f"# Scene: {params.num_geoms} geoms, {params.num_bvh_nodes} BVH nodes, "
          f"intersector={params.intersector}")

    # ---- 1. Shadow-trace AOV parity vs oracle ---------------------------
    t0 = time.time()
    out = render(arrays, params, mode="shadow-trace", chunk_size=min(size * size, 1 << 16))
    print(f"# Shadow trace: {size*size/(time.time()-t0):.3g} rays/s, hits {out.hit_count}")

    rows, cols = pixel_grid(size, size, 0, 0)
    o, d = generate_camera_rays(rows, cols, size, size, params.fov_radians, 0.0, None)
    res = oracle_shadow_trace(scene, np.asarray(o), np.asarray(d))
    oracle_geom = res["geom"].reshape(size, size)
    oracle_norm = res["normal"].reshape(size, size, 3)
    oracle_hp = res["hit_p"].reshape(size, size, 3)
    oracle_rgb = res["rgb"].reshape(size, size, 3)

    both = (out.geom_id >= 0) & (oracle_geom >= 0)
    mask_agree = float((out.geom_id >= 0).mean() == (oracle_geom >= 0).mean())
    print(f"## Check Hit Masks: agreement {(100*((out.geom_id>=0)==(oracle_geom>=0)).mean()):.2f}%")

    ndots = np.abs(np.sum(out.normal * oracle_norm, axis=-1))[both]
    print(f"## Check Normals: |cos| median {np.median(ndots):.6f}, "
          f"p01 {np.quantile(ndots, 0.01):.6f}")

    hp_err = np.linalg.norm(out.hit_p - oracle_hp, axis=-1)[both]
    print(f"## Check Hit Points: abs err median {np.median(hp_err):.4g}, "
          f"p99 {np.quantile(hp_err, 0.99):.4g} (scene units)")

    print(f"## Check Shadow RGB: MSE {mse(out.rgb, oracle_rgb):.3g}")

    # ---- 2. Path trace: histogram parity across RNG seeds ----------------
    t0 = time.time()
    a = render(arrays, params, mode="path-trace", chunk_size=min(size * size, 1 << 16))
    dt = time.time() - t0
    print(f"# Path trace: {size*size*spp/dt:.4g} path-samples/s")
    params_b = dataclasses.replace(params, rng_seed=7)
    b = render(arrays, params_b, mode="path-trace", chunk_size=min(size * size, 1 << 16))

    for c, name in enumerate("rgb"):
        ha, _ = np.histogram(a.rgb[..., c], bins=32, range=(0, 2))
        hb, _ = np.histogram(b.rgb[..., c], bins=32, range=(0, 2))
        denom = np.maximum(ha + hb, 1)
        dist = np.abs(ha - hb).sum() / denom.sum()
        print(f"## Path histogram ({name}): L1 distance {dist:.4f} "
              f"(different seeds; small = distributions match)")

    # ---- 2b. Cross-intersector radiometry --------------------------------
    # Same RNG streams + same estimator through two INDEPENDENT
    # intersection implementations (threaded BVH vs dense block tables):
    # images must agree per pixel, not just in distribution.
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    imgs = {}
    for its in ("bvh", "dense"):
        ai, pi, _ = build_scene(scene, image_width=size, image_height=size,
                                samples_per_pixel=spp, intersector=its)
        imgs[its], _done = render_streaming(ai, pi, spp=spp)
    dmax = np.abs(imgs["bvh"] - imgs["dense"]).max(axis=-1)
    print(f"## Cross-intersector (bvh vs dense): mean "
          f"{imgs['bvh'].mean():.5f} vs {imgs['dense'].mean():.5f}, "
          f"q99 pixel diff {np.quantile(dmax, 0.99):.2e}")

    # ---- 3. Collada import + render smoke --------------------------------
    if os.path.exists("assets/hdri_test.dae"):
        from ipu_ray_lib_tpu.scene.collada import import_collada_scene

        dae = import_collada_scene("assets/hdri_test.dae")
        arrays2, params2, _ = build_scene(dae, image_width=48, image_height=48,
                                          samples_per_pixel=4)
        out2 = render(arrays2, params2, mode="shadow-trace", chunk_size=48 * 48)
        print(f"# Collada scene: {sum(len(m.triangles) for m in dae.meshes)} tris, "
              f"hits {out2.hit_count}/{48*48}")

    print("# Done.")


if __name__ == "__main__":
    main()
