#!/usr/bin/env python
"""Smoke test of the renderer on one NVIDIA GPU, end to end.

    python chip_smoke.py                # phases 0-5 on one card
    python chip_smoke.py --four-cards   # the sharded path on four cards

Drives the renderer through its normal entry points (trace.py's scene
set-up, ``render``, ``render_streaming_sharded``) at full frame size and
checks every result against the repo's references:

0. device check: a GPU must be JAX's backend (no CPU fallback); prints
   the card (nvidia-smi), JAX version, BVH builder and compile cache;
1. Cornell box + monkey plinth, 1440x1440, 16 spp path trace; image
   finite, mean in CORNELL_MEAN_BAND, max <= twice the light's emission;
   plus the dense-vs-bvh timing that sets ``auto``'s threshold;
2. the three stored goldens (tests/golden) rendered on the card;
3. shadow trace at 1440x1440, all six AOVs, against the f64 oracle on a
   128x128 crop;
4. spheres lit by the in-repo NIF, 512x512, 16 spp; the env MLP on the
   card against a numpy evaluation of the same weights;
5. the 2.09M-triangle stress heightfield through ``bvh``, 1440x1440,
   4 spp; primary-hit AOVs against the f64 BVH oracle on a 128x128 crop.

``--four-cards`` runs only the device check and the sharded path: 1440x1440
at 64 spp on a four-card mesh against the same frame on one card.

Times printed here are smoke, not a benchmark. Any failed phase makes
the exit code non-zero. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(Exception):
    """A checked quantity is outside its tolerance."""


def check(ok, what: str) -> None:
    print(f"    check {'ok  ' if ok else 'FAIL'}: {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    """nvidia-smi's name and power limit of each card (a child process
    that does not import JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _cli_args(argv):
    """trace.py's parsed flags for ``argv``."""
    import trace as trace_cli

    p = argparse.ArgumentParser()
    trace_cli.add_options(p)
    return p.parse_args(argv)


def _cli_scene(argv):
    """Scene description + built arrays through trace.py's own set-up."""
    import trace as trace_cli

    from ipu_ray_lib_tpu.scene.build import build_scene

    args = _cli_args(argv)
    scene = trace_cli.build_scene_description(args)
    t0 = time.perf_counter()
    arrays, params, _ = build_scene(scene, **trace_cli.scene_build_kwargs(args))
    return args, scene, arrays, params, time.perf_counter() - t0


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _crop_rays(params, size, crop, row_frac=0.5):
    """Camera rays of the ``crop`` x ``crop`` window of a ``size`` x
    ``size`` frame, centred horizontally and at ``row_frac`` of the
    height, as f32 numpy arrays (AA off). Returns (r0, c0, o, d)."""
    from ipu_ray_lib_tpu.ops.camera import generate_camera_rays, pixel_grid

    c0 = (size - crop) // 2
    r0 = min(max(int(size * row_frac) - crop // 2, 0), size - crop)
    rows, cols = pixel_grid(crop, crop, c0, r0)
    o, d = generate_camera_rays(rows, cols, size, size, params.fov_radians,
                                0.0, None)
    return r0, c0, np.asarray(o), np.asarray(d)


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(n_cards: int) -> dict:
    import jax

    from ipu_ray_lib_tpu.bvh.cbuilder import native_available
    from ipu_ray_lib_tpu.runtime.config import setup_compilation_cache

    devices = jax.devices()
    check(len(devices) >= n_cards, f"{len(devices)} device(s) >= {n_cards}")
    for line in card_info().splitlines():
        say(f"card: {line}")
    say(f"jax {jax.__version__}, platform {devices[0].platform}, "
        f"device_kind {devices[0].device_kind}, {len(devices)} device(s)")
    say(f"BVH builder: {'native (csrc/bvh_builder.cpp)' if native_available() else 'Python'}")
    say(f"compile cache: {setup_compilation_cache()}")
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": n_cards}


# Cornell + monkey at 1440^2: image mean 0.0657 in the renderer's
# earlier full-frame runs; +-5% is far outside the Monte-Carlo noise of
# 33M paths and far inside the shifts radiometry bugs cause.
CORNELL_MEAN_BAND = (0.0624, 0.0690)
# Light emission (red channel). A pixel's 16-sample mean can exceed it:
# a sample that sees the light and, after bounces off the light (albedo
# 0.78) and the floor (0.75), reaches it again adds ~0.59 of it. Twice
# the emission bounds that and still catches a throughput above 1.
LIGHT_EMISSION = 13.34


def phase_cornell(size=1440, spp=16, chunk=None, time_bvh=True,
                  mean_band=CORNELL_MEAN_BAND):
    """Cornell + monkey path trace through trace.py's flow, and the
    dense-vs-bvh timing behind ``auto``."""
    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.render.streaming import render_streaming
    from ipu_ray_lib_tpu.scene.build import build_scene

    argv = ["--scene", "box", "-w", str(size), "-H", str(size),
            "--samples", str(spp), "--device-only"]
    if chunk:
        argv += ["--chunk-size", str(chunk)]
    args, scene, arrays, params, t_build = _cli_scene(argv)
    say(f"    scene: {params.num_geoms} geoms, {params.num_bvh_nodes} BVH "
        f"nodes, intersector {params.intersector}; build {t_build:.3f} s")
    (compiled, _), t_comp = _timed(lambda: render_streaming(
        arrays, params, chunk_slots=args.chunk_size, compile_only=True))
    say(f"    compile {t_comp:.3f} s; memory_analysis: "
        f"{compiled.memory_analysis()}")

    def run(a, p):
        return render(a, p, mode="path-trace", chunk_size=args.chunk_size).rgb

    _, t_first = _timed(lambda: run(arrays, params))
    img, t_dense = _timed(lambda: run(arrays, params))
    paths = size * size * spp
    say(f"    first render {t_first:.3f} s (includes loading the program); "
        f"render {t_dense:.3f} s = {paths / t_dense:.6g} paths/s "
        f"(smoke, not a benchmark); peak_bytes_in_use {peak_bytes()}")
    mean, mx = float(img.mean()), float(img.max())
    say(f"    image mean {mean:.6f}, max {mx:.6f}")
    check(bool(np.isfinite(img).all()), "all values finite")
    lo, hi = mean_band
    check(lo <= mean <= hi, f"mean {mean:.6f} in [{lo}, {hi}]")
    check(mx <= 2 * LIGHT_EMISSION,
          f"max {mx:.4f} <= {2 * LIGHT_EMISSION} (twice the light's emission)")

    times = {params.intersector: t_dense}
    if time_bvh:
        other = "bvh" if params.intersector == "dense" else "dense"
        kw = dict(image_width=size, image_height=size, samples_per_pixel=spp,
                  rng_seed=args.seed, intersector=other)
        a2, p2, _ = build_scene(scene, **kw)
        run(a2, p2)
        img2, times[other] = _timed(lambda: run(a2, p2))
        m2 = float(img2.mean())
        say(f"    auto-rule timing at {size}^2 {spp} spp (smoke, not a "
            f"benchmark): dense {times.get('dense', float('nan')):.3f} s, "
            f"bvh {times.get('bvh', float('nan')):.3f} s; {other} mean {m2:.6f}")
        check(abs(m2 - mean) / mean < 0.02,
              f"{other} image mean within 2% of {params.intersector}'s")
    return times


# Per-value relative tolerance of the goldens whose radiance passes
# through the bf16 env MLP: a bf16 rounding that flips between devices
# moves an env value by up to ~2% (phase 4 measures the MLP itself).
GOLDEN_RTOL = {"spheres_nif48x32_spp2": 2e-2}


def phase_goldens():
    """The stored goldens rendered on this device: >= 99.9% of values
    within 1e-4 absolute (+ GOLDEN_RTOL relative for the bf16 env MLP
    golden) and the image mean within 1e-4 relative (the device sums in
    another order, so a few discrete paths may go elsewhere)."""
    import importlib.util

    # By path: another installed package may own the name ``tests``.
    spec = importlib.util.spec_from_file_location(
        "golden_cases", os.path.join(ROOT, "tests", "test_golden.py"))
    golden_cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden_cases)
    CASES, GOLDEN_DIR = golden_cases.CASES, golden_cases.GOLDEN_DIR
    render_case = golden_cases.render_case

    for name in CASES:
        golden = np.load(os.path.join(GOLDEN_DIR, name + ".npy"))
        rgb, done = render_case(name)
        rtol = GOLDEN_RTOL.get(name, 0.0)
        close = float(np.isclose(rgb, golden, rtol=rtol, atol=1e-4).mean())
        rel = abs(float(rgb.mean()) - float(golden.mean())) / float(golden.mean())
        say(f"    {name}: {close * 100:.4f}% of values within 1e-4 + "
            f"{rtol:g} relative (within 1e-4 alone: "
            f"{float((np.abs(rgb - golden) <= 1e-4).mean()) * 100:.4f}%), "
            f"mean rel diff {rel:.3g}, max abs diff "
            f"{float(np.abs(rgb - golden).max()):.4g}")
        check(done == golden.shape[0] * golden.shape[1] * 2,
              f"{name} done count {done}")
        check(close >= 0.999,
              f"{name}: >= 99.9% of values within 1e-4 + {rtol:g} relative")
        check(rel <= 1e-4, f"{name}: image mean within 1e-4 relative")


def phase_shadow(size=1440, crop=128):
    """Shadow trace, all six AOVs, against the f64 oracle on a crop."""
    from ipu_ray_lib_tpu.cpu.reference import oracle_shadow_trace
    from ipu_ray_lib_tpu.render.renderer import render

    args, scene, arrays, params, t_build = _cli_scene(
        ["--scene", "box", "-w", str(size), "-H", str(size),
         "--render-mode", "shadow-trace", "--visualise", "normal",
         "--device-only"])
    say(f"    intersector {params.intersector}, dot precision HIGHEST "
        f"(full f32); build {t_build:.3f} s")

    def run():
        return render(arrays, params, mode="shadow-trace",
                      chunk_size=args.chunk_size)

    _, t_first = _timed(run)
    out, dt = _timed(run)
    say(f"    first render {t_first:.3f} s; render {dt:.3f} s = "
        f"{size * size / dt:.6g} rays/s (smoke, not a benchmark)")
    r0, c0, o, d = _crop_rays(params, size, crop)
    ref = oracle_shadow_trace(scene, o, d)
    sl = (slice(r0, r0 + crop), slice(c0, c0 + crop))
    ours = out.geom_id[sl] >= 0
    theirs = ref["geom"].reshape(crop, crop) >= 0
    agree = float((ours == theirs).mean())
    both = ours & theirs
    n_ref = ref["normal"].reshape(crop, crop, 3)
    dots = np.abs(np.sum(out.normal[sl] * n_ref, axis=-1))[both]
    err = np.linalg.norm(
        out.hit_p[sl] - ref["hit_p"].reshape(crop, crop, 3), axis=-1)[both]
    mse = float(np.mean((out.rgb[sl] - ref["rgb"].reshape(crop, crop, 3)) ** 2))
    say(f"    {crop}x{crop} crop vs f64 oracle: hit mask agrees on "
        f"{agree * 100:.4f}%, normal |dot| q0.02 {np.quantile(dots, 0.02):.6f}, "
        f"hit point err q0.99 {np.quantile(err, 0.99):.4g}, rgb mse {mse:.3g}")
    check(agree >= 0.999, "hit mask agrees on >= 99.9% of pixels")
    check(np.quantile(dots, 0.02) > 0.999, "normals: |dot| q0.02 > 0.999")
    check(np.quantile(err, 0.99) < 0.5, "hit points: err q0.99 < 0.5")
    check(mse < 2e-3, "rgb mse < 2e-3")
    for f in ("rgb", "t", "prim_id", "normal", "hit_p"):
        check(getattr(out, f).shape[:2] == (size, size), f"AOV {f} read back")


def env_mlp_reference(weights, meta, uv, bf16_operands):
    """Numpy float32 evaluation of the NIF env MLP at equirect ``uv``
    (RGB). ``bf16_operands`` rounds the matmul operands to bfloat16, as
    the renderer's MLP does before its f32-accumulated dots. The caller
    passes the uv the device computed: the top Fourier feature multiplies
    uv by 2^(E-1), so an independent uv in another precision would move
    features by more than a bf16 ulp."""
    import ml_dtypes

    def q(a):
        return a.astype(ml_dtypes.bfloat16).astype(np.float32) if bf16_operands else a

    uvn = 2.0 * (uv.astype(np.float32) - 1.0)
    c = 2.0 ** np.arange(meta.embedding_dimension, dtype=np.float32)
    pu, pv = uvn[:, :1] * c, uvn[:, 1:2] * c
    feats = q(np.concatenate([np.sin(pu), np.sin(pv), np.cos(pu), np.cos(pv)],
                             -1).astype(np.float32))
    x = feats
    for i, layer in enumerate(weights.layers):
        k = q(layer.kernel.astype(np.float32))
        if k.shape[0] != x.shape[1]:
            x = np.concatenate([x, feats], -1)
        x = x @ k + layer.bias.astype(np.float32)
        if layer.activation == "relu":
            x = np.maximum(x, 0.0)
        if i + 1 < len(weights.layers):
            x = q(x)
    x = x * np.float32(meta.max) + np.asarray(meta.mean, np.float32)
    if meta.log_tone_map:
        x = np.exp(x)
    return x[:, ::-1]


def phase_nif(size=512, spp=16, n_dirs=65536):
    """Spheres + the in-repo NIF through trace.py's flow, and the env MLP
    on the device against numpy."""
    import jax
    import jax.numpy as jnp

    from ipu_ray_lib_tpu.nif import load_nif_env
    from ipu_ray_lib_tpu.nif.hdf5 import load_nif_npz
    from ipu_ray_lib_tpu.nif.metadata import NifMetadata
    from ipu_ray_lib_tpu.nif.model import direction_to_equirect_uv
    from ipu_ray_lib_tpu.render.renderer import render

    asset = os.path.join(ROOT, "assets", "nif", "synthetic_urban_4k")
    args, _, arrays, params, _ = _cli_scene(
        ["--scene", "spheres", "-w", str(size), "-H", str(size),
         "--samples", str(spp), "--nif-hdri", asset, "--device-only"])
    env_fn, env_params = load_nif_env(asset)

    def run():
        return render(arrays, params, mode="path-trace",
                      chunk_size=args.chunk_size, env_fn=env_fn,
                      env_params=env_params).rgb

    _, t_first = _timed(run)
    img, dt = _timed(run)
    say(f"    first render {t_first:.3f} s; render {dt:.3f} s = "
        f"{size * size * spp / dt:.6g} paths/s (smoke, not a benchmark); "
        f"image mean {float(img.mean()):.6f}")
    check(bool(np.isfinite(img).all()) and float(img.min()) >= 0.0,
          "image finite and non-negative")
    check(float(img.mean()) > 0.0, "image lit by the env")

    rng = np.random.default_rng(0)
    dirs = rng.normal(size=(n_dirs, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dev = np.asarray(jax.jit(env_fn)(env_params, jnp.asarray(dirs)))
    uv = np.asarray(jax.jit(direction_to_equirect_uv)(
        jnp.asarray(dirs), env_params["rotation"]))
    weights = load_nif_npz(os.path.join(asset, "weights.npz"))
    meta = NifMetadata.load(os.path.join(asset, "nif_metadata.txt"))
    for bf16 in (True, False):
        ref = env_mlp_reference(weights, meta, uv, bf16)
        rel = np.abs(dev - ref) / np.abs(ref)
        say(f"    env MLP (bf16 operands, f32 accumulation) vs numpy f32"
            f"{' of bf16-rounded operands' if bf16 else ''}, {n_dirs} "
            f"directions: rel err max {rel.max():.4g}, q0.999 "
            f"{np.quantile(rel, 0.999):.4g}, median {np.median(rel):.4g}, "
            f"mean rel diff {abs(dev.mean() - ref.mean()) / ref.mean():.3g}")
        if bf16:
            check(float((rel <= 2e-2).mean()) >= 0.999,
                  ">= 99.9% of values within rtol 2e-2 (bf16 operands)")
        else:
            check(abs(dev.mean() - ref.mean()) / ref.mean() <= 2e-2,
                  "mean over directions within 2e-2 of the pure f32 MLP")


def phase_stress(grid=1024, size=1440, spp=4, crop=128):
    """The stress heightfield through bvh: SAH build, compile, render,
    and primary-hit AOVs against the f64 BVH oracle on a crop."""
    import jax
    import jax.numpy as jnp

    from ipu_ray_lib_tpu.cpu.reference import oracle_intersect_bvh
    from ipu_ray_lib_tpu.ops.traversal import scene_intersect_with_normal
    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.render.streaming import render_streaming
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import make_stress_scene

    scene, t_gen = _timed(lambda: make_stress_scene(grid))
    n_tri = sum(len(m.triangles) for m in scene.meshes)
    (arrays, params, _), t_build = _timed(lambda: build_scene(
        scene, image_width=size, image_height=size, samples_per_pixel=spp))
    say(f"    {n_tri} triangles (generated in {t_gen:.3f} s); SAH build + "
        f"upload {t_build:.3f} s; intersector {params.intersector}")
    check(params.intersector == "bvh", "auto picks bvh at this size")
    chunk = 1 << 16
    (compiled, _), t_comp = _timed(lambda: render_streaming(
        arrays, params, chunk_slots=chunk, compile_only=True))
    say(f"    compile {t_comp:.3f} s; memory_analysis: "
        f"{compiled.memory_analysis()}")

    def run():
        return render(arrays, params, mode="path-trace", chunk_size=chunk).rgb

    _, t_first = _timed(run)
    img, dt = _timed(run)
    say(f"    first render {t_first:.3f} s; render {dt:.3f} s = "
        f"{size * size * spp / dt:.6g} paths/s (smoke, not a benchmark); "
        f"image mean {float(img.mean()):.6f}; peak_bytes_in_use {peak_bytes()}")
    check(bool(np.isfinite(img).all()), "all values finite")

    # The terrain fills the lower half of the frame, the sky the upper:
    _, _, o, d = _crop_rays(params, size, crop, row_frac=0.75)
    R = len(o)
    hit_fn = jax.jit(lambda a, o_, d_: scene_intersect_with_normal(
        a, o_, d_, jnp.zeros(R, jnp.float32),
        jnp.full(R, jnp.inf, jnp.float32), "bvh"))
    hit, n = hit_fn(arrays, jnp.asarray(o), jnp.asarray(d))
    (t_o, g_o, p_o, n_o), t_oracle = _timed(
        lambda: oracle_intersect_bvh(scene, o, d))
    found, found_o = np.asarray(hit.found), g_o >= 0
    both = found & found_o
    check(both.mean() > 0.2, "the crop sees the terrain")
    agree = float((found == found_o).mean())
    rel = (np.abs(np.asarray(hit.t)[both] - t_o[both])
           / np.maximum(t_o[both], 1e-9))
    dots = np.abs(np.sum(np.asarray(n)[both] * n_o[both], axis=-1))
    same = float((np.asarray(hit.prim_id)[both] == p_o[both]).mean())
    say(f"    {crop}x{crop} crop vs f64 BVH oracle ({t_oracle:.3f} s): "
        f"hit mask agrees on {agree * 100:.4f}%, t rel err q0.99 "
        f"{np.quantile(rel, 0.99):.3g}, same prim {same * 100:.3f}%, "
        f"normal |dot| q0.01 {np.quantile(dots, 0.01):.6f}")
    check(agree >= 0.999, "hit mask agrees on >= 99.9% of rays")
    check(np.quantile(rel, 0.99) < 1e-4, "t rel err q0.99 < 1e-4")
    check(np.quantile(dots, 0.01) > 0.999, "normals: |dot| q0.01 > 0.999")


def phase_four_cards(size=1440, spp=64, n_cards=4, mean_tol=0.01):
    """render_streaming_sharded on an n-card mesh against one card. The
    1% mean tolerance holds at the full frame and spp; smaller
    rehearsals pass a wider one."""
    import jax

    from ipu_ray_lib_tpu.parallel.mesh import (make_ray_mesh,
                                               render_streaming_sharded)
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    _, _, arrays, params, _ = _cli_scene(
        ["--scene", "box", "-w", str(size), "-H", str(size),
         "--samples", str(spp), "--device-only"])
    mesh = make_ray_mesh(jax.devices()[:n_cards])
    paths = size * size * spp

    def sharded():
        return render_streaming_sharded(arrays, params, mesh)

    def one(**kw):
        return render_streaming(arrays, params, **kw)

    _, t_first = _timed(sharded)
    (img_s, done_s), t_s = _timed(sharded)
    # The one-card program compiles ahead instead of a warm-up render:
    _, t_comp1 = _timed(lambda: one(compile_only=True))
    (img_1, done_1), t_1 = _timed(one)
    ms, m1 = float(img_s.mean()), float(img_1.mean())
    say(f"    {n_cards} cards: first {t_first:.3f} s, render {t_s:.3f} s = "
        f"{paths / t_s:.6g} paths/s, {paths / t_s / n_cards:.6g} per card; "
        f"done {done_s}; mean {ms:.6f} (smoke, not a benchmark)")
    say(f"    1 card: compile {t_comp1:.3f} s, render {t_1:.3f} s = "
        f"{paths / t_1:.6g} paths/s (includes loading the program); done "
        f"{done_1}; mean {m1:.6f}")
    say(f"    per-card rate / one-card rate: {(paths / t_s / n_cards) / (paths / t_1):.4f}")
    check(done_s == paths, f"{n_cards}-card done count == W*H*spp ({paths})")
    check(done_1 == paths, f"1-card done count == W*H*spp ({paths})")
    check(bool(np.isfinite(img_s).all()), "all values finite")
    check(abs(ms - m1) / m1 < mean_tol, f"image means within {mean_tol:.0%} "
          "(RNG streams differ per replica)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on a four-card mesh and "
                         "its one-card comparison")
    args = ap.parse_args(argv)
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)

    from ipu_ray_lib_tpu.runtime.config import NoGpuError, require_gpu

    try:
        require_gpu()
    except NoGpuError as e:
        sys.stderr.write(f"chip_smoke.py: {e}\n")
        return 1

    n_cards = 4 if args.four_cards else 1
    if args.four_cards:
        phases = [("four cards: sharded 1440^2 64 spp vs one card",
                   phase_four_cards)]
    else:
        phases = [
            ("Cornell + monkey 1440^2 16 spp, dense vs bvh", phase_cornell),
            ("goldens on the card", phase_goldens),
            ("shadow trace 1440^2, 6 AOVs, vs f64 oracle", phase_shadow),
            ("spheres + NIF 512^2 16 spp, env MLP vs numpy", phase_nif),
            ("stress 2.09M tris, bvh, 1440^2 4 spp, vs BVH oracle",
             phase_stress),
        ]
    say("[phase 0] device check")
    try:
        device = phase_device(n_cards)
    except (SmokeFailure, OSError, subprocess.SubprocessError):
        traceback.print_exc()
        return 1
    failed = []
    for i, (name, fn) in enumerate(phases, 1):
        say(f"[phase {i if not args.four_cards else 'four-cards'}] {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:   # report every phase, then fail the run
            traceback.print_exc()
            failed.append(name)
        say(f"    phase time {time.perf_counter() - t0:.3f} s")
    if failed:
        sys.stderr.write(f"chip_smoke.py: failed phases: {failed}\n")
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
