#!/usr/bin/env python
"""trace.py — render a scene on the GPU, with CPU-twin and oracle verification.

The application layer of ipu_ray_lib_tpu: the counterpart of the
reference's ``trace`` CLI (ref: trace.cpp:338-424 for the flag set,
426-544 for the run/verify flow). Renders the scene with:

  * the brute-force numpy oracle (the "Embree role" reference image),
  * the same JAX code on the CPU backend (the CPU-twin debug path), and
  * the device renderer (the GPU; the CPU only when ``JAX_PLATFORMS=cpu``),

then writes EXR AOVs and reports cross-renderer MSE.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def add_options(p: argparse.ArgumentParser) -> None:
    # Flag set mirrors ref trace.cpp:338-378.
    p.add_argument("-o", "--outprefix", default="out", help="Output filename prefix.")
    p.add_argument("--devices", type=int, default=0,
                   help="Number of devices to shard rays over (0 = all available).")
    p.add_argument("--chunk-size", type=int, default=1 << 16,
                   help="Rays per device chunk (static shape; analogue of rays-per-worker).")
    p.add_argument("-w", "--width", type=int, default=768, help="Image width.")
    p.add_argument("-H", "--height", type=int, default=432, help="Image height.")
    p.add_argument("--crop", default="",
                   help="Render window, format wxh+c+r (width x height + col + row offset).")
    p.add_argument("--anti-alias", type=float, default=0.25,
                   help="Std-dev of gaussian anti-aliasing jitter in pixels.")
    p.add_argument("--mesh-file", default="",
                   help="Scene file to render (.glb supported natively).")
    p.add_argument("--nif-hdri", default="",
                   help="Path to the assets.extra directory of a saved NIF model "
                        "(HDRI environment light for escaped rays).")
    p.add_argument("--hdri-rotation", type=float, default=0.0,
                   help="Azimuthal rotation for the HDRI environment (degrees).")
    p.add_argument("--load-normals", action="store_true",
                   help="Load & interpolate vertex normals from the mesh file.")
    p.add_argument("--scene", default="box", choices=["box-simple", "box", "spheres"],
                   help="Built-in scene (when no mesh-file given).")
    p.add_argument("--visualise", default="rgb",
                   choices=["rgb", "normal", "hitpoint", "tfar", "color", "id"],
                   help="AOV to write.")
    p.add_argument("--render-mode", default="path-trace",
                   choices=["shadow-trace", "path-trace"])
    p.add_argument("--max-path-length", type=int, default=10)
    p.add_argument("--roulette-start-depth", type=int, default=3)
    p.add_argument("--samples", type=int, default=256, help="Samples per pixel.")
    p.add_argument("--seed", type=int, default=1442)
    p.add_argument("--max-nif-batch-size", type=int, default=0,
                   help="Kept for interface parity; NIF batches are evaluated "
                        "inside the wavefront, no serialisation needed.")
    p.add_argument("--device-only", action="store_true",
                   help="Skip the CPU/oracle reference renders.")
    p.add_argument("--progressive", action="store_true",
                   help="Report partial results chunk-by-chunk while rendering "
                        "(RayCallback analogue).")
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "bvh", "dense"],
                   help="Closest-hit engine: threaded-BVH wavefront or dense "
                        "brute force over triangle blocks (auto picks by "
                        "primitive count).")
    p.add_argument("--compile-only", action="store_true",
                   help="AOT-compile the render program for this scene/config "
                        "(with compile-progress heartbeat) and exit without "
                        "executing; the executable lands in the persistent "
                        "compilation cache for later runs.")
    p.add_argument("--scene-cache", default="",
                   help="Directory for compiled-scene bundles: imports + BVH "
                        "build + table packing persist across runs, keyed by "
                        "the scene-affecting flags (the user-facing twin of "
                        "the reference's saveExe/loadExe pathway, "
                        "ipu_utils.hpp:51-76 — XLA executables already "
                        "persist via the compilation cache).")
    p.add_argument("--log-level", default="info",
                   choices=["trace", "debug", "info", "warn", "err", "critical", "off"])


def parse_crop(s: str):
    from ipu_ray_lib_tpu.scene.types import CropWindow
    import re

    if not s:
        return None
    m = re.search(r"(\d+)x(\d+)\+(\d+)\+(\d+)", s)
    if not m:
        raise ValueError(f"Badly formatted --crop string: '{s}'")
    return CropWindow(int(m.group(1)), int(m.group(2)), int(m.group(3)), int(m.group(4)))


def build_scene_description(args):
    from ipu_ray_lib_tpu.scene.builtin import (
        make_cornell_box_scene,
        make_primitive_scene,
    )
    from ipu_ray_lib_tpu.scene.io import import_scene
    from ipu_ray_lib_tpu.scene.types import PathTraceSettings

    if args.mesh_file:
        scene = import_scene(args.mesh_file, load_normals=args.load_normals)
    elif args.scene in ("box", "box-simple"):
        mesh_file = "assets/monkey_bust.glb"
        import os

        if not os.path.exists(mesh_file):
            mesh_file = None
        scene = make_cornell_box_scene(mesh_file, box_only=args.scene == "box-simple")
    elif args.scene == "spheres":
        scene = make_primitive_scene()
    else:
        raise ValueError(f"Invalid scene selection: {args.scene}")

    if args.render_mode == "path-trace":
        if args.visualise != "rgb":
            raise RuntimeError("Path tracing without visualise=rgb is not advised.")
        scene.path_trace = PathTraceSettings(
            samples_per_pixel=args.samples,
            max_path_length=args.max_path_length,
            roulette_start_depth=args.roulette_start_depth,
            rng_seed=args.seed,
        )
    return scene


def scene_build_kwargs(args) -> dict:
    """build_scene keyword arguments for the parsed CLI flags."""
    return dict(
        image_width=args.width,
        image_height=args.height,
        window=parse_crop(args.crop),
        anti_alias_scale=args.anti_alias,
        max_path_length=args.max_path_length,
        roulette_start_depth=args.roulette_start_depth,
        samples_per_pixel=args.samples,
        rng_seed=args.seed,
        intersector=args.intersector,
    )


def _render_sharded(arrays, params, n_dev, env_fn, env_params):
    """Full-frame data-parallel path render (ray axis sharded over devices)."""
    import jax
    import jax.numpy as jnp

    from ipu_ray_lib_tpu.ops.camera import pixel_grid
    from ipu_ray_lib_tpu.parallel.mesh import (
        make_ray_mesh, render_path_sharded, render_streaming_sharded, shard_rays,
    )
    from ipu_ray_lib_tpu.render.renderer import RenderOutput

    mesh = make_ray_mesh(jax.devices()[:n_dev])
    if env_fn is None:
        # Flagship integrator (streaming regeneration), sharded:
        rgb, _done = render_streaming_sharded(arrays, params, mesh)
    else:
        rows, cols = pixel_grid(
            params.window_w, params.window_h, params.window_c, params.window_r
        )
        total = rows.shape[0]
        n = shard_rays(total, mesh)
        rows = jnp.pad(rows, (0, n - total))
        cols = jnp.pad(cols, (0, n - total))
        key = jax.random.PRNGKey(params.rng_seed)
        rgb = np.asarray(
            render_path_sharded(arrays, params, rows, cols, key, mesh,
                                env_fn=env_fn, env_params=env_params)
        )[:total].reshape(params.window_h, params.window_w, 3)
    zero = np.zeros_like(rgb)
    zi = np.full(rgb.shape[:2], -1, np.int32)
    zf = np.full(rgb.shape[:2], np.inf, np.float32)
    return RenderOutput(rgb=rgb, t=zf, geom_id=zi, prim_id=zi, normal=zero, hit_p=zero)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_options(parser)
    args = parser.parse_args(argv)

    from ipu_ray_lib_tpu.utils.log import logger, setup_logging

    setup_logging(args.log_level)
    log = logger()

    import jax

    from ipu_ray_lib_tpu.runtime.config import (
        NoGpuError, install_compile_event_logging, select_backend,
        setup_compilation_cache)

    # The GPU, or the CPU only when JAX_PLATFORMS=cpu asks for it:
    try:
        select_backend()
    except NoGpuError as e:
        log.error("%s", e)
        return 2
    dev0 = jax.devices()[0]
    log.info("Rendering on platform '%s' (%s), %d device(s); compile cache %s",
             dev0.platform, dev0.device_kind, len(jax.devices()),
             setup_compilation_cache())
    # Compile-progress observability (ref CallbackFilter role): every XLA
    # backend compile reports its duration; slow ones log at info.
    install_compile_event_logging()

    from ipu_ray_lib_tpu.cpu.reference import oracle_shadow_trace
    from ipu_ray_lib_tpu.ops.camera import generate_camera_rays, pixel_grid
    from ipu_ray_lib_tpu.render.aov import VisualiseMode, make_aov_image
    from ipu_ray_lib_tpu.render.renderer import render
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.utils.image import mse, write_image

    build_kwargs = scene_build_kwargs(args)

    cache_path = None
    if args.scene_cache:
        # Bundle key: every flag that changes the built scene or params.
        # Loads rebuild the deterministic intersector tables; everything
        # expensive (import parse, SAH build, packing) comes from disk:
        import hashlib
        import json as _json

        # Mesh files key by (path, mtime, size) so an edited scene file
        # invalidates its bundle instead of silently loading stale
        # geometry:
        mesh_key = ""
        if args.mesh_file:
            st = os.stat(args.mesh_file)
            mesh_key = (f"{os.path.abspath(args.mesh_file)}"
                        f":{st.st_mtime_ns}:{st.st_size}")
        keysrc = _json.dumps(
            {"scene": args.scene, "mesh": mesh_key,
             "normals": args.load_normals,
             "w": args.width, "h": args.height, "crop": args.crop,
             "aa": args.anti_alias, "mpl": args.max_path_length,
             "rsd": args.roulette_start_depth, "spp": args.samples,
             "seed": args.seed, "intersector": args.intersector},
            sort_keys=True)
        tag = hashlib.sha1(keysrc.encode()).hexdigest()[:16]
        os.makedirs(args.scene_cache, exist_ok=True)
        cache_path = os.path.join(args.scene_cache, f"scene-{tag}.tprs")

    if cache_path is not None and os.path.exists(cache_path):
        from ipu_ray_lib_tpu.scene.cache import load_compiled_scene

        arrays, params, bvh = load_compiled_scene(cache_path)
        log.info("Loaded compiled scene from cache: %s", cache_path)
    else:
        scene = build_scene_description(args)
        arrays, params, bvh = build_scene(scene, **build_kwargs)
        if cache_path is not None:
            from ipu_ray_lib_tpu.scene.cache import save_compiled_scene

            save_compiled_scene(cache_path, arrays, params, bvh)
            log.info("Saved compiled scene to cache: %s", cache_path)
    log.info(
        "Scene built: %d geoms, %d BVH nodes (max depth %d), window %dx%d+%d+%d, intersector=%s",
        params.num_geoms, params.num_bvh_nodes, params.bvh_max_depth,
        params.window_w, params.window_h, params.window_c, params.window_r,
        params.intersector,
    )

    env_fn = env_params = None
    if args.nif_hdri:
        from ipu_ray_lib_tpu.nif import load_nif_env

        env_fn, env_params = load_nif_env(
            args.nif_hdri, rotation_degrees=args.hdri_rotation
        )
        log.info("Loaded NIF environment light from %s", args.nif_hdri)

    if args.compile_only:
        # AOT-compile the production program for this exact scene/config,
        # then exit without executing (ref RuntimeConfig::compileOnly,
        # ipu_utils.hpp:581-584; the persistent XLA cache is the saveExe).
        if args.render_mode == "path-trace":
            from ipu_ray_lib_tpu.render.streaming import render_streaming

            render_streaming(
                arrays, params, chunk_slots=args.chunk_size,
                env_fn=env_fn, env_params=env_params, compile_only=True,
            )
        else:
            import jax.numpy as jnp

            from ipu_ray_lib_tpu.render.renderer import _shadow_chunk
            from ipu_ray_lib_tpu.runtime.config import CompileProgress

            zeros = jnp.zeros((args.chunk_size,), jnp.int32)
            with CompileProgress("shadow_chunk"):
                _shadow_chunk.lower(
                    arrays, zeros, zeros,
                    fov=params.fov_radians,
                    width=params.image_width,
                    height=params.image_height,
                    intersector=params.intersector,
                ).compile()
        log.info("Compile-only run complete; exiting without execution.")
        return 0

    vis = VisualiseMode(args.visualise)
    prefix = f"{args.outprefix}_{args.visualise}_"
    mat_id = np.asarray(arrays.mat_id)
    mat_albedo = np.asarray(arrays.mat_albedo)

    images = {}

    if not args.device_only:
        # Oracle reference (the Embree role):
        if args.render_mode == "shadow-trace":
            rows, cols = pixel_grid(
                params.window_w, params.window_h, params.window_c, params.window_r
            )
            o, d = generate_camera_rays(
                rows, cols, args.width, args.height, params.fov_radians, 0.0, None
            )
            t0 = time.time()
            res = oracle_shadow_trace(scene, np.asarray(o), np.asarray(d))
            dt = time.time() - t0
            log.info("Oracle ray rate: %.3g rays/sec", len(rows) / dt)

            class _O:  # shape into RenderOutput-like for AOVs
                rgb = res["rgb"].reshape(params.window_h, params.window_w, 3)
                t = res["t"].reshape(params.window_h, params.window_w)
                geom_id = res["geom"].reshape(params.window_h, params.window_w)
                prim_id = res["prim"].reshape(params.window_h, params.window_w)
                normal = res["normal"].reshape(params.window_h, params.window_w, 3)
                hit_p = res["hit_p"].reshape(params.window_h, params.window_w, 3)

            img = make_aov_image(_O, vis, mat_id, mat_albedo)
            images["oracle"] = img
            write_image(prefix + "oracle.exr", img)
        else:
            log.info("Oracle path tracing skipped (matches reference: no Embree path trace).")

        # CPU twin: identical JAX code on the CPU backend.
        try:
            cpu_dev = jax.devices("cpu")[0]
            with jax.default_device(cpu_dev):
                t0 = time.time()
                out = render(
                    arrays, params, mode=args.render_mode,
                    chunk_size=args.chunk_size, env_fn=env_fn, env_params=env_params,
                )
                dt = time.time() - t0
            spp = args.samples if args.render_mode == "path-trace" else 1
            log.info(
                "CPU-twin rate: %.3g %s/sec",
                params.window_w * params.window_h * spp / dt,
                "path-samples" if spp > 1 else "rays",
            )
            img = make_aov_image(out, vis, mat_id, mat_albedo)
            images["cpu"] = img
            write_image(prefix + "cpu.exr", img)
        except RuntimeError as e:
            log.warning("CPU twin render unavailable: %s", e)

    # Device render:
    cb = None
    if args.progressive:
        def cb(ci, rgb_chunk):
            log.info("chunk %d done (mean %.4f)", ci, float(rgb_chunk.mean()))

    n_dev = len(jax.devices())
    want_dev = args.devices if args.devices > 0 else n_dev
    t0 = time.time()
    if want_dev > 1 and n_dev > 1 and args.render_mode == "path-trace":
        # Data-parallel over the device mesh (replicated scene, sharded rays):
        out = _render_sharded(arrays, params, min(want_dev, n_dev), env_fn, env_params)
        log.info("Sharded render over %d devices", min(want_dev, n_dev))
    else:
        # Read back only the AOV fields this visualise mode needs — the
        # full 6-field set is host-link bound at large resolutions:
        needed = {
            "rgb": ("rgb",), "normal": ("normal",), "tfar": ("t",),
            "hitpoint": ("hit_p",), "id": ("prim_id",), "color": (),
        }[args.visualise]
        out = render(
            arrays, params, mode=args.render_mode,
            chunk_size=args.chunk_size, env_fn=env_fn, env_params=env_params,
            progress_callback=cb, aovs=needed,
        )
    dt = time.time() - t0
    spp = args.samples if args.render_mode == "path-trace" else 1
    log.info(
        "Render rate: %.4g %s/sec (%.2fs)",
        params.window_w * params.window_h * spp / dt,
        "path-samples" if spp > 1 else "rays", dt,
    )
    img = make_aov_image(out, vis, mat_id, mat_albedo)
    images["device"] = img
    write_image(prefix + "device.exr", img)
    if args.render_mode == "shadow-trace":
        log.info("Hit count: %d", out.hit_count)

    if "cpu" in images:
        log.info("MSE device vs CPU-twin: %.6g", mse(images["device"], images["cpu"]))
    if "oracle" in images:
        log.info("MSE device vs oracle: %.6g", mse(images["device"], images["oracle"]))

    log.info("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
