"""Streaming wavefront path tracer with path regeneration.

The highest-throughput integrator: a fixed pool of R ray slots advances
one segment per iteration; the moment a path terminates (escape, roulette,
bounce limit) its radiance is banked and the slot immediately
*regenerates* the next (pixel, sample) camera path. Slot utilisation
stays ~100%, versus ~40% for the per-sample wavefront whose loop drags
every lane to the longest path's length (render/path.py keeps that mode
for per-sample parity testing).

Design points:

* **No scatters** — each slot owns a private strided pixel set (slot s
  serves pixels {s, s+R, ...} of the tile-ordered stream), so banking is
  a dense masked add with no write conflicts.
* **Ray-minor accumulator layout** — the accumulator is shaped
  [J, 3, R], with the ray axis last, so the per-iteration banking add
  reads and writes contiguous rows.
* The self-intersection offset is folded into the end of the iteration,
  so the surface normal never enters the loop carry.

Radiometry is identical to the reference's path-trace codelet: emissive
accumulation on hit, diffuse/specular/dielectric sampling, roulette
after the configured depth, env light (NIF) on escape
(codelets/TraceCodelets.cpp:170-264, 321-382). RNG is counter-based per
(path_id, bounce) (ops/rng.py) — matching the reference's per-worker HW
RNG contract in distribution.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.bxdf import (
    dielectric,
    evaluate_roulette,
    offset_ray_origin,
    reflect,
    sample_diffuse,
)
from ..ops.camera import pixel_to_ray_dir
from ..ops.rng import normal2, uniform01
from ..ops.traversal import scene_intersect_with_normal
from ..scene.build import SceneArrays, SceneParams

MAT_DIFFUSE = 0
MAT_SPECULAR = 1
MAT_REFRACTIVE = 2


def _camera_ray(scene_params, rows, cols, pix, path_id, aa_scale, seed):
    """Fresh camera rays for the given slot pixel indices (vectorised).
    Origins come back pre-offset along the initial normal (0, 0, 1),
    matching the reference's first offsetRay on camera rays."""
    g1, g2 = normal2(path_id, seed, jnp.uint32(0xCA3))
    pu = rows[pix] + aa_scale * g1
    pv = cols[pix] + aa_scale * g2
    tan_theta = jnp.tan(jnp.float32(scene_params.fov_radians) / 2.0)
    d = pixel_to_ray_dir(
        pv, pu,
        jnp.float32(scene_params.image_width),
        jnp.float32(scene_params.image_height),
        tan_theta,
    )
    o = offset_ray_origin(
        jnp.zeros_like(d), d,
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32), d.shape),
    )
    return o, d


@functools.partial(
    jax.jit,
    static_argnames=("params", "slots", "j_per_slot", "spp", "max_iters",
                     "has_env", "env_fn"),
)
def streaming_path_trace(
    scene: SceneArrays,
    rows: jnp.ndarray,          # [slots * j_per_slot] f32 pixel rows (padded)
    cols: jnp.ndarray,          # [slots * j_per_slot] f32 pixel cols
    seed: jnp.ndarray,          # u32 scalar
    env_params,
    n_valid: jnp.ndarray | None = None,  # i32 scalar: real (unpadded) pixel count
    *,
    params: SceneParams,
    slots: int,
    j_per_slot: int,
    spp: int,
    max_iters: int,
    has_env: bool,
    env_fn=None,
):
    """Returns (accum [J, 3, slots] radiance sums, paths_done, iters).
    Pixel p of the padded stream lives at accum[p // slots, :, p % slots].

    ``n_valid`` marks the tail of the pixel stream as padding: slots never
    spawn paths for pixels >= n_valid, so no work is wasted tracing pixel
    (0, 0) stand-ins and ``paths_done`` counts real paths only."""
    R = slots
    J = j_per_slot
    K = J * spp  # paths per slot
    f32 = jnp.float32
    aa = f32(params.anti_alias_scale)
    slot_ids = jnp.arange(R, dtype=jnp.uint32)

    def slot_pix(k):
        j = k // spp
        return slot_ids.astype(jnp.int32) + j * R, j

    def slot_pid(k):
        # Path id = stream pixel * spp + sample: a function of the pixel
        # and sample alone, so the image does not depend on the slot
        # count R that chunk_slots picks:
        pix, _ = slot_pix(k)
        return (pix.astype(jnp.uint32) * jnp.uint32(spp)
                + (k % spp).astype(jnp.uint32))

    # Per-slot path budget: slot s serves pixels {s, s+R, ...}; rows with
    # pixel index >= n_valid are padding and get no paths at all:
    if n_valid is None:
        n_valid = jnp.int32(R * J)
    valid_j = jnp.clip(
        -(-(n_valid - slot_ids.astype(jnp.int32)) // R), 0, J
    )
    k_cap = valid_j * spp                        # [R] i32, per-slot K

    k0 = jnp.zeros(R, jnp.int32)
    o0, d0 = _camera_ray(params, rows, cols, slot_pix(k0)[0], slot_pid(k0), aa, seed)

    state = dict(
        it=jnp.int32(0),
        k=k0,
        bounce=jnp.zeros(R, jnp.int32),
        o=o0,
        d=d0,
        tp=jnp.ones((R, 3), f32),
        color=jnp.zeros((R, 3), f32),
        active=k_cap > 0,
        accum=jnp.zeros((J, 3, R), f32),
        done=jnp.uint32(0),
    )

    t_min = jnp.zeros(R, f32)

    j_iota = jax.lax.broadcasted_iota(jnp.int32, (J, 1, 1), 0)

    def cond(s):
        return (s["it"] < max_iters) & jnp.any(s["active"])

    def body(s):
        active = s["active"]
        pid = slot_pid(s["k"])
        rng_b = s["bounce"].astype(jnp.uint32) + jnp.uint32(7) + seed

        o = s["o"]
        d = s["d"]
        t_max = jnp.where(active, f32(jnp.inf), f32(-1.0))
        hit, hit_n = scene_intersect_with_normal(
            scene, o, d, t_min, t_max, params.intersector
        )
        found = hit.found
        hit_t = hit.t
        g_safe = jnp.clip(hit.geom_id, 0, scene.mat_id.shape[0] - 1)
        mid = scene.mat_id[g_safe]
        albedo = scene.mat_albedo[mid]
        ior = scene.mat_ior[mid]
        mtype = scene.mat_type[mid]
        mid_safe = jnp.clip(mid, 0, scene.mat_emission.shape[0] - 1)
        emission = scene.mat_emission[mid_safe]
        emissive = scene.mat_emissive[mid_safe] != 0

        live = active & found
        hit_p = o + d * hit_t[..., None]

        color = s["color"] + jnp.where(
            (live & emissive)[..., None], s["tp"] * emission, 0.0
        )

        u0 = uniform01(pid, rng_b, jnp.uint32(0))
        u1 = uniform01(pid, rng_b, jnp.uint32(1))
        u2 = uniform01(pid, rng_b, jnp.uint32(2))
        u3 = uniform01(pid, rng_b, jnp.uint32(3))

        d_diffuse = sample_diffuse(hit_n, u0, u1)
        d_specular = reflect(d, hit_n)
        d_dielec, refracted = dielectric(d, hit_n, ior, u2)
        is_diff = mtype == MAT_DIFFUSE
        is_spec = mtype == MAT_SPECULAR
        new_d = jnp.where(
            is_diff[..., None], d_diffuse,
            jnp.where(is_spec[..., None], d_specular, d_dielec),
        )
        scale_tp = is_diff | is_spec | ((mtype == MAT_REFRACTIVE) & refracted)
        tp = s["tp"] * jnp.where((live & scale_tp)[..., None], albedo, 1.0)

        # Next segment origin, pre-offset (normal leaves the loop here):
        o = jnp.where(
            live[..., None],
            offset_ray_origin(hit_p, new_d, hit_n),
            o,
        )
        d = jnp.where(live[..., None], new_d, d)

        # Roulette (after the configured depth):
        stop_r, tp_r = evaluate_roulette(u3, tp)
        use_roulette = s["bounce"] > params.roulette_start_depth
        tp = jnp.where((use_roulette & live)[..., None], tp_r, tp)
        killed = live & use_roulette & stop_r

        # Escape contribution (env light / NIF). Escaped lanes kept their
        # traced direction (not live, so the resample didn't touch them):
        escaped = active & ~found
        if has_env:
            env_rgb = env_fn(env_params, d)
            color = color + jnp.where(escaped[..., None], s["tp"] * env_rgb, 0.0)

        bounce = s["bounce"] + 1
        over = live & (bounce >= params.max_path_length)
        terminated = escaped | killed | over

        # Bank finished paths: dense lane-major one-hot FMA:
        _, j_cur = slot_pix(s["k"])
        sel = (j_iota == j_cur[None, None, :]) & terminated[None, None, :]
        accum = s["accum"] + jnp.where(sel, color.T[None], 0.0)
        done = s["done"] + terminated.sum().astype(jnp.uint32)

        k = jnp.where(terminated, jnp.minimum(s["k"] + 1, K), s["k"])
        active = active & ~terminated
        bounce = jnp.where(terminated, 0, bounce)
        color = jnp.where(terminated[..., None], 0.0, color)

        # Regenerate idle slots with their next path (k_cap excludes
        # padding rows, so dead-pixel paths are never spawned or counted):
        can_spawn = (~active) & (k < k_cap)
        pix, _ = slot_pix(k)
        co, cd = _camera_ray(params, rows, cols, pix, slot_pid(k), aa, seed)
        o = jnp.where(can_spawn[..., None], co, o)
        d = jnp.where(can_spawn[..., None], cd, d)
        tp = jnp.where(can_spawn[..., None], 1.0, tp)
        active = active | can_spawn

        return dict(
            it=s["it"] + 1,
            k=k, bounce=bounce,
            o=o, d=d, tp=tp, color=color,
            active=active, accum=accum, done=done,
        )

    out = jax.lax.while_loop(cond, body, state)
    return out["accum"], out["done"], out["it"]


_STREAM_CACHE: dict = {}


def _pixel_stream(params, tile):
    """Tile-ordered pixel stream (coherent slot neighbourhoods). Cached —
    the lexsort over megapixel windows costs hundreds of ms of host time
    per call otherwise, during which the device waits."""
    w, h = params.window_w, params.window_h
    key = (w, h, params.window_c, params.window_r, tile)
    hit = _STREAM_CACHE.get(key)
    if hit is not None:
        return hit
    rr, cc = np.meshgrid(
        np.arange(params.window_r, params.window_r + h),
        np.arange(params.window_c, params.window_c + w),
        indexing="ij",
    )
    rel_r, rel_c = rr - params.window_r, cc - params.window_c
    order = np.lexsort(
        (rel_c.ravel() % tile, rel_r.ravel() % tile,
         rel_c.ravel() // tile, rel_r.ravel() // tile)
    )
    rows_np = rr.ravel()[order].astype(np.float32)
    cols_np = cc.ravel()[order].astype(np.float32)
    if len(_STREAM_CACHE) > 8:
        _STREAM_CACHE.clear()
    _STREAM_CACHE[key] = (rows_np, cols_np, order)
    return rows_np, cols_np, order


_DEV_STREAM_CACHE: dict = {}


def _device_stream(rows_np, cols_np, pad, key):
    """Padded device-resident pixel stream, cached per window config (the
    host->device upload of multi-MB coordinate arrays is per-window
    constant work)."""
    hit = _DEV_STREAM_CACHE.get(key)
    if hit is not None:
        return hit
    rows = jnp.asarray(np.pad(rows_np, (0, pad)))
    cols = jnp.asarray(np.pad(cols_np, (0, pad)))
    if len(_DEV_STREAM_CACHE) > 8:
        _DEV_STREAM_CACHE.clear()
    _DEV_STREAM_CACHE[key] = (rows, cols)
    return rows, cols


# Dispatch bounds: device time of one streaming_path_trace call scales
# with J * spp_b (paths per slot over a fixed slot pool). A render runs
# as decorrelated batches of at most SPP_BATCH samples, and at most
# MAX_K_PER_DISPATCH paths per slot, so no single XLA program runs for
# minutes, a progressive caller sees every batch, and each compiled
# max_iters stays bounded. Shared by render_streaming, compile_only, and
# the sharded path (parallel/mesh.py):
SPP_BATCH = 64
MAX_K_PER_DISPATCH = 2048


def render_streaming(
    scene: SceneArrays,
    params: SceneParams,
    chunk_slots: int = 1 << 17,
    env_fn: Optional[Callable] = None,
    env_params=None,
    spp: int | None = None,
    tile: int = 32,
    seed: int | None = None,
    compile_only: bool = False,
    spp_batch: int = SPP_BATCH,
    progress_callback: Optional[Callable[[int, np.ndarray], None]] = None,
):
    """Full-window streaming render; returns (rgb [H, W, 3] numpy, done).

    Samples render in decorrelated batches of at most ``spp_batch`` (and
    ``MAX_K_PER_DISPATCH // J``); batch ``i`` uses seed
    ``seed + 0x9E3779B9 * i``. ``progress_callback(i, running_avg_rgb)``
    fires after each batch (ref RayCallback.cpp:8-24 semantics); its last
    frame is the returned image.

    ``compile_only``: AOT-compile the exact production batch program for
    this scene/config without executing it (ref compileOnly,
    ipu_utils.hpp:581-584), under a heartbeat logger. The executable
    lands in the persistent compilation cache, so a later real run loads
    it. Returns (the compiled executable, 0)."""
    spp = spp if spp is not None else params.samples_per_pixel
    seed = params.rng_seed if seed is None else seed

    w, h = params.window_w, params.window_h
    n_pix = w * h
    rows_np, cols_np, order = _pixel_stream(params, tile)

    R = min(chunk_slots, n_pix)
    J = -(-n_pix // R)
    pad = R * J - n_pix
    rows_d, cols_d = _device_stream(
        rows_np, cols_np, pad,
        (params.window_w, params.window_h, params.window_c, params.window_r,
         tile, R, J),
    )
    b_cap = max(1, MAX_K_PER_DISPATCH // J)

    if compile_only:
        from ..runtime.config import CompileProgress

        # First production batch size — the same J*spp-capped pick the
        # render loop below makes, so the AOT-compiled program is the
        # one the real run executes:
        b = min(spp_batch, b_cap, spp)
        name = "streaming_path_trace"
        with CompileProgress(name):
            compiled = streaming_path_trace.lower(
                scene, rows_d, cols_d, jnp.uint32((seed or 0) & 0xFFFFFFFF),
                env_params, jnp.int32(n_pix),
                params=params, slots=R, j_per_slot=J, spp=b,
                max_iters=J * b * params.max_path_length + 16,
                has_env=env_fn is not None, env_fn=env_fn,
            ).compile()
        from ..utils.log import logger

        logger().info("Compile-only: %s ready (memory: %s)", name,
                      compiled.memory_analysis())
        return compiled, 0

    def run_batch(batch_seed, spp_b):
        """One bounded-spp render; returns (flat [R*J, 3] spp-averaged
        radiance, device-resident; done, a device scalar)."""
        accum, done, _iters = streaming_path_trace(
            scene, rows_d, cols_d,
            jnp.uint32(batch_seed & 0xFFFFFFFF), env_params,
            jnp.int32(n_pix),
            params=params, slots=R, j_per_slot=J, spp=spp_b,
            max_iters=J * spp_b * params.max_path_length + 16,
            has_env=env_fn is not None, env_fn=env_fn,
        )
        # accum[j, :, s] holds padded-stream pixel s + j*R:
        flat_d = accum.transpose(0, 2, 1).reshape(R * J, 3) / spp_b
        return flat_d, done

    def assemble(flat_dev):
        flat = np.asarray(flat_dev).astype(np.float32, copy=False)
        img = np.empty((n_pix, 3), np.float32)
        img[order] = flat[:n_pix]
        return img.reshape(h, w, 3)

    # Render in decorrelated batches (see SPP_BATCH above) — identical
    # estimator — and accumulate ON DEVICE so the image crosses to the
    # host once (plus once per batch for a progressive caller). Optional
    # half-precision readback (``RAY_READBACK_F16=1``): f16 holds ~3
    # significant digits, enough for display/preview, and halves the
    # bytes of a large frame's device-to-host copy; the cast runs on the
    # device before the copy:
    done_d: list = []
    flat_acc = None
    s = bi = 0
    while s < spp:
        b = min(spp_batch, b_cap, spp - s)
        flat_b, done_b = run_batch(
            (seed + 0x9E3779B9 * bi) & 0xFFFFFFFF, b)
        wgt = np.float32(b / spp)
        flat_acc = (flat_b * wgt if flat_acc is None
                    else flat_acc + flat_b * wgt)
        done_d.append(done_b)
        s += b
        if progress_callback is not None and s < spp:
            # Running average so far (the accumulated weights sum to s/spp):
            progress_callback(bi, assemble(flat_acc * np.float32(spp / s)))
        bi += 1
    if os.environ.get("RAY_READBACK_F16", "0") == "1":
        flat_acc = flat_acc.astype(jnp.float16)
    img = assemble(flat_acc)
    if progress_callback is not None:
        progress_callback(bi - 1, img)
    # One stacked transfer for the per-batch done counts:
    done = int(np.asarray(jnp.stack(done_d)).astype(np.int64).sum())
    return img, done
