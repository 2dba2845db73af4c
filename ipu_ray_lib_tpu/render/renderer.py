"""Render orchestration: chunked, jit-compiled, progressive.

The host-runtime layer — role of ref src/IpuScene.cpp execute path +
GraphManager (include/ipu_utils.hpp): batches the ray stream into
fixed-size chunks (static shapes for XLA), runs the jitted integrator per
chunk, and reassembles AOVs. Chunking provides the same "unbounded image
size" property as the reference's DRAM ray streaming (README.md:20-23):
only one chunk of ray state is live on device; chunk results stream back
to the host as they finish (the RayCallback analogue).
"""

from __future__ import annotations

import functools
import os
from typing import Callable, NamedTuple, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..bvh.builder import INVALID_GEOM_ID
from ..ops.camera import generate_camera_rays
from ..scene.build import SceneArrays, SceneParams
from .path import path_trace_sample
from .shadow import shadow_trace

DEFAULT_CHUNK = 1 << 16
TILE = 32  # pixel tile edge for coherent ray ordering


def _prep_f(x, f16: bool):
    """Device-side readback prep for a float AOV: identity at f32, else
    a clamped f16 cast. Finite values clamp to the f16 range first (hit
    distances / points beyond 65504 must degrade to ~3-digit precision
    like everything else, not overflow to inf); true infinities (the
    miss sentinel in t) pass through unchanged."""
    if not f16:
        return x
    fmax = jnp.float32(np.finfo(np.float16).max)
    xc = jnp.where(jnp.isfinite(x), jnp.clip(x, -fmax, fmax), x)
    return xc.astype(jnp.float16)


class RenderOutput(NamedTuple):
    """Per-pixel AOVs, [H, W, ...] numpy arrays (window-sized)."""

    rgb: np.ndarray
    t: np.ndarray
    geom_id: np.ndarray
    prim_id: np.ndarray
    normal: np.ndarray
    hit_p: np.ndarray

    @property
    def hit_count(self) -> int:
        return int(np.sum(self.geom_id >= 0))


@functools.partial(jax.jit, static_argnames=("n", "w"))
def _tile_coords(g0, n, w, window_c, window_r, total):
    """Device-side twin of the host tile-order pixel stream for
    TILE-aligned windows: rows/cols of padded-stream indices
    [g0, g0+n) computed from iota, so the shadow mode uploads no
    per-chunk coordinate arrays. Bitwise-identical values to the host
    lexsort stream (integer arithmetic)."""
    T = TILE
    g = g0 + jax.lax.iota(jnp.int32, n)
    tiles_per_row = w // T
    tile_id = g // (T * T)
    within = g % (T * T)
    tr = tile_id // tiles_per_row
    tc = tile_id % tiles_per_row
    ir = within // T
    ic = within % T
    valid = g < total
    rows = jnp.where(valid, window_r + tr * T + ir, 0).astype(jnp.float32)
    cols = jnp.where(valid, window_c + tc * T + ic, 0).astype(jnp.float32)
    return rows, cols


@functools.partial(
    jax.jit,
    static_argnames=("fov", "width", "height", "intersector"),
)
def _shadow_chunk(scene: SceneArrays, rows, cols, *, fov, width, height,
                  intersector="bvh"):
    origins, dirs = generate_camera_rays(
        rows, cols, width, height, fov, 0.0, None
    )
    return shadow_trace(scene, origins, dirs, intersector=intersector)


@functools.partial(
    jax.jit,
    static_argnames=(
        "fov", "width", "height", "aa_scale", "spp",
        "max_path_length", "roulette_start_depth", "has_env", "env_fn",
        "intersector",
    ),
)
def _path_chunk(
    scene: SceneArrays,
    rows,
    cols,
    key,
    env_params,
    *,
    fov,
    width,
    height,
    aa_scale,
    spp,
    max_path_length,
    roulette_start_depth,
    has_env,
    env_fn=None,
    intersector="bvh",
):
    R = rows.shape[0]

    def one_sample(s, acc, carry_err):
        skey = jax.random.fold_in(key, s)
        origins, dirs = generate_camera_rays(
            rows, cols, width, height, fov, aa_scale, jax.random.fold_in(skey, 0xC0FFEE)
        )
        result = path_trace_sample(
            scene, origins, dirs, skey, max_path_length, roulette_start_depth,
            intersector=intersector,
        )
        rgb = result.rgb
        if has_env:
            env_rgb = env_fn(env_params, result.esc_dir)
            rgb = rgb + jnp.where(
                result.escaped[..., None], result.esc_throughput * env_rgb, 0.0
            )
        err = carry_err | result.error
        return acc + rgb, err

    acc, err = jax.lax.fori_loop(
        0, spp, lambda s, c: one_sample(s, *c),
        (jnp.zeros((R, 3), jnp.float32), jnp.zeros(R, bool)),
    )
    return acc * (1.0 / spp), err


def render(
    scene: SceneArrays,
    params: SceneParams,
    mode: str = "shadow-trace",
    chunk_size: int = DEFAULT_CHUNK,
    env_fn: Optional[Callable] = None,
    env_params=None,
    progress_callback: Optional[Callable[[int, np.ndarray], None]] = None,
    streaming: bool = True,
    aovs: Optional[tuple] = None,
) -> RenderOutput:
    """Render the scene's crop window. ``mode`` is 'shadow-trace' or
    'path-trace'. ``env_fn(env_params, dirs) -> rgb`` is an optional
    environment light (the NIF hook) applied to escaped rays.

    ``aovs`` limits which shadow-trace AOV fields are read back from the
    device (None = all); un-requested fields come back zero-filled.

    ``progress_callback(chunk_index, rgb_chunk)`` fires as each chunk
    completes — the analogue of the reference's RayCallback streaming
    partial results (src/RayCallback.cpp).

    Path tracing uses the regenerating streaming wavefront
    (render/streaming.py) by default — the fastest integrator — including
    progressive mode, which renders decorrelated batches of at most 16
    spp and surfaces the running average per batch. Pass
    ``streaming=False`` for the per-sample wavefront (kept for parity
    tests).
    """
    if mode == "path-trace" and streaming:
        from .streaming import render_streaming

        h, w = params.window_h, params.window_w
        # Progressive mode surfaces the running average after each batch
        # of at most 16 spp (ref RayCallback.cpp:8-24 semantics):
        rgb_img, _done = render_streaming(
            scene, params, chunk_slots=chunk_size,
            env_fn=env_fn, env_params=env_params,
            **({} if progress_callback is None else dict(
                spp_batch=16, progress_callback=progress_callback)),
        )
        zi = np.full((h, w), -1, np.int32)
        zf = np.full((h, w), np.inf, np.float32)
        z3 = np.zeros((h, w, 3), np.float32)
        return RenderOutput(rgb=rgb_img, t=zf, geom_id=zi, prim_id=zi,
                            normal=z3, hit_p=z3)
    w, h = params.window_w, params.window_h
    total = w * h
    # Tile-ordered traversal: rays in a chunk cover compact screen tiles,
    # which keeps ray blocks spatially coherent for the intersectors'
    # block culling (the IPU analogue is rays-per-tile locality). The
    # stream + order come from the streaming renderer's cache (same
    # lexsort keys), and for TILE-aligned windows the per-chunk
    # coordinates are regenerated ON DEVICE (_tile_coords) instead of
    # uploaded — the upload was the shadow mode's biggest link cost:
    from .streaming import _pixel_stream

    rows_np, cols_np, order = _pixel_stream(params, TILE)
    device_coords = (w % TILE == 0) and (h % TILE == 0)
    n_chunks = -(-total // chunk_size)
    padded = n_chunks * chunk_size
    pad = padded - total
    rows_np = np.pad(rows_np, (0, pad))
    cols_np = np.pad(cols_np, (0, pad))

    rgb = np.zeros((padded, 3), np.float32)
    t = np.full(padded, np.inf, np.float32)
    geom = np.full(padded, -1, np.int32)
    prim = np.full(padded, -1, np.int32)
    normal = np.zeros((padded, 3), np.float32)
    hit_p = np.zeros((padded, 3), np.float32)

    base_key = jax.random.PRNGKey(params.rng_seed)
    want = lambda f: aovs is None or f in aovs
    f16 = os.environ.get("RAY_READBACK_F16", "0") == "1"

    # Dispatch all chunks asynchronously (JAX queues them on device), then
    # gather. With a progress callback we synchronise per chunk instead so
    # partial results stream back as they finish (RayCallback semantics).
    pending = []
    for ci in range(n_chunks):
        sl = slice(ci * chunk_size, (ci + 1) * chunk_size)
        if device_coords:
            rows, cols = _tile_coords(
                jnp.int32(ci * chunk_size), n=chunk_size, w=w,
                window_c=jnp.int32(params.window_c),
                window_r=jnp.int32(params.window_r),
                total=jnp.int32(total))
        else:
            rows = jnp.asarray(rows_np[sl])
            cols = jnp.asarray(cols_np[sl])
        if mode == "shadow-trace":
            res = _shadow_chunk(
                scene, rows, cols,
                fov=params.fov_radians,
                width=params.image_width,
                height=params.image_height,
                intersector=params.intersector,
            )
        elif mode == "path-trace":
            ckey = jax.random.fold_in(base_key, ci)
            res, _err = _path_chunk(
                scene, rows, cols, ckey, env_params,
                fov=params.fov_radians,
                width=params.image_width,
                height=params.image_height,
                aa_scale=params.anti_alias_scale,
                spp=params.samples_per_pixel,
                max_path_length=params.max_path_length,
                roulette_start_depth=params.roulette_start_depth,
                has_env=env_fn is not None,
                env_fn=env_fn,
                intersector=params.intersector,
            )
        else:
            raise ValueError(f"Unknown render mode '{mode}'")

        # Device-side readback prep happens HERE, at dispatch time, so
        # the cast/pack ops for chunk ci are enqueued before chunk
        # ci+1's compute — casting at fetch time would queue them behind
        # the LAST chunk and serialise the d2h/compute overlap.
        # RAY_READBACK_F16 halves the d2h bytes of the float AOVs
        # (device-side f16 cast, ~3 significant digits,
        # display/validation-grade).
        # geom ids always ride u16 (the reference's own id width —
        # 0xFFFF invalid sentinel, include/CompactBVH2Node.hpp:73 — so
        # the cast is lossless); prim ids stay exact i32:
        if mode == "shadow-trace":
            fetch = {"geom_id": res.geom_id.astype(jnp.uint16)}
            if want("rgb"):
                fetch["rgb"] = _prep_f(res.rgb, f16)
            if want("t"):
                fetch["t"] = _prep_f(res.t, f16)
            if want("prim_id"):
                fetch["prim_id"] = res.prim_id
            if want("normal"):
                fetch["normal"] = _prep_f(res.normal, f16)
            if want("hit_p"):
                fetch["hit_p"] = _prep_f(res.hit_p, f16)
        else:
            fetch = {"rgb": _prep_f(res, f16)}
        pending.append((ci, sl, fetch,
                        _err if mode == "path-trace" else None))
        if progress_callback is not None:
            chunk_rgb = np.asarray(fetch["rgb"]).astype(np.float32)
            progress_callback(ci, chunk_rgb)

    n_errors = 0
    # Pre-issue every chunk's d2h as an async copy so the fetch loop's
    # host-side work (astype + scatter) overlaps the remaining
    # transfers instead of serialising with them:
    for _, _, fetch, _ in pending:
        for a in fetch.values():
            try:
                a.copy_to_host_async()
            except Exception:   # backend-dependent; asarray still works
                break

    def _host_f(x):
        return np.asarray(x).astype(np.float32)

    for ci, sl, fetch, err in pending:
        if err is not None:
            n_errors += int(np.asarray(err).sum())
        if mode == "shadow-trace":
            g = np.asarray(fetch["geom_id"]).astype(np.int32)
            geom[sl] = np.where(g == INVALID_GEOM_ID, -1, g)
            if "rgb" in fetch:
                rgb[sl] = _host_f(fetch["rgb"])
            if "t" in fetch:
                t[sl] = _host_f(fetch["t"])
            if "prim_id" in fetch:
                prim[sl] = np.asarray(fetch["prim_id"])
            if "normal" in fetch:
                normal[sl] = _host_f(fetch["normal"])
            if "hit_p" in fetch:
                hit_p[sl] = _host_f(fetch["hit_p"])
        else:
            rgb[sl] = _host_f(fetch["rgb"])
    if n_errors:
        from ..utils.log import logger

        # In-band error marker, like the reference's HitRecord::ERROR NaN
        # flagging (TraceCodelets.cpp:240-244):
        logger().warning("%d rays flagged material errors during path trace", n_errors)

    inverse = np.empty(total, np.int64)
    inverse[order] = np.arange(total)

    def im(a, ch=None):
        a = a[:total][inverse]  # undo tile ordering
        return a.reshape((h, w) + ((ch,) if ch else ()))

    return RenderOutput(
        rgb=im(rgb, 3),
        t=im(t),
        geom_id=im(geom),
        prim_id=im(prim),
        normal=im(normal, 3),
        hit_p=im(hit_p, 3),
    )
