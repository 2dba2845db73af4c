"""Data-parallel scale-out over a device mesh.

The reference scales by replicating the whole Poplar graph per IPU and
round-robining ray batches to each replica's DRAM, with per-replica RNG
seeds and no cross-replica collectives (ref: trace.cpp:296-307,
src/IpuScene.cpp:648-684, ipu_utils.hpp:332-341). The equivalent
implemented here:

* one ``jax.sharding.Mesh`` with a single ``rays`` axis (the cards of one
  host reach each other all to all, so one axis is the whole topology);
* scene arrays replicated onto every device once, ray batches sharded on
  ``rays`` via ``shard_map``;
* per-replica RNG: the production streaming path seeds each replica's
  counter-RNG from a jump-separated host xoroshiro128** stream
  (``utils.xoshiro.derive_replica_seeds`` — the reference's scheme);
  the XLA-loop path derives per-shard ``jax.random`` keys with
  ``fold_in(key, axis_index)``;
* results gathered back to the host for image assembly — like the
  reference, no collectives are needed during rendering.
"""

from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.camera import generate_camera_rays
from ..render.path import path_trace_sample
from ..render.shadow import shadow_trace
from ..render.streaming import (MAX_K_PER_DISPATCH, SPP_BATCH,
                                _pixel_stream, streaming_path_trace)
from ..scene.build import SceneArrays, SceneParams

RAY_AXIS = "rays"


def make_ray_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (RAY_AXIS,))


def replicate_scene(scene: SceneArrays, mesh: Mesh) -> SceneArrays:
    """The scene pytree with every leaf replicated on every mesh device.
    A no-op for a scene already replicated on this mesh, so callers can
    replicate once and render many times without re-copying it."""
    return jax.device_put(scene, NamedSharding(mesh, P()))


def shard_rays(n: int, mesh: Mesh) -> int:
    """Round n up so it divides evenly across the mesh (the analogue of the
    reference's equal-batches-per-replica padding, IpuScene.cpp:93-95)."""
    d = mesh.devices.size
    return -(-n // d) * d


def render_path_sharded(
    scene: SceneArrays,
    params: SceneParams,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    key: jax.Array,
    mesh: Mesh,
    env_fn=None,
    env_params=None,
    spp: int | None = None,
):
    """Path-trace a ray batch sharded over the mesh; returns rgb [R,3].

    ``rows``/``cols`` length must be divisible by the mesh size (use
    :func:`shard_rays` to pad).
    """
    spp = spp if spp is not None else params.samples_per_pixel
    has_env = env_fn is not None

    def per_shard(scene_rep, rows_s, cols_s, env_p):
        shard_key = jax.random.fold_in(key, jax.lax.axis_index(RAY_AXIS))
        R = rows_s.shape[0]

        def one_sample(s, acc):
            skey = jax.random.fold_in(shard_key, s)
            o, d = generate_camera_rays(
                rows_s, cols_s, params.image_width, params.image_height,
                params.fov_radians, params.anti_alias_scale,
                jax.random.fold_in(skey, 0xC0FFEE),
            )
            res = path_trace_sample(
                scene_rep, o, d, skey,
                params.max_path_length, params.roulette_start_depth,
                intersector=params.intersector,
            )
            rgb = res.rgb
            if has_env:
                env_rgb = env_fn(env_p, res.esc_dir)
                rgb = rgb + jnp.where(
                    res.escaped[..., None], res.esc_throughput * env_rgb, 0.0
                )
            return acc + rgb

        acc = jax.lax.fori_loop(0, spp, one_sample, jnp.zeros((R, 3), jnp.float32))
        return acc * (1.0 / spp)

    shard_fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    return jax.jit(shard_fn)(replicate_scene(scene, mesh), rows, cols,
                             env_params)


def render_streaming_sharded(
    scene: SceneArrays,
    params: SceneParams,
    mesh: Mesh,
    spp: int | None = None,
    chunk_slots: int = 1 << 17,
    tile: int = 32,
    env_fn=None,
    env_params=None,
    progress_callback=None,
    spp_batch: int = SPP_BATCH,
):
    """Data-parallel streaming path render: the tile-ordered pixel stream
    is split across the mesh; every device runs the full regenerating
    wavefront (render/streaming.py) on its own slice with a per-device
    RNG stream. Returns (rgb [H, W, 3] numpy, paths_done).

    This is the streaming-integrator counterpart of the reference's
    multi-IPU replication: scene replicated, rays sharded, no collectives
    (images reassemble on the host — ref IpuScene.cpp:676-732).

    Same dispatch discipline as the single-device path
    (render/streaming.py): spp renders in decorrelated <= ``spp_batch``
    batches of at most ``MAX_K_PER_DISPATCH``
    paths per slot, batches accumulate ON DEVICE (sharded) so the image
    crosses to the host once, ``RAY_READBACK_F16=1`` halves that
    transfer, and ``progress_callback(batch_index, running_avg_rgb)``
    surfaces partial results per batch (ref RayCallback.cpp semantics)."""
    from ..utils.xoshiro import derive_replica_seeds

    spp = spp if spp is not None else params.samples_per_pixel
    w, h = params.window_w, params.window_h
    n_pix = w * h
    n_dev = mesh.devices.size
    rows_np, cols_np, order = _pixel_stream(params, tile)

    # Per-device slice sizes: R_local slots x J rows, same (static) J on
    # every device:
    per_dev = -(-n_pix // n_dev)
    R_local = min(chunk_slots, per_dev)
    J = -(-per_dev // R_local)
    stream = n_dev * R_local * J
    # Each device's slice is contiguous [R_local * J] of the padded stream:
    rays = NamedSharding(mesh, P(RAY_AXIS))
    rows_d = jax.device_put(
        np.pad(rows_np, (0, stream - n_pix)).reshape(n_dev, R_local * J),
        rays)
    cols_d = jax.device_put(
        np.pad(cols_np, (0, stream - n_pix)).reshape(n_dev, R_local * J),
        rays)
    scene = replicate_scene(scene, mesh)
    if env_params is not None:
        env_params = replicate_scene(env_params, mesh)

    def make_shard_fn(spp_b):
        max_iters = J * spp_b * params.max_path_length + 16

        def per_shard(scene_rep, rows_s, cols_s, env_p, seed_s):
            dev = jax.lax.axis_index(RAY_AXIS)
            # This device's slice covers padded-stream pixels
            # [dev*R_local*J, (dev+1)*R_local*J); only < n_pix are real:
            n_valid = jnp.clip(
                jnp.int32(n_pix)
                - dev.astype(jnp.int32) * jnp.int32(R_local * J),
                0, R_local * J,
            )
            accum, done, _ = streaming_path_trace(
                scene_rep, rows_s[0], cols_s[0], seed_s[0], env_p, n_valid,
                params=params, slots=R_local, j_per_slot=J, spp=spp_b,
                max_iters=max_iters, has_env=env_fn is not None,
                env_fn=env_fn,
            )
            flat = accum.transpose(0, 2, 1).reshape(R_local * J, 3) / spp_b
            return flat[None], done[None]

        return jax.jit(jax.shard_map(
            per_shard,
            mesh=mesh,
            in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(), P(RAY_AXIS)),
            out_specs=(P(RAY_AXIS), P(RAY_AXIS)),
            check_vma=False,
        ))

    shard_fns: dict = {}

    def assemble(flat_dev):
        a = np.asarray(flat_dev).astype(np.float32, copy=False)
        img = np.empty((n_pix, 3), np.float32)
        img[order] = a.reshape(stream, 3)[:n_pix]
        return img.reshape(h, w, 3)

    # Independent per-replica RNG streams via xoroshiro128** jump()
    # (utils/xoshiro.py) — the reference's per-replica seed derivation
    # (ref src/IpuScene.cpp:648-654). The u64 jump seeds fold to u32 (the
    # counter-RNG seed width); per spp-batch decorrelation folds in the
    # batch index with a golden-ratio stride:
    rep64 = derive_replica_seeds(params.rng_seed, n_dev)
    rep32 = ((rep64 ^ (rep64 >> np.uint64(32)))
             & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b_cap = max(1, MAX_K_PER_DISPATCH // J)
    flat_acc = None
    done_d: list = []
    s = bi = 0
    while s < spp:
        b = min(spp_batch, b_cap, spp - s)
        fn = shard_fns.get(b)
        if fn is None:
            fn = shard_fns[b] = make_shard_fn(b)
        seeds_b = jax.device_put(
            rep32 + np.uint32((0x85EBCA6B * bi) & 0xFFFFFFFF), rays)
        flat_b, done_b = fn(scene, rows_d, cols_d, env_params, seeds_b)
        wgt = np.float32(b / spp)
        flat_acc = (flat_b * wgt if flat_acc is None
                    else flat_acc + flat_b * wgt)
        done_d.append(done_b)
        s += b
        if progress_callback is not None:
            # Running average so far (the accumulated weights sum to s/spp):
            progress_callback(bi, assemble(flat_acc) * np.float32(spp / s))
        bi += 1

    done = int(sum(np.asarray(d).astype(np.int64).sum() for d in done_d))
    if os.environ.get("RAY_READBACK_F16", "0") == "1":
        flat_acc = flat_acc.astype(jnp.float16)
    return assemble(flat_acc), done


def render_shadow_sharded(
    scene: SceneArrays,
    params: SceneParams,
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    mesh: Mesh,
):
    """Shadow-trace a ray batch sharded over the mesh; returns TraceResultSoA."""

    def per_shard(scene_rep, rows_s, cols_s):
        o, d = generate_camera_rays(
            rows_s, cols_s, params.image_width, params.image_height,
            params.fov_radians, 0.0, None,
        )
        return shadow_trace(scene_rep, o, d, intersector=params.intersector)

    shard_fn = jax.shard_map(
        per_shard,
        mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    return jax.jit(shard_fn)(replicate_scene(scene, mesh), rows, cols)
