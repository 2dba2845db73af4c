"""Multi-device data parallelism tests on the virtual 8-device CPU mesh.

Covers the reference's replication semantics (SURVEY.md §2 parallelism
item 1): sharded rays, replicated scene, per-shard RNG, and agreement
with the single-device path."""

import os

import numpy as np

import jax
import jax.numpy as jnp

from ipu_ray_lib_tpu.ops.camera import pixel_grid
from ipu_ray_lib_tpu.parallel.mesh import (
    make_ray_mesh,
    render_path_sharded,
    render_shadow_sharded,
    shard_rays,
)
from ipu_ray_lib_tpu.render.renderer import render
from ipu_ray_lib_tpu.utils.xoshiro import Xoroshiro128, derive_replica_seeds


def test_mesh_has_8_devices():
    mesh = make_ray_mesh()
    assert mesh.devices.size == 8


def test_shadow_sharded_matches_single(cornell_built):
    arrays, params, _ = cornell_built
    mesh = make_ray_mesh()
    size = 32
    rows, cols = pixel_grid(size, size, 0, 0)
    n = shard_rays(rows.shape[0], mesh)
    assert n == rows.shape[0]  # 1024 divides 8

    res = render_shadow_sharded(arrays, params, rows, cols, mesh)

    import dataclasses

    p32 = dataclasses.replace(params, window_w=size, window_h=size,
                              window_c=0, window_r=0)
    single = render(arrays, p32, mode="shadow-trace", chunk_size=size * size)
    np.testing.assert_allclose(
        np.asarray(res.rgb).reshape(size, size, 3), single.rgb, rtol=1e-5, atol=1e-6
    )


def test_path_sharded_runs_and_is_consistent(cornell_built):
    arrays, params, _ = cornell_built
    mesh = make_ray_mesh()
    # Central window (corner rays may never reach the light at low spp):
    rows, cols = pixel_grid(16, 16, 56, 56)
    key = jax.random.PRNGKey(0)
    rgb = np.asarray(
        render_path_sharded(arrays, params, rows, cols, key, mesh, spp=4)
    )
    assert rgb.shape == (256, 3)
    assert np.all(np.isfinite(rgb))
    assert rgb.max() > 0

    # Different shards must use different RNG streams: per-shard means of a
    # diffuse region shouldn't be identical.
    shards = rgb.reshape(8, 32, 3)
    means = shards.mean(axis=(1, 2))
    assert len(np.unique(np.round(means, 7))) > 1


def test_replica_seed_derivation():
    seeds = derive_replica_seeds(1442, 4)
    assert len(set(seeds.tolist())) == 4

    # Jump-separated streams should differ immediately:
    g0 = Xoroshiro128(1442)
    g1 = Xoroshiro128(1442)
    g1.jump()
    assert g0.next_u64() != g1.next_u64()


def test_xoshiro_uniform_range():
    g = Xoroshiro128(7)
    u = g.uniform_0_1(1000)
    assert np.all((u >= 0) & (u < 1))
    assert 0.4 < u.mean() < 0.6


def test_streaming_sharded_matches_single(cornell_built):
    """Sharded streaming render must agree with single-device streaming
    in distribution and complete every path."""
    import dataclasses

    from ipu_ray_lib_tpu.parallel.mesh import render_streaming_sharded
    from ipu_ray_lib_tpu.render.streaming import render_streaming

    arrays, params, _ = cornell_built
    p = dataclasses.replace(params, window_w=32, window_h=32,
                            window_c=48, window_r=48, samples_per_pixel=16,
                            intersector="dense")
    mesh = make_ray_mesh()
    img_sh, done = render_streaming_sharded(arrays, p, mesh, chunk_slots=128)
    assert done == 32 * 32 * 16
    img_1, done1 = render_streaming(arrays, p, chunk_slots=1024)
    assert done1 == 32 * 32 * 16
    assert np.all(np.isfinite(img_sh))
    a, b = img_sh.mean(), img_1.mean()
    assert abs(a - b) / max(b, 1e-9) < 0.1
    # Distribution-level agreement, not just energy: a per-device RNG
    # bug that inflates variance would pass a mean check, so compare
    # pixel-value histograms and second moments too:
    assert abs(img_sh.std() - img_1.std()) / max(img_1.std(), 1e-9) < 0.15
    ha, _ = np.histogram(img_sh, bins=16, range=(0, 1.5))
    hb, _ = np.histogram(img_1, bins=16, range=(0, 1.5))
    assert np.abs(ha - hb).sum() / max(ha.sum(), 1) < 0.15
    # Per-pixel agreement at MC-noise scale (same scene, different seeds):
    rmse = float(np.sqrt(((img_sh - img_1) ** 2).mean()))
    assert rmse < 0.25, rmse


def test_streaming_sharded_spp_batching(cornell_built):
    """spp > spp_batch renders in decorrelated on-device-accumulated
    batches (the dispatch bound); the estimator is identical, so the
    batched image must agree with the one-shot image in distribution, and
    the progressive callback must fire once per batch with the running
    average."""
    import dataclasses

    from ipu_ray_lib_tpu.parallel.mesh import render_streaming_sharded

    arrays, params, _ = cornell_built
    p = dataclasses.replace(params, window_w=32, window_h=32,
                            window_c=48, window_r=48, samples_per_pixel=8,
                            intersector="dense")
    mesh = make_ray_mesh()
    seen = []
    img_b, done_b = render_streaming_sharded(
        arrays, p, mesh, chunk_slots=256, spp_batch=4,
        progress_callback=lambda bi, im: seen.append(im.mean()))
    assert done_b == 32 * 32 * 8
    assert len(seen) == 2
    img_1, done_1 = render_streaming_sharded(arrays, p, mesh,
                                             chunk_slots=256, spp_batch=64)
    assert done_1 == 32 * 32 * 8
    assert np.isfinite(img_b).all()
    assert abs(img_b.mean() - img_1.mean()) / max(img_1.mean(), 1e-9) < 0.15
    # The final progressive frame IS the full average:
    assert abs(seen[-1] - img_b.mean()) < 1e-5


def test_multihost_two_process(tmp_path):
    """Real multi-process mesh (docs/SCALING.md): two
    jax.distributed processes x 4 virtual CPU devices = one global
    8-device mesh running the production render_path_sharded. Each
    worker gathers the global result and writes its checksum; both
    processes must agree (same global program, same seeds) and produce
    a finite, non-zero render. This backs SCALING.md's multi-host claim
    with an executed test instead of an assertion."""
    import socket
    import subprocess
    import sys as _sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    outs = [str(tmp_path / f"out{i}.txt") for i in range(2)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [_sys.executable, worker, str(port), str(i), outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    logs = [p.communicate(timeout=420)[0].decode() for p in procs]
    for p, log_ in zip(procs, logs):
        assert p.returncode == 0, log_[-3000:]
    lines = [open(o).read().split() for o in outs]
    assert lines[0][0] == "OK" and lines[1][0] == "OK"
    # Both processes saw the identical global render:
    assert lines[0][1:] == lines[1][1:], lines
