"""Dense intersector correctness: must agree with the BVH path and
the brute-force oracle on closest hits, occlusion, and full AOV renders."""

import dataclasses

import numpy as np
import jax.numpy as jnp

from ipu_ray_lib_tpu.cpu.reference import oracle_intersect
from ipu_ray_lib_tpu.ops.camera import generate_camera_rays, pixel_grid
from ipu_ray_lib_tpu.ops.traversal import bvh_intersect, dense_intersect
from ipu_ray_lib_tpu.render.renderer import render
from ipu_ray_lib_tpu.scene.build import build_scene
from ipu_ray_lib_tpu.scene.builtin import make_primitive_scene


def _camera_rays(params, size):
    rows, cols = pixel_grid(size, size, 0, 0)
    o, d = generate_camera_rays(
        rows, cols, params.image_width, params.image_height,
        params.fov_radians, 0.0, None,
    )
    return o, d


def test_dense_matches_bvh_closest_hit(cornell_built):
    arrays, params, _ = cornell_built
    o, d = _camera_rays(params, 48)
    R = o.shape[0]
    t_min = jnp.zeros(R)
    t_max = jnp.full(R, jnp.inf)

    hb = bvh_intersect(arrays, o, d, t_min, t_max)
    hd = dense_intersect(arrays, o, d, t_min, t_max)

    fb = np.asarray(hb.found)
    fd = np.asarray(hd.found)
    assert (fb == fd).mean() > 0.998

    both = fb & fd
    terr = np.abs(np.asarray(hb.t) - np.asarray(hd.t))[both]
    rel = terr / np.maximum(np.asarray(hb.t)[both], 1.0)
    assert np.quantile(rel, 0.999) < 1e-4
    # geom agreement (modulo coincident-surface ties):
    agree = (np.asarray(hb.geom_id) == np.asarray(hd.geom_id))[both]
    assert agree.mean() > 0.995


def test_dense_matches_oracle_spheres():
    scene = make_primitive_scene()
    arrays, params, _ = build_scene(scene, image_width=64, image_height=64)
    assert params.intersector == "dense"
    o, d = _camera_rays(params, 64)
    hd = dense_intersect(
        arrays, o, d, jnp.zeros(o.shape[0]), jnp.full(o.shape[0], jnp.inf)
    )
    t_ref, geom_ref, _, _ = oracle_intersect(scene, np.asarray(o), np.asarray(d))
    fd = np.asarray(hd.found)
    fr = geom_ref >= 0
    assert (fd == fr).mean() > 0.995
    both = fd & fr
    rel = np.abs(np.asarray(hd.t)[both] - t_ref[both]) / np.maximum(t_ref[both], 1.0)
    assert np.quantile(rel, 0.99) < 1e-4


def test_dense_render_matches_bvh_render(cornell_built):
    arrays, params, _ = cornell_built
    size = 32
    pb = dataclasses.replace(params, window_w=size, window_h=size,
                             intersector="bvh")
    pd = dataclasses.replace(pb, intersector="dense")
    ob = render(arrays, pb, mode="shadow-trace", chunk_size=size * size)
    od = render(arrays, pd, mode="shadow-trace", chunk_size=size * size)
    # Hit masks and shading agree except at rare silhouette/shadow edges:
    assert (ob.geom_id == od.geom_id).mean() > 0.99
    d = (ob.rgb - od.rgb) ** 2
    assert d.mean() < 1e-3


def test_dense_path_trace_smoke(cornell_built):
    arrays, params, _ = cornell_built
    p = dataclasses.replace(
        params, window_w=16, window_h=16, window_c=56, window_r=56,
        samples_per_pixel=4, intersector="dense",
    )
    out = render(arrays, p, mode="path-trace", chunk_size=256)
    assert np.all(np.isfinite(out.rgb))
    assert out.rgb.max() > 0


def test_dense_tables_skipped_at_scale(monkeypatch):
    """Past DENSE_TABLE_MAX_TRIS the (useless-at-scale) dense tables
    are skipped to keep multi-million-triangle imports fast; using the
    dense intersector on such arrays raises a clear error, and an
    explicit intersector='dense' still builds them."""
    import dataclasses

    import jax.numpy as jnp
    import pytest

    from ipu_ray_lib_tpu.ops.traversal import dense_intersect
    from ipu_ray_lib_tpu.scene import build as B
    from ipu_ray_lib_tpu.scene.builtin import make_stress_scene

    scene = make_stress_scene(16)   # 1058 tris
    monkeypatch.setattr(B, "DENSE_TABLE_MAX_TRIS", 100)
    arrays, params, _ = B.build_scene(
        scene, image_width=16, image_height=16, samples_per_pixel=1,
        intersector="bvh")
    assert arrays.dense is None
    o = jnp.zeros((4, 3), jnp.float32)
    d = jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32), (4, 1))
    with pytest.raises(RuntimeError, match="skipped at build time"):
        dense_intersect(arrays, o, d, jnp.zeros(4), jnp.full(4, 1e9))
    arrays2, params2, _ = B.build_scene(
        scene, image_width=16, image_height=16, samples_per_pixel=1,
        intersector="dense")
    assert arrays2.dense is not None
