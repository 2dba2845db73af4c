"""BVH-accelerated f64 oracle: exactness + large-scene AOV parity.

The brute-force oracle is O(R*P) and unusable past ~10k prims, so
without it big-scene correctness would rest on intersector-vs-intersector
agreement only. The BVH oracle must (a) agree EXACTLY
with the brute-force oracle (same f64 prim tests, the BVH only skips
provable misses), and (b) make independent AOV verification practical at
100k+ triangles against the production intersectors."""

import numpy as np
import pytest

import jax.numpy as jnp

from ipu_ray_lib_tpu.cpu.reference import (oracle_intersect,
                                           oracle_intersect_bvh,
                                           oracle_shadow_trace)


def _camera_rays(params, size):
    from ipu_ray_lib_tpu.ops.camera import pixel_grid, pixel_to_ray_dir

    rows, cols = pixel_grid(size, size, 0, 0)
    tan_t = np.tan(params.fov_radians / 2)
    d = np.asarray(pixel_to_ray_dir(cols, rows, float(size), float(size),
                                    np.float32(tan_t)))
    return np.zeros_like(d), d


def test_bvh_oracle_matches_brute_force_exactly(cornell_scene):
    """Same f64 prim tests + conservative BVH culling => identical hits
    (bitwise t, same ids) on the Cornell scene."""
    from ipu_ray_lib_tpu.scene.build import build_scene

    scene = cornell_scene
    _, params, _ = build_scene(scene, image_width=40, image_height=40,
                               samples_per_pixel=1)
    o, d = _camera_rays(params, 40)
    t_a, g_a, p_a, n_a = oracle_intersect(scene, o, d)
    t_b, g_b, p_b, n_b = oracle_intersect_bvh(scene, o, d)
    np.testing.assert_array_equal(g_a, g_b)
    np.testing.assert_array_equal(p_a, p_b)
    np.testing.assert_array_equal(t_a, t_b)
    np.testing.assert_allclose(n_a, n_b, atol=1e-12)


@pytest.mark.slow
@pytest.mark.parametrize("method", ["dense", "bvh"])
def test_large_scene_aov_parity_vs_oracle(method):
    """106k-tri heightfield: the production intersectors' primary-hit
    AOVs must match the independent BVH oracle — the reference's
    Embree-check methodology at a scale the brute-force oracle cannot
    reach (ref trace.cpp:528-540), so the large-scene path is checked
    against an independent algorithm, not just intersector-vs-intersector
    agreement."""
    from ipu_ray_lib_tpu.ops.traversal import scene_intersect_with_normal
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import make_stress_scene

    scene = make_stress_scene(232)              # 2*231^2 = 106,722 tris
    arrays, params, _ = build_scene(
        scene, image_width=48, image_height=48, samples_per_pixel=1,
        intersector=method)
    o, d = _camera_rays(params, 48)
    R = len(o)

    t_o, g_o, p_o, n_o = oracle_intersect_bvh(scene, o, d)
    hit, n_k = scene_intersect_with_normal(
        arrays, jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
        jnp.zeros(R, jnp.float32), jnp.full(R, jnp.inf, jnp.float32),
        method)
    found_k = np.asarray(hit.found)
    found_o = g_o >= 0
    # Identical hit/miss classification (the heightfield fills the view,
    # modulo a handful of silhouette-grazing rays):
    assert (found_k != found_o).mean() < 0.01
    both = found_k & found_o
    t_k = np.asarray(hit.t)[both]
    rel = np.abs(t_k - t_o[both]) / np.maximum(t_o[both], 1e-9)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    # Geometric normals agree (up to f32; both unit length):
    dot = np.abs(np.sum(np.asarray(n_k)[both] * n_o[both], axis=-1))
    assert np.quantile(dot, 0.01) > 0.999


@pytest.mark.slow
def test_large_scene_shadow_aovs_finite():
    """The full shadow-trace oracle runs at 100k+ tris in seconds/minutes
    (it auto-selects the BVH path) and produces sane AOVs."""
    from ipu_ray_lib_tpu.scene.build import build_scene
    from ipu_ray_lib_tpu.scene.builtin import make_stress_scene

    scene = make_stress_scene(232)
    _, params, _ = build_scene(scene, image_width=32, image_height=32,
                               samples_per_pixel=1)
    o, d = _camera_rays(params, 32)
    aov = oracle_shadow_trace(scene, o, d)
    assert np.isfinite(aov["rgb"]).all()
    # Terrain fills the lower half of the frame; the rest is sky:
    assert (aov["geom"] >= 0).mean() > 0.3
    assert aov["rgb"][aov["geom"] >= 0].max() > 0
