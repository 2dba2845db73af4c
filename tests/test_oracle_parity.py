"""Oracle parity of both intersectors on every in-repo scene.

For each scene (the built-ins, the stress heightfield and the two
Collada files in ``assets/``) and each intersector (``dense`` and
``bvh``), the closest-hit AOVs of primary camera rays and the occlusion
of shadow rays must match the independent f64 oracle
(``cpu/reference.py``) on a window of at most 48x48 rays — the
reference's Embree-check methodology (ref trace.cpp:528-540).
"""

import functools
import os

import numpy as np
import pytest

import jax.numpy as jnp

ROOT = os.path.join(os.path.dirname(__file__), "..")
SIZE = 40


def _scene(name):
    from ipu_ray_lib_tpu.scene.builtin import (make_cornell_box_scene,
                                               make_primitive_scene,
                                               make_stress_scene)
    from ipu_ray_lib_tpu.scene.io import import_scene

    if name == "box-simple":
        return make_cornell_box_scene(None, box_only=True)
    if name == "box":
        return make_cornell_box_scene(None, box_only=False)
    if name == "box-monkey":
        return make_cornell_box_scene(
            os.path.join(ROOT, "assets", "monkey_bust.glb"), box_only=False)
    if name == "spheres":
        return make_primitive_scene()
    if name == "stress24":
        return make_stress_scene(24)
    return import_scene(os.path.join(ROOT, "assets", name))


SCENES = ["box-simple", "box", "box-monkey", "spheres", "stress24",
          "test_scene.dae", "hdri_test.dae"]


@functools.lru_cache(maxsize=None)
def _primary(name):
    """Scene description, camera rays and the oracle's closest hits."""
    from ipu_ray_lib_tpu.cpu.reference import oracle_intersect
    from ipu_ray_lib_tpu.ops.camera import generate_camera_rays, pixel_grid

    scene = _scene(name)
    rows, cols = pixel_grid(SIZE, SIZE, 0, 0)
    o, d = generate_camera_rays(rows, cols, SIZE, SIZE,
                                float(scene.camera.horizontal_fov), 0.0, None)
    o, d = np.asarray(o), np.asarray(d)
    return scene, o, d, oracle_intersect(scene, o, d)


def _built(name, intersector):
    from ipu_ray_lib_tpu.scene.build import build_scene

    scene = _primary(name)[0]
    arrays, params, _ = build_scene(scene, image_width=SIZE,
                                    image_height=SIZE, samples_per_pixel=1,
                                    intersector=intersector)
    assert params.intersector == intersector
    return arrays


@pytest.mark.parametrize("intersector", ["dense", "bvh"])
@pytest.mark.parametrize("name", SCENES)
def test_closest_hit_matches_oracle(name, intersector):
    from ipu_ray_lib_tpu.ops.traversal import scene_intersect_with_normal

    _, o, d, (t_ref, g_ref, p_ref, n_ref) = _primary(name)
    arrays = _built(name, intersector)
    R = len(o)
    hit, n = scene_intersect_with_normal(
        arrays, jnp.asarray(o), jnp.asarray(d), jnp.zeros(R, jnp.float32),
        jnp.full(R, jnp.inf, jnp.float32), intersector)
    found = np.asarray(hit.found)
    found_ref = g_ref >= 0
    assert found_ref.any(), "window must see geometry"
    # Hit masks agree except at a few silhouette-grazing rays:
    assert (found == found_ref).mean() > 0.995
    both = found & found_ref
    t = np.asarray(hit.t)[both]
    rel = np.abs(t - t_ref[both]) / np.maximum(t_ref[both], 1.0)
    assert np.quantile(rel, 0.99) < 1e-4, np.quantile(rel, 0.99)
    geom = np.asarray(hit.geom_id)[both]
    assert (geom == g_ref[both]).mean() > 0.99
    same = geom == g_ref[both]
    assert (np.asarray(hit.prim_id)[both][same] == p_ref[both][same]).mean() > 0.99
    dots = np.abs(np.sum(np.asarray(n)[both] * n_ref[both], axis=-1))
    assert np.quantile(dots, 0.01) > 0.999


@pytest.mark.parametrize("intersector", ["dense", "bvh"])
@pytest.mark.parametrize("name", SCENES)
def test_occlusion_matches_oracle(name, intersector):
    """Shadow rays from the oracle's primary hit points towards a point
    light above and in front of the camera."""
    from ipu_ray_lib_tpu.cpu.reference import oracle_occluded
    from ipu_ray_lib_tpu.ops.traversal import scene_occluded

    scene, o, d, (t_ref, g_ref, _, n_ref) = _primary(name)
    found = g_ref >= 0
    hp = o[found] + d[found] * t_ref[found][:, None]
    # A light offset from the camera so that shadow rays cross the scene:
    scale = float(np.max(np.abs(hp))) or 1.0
    light = np.array([0.3 * scale, 0.8 * scale, 0.1 * scale])
    lo = light[None] - hp
    dist = np.linalg.norm(lo, axis=-1)
    sdir = lo / dist[:, None]
    # Leave the surface on the light's side along the normal:
    n = n_ref[found] * np.sign(np.sum(n_ref[found] * sdir, axis=-1))[:, None]
    sorig = hp + n * (1e-3 * scale)
    t_max = dist - 2e-3 * scale
    ref = oracle_occluded(scene, sorig, sdir, t_max)

    arrays = _built(name, intersector)
    R = len(sorig)
    occ = np.asarray(scene_occluded(
        arrays, jnp.asarray(sorig, jnp.float32),
        jnp.asarray(sdir, jnp.float32), jnp.zeros(R, jnp.float32),
        jnp.asarray(t_max, jnp.float32), intersector))
    assert (occ == ref).mean() > 0.995, (occ != ref).sum()
