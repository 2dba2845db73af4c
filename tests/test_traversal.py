"""Traversal correctness: threaded-BVH closest hit vs brute-force oracle.

The reference's AOV parity methodology
(LITERATE_TEST.ipynb: compare custom BVH render vs Embree)."""

import numpy as np
import jax.numpy as jnp

from ipu_ray_lib_tpu.cpu.reference import oracle_intersect, oracle_occluded
from ipu_ray_lib_tpu.ops.camera import generate_camera_rays, pixel_grid
from ipu_ray_lib_tpu.ops.traversal import bvh_intersect, bvh_occluded, hit_normal
from ipu_ray_lib_tpu.scene.build import build_scene
from ipu_ray_lib_tpu.scene.builtin import make_primitive_scene


def _camera_rays(params, n_sub=4):
    rows, cols = pixel_grid(
        params.window_w // n_sub, params.window_h // n_sub, 0, 0
    )
    rows = rows * n_sub
    cols = cols * n_sub
    o, d = generate_camera_rays(
        rows, cols, params.image_width, params.image_height,
        params.fov_radians, 0.0, None,
    )
    return np.asarray(o), np.asarray(d)


def _check_scene(scene_desc, built, tol_t=2e-3):
    arrays, params, _ = built
    origins, dirs = _camera_rays(params)
    R = len(origins)
    t_min = jnp.zeros(R, jnp.float32)
    t_max = jnp.full(R, jnp.inf, jnp.float32)

    hit = bvh_intersect(arrays, jnp.asarray(origins), jnp.asarray(dirs), t_min, t_max)
    t_ref, geom_ref, prim_ref, n_ref = oracle_intersect(scene_desc, origins, dirs)

    found = np.asarray(hit.found)
    found_ref = geom_ref >= 0
    # Hit/miss masks agree except possibly at silhouette pixels; none
    # expected on these axis-aligned test views:
    agree = found == found_ref
    assert agree.mean() > 0.995, f"hit masks differ on {np.sum(~agree)} rays"

    both = found & found_ref
    t_err = np.abs(np.asarray(hit.t)[both] - t_ref[both]) / np.maximum(t_ref[both], 1.0)
    assert np.max(t_err) < tol_t

    same_geom = np.asarray(hit.geom_id)[both] == geom_ref[both]
    assert same_geom.mean() > 0.999

    n = np.asarray(hit_normal(arrays, jnp.asarray(origins), jnp.asarray(dirs), hit))
    # Orientation-insensitive comparison (oracle normal may be flipped
    # for double-sided geometry):
    dots = np.abs(np.sum(n[both] * n_ref[both], axis=-1))
    assert np.quantile(dots, 0.01) > 0.99


def test_cornell_intersect_matches_oracle(cornell_scene, cornell_built):
    _check_scene(cornell_scene, cornell_built)


def test_spheres_intersect_matches_oracle():
    scene = make_primitive_scene()
    built = build_scene(scene, image_width=128, image_height=128)
    _check_scene(scene, built)


def test_occlusion_matches_oracle(cornell_scene, cornell_built):
    arrays, params, _ = cornell_built
    origins, dirs = _camera_rays(params)
    hit = bvh_intersect(
        arrays, jnp.asarray(origins), jnp.asarray(dirs),
        jnp.zeros(len(origins), jnp.float32),
        jnp.full(len(origins), jnp.inf, jnp.float32),
    )
    found = np.asarray(hit.found)
    hp = origins + dirs * np.asarray(hit.t)[:, None]

    light = np.array([18.0, 257.0, -1060.0], np.float32)
    lo = light[None] - hp
    dist = np.linalg.norm(lo, axis=-1)
    sdir = (lo / np.maximum(dist[:, None], 1e-9)).astype(np.float32)
    sorig = (hp + sdir * 0.01).astype(np.float32)

    occ = np.asarray(
        bvh_occluded(
            arrays, jnp.asarray(sorig), jnp.asarray(sdir),
            jnp.zeros(len(origins), jnp.float32), jnp.asarray(dist - 0.02),
        )
    )
    occ_ref = oracle_occluded(cornell_scene, sorig[found], sdir[found], (dist - 0.02)[found])
    agree = occ[found] == occ_ref
    assert agree.mean() > 0.995


def test_bvh_interpolated_normals_match_dense():
    """Vertex-normal interpolation must give the same shading normals
    through both intersectors (same hit_normal recomputation, different
    closest-hit search)."""
    from ipu_ray_lib_tpu.ops.traversal import scene_intersect_with_normal
    from ipu_ray_lib_tpu.scene.types import HostMesh, Material, SceneDescription

    # A 2-triangle quad at z=-5 with deliberately tilted vertex normals so
    # interpolation differs measurably from the geometric normal:
    verts = np.array([[-1, -1, -5], [1, -1, -5], [1, 1, -5], [-1, 1, -5]],
                     np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.uint32)
    normals = np.array([[0.6, 0, 0.8], [-0.6, 0, 0.8],
                        [0, 0.6, 0.8], [0, -0.6, 0.8]], np.float32)
    scene = SceneDescription()
    scene.meshes.append(HostMesh(triangles=tris, vertices=verts,
                                 normals=normals))
    scene.materials = [Material(np.array([0.7, 0.7, 0.7], np.float32))]
    scene.mat_ids = [0]
    scene.validate()
    arrays, params, _ = build_scene(scene, image_width=8, image_height=8,
                                    samples_per_pixel=1, intersector="dense")

    rng = np.random.default_rng(5)
    R = 256
    targets = np.stack([rng.uniform(-0.9, 0.9, R), rng.uniform(-0.9, 0.9, R),
                        np.full(R, -5.0)], axis=-1).astype(np.float32)
    o = np.zeros((R, 3), np.float32)
    d = targets / np.linalg.norm(targets, axis=-1, keepdims=True)
    o_j, d_j = jnp.asarray(o), jnp.asarray(d)
    tmin = jnp.zeros(R)
    tmax = jnp.full(R, jnp.inf)

    hb, nb = scene_intersect_with_normal(arrays, o_j, d_j, tmin, tmax, "bvh")
    hd, nd = scene_intersect_with_normal(arrays, o_j, d_j, tmin, tmax,
                                         "dense")
    m = np.asarray(hb.found) & np.asarray(hd.found)
    assert m.sum() > 200
    n_b = np.asarray(nb)[m]
    n_d = np.asarray(nd)[m]
    # Interpolated normals really vary across the quad:
    assert n_b.std(axis=0).max() > 0.05
    dots = np.sum(n_b * n_d, axis=-1)
    assert dots.min() > 0.9999, float(dots.min())
