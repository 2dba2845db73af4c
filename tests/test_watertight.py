"""Watertight acceptance: adversarial shared-edge / vertex crack tests.

The reference's hot-path contract is the PBRT watertight triangle test
(ref: src/Mesh.cpp:8-104, README.md:109-120): a ray through a shared
mesh edge or vertex must hit at least one incident triangle — never fall
through the crack. The dense test keeps the plane+barycentric
formulation but widens acceptance by a rigorous rounding bound
(utils/constants.py WATERTIGHT_EPS_SCALE), which makes cracks impossible
by construction. These tests aim thousands of rays exactly at shared
edges, edge midpoints and vertices of tessellated surfaces and assert
zero leaks on every intersector (dense and bvh), both for direct
closest-hit queries and through the streaming integrator."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp


def _skewed_grid_scene(n=12, seed=3):
    """A solid tessellated quad (2*(n-1)^2 tris, shared edges everywhere),
    skewed and tilted so no edge is axis-aligned, emissive so a path
    trace reveals leaks as zero-radiance pixels."""
    from ipu_ray_lib_tpu.scene.types import (Camera, HostMesh, Material,
                                             MaterialType, SceneDescription)

    rng = np.random.default_rng(seed)
    u = np.linspace(-2.0, 2.0, n)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    # Irregular interior vertices (worst case for sliver triangles):
    uu[1:-1, 1:-1] += rng.uniform(-0.12, 0.12, (n - 2, n - 2))
    vv[1:-1, 1:-1] += rng.uniform(-0.12, 0.12, (n - 2, n - 2))
    # Tilted plane in camera space:
    verts = np.stack(
        [uu, vv, -4.0 + 0.23 * uu - 0.11 * vv], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate(
        [np.stack([a, b, c], -1), np.stack([b, d, c], -1)]
    ).astype(np.uint32)

    scene = SceneDescription()
    scene.meshes = [HostMesh(triangles=tris, vertices=verts)]
    white = np.array([0.75, 0.75, 0.75], np.float32)
    emit = np.array([5.0, 5.0, 5.0], np.float32)
    scene.materials = [Material(white, emit, MaterialType.DIFFUSE)]
    scene.mat_ids = [0]
    scene.camera = Camera(horizontal_fov=float(np.pi / 3))
    scene.validate()
    return scene, verts, tris


def _edge_targets(verts, tris, per_edge=3, seed=0):
    """Points exactly on shared edges (f32 lerp endpoints are bitwise
    shared between the two incident triangles), plus every vertex."""
    rng = np.random.default_rng(seed)
    edges = set()
    for t in tris:
        for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            edges.add((min(e), max(e)))
    pts = [verts]
    for (i, j) in sorted(edges):
        w = rng.uniform(0.05, 0.95, per_edge).astype(np.float32)[:, None]
        pts.append(verts[i] * (1 - w) + verts[j] * w)
        pts.append(((verts[i] + verts[j]) * np.float32(0.5))[None, :])
    return np.concatenate(pts).astype(np.float32)


@pytest.fixture(scope="module")
def crack_setup():
    from ipu_ray_lib_tpu.scene.build import build_scene

    scene, verts, tris = _skewed_grid_scene()
    arrays, params, _ = build_scene(
        scene, image_width=64, image_height=64, samples_per_pixel=1,
        intersector="dense")
    targets = _edge_targets(verts, tris)
    o = np.zeros_like(targets)
    d = targets / np.linalg.norm(targets, axis=-1, keepdims=True)
    return arrays, params, jnp.asarray(o), jnp.asarray(d.astype(np.float32))


@pytest.mark.parametrize("intersector", ["dense", "bvh"])
def test_no_cracks_on_shared_edges(crack_setup, intersector):
    """Every ray aimed exactly at a shared edge/vertex must hit: a miss
    is a crack. Covers ops/dense.py and ops/traversal.py (PBRT
    watertight)."""
    from ipu_ray_lib_tpu.ops.traversal import scene_intersect_with_normal

    arrays, params, o, d = crack_setup
    R = o.shape[0]
    hit, _ = scene_intersect_with_normal(
        arrays, o, d, jnp.zeros(R, jnp.float32),
        jnp.full(R, jnp.inf, jnp.float32), intersector)
    found = np.asarray(hit.found)
    assert found.all(), (
        f"{intersector}: {int((~found).sum())}/{R} edge rays leaked")
    # And the hits are on the surface, not garbage accepts:
    t = np.asarray(hit.t)[found]
    assert np.isfinite(t).all() and (t > 1.0).all() and (t < 10.0).all()


def _pixel_vertex_scene(size=32):
    """A tessellation whose VERTICES sit exactly on every pixel-centre
    camera ray (AA off): each primary ray of a render then passes through
    a mesh vertex — the adversarial worst case for the integrator, which
    generates its own camera rays."""
    from ipu_ray_lib_tpu.scene.types import (Camera, HostMesh, Material,
                                             MaterialType, SceneDescription)

    fov = np.pi / 3
    tan_t = np.tan(fov / 2)
    r, c = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    # Mirror ops/camera.py pixel_to_ray_dir's pre-normalisation point at
    # depth z = -zs (the direction is scale-invariant; pixel coords are
    # integer row/col, pixel_grid convention):
    xn = c / size - 0.5
    yn = r / size - 0.5
    zs = 3.7
    verts = np.stack([
        (2 * tan_t * xn) * zs, (-2 * tan_t * yn) * zs,
        np.full_like(xn, -zs),
    ], axis=-1).reshape(-1, 3).astype(np.float32)
    idx = np.arange(size * size).reshape(size, size)
    a = idx[:-1, :-1].ravel()
    b = idx[1:, :-1].ravel()
    c_ = idx[:-1, 1:].ravel()
    d = idx[1:, 1:].ravel()
    tris = np.concatenate(
        [np.stack([a, b, c_], -1), np.stack([b, d, c_], -1)]
    ).astype(np.uint32)
    scene = SceneDescription()
    scene.meshes = [HostMesh(triangles=tris, vertices=verts)]
    white = np.array([0.7, 0.7, 0.7], np.float32)
    emit = np.array([3.0, 3.0, 3.0], np.float32)
    scene.materials = [Material(white, emit, MaterialType.DIFFUSE)]
    scene.mat_ids = [0]
    scene.camera = Camera(horizontal_fov=float(fov))
    scene.validate()
    return scene


@pytest.mark.parametrize("intersector", ["dense", "bvh"])
def test_integrator_no_cracks_at_vertices(intersector):
    """Render the pixel-aligned vertex grid through the streaming
    integrator: every interior pixel ray passes through a shared mesh
    vertex. Any black pixel inside the grid = a crack."""
    from ipu_ray_lib_tpu.render import streaming as S
    from ipu_ray_lib_tpu.scene.build import build_scene

    size = 32
    scene = _pixel_vertex_scene(size)
    arrays, params, _ = build_scene(
        scene, image_width=size, image_height=size, samples_per_pixel=1,
        max_path_length=2, intersector=intersector)
    params = dataclasses.replace(params, anti_alias_scale=0.0)

    img, done = S.render_streaming(arrays, params, spp=1)
    assert done == size * size
    # Interior pixels (border rays graze the mesh boundary edge-on):
    inner = img[1:-1, 1:-1]
    dark = (inner.sum(axis=-1) <= 0).sum()
    assert dark == 0, f"{dark} cracked pixels at mesh vertices ({intersector})"
