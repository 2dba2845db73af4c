"""Scene compilation: SceneDescription -> device-ready SoA arrays.

The JAX replacement for the reference's ``buildSceneData`` +
serialiser + on-device ``BuildDataStructures`` re-wrapping
(ref: src/app_utils.cpp:291-364, codelets/TraceCodelets.cpp:63-124):
instead of a byte stream that must be deserialised on device, the scene is
a **pytree of JAX arrays** (:class:`SceneArrays`) that jit functions close
over directly. Mesh vertex indices are rebased to a single global vertex
array at build time, so no per-mesh offset lookups happen on device.

GeomID assignment order matches the reference (meshes, then spheres, then
discs — src/app_utils.cpp:321-339) so material tables carry over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from ..bvh.builder import CompactBvh, build_bvh
from .types import CropWindow, SceneDescription

if False:  # import-cycle guard: only an annotation here
    from ..ops.dense import DenseTables

GEOM_MESH = 0
GEOM_SPHERE = 1
GEOM_DISC = 2

# Scenes larger than this skip the dense intersector tables unless it is
# requested explicitly — see build_scene (tests monkeypatch this down to
# cover the skip path):
DENSE_TABLE_MAX_TRIS = 65536

INTERSECTORS = ("bvh", "dense")

# intersector="auto" picks 'dense' up to this many primitives and 'bvh'
# above it. Dense cost grows with the number of 512-triangle blocks, the
# BVH walk's barely: on an H100, Cornell + monkey at 1440^2 (4,035
# primitives, 8 blocks) renders ~10% faster dense, and with 8,035
# primitives bvh is 1.65x faster, so the crossover is past 8 blocks and
# before 9 (CHANGES.md, PR 1):
AUTO_DENSE_MAX_PRIMS = 4096


def resolve_intersector(intersector: str, total_prims: int) -> str:
    """The intersector build_scene uses: ``auto`` resolves by primitive
    count; 'bvh' and 'dense' pass through; anything else is an error."""
    if intersector == "auto":
        return "dense" if total_prims <= AUTO_DENSE_MAX_PRIMS else "bvh"
    if intersector not in INTERSECTORS:
        raise ValueError(
            f"unknown intersector {intersector!r}: expected 'auto', "
            "'bvh' or 'dense'")
    return intersector


class SceneArrays(NamedTuple):
    """Replicated-per-device scene data. All leaves are jnp arrays."""

    # BVH (threaded compact nodes):
    bvh_min: jnp.ndarray   # [N,3] f32
    bvh_ext: jnp.ndarray   # [N,3] f16 (conservatively rounded up)
    bvh_meta: jnp.ndarray  # [N] i32: leaf->primID, inner->second child
    bvh_geom: jnp.ndarray  # [N] i32: leaf->geomID, inner->0xFFFF
    bvh_miss: jnp.ndarray  # [N] i32: miss link (N => done)

    # Unified mesh arrays (global vertex indexing):
    tri_v: jnp.ndarray       # [T,3] i32 global vertex ids
    verts: jnp.ndarray       # [V,3] f32
    normals: jnp.ndarray     # [V,3] f32 (zeros when absent)
    mesh_first_tri: jnp.ndarray  # [M] i32: geom-local primID -> global tri
    mesh_has_normals: jnp.ndarray  # [M] i32

    # Analytic primitives:
    spheres: jnp.ndarray  # [S,4] f32: cx,cy,cz,r
    discs: jnp.ndarray    # [D,7] f32: nx,ny,nz,cx,cy,cz,r

    # Geometry registry + materials:
    geom_type: jnp.ndarray   # [G] i32
    geom_index: jnp.ndarray  # [G] i32 (index into per-type table)
    mat_id: jnp.ndarray      # [G] i32
    mat_albedo: jnp.ndarray    # [Mm,3] f32
    mat_emission: jnp.ndarray  # [Mm,3] f32
    mat_ior: jnp.ndarray       # [Mm] f32
    mat_type: jnp.ndarray      # [Mm] i32
    mat_emissive: jnp.ndarray  # [Mm] i32

    # Dense-intersector tables (ops/dense.py) + per-prim geom id maps:
    dense: "DenseTables"
    sphere_geom: jnp.ndarray  # [S] i32 geomID of each sphere
    disc_geom: jnp.ndarray    # [D] i32 geomID of each disc


@dataclass(frozen=True)
class SceneParams:
    """Static (hashable) scene/render metadata — the analogue of the
    non-array fields of the reference's SceneRef (include/Scene.hpp:49-80)."""

    num_bvh_nodes: int
    bvh_max_depth: int
    num_geoms: int
    num_meshes: int
    image_width: int
    image_height: int
    fov_radians: float
    anti_alias_scale: float
    max_path_length: int
    roulette_start_depth: int
    samples_per_pixel: int
    rng_seed: int
    window_w: int
    window_h: int
    window_c: int
    window_r: int
    path_trace: bool
    # 'bvh' (threaded traversal, any scene size) or 'dense' (brute force
    # over triangle blocks, for small scenes like the reference's):
    intersector: str = "bvh"


def _pad_rows(a: np.ndarray, min_rows: int = 1) -> np.ndarray:
    """Ensure at least min_rows rows (zero-size arrays are awkward on device)."""
    if len(a) >= min_rows:
        return a
    pad = np.zeros((min_rows - len(a),) + a.shape[1:], a.dtype)
    return np.concatenate([a, pad]) if len(a) else pad


def build_scene(
    scene: SceneDescription,
    *,
    image_width: int = 768,
    image_height: int = 432,
    window: CropWindow | None = None,
    anti_alias_scale: float = 0.25,
    max_path_length: int = 10,
    roulette_start_depth: int = 3,
    samples_per_pixel: int = 256,
    rng_seed: int = 1442,
    max_leaf_size: int = 1,
    intersector: str = "auto",
) -> tuple[SceneArrays, SceneParams, CompactBvh]:
    """Compile a SceneDescription into device arrays + static params."""
    scene.validate()

    # ---- Unified mesh arrays with vertex-index rebasing -----------------
    tri_list, vert_list, norm_list = [], [], []
    mesh_first_tri, mesh_has_normals = [], []
    vert_base = 0
    tri_base = 0
    for m in scene.meshes:
        mesh_first_tri.append(tri_base)
        mesh_has_normals.append(1 if m.has_normals else 0)
        # Rebase straight into i32 (device index dtype) — the i64
        # round-trip double-copied 48 MB/Mtri on big imports. Vertex
        # counts are bounded far below 2^31 by device memory:
        t32 = m.triangles.astype(np.int32, copy=False)
        tri_list.append(t32 + np.int32(vert_base) if vert_base else t32)
        vert_list.append(m.vertices)
        if m.has_normals:
            norm_list.append(m.normals)
        else:
            norm_list.append(np.zeros_like(m.vertices))
        vert_base += len(m.vertices)
        tri_base += len(m.triangles)

    tri_v = (
        np.concatenate(tri_list) if len(tri_list) > 1
        else (np.ascontiguousarray(tri_list[0]) if tri_list
              else np.zeros((0, 3), np.int32))
    )
    def _cat(lst, dt):
        if not lst:
            return np.zeros((0, 3), dt)
        return lst[0] if len(lst) == 1 else np.concatenate(lst)

    verts = _cat(vert_list, np.float32)
    normals = _cat(norm_list, np.float32)

    # ---- Geometry registry (ordering defines geomIDs) -------------------
    geom_type, geom_index = [], []
    for i in range(len(scene.meshes)):
        geom_type.append(GEOM_MESH)
        geom_index.append(i)
    for i in range(len(scene.spheres)):
        geom_type.append(GEOM_SPHERE)
        geom_index.append(i)
    for i in range(len(scene.discs)):
        geom_type.append(GEOM_DISC)
        geom_index.append(i)
    geom_type = np.asarray(geom_type, np.int32)
    geom_index = np.asarray(geom_index, np.int32)
    num_geoms = len(geom_type)

    # ---- Build primitives for the BVH (per-triangle granularity) --------
    # (ref: src/app_utils.cpp:145-188 — meshes split into individual
    # triangles; spheres/discs are single primitives with primID 0.)
    lo_list, hi_list, gid_list, pid_list = [], [], [], []
    for gid, m in enumerate(scene.meshes):
        lo, hi = m.triangle_bounds()
        lo_list.append(lo)
        hi_list.append(hi)
        gid_list.append(np.full(len(lo), gid, np.int64))
        pid_list.append(np.arange(len(lo), dtype=np.int64))
    sphere_gid0 = len(scene.meshes)
    for i, s in enumerate(scene.spheres):
        c, r = s[:3], s[3]
        lo_list.append((c - r)[None])
        hi_list.append((c + r)[None])
        gid_list.append(np.array([sphere_gid0 + i], np.int64))
        pid_list.append(np.zeros(1, np.int64))
    disc_gid0 = sphere_gid0 + len(scene.spheres)
    for i, d in enumerate(scene.discs):
        c, r = d[3:6], d[6]
        # Bounding-sphere bound for discs (ref: include/Primitives.hpp:79-84).
        lo_list.append((c - r)[None])
        hi_list.append((c + r)[None])
        gid_list.append(np.array([disc_gid0 + i], np.int64))
        pid_list.append(np.zeros(1, np.int64))

    bvh = build_bvh(
        np.concatenate(lo_list),
        np.concatenate(hi_list),
        np.concatenate(gid_list),
        np.concatenate(pid_list),
        max_leaf_size=max_leaf_size,
    )

    # ---- Materials ------------------------------------------------------
    mats = scene.materials
    mat_albedo = np.stack([m.albedo for m in mats]).astype(np.float32)
    mat_emission = np.stack([m.emission for m in mats]).astype(np.float32)
    mat_ior = np.array([m.ior for m in mats], np.float32)
    mat_type = np.array([int(m.type) for m in mats], np.int32)
    mat_emissive = np.array([1 if m.emissive else 0 for m in mats], np.int32)
    mat_id = np.asarray(scene.mat_ids[:num_geoms], np.int32)

    # Dense tables: global triangle -> (geomID, local primID):
    tri_geom_ids = (
        np.concatenate([np.full(len(m.triangles), g, np.int32) for g, m in enumerate(scene.meshes)])
        if scene.meshes else np.zeros(0, np.int32)
    )
    tri_prim_ids = (
        np.concatenate([np.arange(len(m.triangles), dtype=np.int32) for m in scene.meshes])
        if scene.meshes else np.zeros(0, np.int32)
    )
    from ..ops.dense import build_dense_tables

    total_prims = len(tri_geom_ids) + len(scene.spheres) + len(scene.discs)
    intersector = resolve_intersector(intersector, total_prims)

    # Dense tables are only auto-selected for small scenes; building them
    # for a 2M-tri import wastes ~30% of host build time. Skip them at
    # scale unless the caller explicitly asked for the dense intersector;
    # dense_intersect raises a clear error on a skipped table:
    build_dense = (
        len(tri_v) <= DENSE_TABLE_MAX_TRIS or intersector == "dense")
    dense = build_dense_tables(
        tri_v if len(tri_v) else np.zeros((0, 3), np.int32),
        verts if len(verts) else np.zeros((0, 3), np.float32),
        tri_geom_ids, tri_prim_ids,
    ) if build_dense else None
    sphere_geom = sphere_gid0 + np.arange(max(len(scene.spheres), 1), dtype=np.int32)
    disc_geom = disc_gid0 + np.arange(max(len(scene.discs), 1), dtype=np.int32)

    arrays = SceneArrays(
        bvh_min=jnp.asarray(bvh.mins),
        bvh_ext=jnp.asarray(bvh.exts),
        bvh_meta=jnp.asarray(bvh.meta),
        bvh_geom=jnp.asarray(bvh.geom),
        bvh_miss=jnp.asarray(bvh.miss),
        tri_v=jnp.asarray(_pad_rows(tri_v)),
        verts=jnp.asarray(_pad_rows(verts)),
        normals=jnp.asarray(_pad_rows(normals)),
        mesh_first_tri=jnp.asarray(_pad_rows(np.asarray(mesh_first_tri, np.int32))),
        mesh_has_normals=jnp.asarray(_pad_rows(np.asarray(mesh_has_normals, np.int32))),
        spheres=jnp.asarray(_pad_rows(scene.spheres)),
        discs=jnp.asarray(_pad_rows(scene.discs)),
        geom_type=jnp.asarray(_pad_rows(geom_type)),
        geom_index=jnp.asarray(_pad_rows(geom_index)),
        mat_id=jnp.asarray(_pad_rows(mat_id)),
        mat_albedo=jnp.asarray(_pad_rows(mat_albedo)),
        mat_emission=jnp.asarray(_pad_rows(mat_emission)),
        mat_ior=jnp.asarray(_pad_rows(mat_ior)),
        mat_type=jnp.asarray(_pad_rows(mat_type)),
        mat_emissive=jnp.asarray(_pad_rows(mat_emissive)),
        dense=dense,
        sphere_geom=jnp.asarray(sphere_geom),
        disc_geom=jnp.asarray(disc_geom),
    )

    win = window or CropWindow(image_width, image_height, 0, 0)
    params = SceneParams(
        num_bvh_nodes=bvh.num_nodes,
        bvh_max_depth=bvh.max_depth,
        num_geoms=num_geoms,
        num_meshes=len(scene.meshes),
        image_width=image_width,
        image_height=image_height,
        fov_radians=float(scene.camera.horizontal_fov),
        anti_alias_scale=float(anti_alias_scale),
        max_path_length=int(max_path_length),
        roulette_start_depth=int(roulette_start_depth),
        samples_per_pixel=int(samples_per_pixel),
        rng_seed=int(rng_seed),
        window_w=win.w,
        window_h=win.h,
        window_c=win.c,
        window_r=win.r,
        path_trace=scene.path_trace is not None,
        intersector=intersector,
    )
    return arrays, params, bvh
