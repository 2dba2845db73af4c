"""Stackless threaded-BVH traversal, batched over rays.

Batched redesign of the reference's per-ray stack traversal
(ref: include/CompactBvh.hpp:33-139). An IPU runs an independent scalar
program per ray, so a traversal stack per ray is natural there. Here we
instead thread the flattened node array with *miss links* at build time
(:mod:`ipu_ray_lib_tpu.bvh.builder`), which reduces traversal to a single
uniform loop over all rays in a batch:

    next = box_hit & inner ? current + 1 : miss_link[current]

Every ray advances in lockstep under one ``lax.while_loop``; finished rays
park on a sentinel. Per step the node fetch is a batched gather — a
memory-bound operation XLA handles well for large ray batches.
The closest-hit metric and hit-acceptance conditions (strict
``t > t_min``, ``t < closest``) match the reference exactly, so AOVs are
comparable bit-for-bit modulo visit order.

Leaf primitive dispatch evaluates the triangle/sphere/disc tests with
masked lanes and selects by geometry type — the vector-machine analogue of
the reference's ``primLookup`` virtual dispatch
(codelets/TraceCodelets.cpp:127-140).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..bvh.builder import INVALID_GEOM_ID
from ..scene.build import GEOM_MESH, GEOM_SPHERE, SceneArrays
from .intersect import (
    RayShear,
    intersect_box_slab,
    intersect_disc,
    intersect_sphere,
    intersect_triangle_watertight,
    make_ray_shear,
)

INVALID_PRIM_ID = jnp.int32(-1)


class Hit(NamedTuple):
    t: jnp.ndarray        # [R] f32 — hit distance (== t_max_in if no hit)
    geom_id: jnp.ndarray  # [R] i32 — INVALID_GEOM_ID if no hit
    prim_id: jnp.ndarray  # [R] i32 — -1 if no hit

    @property
    def found(self) -> jnp.ndarray:
        return self.geom_id != INVALID_GEOM_ID


def _leaf_prim_t(
    scene: SceneArrays,
    shear: RayShear,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_min: jnp.ndarray,
    gid: jnp.ndarray,
    pid: jnp.ndarray,
):
    """Intersection t against the leaf primitive (gid, pid) for each lane.

    Computes all three primitive types with safe (clipped) gathers and
    selects by type; miss => t == 0.
    """
    g_safe = jnp.clip(gid, 0, scene.geom_type.shape[0] - 1)
    gtype = scene.geom_type[g_safe]
    gindex = scene.geom_index[g_safe]

    # Triangles (global vertex ids; mesh offsets folded in at build):
    mi = jnp.clip(gindex, 0, scene.mesh_first_tri.shape[0] - 1)
    tri = jnp.clip(
        scene.mesh_first_tri[mi] + pid, 0, scene.tri_v.shape[0] - 1
    )
    v = scene.tri_v[tri]
    p0 = scene.verts[v[..., 0]]
    p1 = scene.verts[v[..., 1]]
    p2 = scene.verts[v[..., 2]]
    tri_hit = intersect_triangle_watertight(
        shear, p0, p1, p2, jnp.float32(jnp.inf)
    )

    si = jnp.clip(gindex, 0, scene.spheres.shape[0] - 1)
    sp = scene.spheres[si]
    t_sphere = intersect_sphere(origin, direction, t_min, sp[..., :3], sp[..., 3] * sp[..., 3])

    di = jnp.clip(gindex, 0, scene.discs.shape[0] - 1)
    dc = scene.discs[di]
    t_disc = intersect_disc(origin, direction, dc[..., 0:3], dc[..., 3:6], dc[..., 6] * dc[..., 6])

    return jnp.where(
        gtype == GEOM_MESH,
        tri_hit.t,
        jnp.where(gtype == GEOM_SPHERE, t_sphere, t_disc),
    )


def bvh_intersect(
    scene: SceneArrays,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_min: jnp.ndarray,
    t_max: jnp.ndarray,
) -> Hit:
    """Closest-hit query for a batch of rays (ref CompactBvh::intersect)."""
    n_nodes = scene.bvh_min.shape[0]
    inv_dir = 1.0 / direction
    shear = make_ray_shear(origin, direction)

    cur0 = jnp.zeros_like(t_min, dtype=jnp.int32)
    best_t0 = t_max
    best_g0 = jnp.full_like(cur0, INVALID_GEOM_ID)
    best_p0 = jnp.full_like(cur0, INVALID_PRIM_ID)

    def cond(state):
        cur, _, _, _ = state
        return jnp.any(cur < n_nodes)

    def body(state):
        cur, best_t, best_g, best_p = state
        active = cur < n_nodes
        cs = jnp.clip(cur, 0, n_nodes - 1)
        lo = scene.bvh_min[cs]
        hi = lo + scene.bvh_ext[cs].astype(jnp.float32)
        gid = scene.bvh_geom[cs]
        meta = scene.bvh_meta[cs]
        miss = scene.bvh_miss[cs]

        box_hit, _, _ = intersect_box_slab(origin, inv_dir, lo, hi, t_min, best_t)
        is_leaf = gid != INVALID_GEOM_ID

        do_prim = active & box_hit & is_leaf
        t_prim = _leaf_prim_t(scene, shear, origin, direction, t_min, gid, meta)
        better = do_prim & (t_prim > t_min) & (t_prim < best_t)
        best_t = jnp.where(better, t_prim, best_t)
        best_g = jnp.where(better, gid, best_g)
        best_p = jnp.where(better, meta, best_p)

        descend = active & box_hit & ~is_leaf
        nxt = jnp.where(descend, cs + 1, miss)
        cur = jnp.where(active, nxt, n_nodes)
        return cur, best_t, best_g, best_p

    _, best_t, best_g, best_p = jax.lax.while_loop(
        cond, body, (cur0, best_t0, best_g0, best_p0)
    )
    return Hit(t=best_t, geom_id=best_g, prim_id=best_p)


def bvh_occluded(
    scene: SceneArrays,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_min: jnp.ndarray,
    t_max: jnp.ndarray,
) -> jnp.ndarray:
    """Any-hit query with early lane termination (ref CompactBvh::occluded)."""
    n_nodes = scene.bvh_min.shape[0]
    inv_dir = 1.0 / direction
    shear = make_ray_shear(origin, direction)

    cur0 = jnp.zeros_like(t_min, dtype=jnp.int32)
    occ0 = jnp.zeros(t_min.shape, dtype=bool)

    def cond(state):
        cur, _ = state
        return jnp.any(cur < n_nodes)

    def body(state):
        cur, occ = state
        active = cur < n_nodes
        cs = jnp.clip(cur, 0, n_nodes - 1)
        lo = scene.bvh_min[cs]
        hi = lo + scene.bvh_ext[cs].astype(jnp.float32)
        gid = scene.bvh_geom[cs]
        meta = scene.bvh_meta[cs]
        miss = scene.bvh_miss[cs]

        box_hit, _, _ = intersect_box_slab(origin, inv_dir, lo, hi, t_min, t_max)
        is_leaf = gid != INVALID_GEOM_ID
        do_prim = active & box_hit & is_leaf
        t_prim = _leaf_prim_t(scene, shear, origin, direction, t_min, gid, meta)
        found = do_prim & (t_prim > t_min) & (t_prim < t_max)
        occ = occ | found

        descend = active & box_hit & ~is_leaf
        nxt = jnp.where(descend, cs + 1, miss)
        # Early per-lane exit once occluded:
        cur = jnp.where(active & ~occ, nxt, n_nodes)
        return cur, occ

    _, occ = jax.lax.while_loop(cond, body, (cur0, occ0))
    return occ


def dense_intersect(
    scene: SceneArrays,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    t_min: jnp.ndarray,
    t_max: jnp.ndarray,
) -> Hit:
    """Closest-hit via the dense intersector (ops/dense.py): triangles
    as chunked matmuls, spheres/discs broadcast-dense, running min."""
    from .dense import dense_closest_tri, dense_discs, dense_spheres

    if scene.dense is None:
        raise RuntimeError(
            "dense intersector tables were skipped at build time (scene "
            "exceeds scene.build.DENSE_TABLE_MAX_TRIS); rebuild with "
            "build_scene(..., intersector='dense') to use them")
    best_t, tri = dense_closest_tri(scene.dense, origin, direction, t_min, t_max)
    tri_safe = jnp.clip(tri, 0, scene.dense.tri_geom.shape[0] - 1)
    geom = jnp.where(tri >= 0, scene.dense.tri_geom[tri_safe], INVALID_GEOM_ID)
    prim = jnp.where(tri >= 0, scene.dense.tri_prim[tri_safe], INVALID_PRIM_ID)

    sb, st, si = dense_spheres(scene.spheres, origin, direction, t_min, best_t)
    geom = jnp.where(sb, scene.sphere_geom[si], geom)
    prim = jnp.where(sb, 0, prim)
    best_t = jnp.where(sb, st, best_t)

    db, dtt, di = dense_discs(scene.discs, origin, direction, t_min, best_t)
    geom = jnp.where(db, scene.disc_geom[di], geom)
    prim = jnp.where(db, 0, prim)
    best_t = jnp.where(db, dtt, best_t)

    found = geom != INVALID_GEOM_ID
    return Hit(
        t=jnp.where(found, best_t, t_max),
        geom_id=geom.astype(jnp.int32),
        prim_id=prim.astype(jnp.int32),
    )


def scene_intersect_with_normal(scene, origin, direction, t_min, t_max,
                                method: str = "bvh"):
    """Closest hit + shading normal in one call."""
    hit = scene_intersect(scene, origin, direction, t_min, t_max, method)
    return hit, hit_normal(scene, origin, direction, hit)


def scene_intersect(scene, origin, direction, t_min, t_max, method: str = "bvh") -> Hit:
    """Closest-hit dispatch: 'bvh' (threaded traversal) or 'dense'
    (brute force over triangle blocks)."""
    if method == "dense":
        return dense_intersect(scene, origin, direction, t_min, t_max)
    if method == "bvh":
        return bvh_intersect(scene, origin, direction, t_min, t_max)
    raise ValueError(f"unknown intersector {method!r} (expected 'bvh' or 'dense')")


def scene_occluded(scene, origin, direction, t_min, t_max, method: str = "bvh"):
    """Any-hit dispatch."""
    if method == "dense":
        hit = dense_intersect(scene, origin, direction, t_min, t_max)
        return hit.found & (hit.t < t_max)
    if method == "bvh":
        return bvh_occluded(scene, origin, direction, t_min, t_max)
    raise ValueError(f"unknown intersector {method!r} (expected 'bvh' or 'dense')")


def hit_normal(
    scene: SceneArrays,
    origin: jnp.ndarray,
    direction: jnp.ndarray,
    hit: Hit,
) -> jnp.ndarray:
    """Surface normal at a hit, after the fact.

    Equivalent of ``Primitive::normal`` dispatch + mesh normal
    interpolation (ref: include/Mesh.hpp:106-121, src/Primitives.cpp).
    Rays that did not hit get the Embree-compatible default (0, 0, 1)
    (ref: include/embree_utils/geometry.hpp:236 HitRecord ctor).
    """
    g_safe = jnp.clip(hit.geom_id, 0, scene.geom_type.shape[0] - 1)
    gtype = scene.geom_type[g_safe]
    gindex = scene.geom_index[g_safe]
    hit_p = origin + direction * hit.t[..., None]

    # Mesh normals: geometric, or interpolated when the mesh has normals.
    mi = jnp.clip(gindex, 0, scene.mesh_first_tri.shape[0] - 1)
    tri = jnp.clip(scene.mesh_first_tri[mi] + hit.prim_id, 0, scene.tri_v.shape[0] - 1)
    v = scene.tri_v[tri]
    p0 = scene.verts[v[..., 0]]
    p1 = scene.verts[v[..., 1]]
    p2 = scene.verts[v[..., 2]]
    geo_n = jnp.cross(p1 - p0, p2 - p0)
    geo_n = geo_n / jnp.maximum(
        jnp.linalg.norm(geo_n, axis=-1, keepdims=True), jnp.float32(1e-30)
    )
    # Barycentrics at the hit (re-derived with the same watertight test):
    shear = make_ray_shear(origin, direction)
    tri_hit = intersect_triangle_watertight(shear, p0, p1, p2, jnp.float32(jnp.inf))
    n0 = scene.normals[v[..., 0]]
    n1 = scene.normals[v[..., 1]]
    n2 = scene.normals[v[..., 2]]
    interp = (
        n0 * tri_hit.b0[..., None]
        + n1 * tri_hit.b1[..., None]
        + n2 * tri_hit.b2[..., None]
    )
    interp = interp / jnp.maximum(
        jnp.linalg.norm(interp, axis=-1, keepdims=True), jnp.float32(1e-30)
    )
    has_n = scene.mesh_has_normals[mi][..., None] != 0
    mesh_n = jnp.where(has_n, interp, geo_n)

    si = jnp.clip(gindex, 0, scene.spheres.shape[0] - 1)
    sp = scene.spheres[si]
    sphere_n = hit_p - sp[..., :3]
    sphere_n = sphere_n / jnp.maximum(
        jnp.linalg.norm(sphere_n, axis=-1, keepdims=True), jnp.float32(1e-30)
    )

    di = jnp.clip(gindex, 0, scene.discs.shape[0] - 1)
    disc_n = scene.discs[di][..., 0:3]

    n = jnp.where(
        (gtype == GEOM_MESH)[..., None],
        mesh_n,
        jnp.where((gtype == GEOM_SPHERE)[..., None], sphere_n, disc_n),
    )
    default = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], jnp.float32), n.shape)
    return jnp.where(hit.found[..., None], n, default)
