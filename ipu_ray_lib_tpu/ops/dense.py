"""Dense intersector: ray x primitive tests as chunked matmuls.

An alternative to BVH traversal for scenes in the size class the
reference targets (its whole scene must fit in one IPU tile's SRAM —
README.md:51 — i.e. thousands of primitives, not millions). Expressing
the ray/triangle test as `[R,3] @ [3,T]` contractions gives

    t  = (n.p0 - n.o) / (n.d)
    b1 = (o.g1 + t * d.g1) - g1.p0      (barycentric via precomputed
    b2 = (o.g2 + t * d.g2) - g2.p0       gradient vectors g1, g2)

six matmuls + elementwise work per (ray, triangle) block, with a running
closest-hit min over triangle blocks — fully dense, no gathers, no
divergence, ~50 flops per pair. Its cost grows with the triangle count,
so scene build selects it only for small scenes (scene/build.py
``AUTO_DENSE_MAX_PRIMS``).

Triangle normals are stored *normalised* so the plane-distance
subtraction (n.p0 - n.o) stays in world units and f32 cancellation error
stays ~scene_scale * 1e-7, well inside the self-intersection offset
(ops/bxdf.py offset_ray_origin).

The threaded-BVH path (ops/traversal.py) remains the general-scene
intersector; scene build selects per scene (SceneParams.intersector).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from ..utils.constants import MACHINE_EPSILON, WATERTIGHT_EPS_SCALE

TRI_BLOCK = 512


class DenseTables(NamedTuple):
    """Precomputed per-triangle data for the dense intersector (padded to a
    multiple of TRI_BLOCK; padding rows have n == 0 and never hit)."""

    tn: jnp.ndarray     # [T,3] unit normal
    tnp0: jnp.ndarray   # [T]   n . p0
    g1: jnp.ndarray     # [T,3] barycentric gradient for b1
    g1p0: jnp.ndarray   # [T]   g1 . p0
    g2: jnp.ndarray     # [T,3]
    g2p0: jnp.ndarray   # [T]
    tri_geom: jnp.ndarray  # [T] i32 geomID owning the triangle
    tri_prim: jnp.ndarray  # [T] i32 primID within that geometry
    # Watertight acceptance-bound terms (constants.WATERTIGHT_EPS_SCALE):
    tS: jnp.ndarray     # [T]   |g1p0| + |g2p0|
    tG: jnp.ndarray     # [T]   ||g1||_1 + ||g2||_1


def build_dense_tables(tri_v: np.ndarray, verts: np.ndarray,
                       tri_geom: np.ndarray, tri_prim: np.ndarray) -> DenseTables:
    """Host-side precompute (numpy), vectorised over all triangles."""
    T = len(tri_v)
    p0 = verts[tri_v[:, 0]].astype(np.float64)
    p1 = verts[tri_v[:, 1]].astype(np.float64)
    p2 = verts[tri_v[:, 2]].astype(np.float64)
    e1 = p1 - p0
    e2 = p2 - p0
    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    degenerate = (nlen[:, 0] < 1e-20)
    n = np.where(degenerate[:, None], 0.0, n / np.maximum(nlen, 1e-30))

    d00 = np.sum(e1 * e1, axis=-1)
    d01 = np.sum(e1 * e2, axis=-1)
    d11 = np.sum(e2 * e2, axis=-1)
    denom = d00 * d11 - d01 * d01
    safe = np.where(np.abs(denom) < 1e-30, 1.0, denom)
    g1 = (e1 * d11[:, None] - e2 * d01[:, None]) / safe[:, None]
    g2 = (e2 * d00[:, None] - e1 * d01[:, None]) / safe[:, None]
    g1 = np.where(degenerate[:, None], 0.0, g1)
    g2 = np.where(degenerate[:, None], 0.0, g2)

    pad = (-T) % TRI_BLOCK
    if pad == 0 and T == 0:
        pad = TRI_BLOCK

    def pad0(a):
        return np.pad(a.astype(np.float32), ((0, pad),) + ((0, 0),) * (a.ndim - 1))

    def padi(a):
        return np.pad(a.astype(np.int32), (0, pad))

    return DenseTables(
        tn=jnp.asarray(pad0(n)),
        tnp0=jnp.asarray(pad0(np.sum(n * p0, axis=-1))),
        g1=jnp.asarray(pad0(g1)),
        g1p0=jnp.asarray(pad0(np.sum(g1 * p0, axis=-1))),
        g2=jnp.asarray(pad0(g2)),
        g2p0=jnp.asarray(pad0(np.sum(g2 * p0, axis=-1))),
        tri_geom=jnp.asarray(padi(np.asarray(tri_geom))),
        tri_prim=jnp.asarray(padi(np.asarray(tri_prim))),
        tS=jnp.asarray(pad0(np.abs(np.sum(g1 * p0, axis=-1))
                            + np.abs(np.sum(g2 * p0, axis=-1)))),
        tG=jnp.asarray(pad0(np.abs(g1).sum(axis=-1)
                            + np.abs(g2).sum(axis=-1))),
    )


def _tri_block_best(dt: DenseTables, blk: int, origins, dirs, t_min, best):
    """Closest hit against one TRI_BLOCK of triangles; returns updated
    (best_t [R], best_tri [R])."""
    sl = slice(blk * TRI_BLOCK, (blk + 1) * TRI_BLOCK)
    tn = jax.lax.dynamic_slice_in_dim(dt.tn, blk * TRI_BLOCK, TRI_BLOCK, 0)
    g1 = jax.lax.dynamic_slice_in_dim(dt.g1, blk * TRI_BLOCK, TRI_BLOCK, 0)
    g2 = jax.lax.dynamic_slice_in_dim(dt.g2, blk * TRI_BLOCK, TRI_BLOCK, 0)
    tnp0 = jax.lax.dynamic_slice_in_dim(dt.tnp0, blk * TRI_BLOCK, TRI_BLOCK, 0)
    g1p0 = jax.lax.dynamic_slice_in_dim(dt.g1p0, blk * TRI_BLOCK, TRI_BLOCK, 0)
    g2p0 = jax.lax.dynamic_slice_in_dim(dt.g2p0, blk * TRI_BLOCK, TRI_BLOCK, 0)

    best_t, best_tri = best
    # Ray geometry must be exact f32. At DEFAULT precision a float32 dot
    # may run on the GPU's tensor cores in TF32 (10-bit mantissa, ~1e-3
    # relative): at scene scales of hundreds of units that is a
    # multi-unit hit-point error — shadow acne, self-hits past the
    # offset, energy bias. Precision.HIGHEST keeps full f32:
    HI = jax.lax.Precision.HIGHEST
    dn = jnp.dot(dirs, tn.T, preferred_element_type=jnp.float32, precision=HI)
    on = jnp.dot(origins, tn.T, preferred_element_type=jnp.float32, precision=HI)
    t = (tnp0[None, :] - on) / dn
    dg1 = jnp.dot(dirs, g1.T, preferred_element_type=jnp.float32, precision=HI)
    og1 = jnp.dot(origins, g1.T, preferred_element_type=jnp.float32, precision=HI)
    dg2 = jnp.dot(dirs, g2.T, preferred_element_type=jnp.float32, precision=HI)
    og2 = jnp.dot(origins, g2.T, preferred_element_type=jnp.float32, precision=HI)
    b1 = og1 + t * dg1 - g1p0[None, :]
    b2 = og2 + t * dg2 - g2p0[None, :]

    # Watertight widened acceptance (utils/constants.py
    # WATERTIGHT_EPS_SCALE; ref src/Mesh.cpp:8-104 contract):
    tS = jax.lax.dynamic_slice_in_dim(dt.tS, blk * TRI_BLOCK, TRI_BLOCK, 0)
    tG = jax.lax.dynamic_slice_in_dim(dt.tG, blk * TRI_BLOCK, TRI_BLOCK, 0)
    o_mag = jnp.max(jnp.abs(origins), axis=-1, keepdims=True)   # [R, 1]
    et = (jnp.abs(tnp0[None, :]) + jnp.abs(on)) / jnp.abs(
        jnp.where(dn == 0.0, 1.0, dn))
    # Clamped: near-grazing pairs (dn -> 0) blow E_t up and would turn
    # the widened test into accept-all; 1e-3 is 10-100x the legitimate
    # edge-acceptance bound while keeping grazing acceptance negligible
    # (the shared-edge NEIGHBOR's well-conditioned test is what makes
    # edge points watertight there):
    eps = jnp.minimum(
        WATERTIGHT_EPS_SCALE * (tS[None, :] + tG[None, :] * (o_mag + et)),
        jnp.float32(1e-3))
    ok = (
        (dn != 0.0)
        & (b1 >= -eps)
        & (b2 >= -eps)
        & (b1 + b2 <= 1.0 + eps)
        & (t > t_min[:, None])
        & (t < best_t[:, None])
    )
    t = jnp.where(ok, t, jnp.inf)
    local_best = jnp.min(t, axis=1)
    local_idx = jnp.argmin(t, axis=1).astype(jnp.int32) + blk * TRI_BLOCK
    better = local_best < best_t
    return (
        jnp.where(better, local_best, best_t),
        jnp.where(better, local_idx, best_tri),
    )


def dense_closest_tri(dt: DenseTables, origins, dirs, t_min, t_max):
    """Closest triangle over all blocks. Returns (t, tri_index) with
    tri_index == -1 when nothing is hit before t_max."""
    n_blocks = dt.tn.shape[0] // TRI_BLOCK
    best_t0 = t_max
    best_i0 = jnp.full(t_min.shape, -1, jnp.int32)

    def body(blk, best):
        bt, bi = _tri_block_best(dt, blk, origins, dirs, t_min, best)
        return bt, bi

    best_t, best_tri = jax.lax.fori_loop(0, n_blocks, body, (best_t0, best_i0))
    best_tri = jnp.where(best_t < t_max, best_tri, -1)
    return best_t, best_tri


def dense_spheres(spheres, origins, dirs, t_min, best_t):
    """All-spheres closest hit (vectorised over the sphere axis).
    Same geometric test as ops.intersect.intersect_sphere."""
    c = spheres[:, :3]                                  # [S,3]
    r2 = spheres[:, 3] * spheres[:, 3]
    oc = c[None, :, :] - origins[:, None, :]            # [R,S,3]
    rd2 = 1.0 / jnp.sum(dirs * dirs, axis=-1)
    # Exact f32 (see _tri_block_best precision note):
    tca = jnp.einsum("rsk,rk->rs", oc, dirs,
                     precision=jax.lax.Precision.HIGHEST) * rd2[:, None]
    l = oc - dirs[:, None, :] * tca[..., None]
    l2 = jnp.sum(l * l, axis=-1)
    td = jnp.sqrt(jnp.maximum(r2[None, :] - l2, 0.0)) * rd2[:, None]
    t0 = tca - td
    t1 = tca + td
    t = jnp.where(t0 < t_min[:, None], t1, t0)
    miss = (tca < 0.0) | (l2 > r2[None, :]) | (t < t_min[:, None]) | (r2[None, :] <= 0.0)
    t = jnp.where(miss | (t <= t_min[:, None]), jnp.inf, t)
    ti = jnp.min(t, axis=1)
    ii = jnp.argmin(t, axis=1).astype(jnp.int32)
    better = ti < best_t
    return better, ti, ii


def dense_discs(discs, origins, dirs, t_min, best_t):
    """All-discs closest hit. Same quirky plane-offset convention as
    ops.intersect.intersect_disc (d = |c.n|)."""
    n = discs[:, 0:3]
    c = discs[:, 3:6]
    r2 = discs[:, 6] * discs[:, 6]
    # Exact f32 (see _tri_block_best precision note):
    HI = jax.lax.Precision.HIGHEST
    angle = jnp.dot(dirs, n.T, precision=HI)            # [R,D]
    d_off = jnp.abs(jnp.sum(c * n, axis=-1))            # [D]
    t = -(jnp.dot(origins, n.T, precision=HI) + d_off[None, :]) / angle
    hp = origins[:, None, :] + dirs[:, None, :] * t[..., None]
    d2 = jnp.sum((hp - c[None, :, :]) ** 2, axis=-1)
    ok = (angle != 0.0) & (t > MACHINE_EPSILON) & (d2 < r2[None, :]) & (r2[None, :] > 0.0)
    ok &= t > t_min[:, None]
    t = jnp.where(ok, t, jnp.inf)
    ti = jnp.min(t, axis=1)
    ii = jnp.argmin(t, axis=1).astype(jnp.int32)
    better = ti < best_t
    return better, ti, ii
