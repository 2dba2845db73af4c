"""Brute-force numpy oracle renderer.

Plays the role Embree plays in the reference's verification methodology
(ref: trace.cpp:7-113, README.md:31-34): an *algorithmically independent*
renderer the JAX pipeline is compared against. Differences from the
production path are deliberate:

* No BVH — every ray is tested against every primitive (O(R*P)).
* Classic Moller-Trumbore in float64 rather than the watertight shear
  test in float32.

Exact agreement is therefore not expected; AOVs must match within the
same cross-renderer tolerances the reference accepts for Embree-vs-IPU
(MSE checks, trace.cpp:528-540).
"""

from __future__ import annotations

import numpy as np

from ..scene.types import SceneDescription

_EPS = 1e-12


def _mesh_intersect(mesh, origins, dirs, t_best, geom, prim, normal, gid):
    """Moller-Trumbore all-triangles test in f64; updates best-hit arrays."""
    v0 = mesh.vertices[mesh.triangles[:, 0]].astype(np.float64)
    v1 = mesh.vertices[mesh.triangles[:, 1]].astype(np.float64)
    v2 = mesh.vertices[mesh.triangles[:, 2]].astype(np.float64)
    e1 = v1 - v0
    e2 = v2 - v0
    has_normals = mesh.has_normals

    # Chunk rays to bound the [R, T] temporaries:
    R = len(origins)
    chunk = max(1, int(4e6 // max(len(v0), 1)))
    for s in range(0, R, chunk):
        o = origins[s : s + chunk].astype(np.float64)[:, None, :]
        d = dirs[s : s + chunk].astype(np.float64)[:, None, :]
        p = np.cross(d, e2[None])
        det = np.sum(e1[None] * p, axis=-1)
        ok = np.abs(det) > _EPS
        inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = o - v0[None]
        u = np.sum(tv * p, axis=-1) * inv_det
        q = np.cross(tv, e1[None])
        v = np.sum(d * q, axis=-1) * inv_det
        t = np.sum(e2[None] * q, axis=-1) * inv_det
        ok &= (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-7)
        t = np.where(ok, t, np.inf)
        best_tri = np.argmin(t, axis=1)
        rows = np.arange(len(best_tri))
        tmin = t[rows, best_tri]
        upd = tmin < t_best[s : s + chunk]
        idx = np.nonzero(upd)[0]
        if len(idx) == 0:
            continue
        gsel = s + idx
        tri_sel = best_tri[idx]
        t_best[gsel] = tmin[idx]
        geom[gsel] = gid
        prim[gsel] = tri_sel
        if has_normals:
            uu = u[idx, tri_sel][:, None]
            vv = v[idx, tri_sel][:, None]
            n0 = mesh.normals[mesh.triangles[tri_sel, 0]].astype(np.float64)
            n1 = mesh.normals[mesh.triangles[tri_sel, 1]].astype(np.float64)
            n2 = mesh.normals[mesh.triangles[tri_sel, 2]].astype(np.float64)
            n = n0 * (1 - uu - vv) + n1 * uu + n2 * vv
        else:
            n = np.cross(e1[tri_sel], e2[tri_sel])
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), _EPS)
        normal[gsel] = n


def _sphere_intersect(sph, origins, dirs, t_best, geom, prim, normal, gid):
    c = sph[:3].astype(np.float64)
    r2 = float(sph[3]) ** 2
    o = origins.astype(np.float64)
    d = dirs.astype(np.float64)
    oc = o - c
    b = np.sum(oc * d, axis=-1)
    cc = np.sum(oc * oc, axis=-1) - r2
    disc = b * b - np.sum(d * d, axis=-1) * cc
    ok = disc >= 0
    sq = np.sqrt(np.maximum(disc, 0.0))
    a = np.sum(d * d, axis=-1)
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    t = np.where(t0 > 1e-7, t0, t1)
    ok &= t > 1e-7
    upd = ok & (t < t_best)
    t_best[upd] = t[upd]
    geom[upd] = gid
    prim[upd] = 0
    hp = o[upd] + d[upd] * t[upd][:, None]
    n = hp - c
    normal[upd] = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), _EPS)


def _disc_intersect(disc, origins, dirs, t_best, geom, prim, normal, gid):
    n = disc[0:3].astype(np.float64)
    c = disc[3:6].astype(np.float64)
    r2 = float(disc[6]) ** 2
    o = origins.astype(np.float64)
    d = dirs.astype(np.float64)
    denom = d @ n
    ok = np.abs(denom) > _EPS
    t = ((c - o) @ n) / np.where(ok, denom, 1.0)
    hp = o + d * t[:, None]
    dist2 = np.sum((hp - c) ** 2, axis=-1)
    ok &= (t > 1e-7) & (dist2 < r2)
    upd = ok & (t < t_best)
    t_best[upd] = t[upd]
    geom[upd] = gid
    prim[upd] = 0
    normal[upd] = n


def oracle_intersect(scene: SceneDescription, origins: np.ndarray, dirs: np.ndarray):
    """Closest hit over all primitives. Returns (t, geom, prim, normal);
    t == inf and geom == -1 for misses."""
    R = len(origins)
    t_best = np.full(R, np.inf)
    geom = np.full(R, -1, np.int64)
    prim = np.full(R, -1, np.int64)
    normal = np.zeros((R, 3), np.float64)

    gid = 0
    for m in scene.meshes:
        _mesh_intersect(m, origins, dirs, t_best, geom, prim, normal, gid)
        gid += 1
    for s in scene.spheres:
        _sphere_intersect(s, origins, dirs, t_best, geom, prim, normal, gid)
        gid += 1
    for d in scene.discs:
        _disc_intersect(d, origins, dirs, t_best, geom, prim, normal, gid)
        gid += 1
    return t_best, geom, prim, normal


# ---------------------------------------------------------------------------
# BVH-accelerated oracle: the same f64 Moller-Trumbore ground truth at
# hundreds of thousands of triangles (the brute-force form above is
# O(R*P) and impractical past ~10k prims). The BVH
# *structure* is reused from bvh/builder.py (as the reference reuses
# Embree's build for its own flatten, app_utils.cpp:344-361), but the
# traversal below is an independent vectorised-over-rays numpy stepper
# and every primitive test stays the f64 brute-force code above in
# single-triangle form — the production bvh/dense intersectors share no
# algorithm with it.
# ---------------------------------------------------------------------------
class _OracleBvh:
    def __init__(self, scene: SceneDescription):
        from ..bvh.builder import INVALID_GEOM_ID, build_bvh

        lo_list, hi_list, gid_list, pid_list = [], [], [], []
        self.tri_base: dict[int, int] = {}
        v0s, v1s, v2s, n0s, n1s, n2s, hasn = [], [], [], [], [], [], []
        gid = 0
        base = 0
        for m in scene.meshes:
            v0 = m.vertices[m.triangles[:, 0]].astype(np.float64)
            v1 = m.vertices[m.triangles[:, 1]].astype(np.float64)
            v2 = m.vertices[m.triangles[:, 2]].astype(np.float64)
            lo_list.append(np.minimum(np.minimum(v0, v1), v2))
            hi_list.append(np.maximum(np.maximum(v0, v1), v2))
            gid_list.append(np.full(len(v0), gid, np.int64))
            pid_list.append(np.arange(len(v0), dtype=np.int64))
            v0s.append(v0)
            v1s.append(v1)
            v2s.append(v2)
            if m.has_normals:
                n0s.append(m.normals[m.triangles[:, 0]].astype(np.float64))
                n1s.append(m.normals[m.triangles[:, 1]].astype(np.float64))
                n2s.append(m.normals[m.triangles[:, 2]].astype(np.float64))
            else:
                z = np.zeros_like(v0)
                n0s.append(z)
                n1s.append(z)
                n2s.append(z)
            hasn.append(np.full(len(v0), bool(m.has_normals)))
            self.tri_base[gid] = base
            base += len(v0)
            gid += 1
        self.tri_base_arr = np.array(
            [self.tri_base.get(g, 0) for g in range(max(gid, 1))], np.int64)
        self.sphere_gid0 = gid
        for s in scene.spheres:
            c, r = s[:3].astype(np.float64), float(s[3])
            lo_list.append((c - r)[None])
            hi_list.append((c + r)[None])
            gid_list.append(np.array([gid], np.int64))
            pid_list.append(np.zeros(1, np.int64))
            gid += 1
        self.disc_gid0 = gid
        for d in scene.discs:
            c, r = d[3:6].astype(np.float64), float(d[6])
            n = d[0:3].astype(np.float64)
            ext = r * np.sqrt(np.maximum(1.0 - n * n, 0.0))
            lo_list.append((c - ext)[None])
            hi_list.append((c + ext)[None])
            gid_list.append(np.array([gid], np.int64))
            pid_list.append(np.zeros(1, np.int64))
            gid += 1

        self.scene = scene
        self.v0 = np.concatenate(v0s) if v0s else np.zeros((0, 3))
        self.v1 = np.concatenate(v1s) if v1s else np.zeros((0, 3))
        self.v2 = np.concatenate(v2s) if v2s else np.zeros((0, 3))
        self.n0 = np.concatenate(n0s) if n0s else np.zeros((0, 3))
        self.n1 = np.concatenate(n1s) if n1s else np.zeros((0, 3))
        self.n2 = np.concatenate(n2s) if n2s else np.zeros((0, 3))
        self.hasn = np.concatenate(hasn) if hasn else np.zeros(0, bool)
        bvh = build_bvh(
            np.concatenate(lo_list).astype(np.float32),
            np.concatenate(hi_list).astype(np.float32),
            np.concatenate(gid_list), np.concatenate(pid_list))
        self.mins = bvh.mins.astype(np.float64)
        self.exts = bvh.exts.astype(np.float64)   # fp16 round-up: conservative
        self.meta = bvh.meta.astype(np.int64)
        self.geom = bvh.geom.astype(np.int64)
        self.miss = bvh.miss.astype(np.int64)
        self.invalid = INVALID_GEOM_ID

    def intersect(self, origins, dirs):
        o = np.asarray(origins, np.float64)
        d = np.asarray(dirs, np.float64)
        R = len(o)
        inv = 1.0 / np.where(d == 0.0, 1e-300, d)
        t_best = np.full(R, np.inf)
        geom = np.full(R, -1, np.int64)
        prim = np.full(R, -1, np.int64)
        normal = np.zeros((R, 3), np.float64)
        N = len(self.mins)
        node = np.zeros(R, np.int64)
        sph = self.scene.spheres
        dsc = self.scene.discs

        while True:
            act = np.nonzero(node < N)[0]
            if len(act) == 0:
                break
            nd = node[act]
            lo = self.mins[nd]
            hi = lo + self.exts[nd]
            t0 = (lo - o[act]) * inv[act]
            t1 = (hi - o[act]) * inv[act]
            tin = np.minimum(t0, t1).max(axis=1)
            tout = np.maximum(t0, t1).min(axis=1)
            hit_box = (tin <= tout) & (tout > 0) & (tin < t_best[act])

            g = self.geom[nd]
            is_leaf = g != self.invalid
            test = hit_box & is_leaf
            # Triangle leaves test their one tri (f64 Moller-Trumbore);
            # sphere/disc leaves are skipped here — the few analytic
            # prims are brute-forced after the walk:
            test = test & (g < self.sphere_gid0)
            if np.any(test):
                ti = act[test]
                gi = g[test]
                pi = self.meta[nd[test]]
                rows = self.tri_base_arr[gi] + pi
                self._tri_test(ti, rows, gi, pi,
                               o, d, t_best, geom, prim, normal)
            # Advance: inner hit -> first child (nd+1); otherwise miss link.
            nxt = np.where(hit_box & ~is_leaf, nd + 1, self.miss[nd])
            node[act] = nxt

        # Analytic prims brute-force (counts are tiny in every scene):
        for i, s in enumerate(sph):
            _sphere_intersect(s, o, d, t_best, geom, prim, normal,
                              self.sphere_gid0 + i)
        for i, dd in enumerate(dsc):
            _disc_intersect(dd, o, d, t_best, geom, prim, normal,
                            self.disc_gid0 + i)
        return t_best, geom, prim, normal

    def _tri_test(self, rays, rows, gids, pids, o, d, t_best, geom, prim,
                  normal):
        v0 = self.v0[rows]
        e1 = self.v1[rows] - v0
        e2 = self.v2[rows] - v0
        oo = o[rays]
        dd = d[rays]
        p = np.cross(dd, e2)
        det = np.sum(e1 * p, axis=-1)
        ok = np.abs(det) > _EPS
        inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
        tv = oo - v0
        u = np.sum(tv * p, axis=-1) * inv_det
        q = np.cross(tv, e1)
        v = np.sum(dd * q, axis=-1) * inv_det
        t = np.sum(e2 * q, axis=-1) * inv_det
        ok &= (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-7)
        upd = ok & (t < t_best[rays])
        if not np.any(upd):
            return
        sel = np.nonzero(upd)[0]
        ri = rays[sel]
        t_best[ri] = t[sel]
        geom[ri] = gids[sel]
        prim[ri] = pids[sel]
        hn = self.hasn[rows[sel]]
        n_geo = np.cross(e1[sel], e2[sel])
        uu = u[sel][:, None]
        vv = v[sel][:, None]
        n_int = (self.n0[rows[sel]] * (1 - uu - vv)
                 + self.n1[rows[sel]] * uu + self.n2[rows[sel]] * vv)
        n = np.where(hn[:, None], n_int, n_geo)
        normal[ri] = n / np.maximum(
            np.linalg.norm(n, axis=-1, keepdims=True), _EPS)


def oracle_intersect_bvh(scene: SceneDescription, origins, dirs):
    """BVH-accelerated f64 oracle closest hit (same contract as
    :func:`oracle_intersect`; usable at 100k+ triangles). The built BVH
    is cached on the scene object itself (an id()-keyed dict would alias
    after garbage collection)."""
    ob = getattr(scene, "_oracle_bvh", None)
    if ob is None:
        ob = _OracleBvh(scene)
        try:
            scene._oracle_bvh = ob
        except AttributeError:
            pass                      # slots/frozen scene: rebuild per call
    return ob.intersect(origins, dirs)


def _total_prims(scene: SceneDescription) -> int:
    return (sum(len(m.triangles) for m in scene.meshes)
            + len(scene.spheres) + len(scene.discs))


def _auto_intersect(scene, origins, dirs, use_bvh=None):
    if use_bvh is None:
        use_bvh = _total_prims(scene) > 20000
    fn = oracle_intersect_bvh if use_bvh else oracle_intersect
    return fn(scene, origins, dirs)


def oracle_occluded(scene: SceneDescription, origins: np.ndarray,
                    dirs: np.ndarray, t_max: np.ndarray, use_bvh=None):
    t, geom, _, _ = _auto_intersect(scene, origins, dirs, use_bvh)
    return (geom >= 0) & (t < t_max)


def oracle_shadow_trace(
    scene: SceneDescription,
    origins: np.ndarray,
    dirs: np.ndarray,
    light_pos=(18.0, 257.0, -1060.0),
    ambient: float = 0.05,
    shadow_offset: float = 0.005,
    use_bvh=None,
):
    """Primary hit + one shadow ray to a fixed light — the reference's
    Embree shadow render (trace.cpp:44-107, same 0.005 shadow offset).

    Returns dict of AOVs: rgb, t, geom, prim, normal, hit_p.
    ``use_bvh``: None auto-selects the BVH-accelerated f64 oracle above
    ~20k primitives (same ground-truth contract, minutes not hours at
    100k+ tris)."""
    light = np.asarray(light_pos, np.float64)
    t, geom, prim, normal = _auto_intersect(scene, origins, dirs, use_bvh)
    found = geom >= 0
    hit_p = origins.astype(np.float64) + dirs.astype(np.float64) * np.where(found, t, 0.0)[:, None]

    mat_ids = np.asarray(scene.mat_ids, np.int64)
    albedo = np.stack([m.albedo for m in scene.materials]).astype(np.float64)
    rgb = np.zeros((len(origins), 3), np.float64)

    lo = light[None] - hit_p
    dist = np.linalg.norm(lo, axis=-1)
    sdir = lo / np.maximum(dist[:, None], _EPS)
    sorig = hit_p + sdir * shadow_offset
    occ = oracle_occluded(scene, sorig[found], sdir[found],
                          (dist - 2 * shadow_offset)[found], use_bvh)

    mat_rgb = albedo[mat_ids[np.where(found, geom, 0)]]
    lambert = np.sum(sdir * normal, axis=-1)
    lit = np.zeros(len(origins), bool)
    lit[found] = ~occ
    rgb = np.where(
        found[:, None],
        mat_rgb * ambient + np.where(lit, lambert, 0.0)[:, None] * mat_rgb,
        0.0,
    )
    return {
        "rgb": rgb.astype(np.float32),
        "t": np.where(found, t, np.inf).astype(np.float32),
        "geom": geom,
        "prim": prim,
        "normal": normal.astype(np.float32),
        "hit_p": np.where(found[:, None], hit_p, 0.0).astype(np.float32),
    }
