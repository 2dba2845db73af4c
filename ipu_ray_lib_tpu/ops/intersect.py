"""Primitive intersection tests, vectorised over ray batches (jnp).

The portable compute core of the framework — the role of the reference's
header-only L0 layer (ref: include/CompactBVH2Node.hpp:15-50 slab test,
src/Mesh.cpp:6-110 watertight triangle, src/Primitives.cpp:24-67
sphere/disc). Everything here is pure, shape-polymorphic over a leading
ray-batch axis, in float32, and safe under jit (no data-dependent shapes).

Numerical conventions carried over deliberately:

* Slab test scales tmax by ``1 + 2*gamma(3)`` so rounding error can never
  cull a true hit.
* A miss is encoded as ``t == 0``; hits require ``t > t_min`` (strict).
* Comparisons are written as explicit ``jnp.where(a > b, a, b)`` selects so
  NaNs arising from inf*0 in the slab test resolve exactly like the
  C-ternary forms in the reference (NaN comparisons are false).
* The triangle test uses the full PBRT error-bound rejection (t <= deltaT)
  in f32 only; there is no double-precision fallback here (the
  reference's default build also disables it: CMakeLists.txt:13).

One deliberate divergence: the reference's ``Vec3fa::maxi()`` contains
inverted comparisons (it computes an arg-*min*), which skews its shear-axis
choice and roulette/epsilon scaling. We implement the intended semantics
(argmax of |direction| for the shear permutation, true max component
elsewhere); images agree to well within the cross-renderer tolerances the
reference itself accepts.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..utils.constants import MACHINE_EPSILON, gamma

_SLAB_SCALE = jnp.float32(1.0 + 2.0 * gamma(3))
_GAMMA2 = jnp.float32(gamma(2))
_GAMMA3 = jnp.float32(gamma(3))
_GAMMA5 = jnp.float32(gamma(5))


def intersect_box_slab(origin, inv_dir, box_lo, box_hi, t0, t1):
    """Ray/AABB slab test returning (hit, t0', t1').

    All args broadcast; t0/t1 are the incoming ray interval which is
    narrowed in place (t1 is typically min(tMax, closest_t so far)).
    """
    for a in range(3):
        tmin = (box_lo[..., a] - origin[..., a]) * inv_dir[..., a]
        tmax = (box_hi[..., a] - origin[..., a]) * inv_dir[..., a]
        swap = tmin > tmax
        tmin, tmax = jnp.where(swap, tmax, tmin), jnp.where(swap, tmin, tmax)
        tmax = tmax * _SLAB_SCALE
        t0 = jnp.where(tmin > t0, tmin, t0)
        t1 = jnp.where(tmax < t1, tmax, t1)
    return t0 <= t1, t0, t1


class RayShear(NamedTuple):
    """Precomputed permute+shear transform, one per ray
    (role of ref include/Primitives.hpp:27-35 RayShearParams)."""

    origin: jnp.ndarray  # [R,3]
    perm: jnp.ndarray    # [R,3] i32 permutation indices (ix, iy, iz)
    sx: jnp.ndarray      # [R]
    sy: jnp.ndarray
    sz: jnp.ndarray


def make_ray_shear(origin: jnp.ndarray, direction: jnp.ndarray) -> RayShear:
    iz = jnp.argmax(jnp.abs(direction), axis=-1).astype(jnp.int32)
    ix = jnp.where(iz == 2, 0, iz + 1)
    iy = jnp.where(ix == 2, 0, ix + 1)
    dz = jnp.take_along_axis(direction, iz[..., None], axis=-1)[..., 0]
    dx = jnp.take_along_axis(direction, ix[..., None], axis=-1)[..., 0]
    dy = jnp.take_along_axis(direction, iy[..., None], axis=-1)[..., 0]
    inv_dz = 1.0 / dz
    return RayShear(
        origin=origin,
        perm=jnp.stack([ix, iy, iz], axis=-1),
        sx=-dx * inv_dz,
        sy=-dy * inv_dz,
        sz=inv_dz,
    )


def _permute(v: jnp.ndarray, perm: jnp.ndarray) -> jnp.ndarray:
    return jnp.take_along_axis(v, perm, axis=-1)


class TriangleHit(NamedTuple):
    t: jnp.ndarray   # 0 on miss
    b0: jnp.ndarray
    b1: jnp.ndarray
    b2: jnp.ndarray


def intersect_triangle_watertight(
    shear: RayShear,
    p0: jnp.ndarray,
    p1: jnp.ndarray,
    p2: jnp.ndarray,
    t_far: jnp.ndarray,
) -> TriangleHit:
    """Watertight ray/triangle test (PBRT) with f32 error bounds.

    Behavioural contract of ref src/Mesh.cpp:6-104 (minus the optional
    double fallback): translate to ray frame, permute so the dominant
    direction axis is z, shear, edge-function sign test, conservative
    ``t <= deltaT`` rejection.
    """
    p0t = _permute(p0 - shear.origin, shear.perm)
    p1t = _permute(p1 - shear.origin, shear.perm)
    p2t = _permute(p2 - shear.origin, shear.perm)

    sx, sy, sz = shear.sx, shear.sy, shear.sz
    p0x = p0t[..., 0] + sx * p0t[..., 2]
    p0y = p0t[..., 1] + sy * p0t[..., 2]
    p1x = p1t[..., 0] + sx * p1t[..., 2]
    p1y = p1t[..., 1] + sy * p1t[..., 2]
    p2x = p2t[..., 0] + sx * p2t[..., 2]
    p2y = p2t[..., 1] + sy * p2t[..., 2]

    e0 = p1x * p2y - p1y * p2x
    e1 = p2x * p0y - p2y * p0x
    e2 = p0x * p1y - p0y * p1x

    # Conservative sign classification: an edge function within its own
    # rounding bound of zero counts as zero. Strict signs alone (PBRT
    # f32 without the double fallback) measurably leak rays that pass
    # within ~ulps of a VERTEX: the ring's near-zero edge functions
    # round independently, so every incident triangle can see a wrong
    # strict sign (tests/test_watertight.py caught 120/1684 such rays).
    # The reference resolves exact zeros in double behind
    # ALLOW_DOUBLE_FALLBACK (ref src/Mesh.cpp:38-51, README.md:109-120);
    # with no f64 in the hot path, widening by the delta_e bound is the
    # conservative f32 analogue — near-boundary rays accept in at least
    # one (possibly several, benign for closest-hit) incident triangle:
    max_xt0 = jnp.maximum(jnp.maximum(jnp.abs(p0x), jnp.abs(p1x)),
                          jnp.abs(p2x))
    max_yt0 = jnp.maximum(jnp.maximum(jnp.abs(p0y), jnp.abs(p1y)),
                          jnp.abs(p2y))
    max_zt0 = jnp.maximum(jnp.maximum(jnp.abs(p0t[..., 2]),
                                      jnp.abs(p1t[..., 2])),
                          jnp.abs(p2t[..., 2]))
    dx0 = _GAMMA5 * (max_xt0 + max_zt0)
    dy0 = _GAMMA5 * (max_yt0 + max_zt0)
    de = 2.0 * (_GAMMA2 * max_xt0 * max_yt0
                + dy0 * max_xt0 + dx0 * max_yt0)
    mixed_sign = (((e0 < -de) | (e1 < -de) | (e2 < -de))
                  & ((e0 > de) | (e1 > de) | (e2 > de)))
    det = e0 + e1 + e2

    p0z = p0t[..., 2] * sz
    p1z = p1t[..., 2] * sz
    p2z = p2t[..., 2] * sz
    t_scaled = e0 * p0z + e1 * p1z + e2 * p2z

    bad_neg = (det < 0) & ((t_scaled >= 0) | (t_scaled < t_far * det))
    bad_pos = (det > 0) & ((t_scaled <= 0) | (t_scaled > t_far * det))

    inv_det = 1.0 / det
    b0 = e0 * inv_det
    b1 = e1 * inv_det
    b2 = e2 * inv_det
    t = t_scaled * inv_det

    # Conservative error bound on t (PBRT 3.9.6):
    max_zt = jnp.maximum(jnp.maximum(jnp.abs(p0z), jnp.abs(p1z)), jnp.abs(p2z))
    max_xt = jnp.maximum(jnp.maximum(jnp.abs(p0x), jnp.abs(p1x)), jnp.abs(p2x))
    max_yt = jnp.maximum(jnp.maximum(jnp.abs(p0y), jnp.abs(p1y)), jnp.abs(p2y))
    delta_z = _GAMMA3 * max_zt
    delta_x = _GAMMA5 * (max_xt + max_zt)
    delta_y = _GAMMA5 * (max_yt + max_zt)
    delta_e = 2.0 * (_GAMMA2 * max_xt * max_yt + delta_y * max_xt + delta_x * max_yt)
    max_e = jnp.maximum(jnp.maximum(jnp.abs(e0), jnp.abs(e1)), jnp.abs(e2))
    delta_t = 3.0 * (_GAMMA3 * max_e * max_zt + delta_e * max_zt + delta_z * max_e) * jnp.abs(inv_det)

    miss = mixed_sign | (det == 0) | bad_neg | bad_pos | (t <= delta_t)
    t = jnp.where(miss, 0.0, t)
    return TriangleHit(t=t, b0=b0, b1=b1, b2=b2)


def intersect_sphere(origin, direction, t_min, centre, radius2):
    """Geometric ray/sphere test; returns t (0 on miss).

    Behavioural contract of ref src/Primitives.cpp:24-46 (including its
    use of 1/|d|^2 scaling — exact for the normalised directions all
    renderers produce)."""
    f = centre - origin
    rd2 = 1.0 / jnp.sum(direction * direction, axis=-1)
    tca = jnp.sum(f * direction, axis=-1) * rd2
    l = f - direction * tca[..., None]
    l2 = jnp.sum(l * l, axis=-1)
    td = jnp.sqrt(jnp.maximum(radius2 - l2, 0.0)) * rd2
    t0 = tca - td
    t1 = tca + td
    t = jnp.where(t0 < t_min, t1, t0)
    miss = (tca < 0.0) | (l2 > radius2) | (t < t_min)
    return jnp.where(miss, 0.0, t)


def intersect_disc(origin, direction, normal, centre, radius2):
    """Ray/disc test; returns t (0 on miss).

    Behavioural contract of ref src/Primitives.cpp:48-67, including its
    plane-offset convention d = |c.n| (valid for scenes with c.n <= 0,
    which all built-in scenes satisfy)."""
    angle = jnp.sum(normal * direction, axis=-1)
    d_off = jnp.abs(jnp.sum(centre * normal, axis=-1))
    t = -(jnp.sum(normal * origin, axis=-1) + d_off) / angle
    hit_p = origin + direction * t[..., None]
    dd = hit_p - centre
    d2 = jnp.sum(dd * dd, axis=-1)
    ok = (angle != 0.0) & (t > MACHINE_EPSILON) & (d2 < radius2)
    return jnp.where(ok, t, 0.0)
