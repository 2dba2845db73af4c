"""Shadow-trace integrator (validation renderer).

The wavefront equivalent of the reference's ShadowTrace vertex /
traceShadowRay (ref: codelets/TraceCodelets.cpp:269-316,
include/Render.hpp:37-72): primary closest-hit, then one occlusion ray to
a fixed point light; lambertian + ambient shading. Produces the full AOV
set used for cross-renderer parity checks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..bvh.builder import INVALID_GEOM_ID
from ..ops.bxdf import offset_ray_origin
from ..ops.traversal import scene_intersect_with_normal, scene_occluded
from ..scene.build import SceneArrays

DEFAULT_LIGHT_POS = (18.0, 257.0, -1060.0)  # ref trace.cpp:247
DEFAULT_AMBIENT = 0.05                       # ref trace.cpp:253


class TraceResultSoA(NamedTuple):
    """SoA analogue of the reference's TraceResult stream
    (ref geometry.hpp:254-260)."""

    rgb: jnp.ndarray      # [R,3]
    t: jnp.ndarray        # [R] tfar after hit update (inf if escaped)
    geom_id: jnp.ndarray  # [R] i32
    prim_id: jnp.ndarray  # [R] i32
    normal: jnp.ndarray   # [R,3]
    hit_p: jnp.ndarray    # [R,3]
    escaped: jnp.ndarray  # [R] bool


def shadow_trace(
    scene: SceneArrays,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    light_pos=DEFAULT_LIGHT_POS,
    ambient: float = DEFAULT_AMBIENT,
    intersector: str = "bvh",
) -> TraceResultSoA:
    inf = jnp.float32(jnp.inf)
    zero = jnp.float32(0.0)
    R = origins.shape[0]
    t_min = jnp.zeros(R, jnp.float32)
    t_max = jnp.full(R, inf)

    hit, normal = scene_intersect_with_normal(
        scene, origins, dirs, t_min, t_max, intersector
    )
    found = hit.found
    hit_p = origins + dirs * jnp.where(found, hit.t, zero)[..., None]

    light = jnp.asarray(light_pos, jnp.float32)
    light_offset = light[None, :] - hit_p
    dist = jnp.sqrt(jnp.sum(light_offset * light_offset, axis=-1))
    sdir = light_offset / jnp.maximum(dist[..., None], jnp.float32(1e-30))
    sorig = offset_ray_origin(hit_p, sdir, normal)

    occ = scene_occluded(scene, sorig, sdir, t_min, dist, intersector)

    g_safe = jnp.clip(hit.geom_id, 0, scene.mat_id.shape[0] - 1)
    albedo = scene.mat_albedo[scene.mat_id[g_safe]]
    lambert = jnp.sum(sdir * normal, axis=-1)
    rgb = albedo * ambient + jnp.where(occ, zero, lambert)[..., None] * albedo
    rgb = jnp.where(found[..., None], rgb, zero)

    return TraceResultSoA(
        rgb=rgb,
        t=jnp.where(found, hit.t, inf),
        geom_id=jnp.where(found, hit.geom_id, INVALID_GEOM_ID),
        prim_id=hit.prim_id,
        normal=normal,
        hit_p=jnp.where(found[..., None], hit_p, zero),
        escaped=~found,
    )
