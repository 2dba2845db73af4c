"""Wavefront path-trace integrator (one sample per ray).

Wavefront redesign of the reference's PathTrace codelet
(ref: codelets/TraceCodelets.cpp:170-264): instead of a divergent per-ray
bounce loop, all rays advance together through a ``lax.while_loop`` over
bounces with masked lanes. Per bounce: self-intersection offset, BVH
closest hit, emissive accumulation, masked-select material sampling
(diffuse / specular / dielectric), Russian roulette after the configured
depth. Escaped rays record their direction and throughput so an
environment light (NIF) can be applied afterwards in one batched matmul pass
(the wavefront analogue of the reference's PreProcess/PostProcessEscapedRays
vertices, TraceCodelets.cpp:321-382).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.bxdf import (
    dielectric,
    evaluate_roulette,
    offset_ray_origin,
    reflect,
    sample_diffuse,
)
from ..ops.traversal import scene_intersect_with_normal
from ..scene.build import SceneArrays

MAT_DIFFUSE = 0
MAT_SPECULAR = 1
MAT_REFRACTIVE = 2


def _sort_key(scene, o, d, active):
    """Coherence key for wavefront ray sorting: direction octant (3 bits)
    + 12-bit Morton cell of the origin within the scene bounds. Dead rays
    sort to the back so active lanes stay contiguous (stream compaction +
    binning in one permutation)."""
    root_lo = scene.bvh_min[0]
    root_ext = jnp.maximum(scene.bvh_ext[0].astype(jnp.float32), 1e-6)
    q = jnp.clip((o - root_lo) / root_ext * 16.0, 0.0, 15.0).astype(jnp.int32)

    def spread4(v):
        v = (v | (v << 8)) & 0xF00F
        v = (v | (v << 4)) & 0xC3C3
        v = (v | (v << 2)) & 0x9249
        return v

    morton = spread4(q[..., 0]) | (spread4(q[..., 1]) << 1) | (spread4(q[..., 2]) << 2)
    octant = (
        (d[..., 0] > 0).astype(jnp.int32)
        + 2 * (d[..., 1] > 0).astype(jnp.int32)
        + 4 * (d[..., 2] > 0).astype(jnp.int32)
    )
    key = octant * 4096 + morton
    return jnp.where(active, key, jnp.int32(0x7FFFFFFF))


class SampleResult(NamedTuple):
    rgb: jnp.ndarray            # [R,3] radiance for this sample (env light NOT applied)
    esc_dir: jnp.ndarray        # [R,3] direction at escape (zeros if none)
    esc_throughput: jnp.ndarray # [R,3] throughput at escape
    escaped: jnp.ndarray        # [R] bool
    error: jnp.ndarray          # [R] bool (unknown material type)


def path_trace_sample(
    scene: SceneArrays,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    key: jax.Array,
    max_path_length: int,
    roulette_start_depth: int,
    intersector: str = "bvh",
    sort_rays: int = 0,
) -> SampleResult:
    R = origins.shape[0]
    f32 = jnp.float32
    zero3 = jnp.zeros((R, 3), f32)
    init_normal = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], f32), (R, 3))

    state = dict(
        i=jnp.int32(0),
        o=origins,
        d=dirs,
        n=init_normal,
        throughput=jnp.ones((R, 3), f32),
        color=zero3,
        active=jnp.ones(R, bool),
        esc_dir=zero3,
        esc_tp=zero3,
        escaped=jnp.zeros(R, bool),
        error=jnp.zeros(R, bool),
        # Original lane index each ray came from (identity when not
        # sorting): results are scattered back through this at the end.
        pix=jnp.arange(R, dtype=jnp.int32),
    )

    t_min = jnp.zeros(R, f32)

    def cond(s):
        return (s["i"] < max_path_length) & jnp.any(s["active"])

    def body(s):
        i = s["i"]
        active = s["active"]
        # Offset ray start away from the previous surface:
        o = offset_ray_origin(s["o"], s["d"], s["n"])
        d = s["d"]

        # Dead lanes get t_max = -1: every intersector then culls them
        # for free (slab/dense tests can never satisfy t < t_max):
        t_max = jnp.where(active, jnp.float32(jnp.inf), jnp.float32(-1.0))
        hit, hit_n = scene_intersect_with_normal(scene, o, d, t_min, t_max, intersector)
        found = hit.found

        newly_escaped = active & ~found
        esc_dir = jnp.where(newly_escaped[..., None], d, s["esc_dir"])
        esc_tp = jnp.where(newly_escaped[..., None], s["throughput"], s["esc_tp"])
        escaped = s["escaped"] | newly_escaped

        live = active & found
        n = jnp.where(live[..., None], hit_n, s["n"])
        o = jnp.where(live[..., None], o + d * hit.t[..., None], o)

        g_safe = jnp.clip(hit.geom_id, 0, scene.mat_id.shape[0] - 1)
        mid = scene.mat_id[g_safe]
        albedo = scene.mat_albedo[mid]
        emission = scene.mat_emission[mid]
        emissive = scene.mat_emissive[mid] != 0
        ior = scene.mat_ior[mid]
        mtype = scene.mat_type[mid]

        color = s["color"] + jnp.where(
            (live & emissive)[..., None], s["throughput"] * emission, 0.0
        )

        u = jax.random.uniform(jax.random.fold_in(key, i), (4, R), dtype=f32)
        d_diffuse = sample_diffuse(n, u[0], u[1])
        d_specular = reflect(d, n)
        d_dielec, refracted = dielectric(d, n, ior, u[2])

        is_diff = mtype == MAT_DIFFUSE
        is_spec = mtype == MAT_SPECULAR
        is_refr = mtype == MAT_REFRACTIVE
        new_d = jnp.where(
            is_diff[..., None],
            d_diffuse,
            jnp.where(is_spec[..., None], d_specular, d_dielec),
        )
        scale_tp = is_diff | is_spec | (is_refr & refracted)
        tp = s["throughput"] * jnp.where(scale_tp[..., None], albedo, 1.0)
        error = s["error"] | (live & ~(is_diff | is_spec | is_refr))

        d = jnp.where(live[..., None], new_d, d)
        tp = jnp.where(live[..., None], tp, s["throughput"])

        # Russian roulette (enabled strictly after roulette_start_depth):
        stop, tp_r = evaluate_roulette(u[3], tp)
        use_roulette = i > roulette_start_depth
        tp = jnp.where((use_roulette & live)[..., None], tp_r, tp)
        live = live & jnp.where(use_roulette, ~stop, True)

        out = dict(
            i=i + 1,
            o=o,
            d=d,
            n=n,
            throughput=tp,
            color=color,
            active=live,
            esc_dir=esc_dir,
            esc_tp=esc_tp,
            escaped=escaped,
            error=error,
            pix=s["pix"],
        )
        if sort_rays:
            # Re-bin the wavefront: secondary rays grouped by direction
            # octant and origin cell so ray blocks stay coherent for
            # block-level culling (the SURVEY's "stream compaction" role).
            # sort_rays = k sorts on bounces where i % k == 0 (k=1: every
            # bounce); sort_rays = -1 sorts once after the first bounce —
            # the order largely persists, so one argsort buys coherence
            # for every later bounce.
            def do_sort(vals):
                perm = jnp.argsort(_sort_key(scene, vals["o"], vals["d"], vals["active"]))
                return {k: (v if k == "i" else v[perm]) for k, v in vals.items()}

            if int(sort_rays) == -1:
                pred = i == 0
            else:
                pred = (i % jnp.int32(int(sort_rays))) == 0
            out = jax.lax.cond(pred, do_sort, lambda v: v, out)
        return out

    out = jax.lax.while_loop(cond, body, state)
    if sort_rays:
        # Scatter results back to the caller's lane order:
        pix = out["pix"]

        def unsort(v):
            return jnp.zeros_like(v).at[pix].set(v)

        return SampleResult(
            rgb=unsort(out["color"]),
            esc_dir=unsort(out["esc_dir"]),
            esc_throughput=unsort(out["esc_tp"]),
            escaped=unsort(out["escaped"]),
            error=unsort(out["error"]),
        )
    return SampleResult(
        rgb=out["color"],
        esc_dir=out["esc_dir"],
        esc_throughput=out["esc_tp"],
        escaped=out["escaped"],
        error=out["error"],
    )
