"""Compiled-scene caching: save/load SceneArrays + params as one bundle.

Role of the reference's executable/save-load pathway applied to scenes:
expensive host-side work (imports, BVH build) is done once and persisted
via :mod:`.serial`; loads rebuild the device pytree directly. The
derived dense intersector tables are a deterministic precompute and are
regenerated on load.
"""

from __future__ import annotations

import dataclasses

import numpy as np

import jax.numpy as jnp

from ..bvh.builder import CompactBvh
from .build import SceneArrays, SceneParams
from .serial import load_scene_bundle, save_scene_bundle

_ARRAY_FIELDS = [
    "tri_v", "verts", "normals", "mesh_first_tri", "mesh_has_normals",
    "spheres", "discs", "geom_type", "geom_index", "mat_id",
    "mat_albedo", "mat_emission", "mat_ior", "mat_type", "mat_emissive",
    "sphere_geom", "disc_geom",
]


def save_compiled_scene(path: str, arrays: SceneArrays, params: SceneParams,
                        bvh: CompactBvh) -> None:
    host = {name: np.asarray(getattr(arrays, name)) for name in _ARRAY_FIELDS}
    meta = dataclasses.asdict(params)
    save_scene_bundle(path, bvh=bvh, arrays_host=host, meta=meta)


def load_compiled_scene(path: str):
    """Returns (SceneArrays, SceneParams, CompactBvh)."""
    from ..ops.dense import build_dense_tables

    bvh, host, meta = load_scene_bundle(path)
    params = SceneParams(**meta)  # keys align with dataclasses.asdict(params)

    tri_v = host["tri_v"]
    verts = host["verts"]
    # Recover per-triangle geom/prim maps from the BVH leaves is lossy for
    # padded rows; rebuild from mesh_first_tri instead:
    mft = host["mesh_first_tri"][: params.num_meshes]
    T = len(tri_v)
    tri_geom = np.zeros(T, np.int32)
    tri_prim = np.zeros(T, np.int32)
    bounds = list(mft.astype(np.int64)) + [T]
    for g in range(params.num_meshes):
        sl = slice(bounds[g], bounds[g + 1])
        tri_geom[sl] = g
        tri_prim[sl] = np.arange(sl.stop - sl.start, dtype=np.int32)

    from .build import DENSE_TABLE_MAX_TRIS

    dense = (
        build_dense_tables(tri_v, verts, tri_geom, tri_prim)
        if (T <= DENSE_TABLE_MAX_TRIS or params.intersector == "dense")
        else None)  # same skip rule as build_scene (host-build time)
    arrays = SceneArrays(
        bvh_min=jnp.asarray(bvh.mins),
        bvh_ext=jnp.asarray(bvh.exts),
        bvh_meta=jnp.asarray(bvh.meta),
        bvh_geom=jnp.asarray(bvh.geom),
        bvh_miss=jnp.asarray(bvh.miss),
        dense=dense,
        **{name: jnp.asarray(host[name]) for name in _ARRAY_FIELDS},
    )
    return arrays, params, bvh
