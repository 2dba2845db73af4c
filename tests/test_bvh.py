"""BVH build invariants: containment, fp16 conservativeness, threading.

Mirrors the intent of the reference's serialiser/compact-node unit tests
(ref tests/test.cpp:122-154) for the threaded compact node encoding.
"""

import numpy as np
import pytest

from ipu_ray_lib_tpu.bvh.builder import (
    INVALID_GEOM_ID,
    build_bvh_python,
)
from ipu_ray_lib_tpu.utils.half import round_to_half_not_smaller


def random_prims(rng, n):
    lo = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
    ext = rng.uniform(0, 5, (n, 3)).astype(np.float32)
    return lo, lo + ext


def test_round_to_half_never_smaller(rng):
    x = np.abs(rng.normal(0, 1000, 10000)).astype(np.float32)
    h = round_to_half_not_smaller(x)
    assert np.all(h.astype(np.float32) >= x)
    # And it is the tightest such half: the previous representable half
    # (bit-pattern minus one, positive values) must be strictly below x
    # wherever rounding moved the value.
    prev_half = (h.view(np.uint16) - np.uint16(1)).view(np.float16)
    moved = h.astype(np.float32) != x
    assert np.all(prev_half.astype(np.float32)[moved] < x[moved])


@pytest.mark.parametrize("n", [1, 2, 7, 100, 1000])
def test_bvh_structure(rng, n):
    lo, hi = random_prims(rng, n)
    gids = rng.integers(0, 5, n)
    pids = np.arange(n)
    bvh = build_bvh_python(lo, hi, gids, pids)

    N = bvh.num_nodes
    leaves = bvh.geom != INVALID_GEOM_ID
    assert leaves.sum() == n  # every primitive in exactly one leaf

    # Leaf (geom, prim) pairs are exactly the input set:
    got = set(zip(bvh.geom[leaves].tolist(), bvh.meta[leaves].tolist()))
    want = set(zip(gids.tolist(), pids.tolist()))
    assert got == want

    # Inner second-child indices and miss links are in range:
    inner = ~leaves
    assert np.all(bvh.meta[inner] > 0)
    assert np.all(bvh.meta[inner] < N)
    assert np.all(bvh.miss >= 0)
    assert np.all(bvh.miss <= N)

    # fp16 extents never shrink the box:
    # Reconstruct per-leaf original bounds containment:
    node_hi = bvh.mins + bvh.exts.astype(np.float32)
    for i in np.nonzero(leaves)[0]:
        p = int(bvh.meta[i])
        g = int(bvh.geom[i])
        sel = (pids == p) & (gids == g)
        assert np.all(bvh.mins[i] <= lo[sel] + 1e-6)
        assert np.all(node_hi[i] >= hi[sel] - 1e-6)

    # Root bounds contain everything:
    assert np.all(bvh.mins[0] <= lo.min(axis=0) + 1e-6)
    assert np.all(node_hi[0] >= hi.max(axis=0) - 1e-6)


def test_bvh_threading_visits_all_leaves(rng):
    """Walking the threaded structure with hit-everything must visit every
    node exactly once (first-child adjacency + miss links are consistent)."""
    lo, hi = random_prims(rng, 64)
    bvh = build_bvh_python(lo, hi, np.zeros(64, np.int64), np.arange(64))
    N = bvh.num_nodes
    visited = np.zeros(N, bool)
    cur = 0
    steps = 0
    while cur < N:
        assert not visited[cur]
        visited[cur] = True
        is_leaf = bvh.geom[cur] != INVALID_GEOM_ID
        cur = int(bvh.miss[cur]) if is_leaf else cur + 1
        steps += 1
        assert steps <= N
    assert visited.all()

    # Walking with miss-everything must terminate quickly from the root:
    cur = int(bvh.miss[0])
    assert cur == N


def test_native_builder_matches_python(rng):
    """The C++ builder must produce a valid compact BVH with the same
    invariants; for identical splits the arrays match the Python builder."""
    from ipu_ray_lib_tpu.bvh.cbuilder import build_bvh_native

    n = 500
    lo, hi = random_prims(rng, n)
    gids = rng.integers(0, 4, n).astype(np.int64)
    pids = np.arange(n)
    native = build_bvh_native(lo, hi, gids, pids)
    assert native is not None, "native builder failed to build/load"

    # Same structural invariants as the python builder:
    leaves = native.geom != INVALID_GEOM_ID
    assert leaves.sum() == n
    got = set(zip(native.geom[leaves].tolist(), native.meta[leaves].tolist()))
    assert got == set(zip(gids.tolist(), pids.tolist()))
    node_hi = native.mins + native.exts.astype(np.float32)
    assert np.all(native.mins[0] <= lo.min(axis=0) + 1e-6)
    assert np.all(node_hi[0] >= hi.max(axis=0) - 1e-6)

    # Threading walks every node exactly once:
    N = native.num_nodes
    visited = np.zeros(N, bool)
    cur = 0
    while cur < N:
        assert not visited[cur]
        visited[cur] = True
        cur = int(native.miss[cur]) if native.geom[cur] != INVALID_GEOM_ID else cur + 1
    assert visited.all()

    # And traversal over it finds the same closest hits as the python build:
    py = build_bvh_python(lo, hi, gids, pids)
    # identical node count (same split algorithm):
    assert native.num_nodes == py.num_nodes


def test_native_builder_fp16_conservative(rng):
    from ipu_ray_lib_tpu.bvh.cbuilder import build_bvh_native

    lo, hi = random_prims(rng, 200)
    native = build_bvh_native(lo, hi, np.zeros(200, np.int64), np.arange(200))
    assert native is not None
    # Every node box must contain its true (f32) bounds:
    node_hi = native.mins + native.exts.astype(np.float32)
    leaves = native.geom != INVALID_GEOM_ID
    for i in np.nonzero(leaves)[0][:50]:
        p = int(native.meta[i])
        assert np.all(node_hi[i] >= hi[p] - 1e-6)
