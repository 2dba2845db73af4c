"""ctypes bindings to the native C++ binned-SAH builder.

The native builder (csrc/bvh_builder.cpp) implements the identical
algorithm and node encoding as :func:`ipu_ray_lib_tpu.bvh.builder.build_bvh_python`
but runs orders of magnitude faster on large scenes. It is built from
the committed sources with the system toolchain (``make -C csrc``) at
first use in each process; make rebuilds the library whenever a source
is newer, so a stale library is never loaded. If it cannot be built,
callers fall back to the Python builder (:func:`native_available` says
which one runs).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB_NAME = "_native_bvh.so"
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        here = os.path.dirname(__file__)
        so = os.path.join(here, _LIB_NAME)
        csrc = os.path.join(here, "..", "..", "csrc")
        if os.path.isdir(csrc):
            try:
                subprocess.run(
                    ["make", "-C", csrc], check=True,
                    stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                )
            except (OSError, subprocess.CalledProcessError):
                return None
        if not os.path.exists(so):
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        fn = lib.bvh_build_compact
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # prim_lo
            ctypes.POINTER(ctypes.c_float),   # prim_hi
            ctypes.POINTER(ctypes.c_int32),   # geom_ids
            ctypes.POINTER(ctypes.c_int32),   # prim_ids
            ctypes.c_int64,                   # n
            ctypes.c_int32,                   # max_leaf_size
            ctypes.POINTER(ctypes.c_float),   # out mins
            ctypes.POINTER(ctypes.c_uint16),  # out exts (f16 bits)
            ctypes.POINTER(ctypes.c_int32),   # out meta
            ctypes.POINTER(ctypes.c_int32),   # out geom
            ctypes.POINTER(ctypes.c_int32),   # out miss
            ctypes.POINTER(ctypes.c_int32),   # out num nodes
            ctypes.POINTER(ctypes.c_int32),   # out max depth
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native builder loads (building it if needed)."""
    return _load() is not None


def build_bvh_native(prim_lo, prim_hi, geom_ids, prim_ids, max_leaf_size=1):
    """Native build; returns a CompactBvh or None if unavailable."""
    from .builder import CompactBvh

    lib = _load()
    if lib is None:
        return None

    prim_lo = np.ascontiguousarray(prim_lo, np.float32).reshape(-1, 3)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32).reshape(-1, 3)
    geom_ids = np.ascontiguousarray(geom_ids, np.int32)
    prim_ids = np.ascontiguousarray(prim_ids, np.int32)
    n = len(prim_lo)
    cap = 2 * n  # worst case: n leaves + (n-1) inner
    mins = np.empty((cap, 3), np.float32)
    exts = np.empty((cap, 3), np.uint16)
    meta = np.empty(cap, np.int32)
    geom = np.empty(cap, np.int32)
    miss = np.empty(cap, np.int32)
    num_nodes = ctypes.c_int32(0)
    max_depth = ctypes.c_int32(0)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.bvh_build_compact(
        ptr(prim_lo, ctypes.c_float), ptr(prim_hi, ctypes.c_float),
        ptr(geom_ids, ctypes.c_int32), ptr(prim_ids, ctypes.c_int32),
        ctypes.c_int64(n), ctypes.c_int32(max_leaf_size),
        ptr(mins, ctypes.c_float), ptr(exts, ctypes.c_uint16),
        ptr(meta, ctypes.c_int32), ptr(geom, ctypes.c_int32),
        ptr(miss, ctypes.c_int32),
        ctypes.byref(num_nodes), ctypes.byref(max_depth),
    )
    if rc == -2:
        raise ValueError("Cannot compress BVH bounds into fp16 (half)")
    if rc != 0:
        return None
    m = num_nodes.value
    # Views, not copies: at leaf=1 the node count is 2n-1 of the 2n
    # capacity, so slicing retains ~nothing extra and the copies were
    # measurably slow (~20 s at 2M tris, cold pages):
    return CompactBvh(
        mins=mins[:m],
        exts=exts[:m].view(np.float16),
        meta=meta[:m],
        geom=geom[:m],
        miss=miss[:m],
        max_depth=max_depth.value,
    )
