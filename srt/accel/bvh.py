"""Host-side BVH build -> flattened stackless device layout.

The reference builds a pointer tree with random-axis median splits via qsort
(``Raytracing_n/bvh.h:21-55,96-119``) and traverses it recursively. Neither
pointers nor recursion map to a wavefront of vector lanes, so:

* Build happens on the host in numpy (scene build time, once) using a binned
  SAH sweep — better trees than the reference's random-axis median, which
  matters because traversal steps are the device hot loop.
* The tree is flattened in depth-first order with *skip links*: on an AABB hit
  the ray advances to ``i+1`` (the first child), on a miss it jumps to
  ``skip[i]`` (the node after the subtree). Leaves reference a contiguous
  triangle range (triangles are reordered at build). Traversal on device is a
  uniform ``lax.while_loop`` over per-ray node cursors — two gathers and one
  slab test per step, no stack, no recursion, bounded iteration.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FlatBVH(NamedTuple):
    lo: np.ndarray     # (B, 3) f32 node AABB min
    hi: np.ndarray     # (B, 3) f32 node AABB max
    skip: np.ndarray   # (B,) i32 node to jump to on miss / after leaf
    first: np.ndarray  # (B,) i32 first triangle index (leaves), -1 internal
    count: np.ndarray  # (B,) i32 leaf triangle count, 0 for internal


_N_BINS = 16


def build_bvh(tri_verts: np.ndarray, leaf_size: int = 4) -> tuple[FlatBVH, np.ndarray]:
    """Build a flattened BVH over triangles ``(T, 3, 3)``.

    Returns ``(flat_bvh, order)`` where ``order`` is the permutation applied
    to the triangles (callers must reorder per-triangle attributes).

    Dispatches to the native C++ builder (srt/native/bvh_builder.cpp,
    same algorithm and layout, ~100x faster on mesh-scale inputs) and falls
    back to the numpy implementation below when the native library is
    unavailable (``SRT_NO_NATIVE=1`` or no compiler).
    """
    t = len(tri_verts)
    if t == 0:
        empty = FlatBVH(lo=np.zeros((0, 3), np.float32),
                        hi=np.zeros((0, 3), np.float32),
                        skip=np.zeros((0,), np.int32),
                        first=np.zeros((0,), np.int32),
                        count=np.zeros((0,), np.int32))
        return empty, np.zeros((0,), np.int64)

    native = _build_bvh_native(tri_verts, leaf_size)
    if native is not None:
        return native

    lo_t = tri_verts.min(axis=1)          # (T, 3)
    hi_t = tri_verts.max(axis=1)
    centroid = 0.5 * (lo_t + hi_t)

    # Nodes are appended in DFS order, so each node's skip link is simply the
    # node index right after its subtree — recorded when the subtree closes.
    nodes_lo, nodes_hi, nodes_first, nodes_count = [], [], [], []
    spans: list[int] = []  # per node: index of the node after its subtree
    order: list[np.ndarray] = []
    n_emitted = 0  # triangles written so far

    import sys
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100000))

    def emit(idx: np.ndarray) -> int:
        """Build subtree over triangle ids ``idx``; return node id."""
        nonlocal n_emitted
        node = len(nodes_lo)
        nodes_lo.append(lo_t[idx].min(axis=0))
        nodes_hi.append(hi_t[idx].max(axis=0))
        nodes_first.append(-1)
        nodes_count.append(0)
        spans.append(-1)

        if len(idx) <= leaf_size:
            nodes_first[node] = n_emitted
            nodes_count[node] = len(idx)
            order.append(idx)
            n_emitted += len(idx)
            spans[node] = node + 1
            return node

        left_idx, right_idx = _split_sah(idx, lo_t, hi_t, centroid, leaf_size)
        emit(left_idx)
        emit(right_idx)
        spans[node] = len(nodes_lo)
        return node

    emit(np.arange(t))

    return FlatBVH(
        lo=np.asarray(nodes_lo, np.float32),
        hi=np.asarray(nodes_hi, np.float32),
        skip=np.asarray(spans, np.int32),
        first=np.asarray(nodes_first, np.int32),
        count=np.asarray(nodes_count, np.int32),
    ), np.concatenate(order)


def _build_bvh_native(tri_verts: np.ndarray, leaf_size: int):
    """C++ builder via ctypes; None when the native lib is unavailable."""
    from srt.native import get_lib
    import ctypes

    lib = get_lib()
    if lib is None:
        return None
    t = len(tri_verts)
    verts = np.ascontiguousarray(tri_verts, np.float32)
    cap = 2 * t  # <= 2T-1 nodes for a binary tree with >=1 tri per leaf
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    skip = np.empty((cap,), np.int32)
    first = np.empty((cap,), np.int32)
    count = np.empty((cap,), np.int32)
    order = np.empty((t,), np.int64)

    def ptr(a, ty):
        return a.ctypes.data_as(ctypes.POINTER(ty))

    n = lib.srt_build_bvh(
        ptr(verts, ctypes.c_float), ctypes.c_int64(t),
        ctypes.c_int(leaf_size),
        ptr(lo, ctypes.c_float), ptr(hi, ctypes.c_float),
        ptr(skip, ctypes.c_int32), ptr(first, ctypes.c_int32),
        ptr(count, ctypes.c_int32), ptr(order, ctypes.c_int64))
    if n < 0:
        return None
    return FlatBVH(lo=lo[:n].copy(), hi=hi[:n].copy(), skip=skip[:n].copy(),
                   first=first[:n].copy(), count=count[:n].copy()), order


def _split_sah(idx, lo_t, hi_t, centroid, leaf_size):
    """Binned SAH split; falls back to median when SAH degenerates."""
    c = centroid[idx]
    cmin, cmax = c.min(axis=0), c.max(axis=0)
    extent = cmax - cmin
    axis = int(np.argmax(extent))
    if extent[axis] <= 1e-12:
        half = len(idx) // 2
        return idx[:half], idx[half:]

    # Bin centroids along the chosen axis.
    rel = (c[:, axis] - cmin[axis]) / extent[axis]
    bins = np.minimum((rel * _N_BINS).astype(np.int64), _N_BINS - 1)

    best_cost, best_bin = np.inf, -1
    # Prefix/suffix AABB areas per bin boundary.
    bin_lo = np.full((_N_BINS, 3), np.inf)
    bin_hi = np.full((_N_BINS, 3), -np.inf)
    bin_n = np.zeros(_N_BINS, np.int64)
    for b in range(_N_BINS):
        mask = bins == b
        if mask.any():
            bin_lo[b] = lo_t[idx[mask]].min(axis=0)
            bin_hi[b] = hi_t[idx[mask]].max(axis=0)
            bin_n[b] = mask.sum()

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    pre_lo = np.minimum.accumulate(bin_lo, axis=0)
    pre_hi = np.maximum.accumulate(bin_hi, axis=0)
    pre_n = np.cumsum(bin_n)
    suf_lo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1]
    suf_hi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1]
    suf_n = np.cumsum(bin_n[::-1])[::-1]

    for b in range(_N_BINS - 1):
        nl, nr = pre_n[b], suf_n[b + 1]
        if nl == 0 or nr == 0:
            continue
        cost = nl * area(pre_lo[b], pre_hi[b]) + nr * area(suf_lo[b + 1], suf_hi[b + 1])
        if cost < best_cost:
            best_cost, best_bin = cost, b

    if best_bin < 0:
        half = len(idx) // 2
        o = np.argsort(c[:, axis], kind="stable")
        return idx[o[:half]], idx[o[half:]]

    left_mask = bins <= best_bin
    return idx[left_mask], idx[~left_mask]
