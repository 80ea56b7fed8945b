"""Host-side binned-SAH BVH builder (numpy, with a C++ fast path).

This is the counterpart of the driver's PREFER_FAST_TRACE BLAS build
(reference: vk_blas_builder.rs:88-170): run once per model at upload time, it
trades build time for traversal quality. Geometry that changes per frame goes
through the jittable LBVH (lbvh.py) instead — the analogue of the reference's
destroy-and-rebuild-every-frame TLAS (vk_tlas_builder.rs:43-46).

Output is the unified skip-link FlatBVH in depth-first order (good locality
for the traversal kernels).
"""
from __future__ import annotations

import numpy as np

from .flat import FlatBVH

_N_BINS = 16


def build_bvh_sah(aabb_min: np.ndarray, aabb_max: np.ndarray,
                  max_leaf_size: int = 4) -> FlatBVH:
    """Binned-SAH top-down build over item AABBs.

    Uses the C++ builder from tpurt.native when available, else numpy.
    """
    bvh = None
    try:
        from ..native import native_build_sah

        out = native_build_sah(aabb_min, aabb_max, max_leaf_size)
        if out is not None:
            bvh = FlatBVH(**out)
    except Exception:
        pass
    if bvh is None:
        bvh = _build_numpy(aabb_min, aabb_max, max_leaf_size)
    return bvh


def _build_numpy(aabb_min, aabb_max, max_leaf_size):
    amin = np.asarray(aabb_min, np.float32).reshape(-1, 3)
    amax = np.asarray(aabb_max, np.float32).reshape(-1, 3)
    n = len(amin)
    centroids = (amin + amax) * 0.5

    node_min, node_max = [], []
    entry, skip, first_tri, tri_count = [], [], [], []
    order = np.arange(n, dtype=np.int32)

    # Iterative DFS; each stack record: (item index slice into `order`,)
    # Children are emitted immediately after their parent (entry = parent+1).
    def emit_node(lo, hi):
        idx = len(node_min)
        items = order[lo:hi]
        node_min.append(amin[items].min(axis=0))
        node_max.append(amax[items].max(axis=0))
        entry.append(-1)
        skip.append(-1)
        first_tri.append(-1)
        tri_count.append(0)
        return idx

    subtree_end = []

    def build(lo, hi):
        node = emit_node(lo, hi)
        subtree_end.append(0)
        count = hi - lo
        if count <= max_leaf_size:
            first_tri[node] = lo
            tri_count[node] = count
        else:
            items = order[lo:hi]
            c = centroids[items]
            ext = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(ext))
            split = None
            if ext[axis] > 1e-12:
                split = _binned_sah_split(amin[items], amax[items], c, axis)
            if split is None:
                # fall back to median split on the widest axis
                key = np.argsort(c[:, axis], kind="stable")
                order[lo:hi] = items[key]
                mid = lo + count // 2
            else:
                mask = split
                order[lo:hi] = np.concatenate([items[mask], items[~mask]])
                mid = lo + int(mask.sum())
                if mid == lo or mid == hi:
                    key = np.argsort(c[:, axis], kind="stable")
                    order[lo:hi] = items[key]
                    mid = lo + count // 2
            entry[node] = len(node_min)
            build(lo, mid)
            build(mid, hi)
        # In DFS layout the skip target is the first node after the subtree.
        subtree_end[node] = len(node_min)
        return node

    import sys
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * int(np.ceil(np.log2(max(n, 2)))) + 1000))
    try:
        build(0, n)
    finally:
        sys.setrecursionlimit(old_limit)

    m = len(node_min)
    entry = np.asarray(entry, np.int32)
    tri_count = np.asarray(tri_count, np.int32)
    subtree_end = np.asarray(subtree_end, np.int64)
    skip = np.where(subtree_end == m, -1, subtree_end).astype(np.int32)

    return FlatBVH(
        aabb_min=np.asarray(node_min, np.float32),
        aabb_max=np.asarray(node_max, np.float32),
        entry=entry,
        skip=skip,
        first_tri=np.asarray(first_tri, np.int32),
        tri_count=tri_count,
        tri_order=order,
    )


def _binned_sah_split(amin, amax, centroids, axis):
    """Return a boolean mask (left partition) for the best SAH binned split,
    or None if no split beats keeping the node whole."""
    c = centroids[:, axis]
    lo, hi = c.min(), c.max()
    if hi - lo < 1e-12:
        return None
    bins = np.clip(((c - lo) / (hi - lo) * _N_BINS).astype(np.int32), 0, _N_BINS - 1)

    bin_min = np.full((_N_BINS, 3), np.inf, np.float32)
    bin_max = np.full((_N_BINS, 3), -np.inf, np.float32)
    bin_cnt = np.zeros(_N_BINS, np.int64)
    for b in range(_N_BINS):
        m = bins == b
        if m.any():
            bin_min[b] = amin[m].min(axis=0)
            bin_max[b] = amax[m].max(axis=0)
            bin_cnt[b] = m.sum()

    def area(mn, mx):
        d = np.maximum(mx - mn, 0)
        return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]

    # prefix/suffix sweeps
    lmin = np.minimum.accumulate(bin_min, axis=0)
    lmax = np.maximum.accumulate(bin_max, axis=0)
    lcnt = np.cumsum(bin_cnt)
    rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
    rcnt = np.cumsum(bin_cnt[::-1])[::-1]

    costs = np.full(_N_BINS - 1, np.inf)
    for s in range(_N_BINS - 1):
        if lcnt[s] == 0 or rcnt[s + 1] == 0:
            continue
        costs[s] = (area(lmin[s], lmax[s]) * lcnt[s]
                    + area(rmin[s + 1], rmax[s + 1]) * rcnt[s + 1])
    best = int(np.argmin(costs))
    if not np.isfinite(costs[best]):
        return None
    return bins <= best
