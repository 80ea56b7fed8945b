"""LBVH construction in pure JAX — jittable, static shapes.

This is the per-frame acceleration-structure rebuild path: the
analogue of the reference's destroy-and-rebuild-every-frame TLAS
(vk_tlas_builder.rs:38-233, comment at :43-46 preferring rebuild over update).
It also doubles as a device-side BLAS builder for dynamic geometry.

Pipeline (all O(N log N), fully parallel across lanes):
  1. 30-bit Morton codes over item centroids (10 bits/axis),
  2. radix order via jnp sort (ties broken by index so keys are unique),
  3. Karras 2012 parallel hierarchy emit (binary search per internal node),
  4. bottom-up AABB refit by fixed-point iteration,
  5. skip-link threading (entry/skip arrays) via vectorized parent walks,
so the output is the same FlatBVH consumed by the traversal kernels.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .flat import FlatBVH


def _expand_bits_10(v):
    """Spread the low 10 bits of v to every 3rd bit (u32)."""
    v = v.astype(jnp.uint32)
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton_codes_3d(points, lo, hi):
    """30-bit Morton codes for points normalized into [lo, hi]^3."""
    extent = jnp.maximum(hi - lo, 1e-12)
    p = jnp.clip((points - lo) / extent, 0.0, 1.0)
    q = jnp.minimum((p * 1024.0), 1023.0).astype(jnp.uint32)
    return ((_expand_bits_10(q[..., 0]) << 2)
            | (_expand_bits_10(q[..., 1]) << 1)
            | _expand_bits_10(q[..., 2]))


def _popcount32(x):
    x = x.astype(jnp.uint32)
    x = x - ((x >> 1) & jnp.uint32(0x55555555))
    x = (x & jnp.uint32(0x33333333)) + ((x >> 2) & jnp.uint32(0x33333333))
    x = (x + (x >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((x * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def _clz32(x):
    x = x.astype(jnp.uint32)
    x = x | (x >> 1)
    x = x | (x >> 2)
    x = x | (x >> 4)
    x = x | (x >> 8)
    x = x | (x >> 16)
    return _popcount32(~x)


def build_lbvh(aabb_min, aabb_max) -> FlatBVH:
    """Build a FlatBVH over N item AABBs. Jittable; N must be static.

    Node layout: internal nodes [0, N-2], leaves [N-1, 2N-2] (leaf i holds the
    i-th Morton-sorted item). Root = 0 (or the single leaf when N == 1).
    """
    amin = jnp.asarray(aabb_min, jnp.float32).reshape(-1, 3)
    amax = jnp.asarray(aabb_max, jnp.float32).reshape(-1, 3)
    n = amin.shape[0]
    if n == 1:
        return FlatBVH(
            aabb_min=amin, aabb_max=amax,
            entry=jnp.full((1,), -1, jnp.int32),
            skip=jnp.full((1,), -1, jnp.int32),
            first_tri=jnp.zeros((1,), jnp.int32),
            tri_count=jnp.ones((1,), jnp.int32),
            tri_order=jnp.zeros((1,), jnp.int32),
        )

    centroids = (amin + amax) * 0.5
    scene_lo = jnp.min(amin, axis=0)
    scene_hi = jnp.max(amax, axis=0)
    codes = morton_codes_3d(centroids, scene_lo, scene_hi)

    order = jnp.argsort(codes).astype(jnp.int32)
    codes = codes[order]
    amin_s = amin[order]
    amax_s = amax[order]

    idx_bits = jnp.arange(n, dtype=jnp.uint32)

    def delta(i, j):
        """Common-prefix length of sorted keys i and j; -1 out of range.
        Equal Morton codes extend the key with the index (unique keys)."""
        valid = (j >= 0) & (j < n)
        j_c = jnp.clip(j, 0, n - 1)
        ci = codes[i]
        cj = codes[j_c]
        x = ci ^ cj
        d = jnp.where(
            x == 0,
            32 + _clz32(idx_bits[i] ^ idx_bits[j_c]),
            _clz32(x),
        )
        return jnp.where(valid, d, -1)

    i = jnp.arange(n - 1, dtype=jnp.int32)

    # Direction of the node's range.
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    d = jnp.where(d == 0, 1, d)
    delta_min = delta(i, i - d)

    # Upper bound for range length by doubling (static trip count).
    max_pow = int(math.ceil(math.log2(max(n, 2)))) + 1

    lmax = jnp.full_like(i, 2)
    for _ in range(max_pow):
        cond = delta(i, i + lmax * d) > delta_min
        lmax = jnp.where(cond, lmax * 2, lmax)

    # Binary search for exact length l.
    l = jnp.zeros_like(i)
    t = lmax // 2
    for _ in range(max_pow + 1):
        cond = (t >= 1) & (delta(i, i + (l + t) * d) > delta_min)
        l = jnp.where(cond, l + t, l)
        t = t // 2
    j = i + l * d

    # Split position via binary search on the node's own prefix.
    delta_node = delta(i, j)
    s = jnp.zeros_like(i)
    t = (l + 1) // 2  # ceil(l / 2)
    prev_t = l  # track to emulate the divide-by-2 ceil loop
    for _ in range(max_pow + 1):
        cond = (t >= 1) & (delta(i, i + (s + t) * d) > delta_node)
        s = jnp.where(cond, s + t, s)
        prev_t = t
        t = jnp.where(prev_t > 1, (prev_t + 1) // 2, 0)
    gamma = i + s * d + jnp.minimum(d, 0)

    range_lo = jnp.minimum(i, j)
    range_hi = jnp.maximum(i, j)
    leaf_base = n - 1
    left = jnp.where(range_lo == gamma, leaf_base + gamma, gamma)
    right = jnp.where(range_hi == gamma + 1, leaf_base + gamma + 1, gamma + 1)

    m = 2 * n - 1
    parent = jnp.zeros(m, jnp.int32)
    parent = parent.at[left].set(i)
    parent = parent.at[right].set(i)

    # ---- bottom-up AABB refit by fixed-point iteration --------------------
    node_min = jnp.zeros((m, 3), jnp.float32).at[leaf_base:].set(amin_s)
    node_max = jnp.zeros((m, 3), jnp.float32).at[leaf_base:].set(amax_s)
    # Depth bound: keys are ~(30 + log2 n) bits, so prefixes (and the tree)
    # can be at most that deep.
    depth_bound = 32 + max_pow

    def refit_body(_, carry):
        nmin, nmax = carry
        lmin = nmin[left]
        lmaxv = nmax[left]
        rmin = nmin[right]
        rmaxv = nmax[right]
        new_min = jnp.minimum(lmin, rmin)
        new_max = jnp.maximum(lmaxv, rmaxv)
        return (nmin.at[:leaf_base].set(new_min), nmax.at[:leaf_base].set(new_max))

    node_min, node_max = jax.lax.fori_loop(
        0, depth_bound, refit_body, (node_min, node_max))

    # ---- skip-link threading ----------------------------------------------
    # skip[x] = right sibling of the lowest ancestor-or-self of x that is a
    # left child; -1 if none (right spine of the tree). Vectorized upward walk.
    nodes = jnp.arange(m, dtype=jnp.int32)

    def walk_body(_, carry):
        cur, res, done = carry
        par = parent[cur]
        is_root = cur == 0
        is_left = left[par] == cur
        newly = (~done) & (~is_root) & is_left
        res = jnp.where(newly, right[par], res)
        done = done | is_root | newly
        cur = jnp.where(done, cur, par)
        return (cur, res, done)

    _, skip, _ = jax.lax.fori_loop(
        0, depth_bound, walk_body,
        (nodes, jnp.full(m, -1, jnp.int32), jnp.zeros(m, bool)))

    entry = jnp.concatenate([left, jnp.full(n, -1, jnp.int32)])
    first_tri = jnp.concatenate([jnp.full(n - 1, -1, jnp.int32),
                                 jnp.arange(n, dtype=jnp.int32)])
    tri_count = jnp.concatenate([jnp.zeros(n - 1, jnp.int32),
                                 jnp.ones(n, jnp.int32)])

    return FlatBVH(
        aabb_min=node_min, aabb_max=node_max, entry=entry, skip=skip,
        first_tri=first_tri, tri_count=tri_count, tri_order=order,
    )
