"""Stackless BVH traversal in plain XLA — the replacement for `traceRayEXT`.

Wavefront style: a whole batch of rays advances in lockstep through the
skip-link BVH (see bvh.flat), one i32 node pointer per lane, inside a single
`lax.while_loop`. Every iteration is pure gathers + elementwise math with no
per-lane control flow; lanes that exit early simply stop contributing (their
pointer parks at -1). This is the tracer off the GPU and the plain reference
for the GPU kernel (traverse_gpu.py); callers go through kernels/trace.py.

Two entry points mirror the reference's two trace calls:
  trace_closest — primary rays (raytrace.rgen.glsl:90-101),
  trace_any     — shadow rays with first-hit termination
                  (raytrace.rgen.glsl:165-182: TerminateOnFirstHit | Opaque |
                  SkipClosestHit).

Geometry arrives pre-reordered to match BVH leaf ranges (scene build does the
gather once) with precomputed MT edges: geom = {v0, e1, e2, tri_id}.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .intersect import moller_trumbore, ray_aabb

INF = jnp.float32(3.0e38)


def _inv_dir(direction):
    # IEEE: 1/0 = inf keeps the slab test correct for axis-parallel rays.
    return 1.0 / direction


def _leaf_intersect(geom, origin, direction, t_min, t, tri, u, v,
                    first, count, do_leaf, max_leaf, any_hit):
    num_tris = geom["v0"].shape[0]
    found = jnp.zeros(do_leaf.shape, bool)
    for k in range(max_leaf):
        tidx = jnp.clip(first + k, 0, num_tris - 1)
        m = do_leaf & (k < count)
        h, tk, uk, vk = moller_trumbore(
            origin, direction, geom["v0"][tidx], geom["e1"][tidx],
            geom["e2"][tidx], t_min, t)
        upd = m & h
        if any_hit:
            found = found | upd
        else:
            t = jnp.where(upd, tk, t)
            tri = jnp.where(upd, geom["tri_id"][tidx], tri)
            u = jnp.where(upd, uk, u)
            v = jnp.where(upd, vk, v)
    return t, tri, u, v, found


@partial(jax.jit, static_argnames=("max_leaf",))
def trace_closest(bvh: dict, geom: dict, origin, direction, t_min, t_max,
                  max_leaf: int = 4):
    """Closest-hit trace for a batch of rays.

    origin/direction: (N, 3). t_min/t_max: scalars or (N,).
    Returns dict(t, tri, u, v); tri = -1 on miss, else original triangle id.
    """
    n = origin.shape[0]
    inv_dir = _inv_dir(direction)
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    state = (
        jnp.zeros(n, jnp.int32),            # node
        t0,                                  # closest t so far (bounds the search)
        jnp.full(n, -1, jnp.int32),          # tri
        jnp.zeros(n, jnp.float32),           # u
        jnp.zeros(n, jnp.float32),           # v
    )

    def cond(state):
        return jnp.any(state[0] >= 0)

    def body(state):
        node, t, tri, u, v = state
        active = node >= 0
        nidx = jnp.maximum(node, 0)
        bmin = bvh["aabb_min"][nidx]
        bmax = bvh["aabb_max"][nidx]
        hit_box = ray_aabb(origin, inv_dir, bmin, bmax, t_min, t) & active
        count = bvh["tri_count"][nidx]
        is_leaf = count > 0
        do_leaf = hit_box & is_leaf
        first = bvh["first_tri"][nidx]
        t, tri, u, v, _ = _leaf_intersect(
            geom, origin, direction, t_min, t, tri, u, v,
            first, count, do_leaf, max_leaf, any_hit=False)
        nxt = jnp.where(hit_box & ~is_leaf, bvh["entry"][nidx], bvh["skip"][nidx])
        node = jnp.where(active, nxt, node)
        return node, t, tri, u, v

    _, t, tri, u, v = jax.lax.while_loop(cond, body, state)
    return dict(t=t, tri=tri, u=u, v=v)


@partial(jax.jit, static_argnames=("max_leaf",))
def trace_any(bvh: dict, geom: dict, origin, direction, t_min, t_max,
              max_leaf: int = 4):
    """Any-hit (occlusion) trace with first-hit termination.

    Returns a boolean (N,) occlusion mask — the reference's ShadowPayload
    (ray_payload.glsl, shadow.rmiss.glsl sets it false on miss).
    """
    n = origin.shape[0]
    inv_dir = _inv_dir(direction)
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))

    state = (
        jnp.zeros(n, jnp.int32),   # node
        jnp.zeros(n, bool),        # occluded
    )

    def cond(state):
        return jnp.any(state[0] >= 0)

    def body(state):
        node, occluded = state
        active = node >= 0
        nidx = jnp.maximum(node, 0)
        bmin = bvh["aabb_min"][nidx]
        bmax = bvh["aabb_max"][nidx]
        hit_box = ray_aabb(origin, inv_dir, bmin, bmax, t_min, t_max) & active
        count = bvh["tri_count"][nidx]
        is_leaf = count > 0
        do_leaf = hit_box & is_leaf
        first = bvh["first_tri"][nidx]
        _, _, _, _, found = _leaf_intersect(
            geom, origin, direction, t_min, t_max, None, None, None,
            first, count, do_leaf, max_leaf, any_hit=True)
        occluded = occluded | found
        nxt = jnp.where(hit_box & ~is_leaf, bvh["entry"][nidx], bvh["skip"][nidx])
        # first-hit termination: occluded lanes park immediately
        node = jnp.where(active & ~occluded, nxt, jnp.where(occluded, -1, node))
        return node, occluded

    _, occluded = jax.lax.while_loop(cond, body, state)
    return occluded


def make_traversal_geom(v0, v1, v2, tri_order):
    """Reorder triangles to BVH leaf order and precompute MT edges."""
    v0 = jnp.asarray(v0, jnp.float32)
    v1 = jnp.asarray(v1, jnp.float32)
    v2 = jnp.asarray(v2, jnp.float32)
    order = jnp.asarray(tri_order, jnp.int32)
    v0o = v0[order]
    return dict(v0=v0o, e1=v1[order] - v0o, e2=v2[order] - v0o,
                tri_id=order)


def trace_closest_brute(geom: dict, origin, direction, t_min, t_max):
    """O(N*T) all-pairs closest hit — test oracle only."""
    o = origin[:, None, :]
    d = direction[:, None, :]
    hit, t, u, v = moller_trumbore(
        o, d, geom["v0"][None], geom["e1"][None], geom["e2"][None],
        jnp.asarray(t_min, jnp.float32),
        jnp.asarray(t_max, jnp.float32))
    t = jnp.where(hit, t, INF)
    best = jnp.argmin(t, axis=1)
    n = origin.shape[0]
    rows = jnp.arange(n)
    best_t = t[rows, best]
    missed = ~jnp.isfinite(best_t) | (best_t >= INF)
    return dict(
        t=jnp.where(missed, jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,)), best_t),
        tri=jnp.where(missed, -1, geom["tri_id"][best]),
        u=u[rows, best],
        v=v[rows, best],
    )
