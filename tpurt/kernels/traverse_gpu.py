"""Closest-hit and any-hit BVH traversal as one Pallas kernel (Triton route).

`kernels/traverse.py` advances every ray of the frame in lockstep: each trip
of its `lax.while_loop` is a chain of XLA kernels that gathers node and
triangle rows for all lanes and writes the whole ray state back to device
memory, until the frame's slowest ray leaves the BVH. Here the loop runs
inside the kernel instead. Each program instance owns a block of rays and
walks the threaded (skip-link) BVH of `bvh/flat.py` until every lane of the
block has parked at -1. Per-lane state is one i32 node pointer plus the
running hit, kept in registers; node and triangle rows are read with
array-indexed loads (pointer gathers) from the whole tables.

The arithmetic is that of `kernels/intersect.py`, written per component
because the Triton lowering takes only power-of-two tensors (no (B, 3)
arrays). Triton's min/max ignore NaN where XLA's propagate it, so the slab
test flags NaN slabs explicitly to keep XLA's answer (a NaN slab misses).

Off the GPU the same kernel runs in the Pallas interpreter, which is how the
CPU tests cover it; on the GPU it is always compiled.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK = 128
NUM_WARPS = 4


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _slab(o, inv, bmin, bmax, t_min, t_max):
    """intersect.ray_aabb per component; a NaN slab (0 * inf) misses."""
    nan = jnp.zeros(t_min.shape, bool)
    near, far = t_min, t_max
    for k in range(3):
        t0 = (bmin[k] - o[k]) * inv[k]
        t1 = (bmax[k] - o[k]) * inv[k]
        nan = nan | (t0 != t0) | (t1 != t1)
        near = jnp.maximum(near, jnp.minimum(t0, t1))
        far = jnp.minimum(far, jnp.maximum(t0, t1))
    return (near <= far) & ~nan


def _moller_trumbore(o, d, v0, e1, e2, t_min, t_max):
    """intersect.moller_trumbore per component."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    valid = jnp.abs(det) > 1e-12
    inv_det = 1.0 / jnp.where(valid, det, 1.0)
    tvec = _sub(o, v0)
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return hit, t, u, v


def _kernel(o_ref, d_ref, tmin_ref, tmax_ref, bmin_ref, bmax_ref, entry_ref,
            skip_ref, first_ref, count_ref, v0_ref, e1_ref, e2_ref, id_ref,
            *out_refs, block: int, max_leaf: int, any_hit: bool):
    num_tris = v0_ref.shape[0]
    ray = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    o = tuple(o_ref[ray, k] for k in range(3))
    d = tuple(d_ref[ray, k] for k in range(3))
    inv = tuple(1.0 / c for c in d)  # 1/0 = inf keeps the slab test right
    t_min = tmin_ref[...]
    t_max = tmax_ref[...]

    def node_step(node, t):
        active = node >= 0
        nidx = jnp.maximum(node, 0)
        bmin = tuple(bmin_ref[nidx, k] for k in range(3))
        bmax = tuple(bmax_ref[nidx, k] for k in range(3))
        hit_box = _slab(o, inv, bmin, bmax, t_min, t) & active
        count = count_ref[nidx]
        is_leaf = count > 0
        nxt = jnp.where(hit_box & ~is_leaf, entry_ref[nidx], skip_ref[nidx])
        return active, hit_box & is_leaf, first_ref[nidx], count, nxt

    def triangle(first, k, m):
        tidx = jnp.clip(first + k, 0, num_tris - 1)

        def row(ref):
            return tuple(plgpu.load(ref.at[tidx, c], mask=m, other=0.0)
                         for c in range(3))

        return tidx, row(v0_ref), row(e1_ref), row(e2_ref)

    def cond(state):
        return jnp.max(state[0]) >= 0

    if any_hit:
        def body(state):
            node, occluded = state
            active, do_leaf, first, count, nxt = node_step(node, t_max)
            for k in range(max_leaf):
                m = do_leaf & (k < count)
                _, v0, e1, e2 = triangle(first, k, m)
                h, _, _, _ = _moller_trumbore(o, d, v0, e1, e2, t_min, t_max)
                occluded = occluded | (m & h)
            # first-hit termination: occluded lanes park at once
            node = jnp.where(active & ~occluded, nxt,
                             jnp.where(occluded, -1, node))
            return node, occluded

        init = (jnp.zeros(block, jnp.int32), jnp.zeros(block, bool))
        _, occluded = jax.lax.while_loop(cond, body, init)
        out_refs[0][...] = occluded.astype(jnp.int32)
        return

    def body(state):
        node, t, tri, u, v = state
        active, do_leaf, first, count, nxt = node_step(node, t)
        for k in range(max_leaf):
            m = do_leaf & (k < count)
            tidx, v0, e1, e2 = triangle(first, k, m)
            h, tk, uk, vk = _moller_trumbore(o, d, v0, e1, e2, t_min, t)
            upd = m & h
            t = jnp.where(upd, tk, t)
            tri = jnp.where(upd, plgpu.load(id_ref.at[tidx], mask=upd,
                                            other=0), tri)
            u = jnp.where(upd, uk, u)
            v = jnp.where(upd, vk, v)
        return jnp.where(active, nxt, node), t, tri, u, v

    init = (jnp.zeros(block, jnp.int32), t_max, jnp.full(block, -1, jnp.int32),
            jnp.zeros(block, jnp.float32), jnp.zeros(block, jnp.float32))
    _, t, tri, u, v = jax.lax.while_loop(cond, body, init)
    for ref, val in zip(out_refs, (t, tri, u, v)):
        ref[...] = val


def _traverse(bvh, geom, origin, direction, t_min, t_max, *, max_leaf: int,
              block: int, any_hit: bool):
    n = origin.shape[0]
    n_pad = -(-n // block) * block
    pad = n_pad - n
    t_min = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    t_max = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,))
    origin = jnp.asarray(origin, jnp.float32)
    direction = jnp.asarray(direction, jnp.float32)
    if pad:
        # padded lanes get tmax = 0: they miss the root box and park
        origin = jnp.pad(origin, ((0, pad), (0, 0)))
        direction = jnp.pad(direction, ((0, pad), (0, 0)), constant_values=1.0)
        t_min = jnp.pad(t_min, (0, pad))
        t_max = jnp.pad(t_max, (0, pad))

    tables = (bvh["aabb_min"], bvh["aabb_max"], bvh["entry"], bvh["skip"],
              bvh["first_tri"], bvh["tri_count"], geom["v0"], geom["e1"],
              geom["e2"], geom["tri_id"])

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i, nd=a.ndim: (0,) * nd)

    lane = pl.BlockSpec((block,), lambda i: (i,))
    if any_hit:
        out_shape = jax.ShapeDtypeStruct((n_pad,), jnp.int32)
        out_specs = lane
    else:
        out_shape = (jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                     jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                     jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                     jax.ShapeDtypeStruct((n_pad,), jnp.float32))
        out_specs = (lane,) * 4
    out = pl.pallas_call(
        partial(_kernel, block=block, max_leaf=max_leaf, any_hit=any_hit),
        grid=(n_pad // block,),
        in_specs=[whole(origin), whole(direction), lane, lane,
                  *(whole(a) for a in tables)],
        out_specs=out_specs,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=jax.default_backend() != "gpu",
        name="bvh_any_hit" if any_hit else "bvh_closest_hit",
    )(origin, direction, t_min, t_max, *tables)
    if any_hit:
        return out[:n] > 0
    t, tri, u, v = (a[:n] for a in out)
    return dict(t=t, tri=tri, u=u, v=v)


@partial(jax.jit, static_argnames=("max_leaf", "block"))
def trace_closest(bvh: dict, geom: dict, origin, direction, t_min, t_max,
                  max_leaf: int = 4, block: int = BLOCK):
    """Closest hit; same contract as traverse.trace_closest."""
    return _traverse(bvh, geom, origin, direction, t_min, t_max,
                     max_leaf=max_leaf, block=block, any_hit=False)


@partial(jax.jit, static_argnames=("max_leaf", "block"))
def trace_any(bvh: dict, geom: dict, origin, direction, t_min, t_max,
              max_leaf: int = 4, block: int = BLOCK):
    """Occlusion with first-hit termination; same contract as
    traverse.trace_any."""
    return _traverse(bvh, geom, origin, direction, t_min, t_max,
                     max_leaf=max_leaf, block=block, any_hit=True)
