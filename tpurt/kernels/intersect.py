"""Ray/primitive intersection math (vectorized jnp).

The reference gets these from the RT hardware behind `traceRayEXT`
(raytrace.rgen.glsl:90-101); here they are explicit array programs:
slab-test ray/AABB and Möller–Trumbore ray/triangle, both double-faced and
opaque (the reference traces with gl_RayFlagsOpaqueEXT and no face culling).
"""
from __future__ import annotations

import jax.numpy as jnp

INF = jnp.float32(3.0e38)


def ray_aabb(origin, inv_dir, box_min, box_max, t_min, t_max):
    """Slab test. All inputs broadcast; returns boolean hit mask.

    `inv_dir` is 1/direction with +/-inf for zero components; the
    min/max formulation is NaN-robust (NaN compares false, slabs with
    origin inside a zero-width axis still pass via the other bound).
    """
    t0 = (box_min - origin) * inv_dir
    t1 = (box_max - origin) * inv_dir
    tsmall = jnp.minimum(t0, t1)
    tbig = jnp.maximum(t0, t1)
    tnear = jnp.maximum(jnp.max(tsmall, axis=-1), t_min)
    tfar = jnp.minimum(jnp.min(tbig, axis=-1), t_max)
    return tnear <= tfar


def moller_trumbore(origin, direction, v0, e1, e2, t_min, t_max):
    """Möller–Trumbore with precomputed edges (e1 = v1-v0, e2 = v2-v0).

    Returns (hit, t, u, v): barycentric weights match the hardware
    convention used by the shading pass (raytrace.rgen.glsl:116) —
    w = 1-u-v on v0, u on v1, v on v2. Double-faced, epsilon-guarded.
    """
    pvec = jnp.cross(direction, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    # no culling: reject only near-degenerate determinants
    valid = jnp.abs(det) > 1e-12
    inv_det = 1.0 / jnp.where(valid, det, 1.0)
    tvec = origin - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(direction * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return hit, t, u, v
