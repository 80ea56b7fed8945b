"""Ray-traced AO ground truth (progressive).

The reference ships a development-only ray-traced AO reference used to tune
XeGTAO (XeGTAO.h:85-99 ReferenceRTAOConstants: TotalRaysLength ≙ radius,
MaxBounces default 1, frame accumulation). This is its form here: per frame,
each hit point shoots cosine-weighted hemisphere occlusion rays bounded by
`total_rays_length`; visibilities accumulate across frames into a converged
reference AO image, which can be compared against passes/gtao.py output.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..kernels.trace import trace_any, trace_closest
from .rays import T_MAX, T_MIN, camera_rays
from .vec import normalize

RTAO_T_MIN = 1e-3


def _onb(n):
    """Build an orthonormal basis around normals (..., 3) (Frisvad-style)."""
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = jnp.stack([1.0 + sign * n[..., 0] ** 2 * a, sign * b,
                   -sign * n[..., 0]], axis=-1)
    bt = jnp.stack([b, sign + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t, bt


def _cosine_dirs(key, n, shape):
    u1 = jax.random.uniform(key, shape)
    key2 = jax.random.fold_in(key, 1)
    u2 = jax.random.uniform(key2, shape)
    r = jnp.sqrt(u1)
    phi = 2.0 * jnp.pi * u2
    x = r * jnp.cos(phi)
    y = r * jnp.sin(phi)
    z = jnp.sqrt(jnp.maximum(1.0 - u1, 0.0))
    t, bt = _onb(n)
    return (x[..., None] * t + y[..., None] * bt + z[..., None] * n)


@partial(jax.jit, static_argnames=("width", "height", "samples_per_frame"))
def rtao_frame(scene: dict, camera: dict, key, *, width: int, height: int,
               samples_per_frame: int = 4, total_rays_length: float = 0.2):
    """One accumulation step: returns (visibility_sum (H,W), hit_mask (H,W)).
    Average visibility over accumulated frames is the converged AO."""
    origin, direction = camera_rays(camera, width, height)
    hits = trace_closest(scene["bvh"], scene["geom"], origin, direction,
                         T_MIN, T_MAX, max_leaf=4)
    valid = hits["tri"] >= 0
    tidx = jnp.maximum(hits["tri"], 0)

    u = hits["u"][:, None]
    v = hits["v"][:, None]
    w = 1.0 - u - v
    if "tri_attr" in scene:
        # lean device pytree: one wide row gather carries all three
        # corners' positions/normals (same values as the vtx tables)
        attr = scene["tri_attr"][tidx]
        p0, p1, p2 = attr[:, 0:3], attr[:, 12:15], attr[:, 24:27]
        n0, n1, n2 = attr[:, 5:8], attr[:, 17:20], attr[:, 29:32]
    else:
        vids = scene["tri_vertex"][tidx]
        p0 = scene["vtx_pos"][vids[:, 0]]
        p1 = scene["vtx_pos"][vids[:, 1]]
        p2 = scene["vtx_pos"][vids[:, 2]]
        n0 = scene["vtx_normal"][vids[:, 0]]
        n1 = scene["vtx_normal"][vids[:, 1]]
        n2 = scene["vtx_normal"][vids[:, 2]]
    world_pos = p0 * w + p1 * u + p2 * v
    normal = n0 * w + n1 * u + n2 * v
    normal = normalize(normal)
    # face the ray origin (double-sided geometry)
    flip = jnp.sum(normal * direction, axis=-1) > 0.0
    normal = jnp.where(flip[:, None], -normal, normal)

    vis_sum = jnp.zeros(origin.shape[0], jnp.float32)
    for s in range(samples_per_frame):
        sub = jax.random.fold_in(key, s)
        d = _cosine_dirs(sub, normal, normal.shape[:-1])
        t_max = jnp.where(valid, total_rays_length, 0.0)
        occluded = trace_any(scene["bvh"], scene["geom"], world_pos, d,
                             RTAO_T_MIN, t_max, max_leaf=4)
        vis_sum = vis_sum + jnp.where(occluded, 0.0, 1.0)

    vis = (vis_sum / samples_per_frame).reshape(height, width)
    return jnp.where(valid.reshape(height, width), vis, 1.0), \
        valid.reshape(height, width)
