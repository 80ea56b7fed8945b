"""Light evaluation library.

Vectorized jnp forms of the reference's device light functions
(reference: src/vk_renderer/shaders/rt_lightning_shadows/light.glsl):

* radiance with spot/area penumbra->umbra falloff pow(t, 2) and squared
  distance-window falloff (light.glsl:34-48),
* area light as the closest point on a bounded plane rectangle, built from
  barycentric clamping against the rectangle's defining triangle and its
  mirrored half (light.glsl:50-124),
* directional L = -dir * 10 (light.glsl:97-99).

Each function takes a single light as a dict of field arrays (see
scene.lights.Lights.shader_arrays, indexed on the light axis) and a batch of
world positions (..., 3); branches become jnp.where cascades.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..scene.lights import (
    LIGHT_TYPE_AREA,
    LIGHT_TYPE_DIRECTIONAL,
    LIGHT_TYPE_POINT,
    LIGHT_TYPE_SPOT,
)
from .vec import length


def _dot(a, b):
    return jnp.sum(a * b, axis=-1)


def compute_barycentric(a, b, c, p):
    """light.glsl:50-67."""
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = _dot(v0, v0)
    d01 = _dot(v0, v1)
    d11 = _dot(v1, v1)
    d20 = _dot(v2, v0)
    d21 = _dot(v2, v1)
    denom = d00 * d11 - d01 * d01
    bx = (d11 * d20 - d01 * d21) / denom
    by = (d00 * d21 - d01 * d20) / denom
    bz = 1.0 - bx - by
    return jnp.stack([bx, by, bz], axis=-1)


def closest_point_to_segment(pos0, pos1, p):
    """light.glsl:69-74."""
    v01 = pos1 - pos0
    t = _dot(p - pos0, v01) / _dot(v01, v01)
    t = jnp.clip(t, 0.0, 1.0)
    return pos0 + t[..., None] * v01


def closest_point_to_triangle(pos0, pos1, pos2, point):
    """light.glsl:76-91."""
    bary = compute_barycentric(pos0, pos1, pos2, point)
    seg20 = closest_point_to_segment(pos2, pos0, point)
    seg12 = closest_point_to_segment(pos1, pos2, point)
    out = jnp.where((bary[..., 2] < 0.0)[..., None], seg12, point)
    out = jnp.where((bary[..., 0] < 0.0)[..., None], seg20, out)
    return out


def get_unnormalized_L_vec(light: dict, pos):
    """light.glsl:93-124. pos: (..., 3); light fields broadcast over pos."""
    ltype = light["light_type"]
    lpos = jnp.broadcast_to(light["pos"], pos.shape)
    ldir = jnp.broadcast_to(light["dir"], pos.shape)

    point_spot = lpos - pos
    directional = jnp.broadcast_to(-light["dir"] * 10.0, pos.shape)

    # Area light: project onto the light plane, clamp to the rectangle.
    area_pos2 = jnp.broadcast_to(light["area_pos2"], pos.shape)
    area_pos3 = jnp.broadcast_to(light["area_pos3"], pos.shape)
    distance = _dot(ldir, area_pos2) - _dot(ldir, pos)
    cp_on_plane = pos + distance[..., None] * ldir
    bary = compute_barycentric(lpos, area_pos2, area_pos3, cp_on_plane)

    pos4 = lpos - area_pos2 + area_pos3
    tri_branch = closest_point_to_triangle(lpos, area_pos3, pos4, cp_on_plane)
    seg_a = closest_point_to_segment(lpos, area_pos2, cp_on_plane)
    seg_b = closest_point_to_segment(area_pos2, area_pos3, cp_on_plane)

    # if-else-if chain: x<0 -> triangle; elif y<0 -> seg(pos, pos2);
    # elif z<0 -> seg(pos2, pos3); else point-on-plane.
    clamped = jnp.where((bary[..., 2] < 0.0)[..., None], seg_b, cp_on_plane)
    clamped = jnp.where((bary[..., 1] < 0.0)[..., None], seg_a, clamped)
    clamped = jnp.where((bary[..., 0] < 0.0)[..., None], tri_branch, clamped)
    area = clamped - pos

    out = jnp.where(
        (ltype == LIGHT_TYPE_POINT) | (ltype == LIGHT_TYPE_SPOT), point_spot,
        jnp.where(ltype == LIGHT_TYPE_DIRECTIONAL, directional,
                  jnp.where(ltype == LIGHT_TYPE_AREA, area,
                            jnp.ones_like(pos))))
    return out


def get_light_radiance(light: dict, pos, L):
    """light.glsl:34-48. L is the normalized light vector at each position."""
    radiance = jnp.broadcast_to(light["color"], pos.shape)
    ltype = light["light_type"]

    is_cone = (ltype == LIGHT_TYPE_SPOT) | (ltype == LIGHT_TYPE_AREA)
    cos_theta = _dot(jnp.broadcast_to(light["dir"], L.shape), -L)
    theta_s = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
    denom = light["penumbra_angle"] - light["umbra_angle"]
    denom = jnp.where(denom == 0.0, 1.0, denom)
    t = jnp.clip((theta_s - light["umbra_angle"]) / denom, 0.0, 1.0)
    radiance = jnp.where(is_cone[..., None] if jnp.ndim(is_cone) else is_cone,
                         radiance * (t * t)[..., None], radiance)

    has_falloff = light["falloff_distance"] > 0.0
    dist = length(jnp.broadcast_to(light["pos"], pos.shape) - pos)
    w = jnp.maximum(1.0 - (dist / light["falloff_distance"]) ** 2, 0.0) ** 2
    radiance = jnp.where(has_falloff[..., None] if jnp.ndim(has_falloff) else has_falloff,
                         radiance * w[..., None], radiance)
    return radiance
