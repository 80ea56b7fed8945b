"""Primary camera-ray generation.

Matches the reference raygen exactly (raytrace.rgen.glsl:77-101): pixel
centers through the inverse projection, directions rotated to world by the
inverse view. Vulkan's top-left origin / NDC-y-down pairs with the camera's
(0,-1,0) up vector, so row 0 of the image is the top of the frame.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .vec import length

_HIGHEST = jax.lax.Precision.HIGHEST  # a GPU would run f32 in TF32

T_MIN = 0.001
T_MAX = 10000.0


def camera_rays(camera: dict, width: int, height: int,
                row_start=0, num_rows=None, jitter=None):
    """Returns (origin (R*W, 3), direction (R*W, 3)) world-space rays for a
    horizontal band of `num_rows` rows starting at `row_start` (full image by
    default). The band form is what the multi-chip tile decomposition uses —
    each chip generates only its own rays (dist/sharding.py).

    jitter: optional (2,) sub-pixel offset in [-0.5, 0.5] pixels (AA /
    progressive accumulation); None = pixel centers (reference behavior)."""
    view_inv = camera["view_inv"]
    proj_inv = camera["proj_inv"]
    num_rows = height if num_rows is None else num_rows
    jx = 0.0 if jitter is None else jitter[0]
    jy = 0.0 if jitter is None else jitter[1]

    x = (jnp.arange(width, dtype=jnp.float32) + 0.5 + jx) / width * 2.0 - 1.0
    rows = row_start + jnp.arange(num_rows, dtype=jnp.float32)
    y = (rows + 0.5 + jy) / height * 2.0 - 1.0
    dx, dy = jnp.meshgrid(x, y)  # (R, W)
    height = num_rows  # shapes below are per-band

    ndc = jnp.stack([dx, dy, jnp.ones_like(dx), jnp.ones_like(dx)], axis=-1)
    target = jnp.einsum("ij,hwj->hwi", proj_inv, ndc,
                        precision=_HIGHEST)[..., :3]
    target = target / length(target)[..., None]
    direction = jnp.einsum("ij,hwj->hwi", view_inv[:3, :3], target,
                           precision=_HIGHEST)

    origin = jnp.broadcast_to(view_inv[:3, 3], (height, width, 3))
    return origin.reshape(-1, 3), direction.reshape(-1, 3)
