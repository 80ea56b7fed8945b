"""Length and normalization of 3-vectors, written per component.

`jnp.linalg.norm(v, axis=-1)` reduces over the minor axis of size 3. Where
the result is broadcast back onto `v` (v / |v|), XLA's GPU compiler turns
the pair into a Triton normalization fusion, and for some batch shapes (a
(16384, 3) batch: every 128x128 frame) the launch of that fusion fails with
CUDA_ERROR_INVALID_VALUE. Summed per component, the same arithmetic
((x*x + y*y) + z*z) is a plain elementwise fusion on every backend.
"""
from __future__ import annotations

import jax.numpy as jnp


def length(v):
    """|v| over the last axis (size 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return jnp.sqrt(x * x + y * y + z * z)


def normalize(v, eps=1e-20):
    """v / max(|v|, eps) over the last axis (size 3)."""
    return v / jnp.maximum(length(v), eps)[..., None]
