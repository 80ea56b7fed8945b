"""Legacy tonemapping curves (Lottes, Uchimura, ACES fitted/film).

The reference keeps these in tree although the LPM tonemapper supersedes
them (shaders/tonemaps.glsl — superseded by ffx_lpm, SURVEY.md §2.2); they
are provided here for the same API completeness, vectorized over arrays.

Note: the reference's `aces_fitted` builds its mat3s with GLSL column-major
constructors from row-listed literals and multiplies matrix*vector, which
applies the *transpose* of the standard Hill ACES matrices; this port keeps
that exact behavior.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def tonemap_lottes(x):
    """Lottes 2016 (tonemaps.glsl:1-18). Elementwise over luminance/channels."""
    a = 1.6
    d = 0.977
    hdr_max = 8.0
    mid_in = 0.18
    mid_out = 0.267
    b = ((-(mid_in ** a) + (hdr_max ** a) * mid_out)
         / (((hdr_max ** (a * d)) - (mid_in ** (a * d))) * mid_out))
    c = (((hdr_max ** (a * d)) * (mid_in ** a)
          - (hdr_max ** a) * (mid_in ** (a * d)) * mid_out)
         / (((hdr_max ** (a * d)) - (mid_in ** (a * d))) * mid_out))
    x = jnp.maximum(x, 0.0)
    return jnp.power(x, a) / (jnp.power(x, a * d) * b + c)


def _smoothstep(e0, e1, x):
    t = jnp.clip((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def tonemap_uchimura(x, P=1.0, a=1.0, m=0.22, l=0.4, c=1.33, b=0.0):
    """Uchimura 2017 "HDR theory and practice" (tonemaps.glsl:20-50)."""
    l0 = ((P - m) * l) / a
    S1 = m + a * l0
    C2 = (a * P) / (P - S1)
    CP = -C2 / P
    S0 = m + l0

    x = jnp.maximum(x, 0.0)
    w0 = 1.0 - _smoothstep(0.0, m, x)
    w2 = jnp.where(x >= m + l0, 1.0, 0.0)
    w1 = 1.0 - w0 - w2

    T = m * jnp.power(x / m, c) + b
    S = P - (P - S1) * jnp.exp(CP * (x - S0))
    L = m + a * (x - m)
    return T * w0 + L * w1 + S * w2


_ACES_IN = np.array([
    [0.59719, 0.35458, 0.04823],
    [0.07600, 0.90834, 0.01566],
    [0.02840, 0.13383, 0.83777],
], np.float32)
_ACES_OUT = np.array([
    [1.60475, -0.53108, -0.07367],
    [-0.10208, 1.10813, -0.00605],
    [-0.00327, -0.07276, 1.07602],
], np.float32)


def _rtt_and_odt_fit(v):
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return a / b


def aces_fitted(rgb):
    """ACES fitted (tonemaps.glsl:52-74); (..., 3) linear color.
    Matches the reference's (transposed-matrix) GLSL arithmetic."""
    v = jnp.einsum("...j,ji->...i", rgb, jnp.asarray(_ACES_IN),
                   precision=jax.lax.Precision.HIGHEST)
    v = _rtt_and_odt_fit(v)
    return jnp.einsum("...j,ji->...i", v, jnp.asarray(_ACES_OUT),
                      precision=jax.lax.Precision.HIGHEST)


def aces_film(x):
    """ACES filmic approximation (tonemaps.glsl:76-83)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)
