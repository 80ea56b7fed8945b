"""Image-format quantization helpers.

The reference renders into quantized storage images: color and encoded
normals in B10G11R11_UFLOAT (renderer.rs:268, vk_rt_lightning_shadows.rs:125-159),
view-space depth in R16F, AO terms in R32_UINT (vk_xe_gtao.rs:295-333). To
keep per-pixel output comparable (<=1% RMSE gate) this pipeline applies the
same quantization at the same points; these helpers implement the format
round-trips with jnp bit ops.
"""
from __future__ import annotations

import jax.numpy as jnp


def _quantize_small_float(x, mantissa_bits: int):
    """Round-trip a positive f32 through a 5-exponent/`mantissa_bits` unsigned
    small float (R11F: 6 mantissa bits, B10F: 5) via the f16 representation:
    f16 shares the 5-bit exponent (bias 15), so dropping f16 mantissa LSBs with
    round-to-nearest reproduces the format's quantization."""
    x = jnp.maximum(x, 0.0)  # unsigned format: negatives clamp to zero
    h = x.astype(jnp.float16)
    bits = h.view(jnp.uint16).astype(jnp.uint32)
    drop = 10 - mantissa_bits
    half = jnp.uint32(1 << (drop - 1))
    mask = jnp.uint32(~((1 << drop) - 1) & 0xFFFF)
    rounded = (bits + half) & mask
    # keep inf behavior: if rounding overflowed past f16 inf, clamp to max finite
    max_finite = jnp.uint32(0x7BFF & mask)
    rounded = jnp.where(rounded >= 0x7C00, jnp.where(bits >= 0x7C00, bits & mask, max_finite),
                        rounded)
    return rounded.astype(jnp.uint16).view(jnp.float16).astype(jnp.float32)


def quantize_r11g11b10f(rgb):
    """Round-trip (..., 3) through B10G11R11_UFLOAT."""
    r = _quantize_small_float(rgb[..., 0], 6)
    g = _quantize_small_float(rgb[..., 1], 6)
    b = _quantize_small_float(rgb[..., 2], 5)
    return jnp.stack([r, g, b], axis=-1)


def quantize_r16f(x):
    """Round-trip through R16F (the G-buffer depth format)."""
    return x.astype(jnp.float16).astype(jnp.float32)


def pack_unorm8(x):
    """float [0,1] -> u8 with the +0.5 rounding the shaders use."""
    return jnp.clip(x * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)


def unpack_unorm8(x):
    return x.astype(jnp.float32) / 255.0


def r11g11b10_unorm_pack(v):
    """XeGTAO.hlsli:75-82 (bent-normal packing)."""
    x = jnp.clip(v[..., 0], 0.0, 1.0)
    y = jnp.clip(v[..., 1], 0.0, 1.0)
    z = jnp.clip(v[..., 2], 0.0, 1.0)
    return ((x * 2047 + 0.5).astype(jnp.uint32)
            | ((y * 2047 + 0.5).astype(jnp.uint32) << 11)
            | ((z * 1023 + 0.5).astype(jnp.uint32) << 22))


def r11g11b10_unorm_unpack(p):
    """XeGTAO.hlsli:66-73."""
    x = (p & 0x7FF).astype(jnp.float32) / 2047.0
    y = ((p >> 11) & 0x7FF).astype(jnp.float32) / 2047.0
    z = ((p >> 22) & 0x3FF).astype(jnp.float32) / 1023.0
    return jnp.stack([x, y, z], axis=-1)


def srgb_approx(rgb):
    """Linear -> sRGB, pow(1/2.2) (color_spaces.glsl:68-70)."""
    return jnp.power(jnp.maximum(rgb, 0.0), 1.0 / 2.2)


def srgb_inverse_approx(srgb):
    """sRGB -> linear, pow(2.2) (color_spaces.glsl:73-75; albedo decode in
    raytrace.rgen.glsl:135)."""
    return jnp.power(jnp.maximum(srgb, 0.0), 2.2)
