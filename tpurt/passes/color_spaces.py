"""Color-space conversion library — complete port of the reference's
color_spaces.glsl (tobspr's GLSL utility collection, MIT).

The reference pipeline itself calls exactly one of these functions
(rgb_to_srgb_approx, tonemap.comp.glsl:37 — mirrored in
passes/encodings.srgb_approx); the rest of the library ships with the
reference as its app-facing color toolbox, so the full surface is ported
here for capability parity. All functions are vectorized over (..., 3)
jnp arrays (hue helpers over (...,)) and follow the GLSL formula for
formula, including the epsilon constants and the reference's own quirk of
`ycbcr_to_hcv` calling rgb_to_hcy (color_spaces.glsl:289 — kept
faithfully).

Reference: src/vk_renderer/shaders/color_spaces.glsl:36-321.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

HCV_EPSILON = 1e-10
HSL_EPSILON = 1e-10
HCY_EPSILON = 1e-10

SRGB_GAMMA = 1.0 / 2.2
SRGB_INVERSE_GAMMA = 2.2
SRGB_ALPHA = 0.055

# column-major GLSL constructor -> row-major matmul matrices (:47-59)
RGB_2_XYZ = jnp.array([[0.4124564, 0.3575761, 0.1804375],
                       [0.2126729, 0.7151522, 0.0721750],
                       [0.0193339, 0.1191920, 0.9503041]], jnp.float32)
XYZ_2_RGB = jnp.array([[3.2404542, -1.5371385, -0.4985314],
                       [-0.9692660, 1.8760108, 0.0415560],
                       [0.0556434, -0.2040259, 1.0572252]], jnp.float32)

LUMA_COEFFS = jnp.array([0.2126, 0.7152, 0.0722], jnp.float32)
_HCY_WTS = jnp.array([0.299, 0.587, 0.114], jnp.float32)


def _sat(v):
    return jnp.clip(v, 0.0, 1.0)


def get_luminance(rgb):
    """:64-66 — luminance of a LINEAR rgb color."""
    return jnp.sum(rgb * LUMA_COEFFS, axis=-1)


def rgb_to_srgb_approx(rgb):
    """:69-71."""
    return jnp.power(jnp.maximum(rgb, 0.0), SRGB_GAMMA)


def srgb_to_rgb_approx(srgb):
    """:74-76."""
    return jnp.power(jnp.maximum(srgb, 0.0), SRGB_INVERSE_GAMMA)


def linear_to_srgb(channel):
    """:79-84 (exact piecewise transfer)."""
    lo = 12.92 * channel
    hi = (1.0 + SRGB_ALPHA) * jnp.power(
        jnp.maximum(channel, 1e-20), 1.0 / 2.4) - SRGB_ALPHA
    return jnp.where(channel <= 0.0031308, lo, hi)


def srgb_to_linear(channel):
    """:87-92."""
    lo = channel / 12.92
    hi = jnp.power(jnp.maximum(
        (channel + SRGB_ALPHA) / (1.0 + SRGB_ALPHA), 1e-20), 2.4)
    return jnp.where(channel <= 0.04045, lo, hi)


def rgb_to_srgb(rgb):
    """:95-101 (exact, per channel)."""
    return linear_to_srgb(rgb)


def srgb_to_rgb(srgb):
    """:104-110."""
    return srgb_to_linear(srgb)


def rgb_to_xyz(rgb):
    """:113-115."""
    return jnp.einsum("ij,...j->...i", RGB_2_XYZ, rgb,
                      precision=jax.lax.Precision.HIGHEST)


def xyz_to_rgb(xyz):
    """:118-120."""
    return jnp.einsum("ij,...j->...i", XYZ_2_RGB, xyz,
                      precision=jax.lax.Precision.HIGHEST)


def xyz_to_xyY(xyz):
    """:123-128."""
    s = xyz[..., 0] + xyz[..., 1] + xyz[..., 2]
    return jnp.stack([xyz[..., 0] / s, xyz[..., 1] / s, xyz[..., 1]],
                     axis=-1)


def xyY_to_xyz(xyY):
    """:131-136."""
    y_lum = xyY[..., 2]
    x = y_lum * xyY[..., 0] / xyY[..., 1]
    z = y_lum * (1.0 - xyY[..., 0] - xyY[..., 1]) / xyY[..., 1]
    return jnp.stack([x, y_lum, z], axis=-1)


def rgb_to_xyY(rgb):
    """:139-142."""
    return xyz_to_xyY(rgb_to_xyz(rgb))


def xyY_to_rgb(xyY):
    """:145-148."""
    return xyz_to_rgb(xyY_to_xyz(xyY))


def rgb_to_hcv(rgb):
    """:151-159 (Hocevar/Persson branchless hue) -> (H, C, V)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    gb = g < b
    px = jnp.where(gb, b, g)
    py = jnp.where(gb, g, b)
    pz = jnp.where(gb, -1.0, 0.0)
    pw = jnp.where(gb, 2.0 / 3.0, -1.0 / 3.0)
    rp = r < px
    qx = jnp.where(rp, px, r)
    qy = py
    qz = jnp.where(rp, pw, pz)
    qw = jnp.where(rp, r, px)
    c = qx - jnp.minimum(qw, qy)
    h = jnp.abs((qw - qy) / (6.0 * c + HCV_EPSILON) + qz)
    return jnp.stack([h, c, qx], axis=-1)


def hue_to_rgb(hue):
    """:162-168, hue (...,) -> (..., 3)."""
    r = jnp.abs(hue * 6.0 - 3.0) - 1.0
    g = 2.0 - jnp.abs(hue * 6.0 - 2.0)
    b = 2.0 - jnp.abs(hue * 6.0 - 4.0)
    return _sat(jnp.stack([r, g, b], axis=-1))


def hsv_to_rgb(hsv):
    """:171-175."""
    rgb = hue_to_rgb(hsv[..., 0])
    return ((rgb - 1.0) * hsv[..., 1:2] + 1.0) * hsv[..., 2:3]


def hsl_to_rgb(hsl):
    """:178-183."""
    rgb = hue_to_rgb(hsl[..., 0])
    c = (1.0 - jnp.abs(2.0 * hsl[..., 2] - 1.0)) * hsl[..., 1]
    return (rgb - 0.5) * c[..., None] + hsl[..., 2:3]


def hcy_to_rgb(hcy):
    """:186-197."""
    rgb = hue_to_rgb(hcy[..., 0])
    z = jnp.sum(rgb * _HCY_WTS, axis=-1)
    y = hcy[..., 2]
    c = hcy[..., 1]
    c = jnp.where(y < z, c * (y / z),
                  jnp.where(z < 1.0, c * (1.0 - y) / (1.0 - z), c))
    return (rgb - z[..., None]) * c[..., None] + y[..., None]


def rgb_to_hsv(rgb):
    """:201-206."""
    hcv = rgb_to_hcv(rgb)
    s = hcv[..., 1] / (hcv[..., 2] + HCV_EPSILON)
    return jnp.stack([hcv[..., 0], s, hcv[..., 2]], axis=-1)


def rgb_to_hsl(rgb):
    """:209-215."""
    hcv = rgb_to_hcv(rgb)
    lum = hcv[..., 2] - hcv[..., 1] * 0.5
    s = hcv[..., 1] / (1.0 - jnp.abs(lum * 2.0 - 1.0) + HSL_EPSILON)
    return jnp.stack([hcv[..., 0], s, lum], axis=-1)


def rgb_to_hcy(rgb):
    """:218-231 (Schaeffer correction)."""
    hcv = rgb_to_hcv(rgb)
    y = jnp.sum(rgb * _HCY_WTS, axis=-1)
    z = jnp.sum(hue_to_rgb(hcv[..., 0]) * _HCY_WTS, axis=-1)
    c = jnp.where(y < z, hcv[..., 1] * z / (HCY_EPSILON + y),
                  hcv[..., 1] * (1.0 - z) / (HCY_EPSILON + 1.0 - y))
    return jnp.stack([hcv[..., 0], c, y], axis=-1)


def rgb_to_ycbcr(rgb):
    """:234-240."""
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    cb = (rgb[..., 2] - y) * 0.565
    cr = (rgb[..., 0] - y) * 0.713
    return jnp.stack([y, cb, cr], axis=-1)


def ycbcr_to_rgb(yuv):
    """:243-249."""
    return jnp.stack([
        yuv[..., 0] + 1.403 * yuv[..., 2],
        yuv[..., 0] - 0.344 * yuv[..., 1] - 0.714 * yuv[..., 2],
        yuv[..., 0] + 1.770 * yuv[..., 1]], axis=-1)


# chained conversions (:254-321) — generated faithfully, including the
# reference's ycbcr_to_hcv typo that routes through rgb_to_hcy (:289)

def xyz_to_srgb(xyz):
    return rgb_to_srgb(xyz_to_rgb(xyz))


def xyY_to_srgb(xyY):
    return rgb_to_srgb(xyY_to_rgb(xyY))


def hue_to_srgb(hue):
    return rgb_to_srgb(hue_to_rgb(hue))


def hsv_to_srgb(hsv):
    return rgb_to_srgb(hsv_to_rgb(hsv))


def hsl_to_srgb(hsl):
    return rgb_to_srgb(hsl_to_rgb(hsl))


def hcy_to_srgb(hcy):
    return rgb_to_srgb(hcy_to_rgb(hcy))


def ycbcr_to_srgb(yuv):
    return rgb_to_srgb(ycbcr_to_rgb(yuv))


def srgb_to_xyz(srgb):
    return rgb_to_xyz(srgb_to_rgb(srgb))


def hue_to_xyz(hue):
    return rgb_to_xyz(hue_to_rgb(hue))


def hsv_to_xyz(hsv):
    return rgb_to_xyz(hsv_to_rgb(hsv))


def hsl_to_xyz(hsl):
    return rgb_to_xyz(hsl_to_rgb(hsl))


def hcy_to_xyz(hcy):
    return rgb_to_xyz(hcy_to_rgb(hcy))


def ycbcr_to_xyz(yuv):
    return rgb_to_xyz(ycbcr_to_rgb(yuv))


def srgb_to_xyY(srgb):
    return rgb_to_xyY(srgb_to_rgb(srgb))


def hue_to_xyY(hue):
    return rgb_to_xyY(hue_to_rgb(hue))


def hsv_to_xyY(hsv):
    return rgb_to_xyY(hsv_to_rgb(hsv))


def hsl_to_xyY(hsl):
    return rgb_to_xyY(hsl_to_rgb(hsl))


def hcy_to_xyY(hcy):
    return rgb_to_xyY(hcy_to_rgb(hcy))


def ycbcr_to_xyY(yuv):
    return rgb_to_xyY(ycbcr_to_rgb(yuv))


def srgb_to_hcv(srgb):
    return rgb_to_hcv(srgb_to_rgb(srgb))


def xyz_to_hcv(xyz):
    return rgb_to_hcv(xyz_to_rgb(xyz))


def xyY_to_hcv(xyY):
    return rgb_to_hcv(xyY_to_rgb(xyY))


def hue_to_hcv(hue):
    return rgb_to_hcv(hue_to_rgb(hue))


def hsv_to_hcv(hsv):
    return rgb_to_hcv(hsv_to_rgb(hsv))


def hsl_to_hcv(hsl):
    return rgb_to_hcv(hsl_to_rgb(hsl))


def hcy_to_hcv(hcy):
    return rgb_to_hcv(hcy_to_rgb(hcy))


def ycbcr_to_hcv(yuv):
    # color_spaces.glsl:289 calls rgb_to_hcy here — kept faithfully
    return rgb_to_hcy(ycbcr_to_rgb(yuv))


def srgb_to_hsv(srgb):
    return rgb_to_hsv(srgb_to_rgb(srgb))


def xyz_to_hsv(xyz):
    return rgb_to_hsv(xyz_to_rgb(xyz))


def xyY_to_hsv(xyY):
    return rgb_to_hsv(xyY_to_rgb(xyY))


def hue_to_hsv(hue):
    return rgb_to_hsv(hue_to_rgb(hue))


def hsl_to_hsv(hsl):
    return rgb_to_hsv(hsl_to_rgb(hsl))


def hcy_to_hsv(hcy):
    return rgb_to_hsv(hcy_to_rgb(hcy))


def ycbcr_to_hsv(yuv):
    return rgb_to_hsv(ycbcr_to_rgb(yuv))


def srgb_to_hsl(srgb):
    return rgb_to_hsl(srgb_to_rgb(srgb))


def xyz_to_hsl(xyz):
    return rgb_to_hsl(xyz_to_rgb(xyz))


def xyY_to_hsl(xyY):
    return rgb_to_hsl(xyY_to_rgb(xyY))


def hue_to_hsl(hue):
    return rgb_to_hsl(hue_to_rgb(hue))


def hsv_to_hsl(hsv):
    return rgb_to_hsl(hsv_to_rgb(hsv))


def hcy_to_hsl(hcy):
    return rgb_to_hsl(hcy_to_rgb(hcy))


def ycbcr_to_hsl(yuv):
    return rgb_to_hsl(ycbcr_to_rgb(yuv))


def srgb_to_hcy(srgb):
    return rgb_to_hcy(srgb_to_rgb(srgb))


def xyz_to_hcy(xyz):
    return rgb_to_hcy(xyz_to_rgb(xyz))


def xyY_to_hcy(xyY):
    return rgb_to_hcy(xyY_to_rgb(xyY))


def hue_to_hcy(hue):
    return rgb_to_hcy(hue_to_rgb(hue))


def hsv_to_hcy(hsv):
    return rgb_to_hcy(hsv_to_rgb(hsv))


def hsl_to_hcy(hsl):
    return rgb_to_hcy(hsl_to_rgb(hsl))


def ycbcr_to_hcy(yuv):
    return rgb_to_hcy(ycbcr_to_rgb(yuv))


def srgb_to_ycbcr(srgb):
    return rgb_to_ycbcr(srgb_to_rgb(srgb))


def xyz_to_ycbcr(xyz):
    return rgb_to_ycbcr(xyz_to_rgb(xyz))


def xyY_to_ycbcr(xyY):
    return rgb_to_ycbcr(xyY_to_rgb(xyY))


def hue_to_ycbcr(hue):
    return rgb_to_ycbcr(hue_to_rgb(hue))


def hsv_to_ycbcr(hsv):
    return rgb_to_ycbcr(hsv_to_rgb(hsv))


def hsl_to_ycbcr(hsl):
    return rgb_to_ycbcr(hsl_to_rgb(hsl))


def hcy_to_ycbcr(hcy):
    return rgb_to_ycbcr(hcy_to_rgb(hcy))
