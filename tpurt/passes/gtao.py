"""XeGTAO ambient occlusion in JAX.

Ground-up reimplementation of Intel XeGTAO v1.30 as three vectorized jnp
image passes (reference: shaders/xegtao/XeGTAO.hlsli, host side
vk_xe_gtao.rs):

  1. prefilter_depths — 5-level weighted depth pyramid
     (XeGTAO_PrefilterDepths16x16, XeGTAO.hlsli:617-694). The reference
     builds all 5 mips in one dispatch via groupshared memory; mip N from
     2x2 quads of mip N-1 is numerically identical, and each reduction is
     a strided-slice reduce that XLA fuses.
  2. main_pass — horizon-slice integration (XeGTAO_MainPass,
     XeGTAO.hlsli:246-577): per-pixel Hilbert+R2 spatio-temporal noise,
     slice/step loops unrolled at trace time (quality tiers are jit
     specialization — the analogue of the reference's SPIR-V
     specialization constants, vk_xe_gtao.rs:1028-1047), per-sample mip
     selection served from a flattened mip atlas with one gather.
  3. denoise — edge-aware blur (XeGTAO_Denoise, XeGTAO.hlsli:744-836),
     N passes by denoise level (vk_xe_gtao.rs:1099-1139).

Stored-image quantization points match the reference formats: depth mips
R16F, working AO term u8 (R32_UINT 0..255), edges u8 (R8_UNORM), final AO
term u16 (the R32_UINT final store is UNCLAMPED and reaches ~383 after the
×1.5 occlusion-term scale, XeGTAO.hlsli:729-731); intermediate math runs
in f32 where the reference uses min16float.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from .encodings import quantize_r16f
from .vec import length, normalize

XE_GTAO_DEPTH_MIP_LEVELS = 5
XE_GTAO_OCCLUSION_TERM_SCALE = 1.5

# Defaults (XeGTAO.h:107-114) with the renderer's overrides
# (vk_xe_gtao.rs:261-272): effect radius fixed to 0.2.
DEFAULT_CONSTANTS = dict(
    effect_radius=0.2,
    effect_falloff_range=0.615,
    radius_multiplier=1.457,
    sample_distribution_power=2.0,
    thin_occluder_compensation=0.0,
    final_value_power=2.2,
    depth_mip_sampling_offset=3.30,
)

# Quality tiers (slice_count, steps_per_slice) — vk_xe_gtao.rs:99-110.
QUALITY_LOW = (1, 2)
QUALITY_MEDIUM = (2, 2)
QUALITY_HIGH = (3, 3)
QUALITY_ULTRA = (9, 3)

PI = 3.1415926535897932384626433832795
PI_HALF = 1.5707963267948966192313216916398


@dataclass(frozen=True)
class GtaoSettings:
    """Static (jit-specializing) settings — the reference's GtaoSettings
    (vk_xe_gtao.rs:93-111). denoise: 0 disabled, 1 sharp, 2 medium, 3 soft.
    bent_normals enables the directional component (XeGTAO v1.30's
    XE_GTAO_COMPUTE_BENT_NORMALS path, compiled out in the reference app)."""

    slice_count: int = 9
    steps_per_slice: int = 3
    denoise: int = 1
    bent_normals: bool = False
    # Arithmetic precision:
    #  * "exact" (default) — f32 everywhere.
    #  * "fp16" — emulate the reference's min16float (lpfloat) pipeline
    #    (XE_GTAO_USE_HALF_FLOAT_PRECISION=1, prefilter_depths.comp.hlsl:1-3):
    #    every lpfloat-typed intermediate of XeGTAO.hlsli's
    #    prefilter/main/denoise computes in jnp.float16 (XLA rounds to f16
    #    after each op — the same round-after-op semantics as GPU
    #    RelaxedPrecision fp16, modulo double-rounding corner cases). The
    #    parity knob for the one arithmetic-precision deviation in
    #    docs/PARITY.md.
    precision: str = "exact"

    @property
    def fp16(self) -> bool:
        return self.precision == "fp16"

    @property
    def denoise_blur_beta(self) -> float:
        return 1e4 if self.denoise == 0 else 1.2

    @property
    def num_denoise_passes(self) -> int:
        # vk_xe_gtao.rs:1099-1139: (denoise-1) regular passes + 1 final
        return max(self.denoise - 1, 0) + 1


def gtao_constants(width: int, height: int, znear: float, zfar: float,
                   fovy: float, aspect: float) -> dict:
    """Dynamic GTAOConstants (GTAOUpdateConstants, XeGTAO.h:170-204, and
    vk_xe_gtao.rs:354-400)."""
    tan_half_fovy = math.tan(fovy * 0.5)
    tan_half_fovx = tan_half_fovy * aspect
    ndc_to_view_mul = (tan_half_fovx * 2.0, tan_half_fovy * -2.0)
    ndc_to_view_add = (-tan_half_fovx, tan_half_fovy)
    consts = dict(DEFAULT_CONSTANTS)
    consts.update(
        viewport_size=(width, height),
        viewport_pixel_size=(1.0 / width, 1.0 / height),
        depth_unpack=((zfar * znear) / (zfar - znear), zfar / (zfar - znear)),
        camera_tan_half_fov=(tan_half_fovx, tan_half_fovy),
        ndc_to_view_mul=ndc_to_view_mul,
        ndc_to_view_add=ndc_to_view_add,
        ndc_to_view_mul_x_pixel_size=(ndc_to_view_mul[0] / width,
                                      ndc_to_view_mul[1] / height),
    )
    return consts


# ---------------------------------------------------------------- noise ----

def _hilbert_lut_64() -> np.ndarray:
    """64x64 Hilbert curve index LUT (HilbertIndex, XeGTAO.h:117-142)."""
    lut = np.zeros((64, 64), np.uint32)
    for y in range(64):
        for x in range(64):
            px, py = x, y
            index = 0
            level = 32
            while level > 0:
                rx = 1 if (px & level) > 0 else 0
                ry = 1 if (py & level) > 0 else 0
                index += level * level * ((3 * rx) ^ ry)
                if ry == 0:
                    if rx == 1:
                        px = 63 - px
                        py = 63 - py
                    px, py = py, px
                level //= 2
            lut[y, x] = index
    return lut


_HILBERT_LUT = _hilbert_lut_64()


def spatio_temporal_noise(height: int, width: int, noise_index,
                          rows=None):
    """Hilbert-driven R2 sequence (main_pass.comp.hlsl:48-65). `rows` gives
    absolute row indices for a band (defaults to 0..height)."""
    lut = jnp.asarray(_HILBERT_LUT)
    yy = (jnp.arange(height) if rows is None else rows) % 64
    xx = jnp.arange(width) % 64
    idx = lut[yy[:, None], xx[None, :]].astype(jnp.uint32)
    idx = idx + jnp.uint32(288) * (jnp.uint32(noise_index) % 64)
    fidx = idx.astype(jnp.float32)
    nx = jnp.mod(0.5 + fidx * 0.75487766624669276005, 1.0)
    ny = jnp.mod(0.5 + fidx * 0.5698402909980532659114, 1.0)
    return nx, ny


# ------------------------------------------------------------- prefilter ----

def _lp_caster(fp16: bool):
    """lpfloat emulation: cast to f16 when the fp16 pipeline is on (XLA
    rounds f16 arithmetic after every op), identity otherwise."""
    if not fp16:
        return lambda x: x
    return lambda x: jnp.asarray(x).astype(jnp.float16)


def _depth_mip_filter(d0, d1, d2, d3, consts, fp16: bool = False):
    """Weighted 2x2 depth reduction (XeGTAO_DepthMIPFilter, :580-604).
    Every quantity in the reference filter is lpfloat — with fp16 the
    whole filter computes in f16."""
    lp = _lp_caster(fp16)
    d0, d1, d2, d3 = lp(d0), lp(d1), lp(d2), lp(d3)
    max_depth = jnp.maximum(jnp.maximum(d0, d1), jnp.maximum(d2, d3))
    depth_range_scale = 0.75
    effect_radius = (depth_range_scale * lp(consts["effect_radius"])
                     * lp(consts["radius_multiplier"]))
    falloff_range = lp(consts["effect_falloff_range"]) * effect_radius
    falloff_from = effect_radius * (1.0 - lp(consts["effect_falloff_range"]))
    falloff_mul = -1.0 / falloff_range
    falloff_add = falloff_from / falloff_range + 1.0

    def w(d):
        return jnp.clip((max_depth - d) * falloff_mul + falloff_add, 0.0, 1.0)

    w0, w1, w2, w3 = w(d0), w(d1), w(d2), w(d3)
    wsum = w0 + w1 + w2 + w3
    return (w0 * d0 + w1 * d1 + w2 * d2 + w3 * d3) / wsum


def prefilter_depths(view_depth, consts, fp16: bool = False):
    """(H, W) linear view depth -> list of 5 R16F-quantized mips.

    The renderer feeds linear view-space depth (XE_GTAO_VIEWSPACE_DEPTH,
    prefilter_depths.comp.hlsl:3), so mip0 is just fp16 clamping
    (XeGTAO_ClampDepth)."""
    d = jnp.clip(view_depth, 0.0, 65504.0)
    mips = [quantize_r16f(d)]
    for _ in range(XE_GTAO_DEPTH_MIP_LEVELS - 1):
        prev = mips[-1]
        h, w = prev.shape
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        # 2x2 grouping as a row split, then column strides on the
        # half-height arrays
        x = prev[:h2 * 2, :w2 * 2]
        top = x[0::2]
        bot = x[1::2]
        m = _depth_mip_filter(top[:, 0::2], top[:, 1::2],
                              bot[:, 0::2], bot[:, 1::2], consts, fp16=fp16)
        mips.append(quantize_r16f(m.astype(jnp.float32)))
    return mips


def _mip_atlas(mips):
    """Flatten the mip chain for single-gather dynamic-mip sampling."""
    flat = jnp.concatenate([m.reshape(-1) for m in mips])
    sizes = np.array([m.shape for m in mips], np.int32)  # (5, 2) h, w
    offsets = np.concatenate([[0], np.cumsum(sizes[:, 0] * sizes[:, 1])[:-1]])
    return flat, jnp.asarray(sizes), jnp.asarray(offsets.astype(np.int32))


def _sample_mip_point(flat, sizes, offsets, uv_x, uv_y, mip):
    """Point-sample the depth pyramid at integer mip level (the reference's
    point-point-point sampler, clamp addressing)."""
    h = sizes[mip, 0]
    w = sizes[mip, 1]
    x = jnp.clip((uv_x * w.astype(jnp.float32)).astype(jnp.int32), 0, w - 1)
    y = jnp.clip((uv_y * h.astype(jnp.float32)).astype(jnp.int32), 0, h - 1)
    return flat[offsets[mip] + y * w + x]


# ------------------------------------------------------------- edge math ----

def _calculate_edges(center, left, right, top, bottom):
    """XeGTAO_CalculateEdges (:121-130). Returns (..., 4) LRTB."""
    e = jnp.stack([left, right, top, bottom], axis=-1) - center[..., None]
    slope_lr = (e[..., 1] - e[..., 0]) * 0.5
    slope_tb = (e[..., 3] - e[..., 2]) * 0.5
    adj = e + jnp.stack([slope_lr, -slope_lr, slope_tb, -slope_tb], axis=-1)
    e = jnp.minimum(jnp.abs(e), jnp.abs(adj))
    return jnp.clip(1.25 - e / (center[..., None] * 0.011), 0.0, 1.0)


def pack_edges(edges_lrtb):
    """XeGTAO_PackEdges (:133-142) -> u8."""
    q = jnp.round(jnp.clip(edges_lrtb, 0.0, 1.0) * 2.9)
    return (q[..., 0] * 64 + q[..., 1] * 16 + q[..., 2] * 4 + q[..., 3]
            ).astype(jnp.uint8)


def unpack_edges(packed_u8):
    """XeGTAO_UnpackEdges (:696-706) -> (..., 4) floats in {0,1/3,2/3,1}."""
    p = packed_u8.astype(jnp.int32)
    return jnp.stack([((p >> 6) & 3), ((p >> 4) & 3),
                      ((p >> 2) & 3), (p & 3)], axis=-1).astype(jnp.float32) / 3.0


# ------------------------------------------------------- fast math ports ----

def _fast_sqrt(x):
    """XeGTAO_FastSqrt (:172-175) — bit-trick approximation, kept for parity."""
    xi = jnp.asarray(x, jnp.float32).view(jnp.int32)
    return (jnp.int32(0x1FBD1DF5) + (xi >> 1)).view(jnp.float32)


def _fast_acos(x):
    """XeGTAO_FastACos (:177-185), input [-1,1] -> [0, PI]."""
    ax = jnp.abs(x)
    res = -0.156583 * ax + PI_HALF
    res = res * _fast_sqrt(jnp.maximum(1.0 - ax, 0.0))
    return jnp.where(x >= 0, res, PI - res)


def _rot_from_minus_z(to):
    """XeGTAO_RotFromToMatrix specialized to from = (0,0,-1)
    (XeGTAO.hlsli:212-244), vectorized over (..., 3) targets. Returns the
    rotated image of a vector function: rot(v) applies the matrix."""
    e = -to[..., 2]
    f = jnp.abs(e)
    # v = cross((0,0,-1), to) = (to_y, -to_x, 0)
    vx = to[..., 1]
    vy = -to[..., 0]
    h = 1.0 / jnp.maximum(1.0 + e, 1e-6)
    m00 = e + h * vx * vx
    m01 = h * vx * vy        # hvxy - v.z with v.z = 0
    m02 = vy                 # hvxz + v.y with v.z = 0
    m10 = h * vx * vy
    m11 = e + h * vy * vy
    m12 = -vx
    m20 = -vy
    m21 = vx
    m22 = e                  # e + h*v.z*v.z with v.z = 0
    near_identity = f > (1.0 - 0.0003)

    def rot(v):
        rx = m00 * v[..., 0] + m01 * v[..., 1] + m02 * v[..., 2]
        ry = m10 * v[..., 0] + m11 * v[..., 1] + m12 * v[..., 2]
        rz = m20 * v[..., 0] + m21 * v[..., 1] + m22 * v[..., 2]
        out = jnp.stack([rx, ry, rz], axis=-1)
        return jnp.where(near_identity[..., None], v, out)

    return rot


def encode_visibility_bent_normal(visibility, bent_normal):
    """XeGTAO_EncodeVisibilityBentNormal (:187-190): RGBA8 pack of
    (bn*0.5+0.5, visibility) into uint32."""
    def u8(x):
        return jnp.clip(x * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint32)

    b = bent_normal * 0.5 + 0.5
    return (u8(b[..., 0]) | (u8(b[..., 1]) << 8) | (u8(b[..., 2]) << 16)
            | (u8(jnp.clip(visibility, 0.0, 1.0)) << 24))


def decode_visibility_bent_normal(packed):
    """XeGTAO_DecodeVisibilityBentNormal (:192-197)."""
    def f(x):
        return x.astype(jnp.float32) / 255.0

    bn = jnp.stack([f(packed & 0xFF), f((packed >> 8) & 0xFF),
                    f((packed >> 16) & 0xFF)], axis=-1) * 2.0 - 1.0
    visibility = f(packed >> 24)
    return visibility, bn


def _shift_clamp(img, dy, dx):
    """img shifted so out[y,x] = img[y+dy, x+dx], clamped at borders."""
    h, w = img.shape[:2]
    ys = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


# ------------------------------------------------------------- main pass ----

def main_pass(depth_mips, normal_enc, consts, settings: GtaoSettings,
              noise_index, row_start: int = 0, num_rows=None):
    """XeGTAO_MainPass.

    depth_mips: output of prefilter_depths over the FULL image. normal_enc:
    (H, W, 3) encoded G-buffer normals (*0.5+0.5, view space, y/z negated —
    decoded exactly like main_pass.comp.hlsl:29-46).

    row_start/num_rows restrict the *output* to a horizontal band (absolute
    pixel coordinates are preserved, sampling still sees the whole pyramid) —
    the multi-chip path computes only its own band + denoise halo.
    Returns (ao_u8 (R,W), edges_u8 (R,W)).

    With settings.precision == "fp16" every lpfloat-typed intermediate of
    the reference (XeGTAO.hlsli:246-576 under
    XE_GTAO_USE_HALF_FLOAT_PRECISION) computes in jnp.float16, mirroring
    the HLSL typing: depths/edges/normals/view-vec/falloff/horizon
    cosines/visibility are lpfloat; screen positions, viewspace sample
    positions and sample deltas stay float32 (the reference keeps those
    float — "using lpfloat for sampleDelta causes precision issues",
    :467-468). FastACos rounds its result to f16 (its internal bit-trick
    sqrt is f32 either way, matching HLSL asuint upconversion).
    """
    lp = _lp_caster(settings.fp16)
    lpdt = jnp.float16 if settings.fp16 else jnp.float32
    d0 = depth_mips[0]
    h, w = d0.shape
    num_rows = h if num_rows is None else num_rows
    pixel_size = jnp.asarray(consts["viewport_pixel_size"], jnp.float32)
    ndc_mul = jnp.asarray(consts["ndc_to_view_mul"], jnp.float32)
    ndc_add = jnp.asarray(consts["ndc_to_view_add"], jnp.float32)

    full_image = isinstance(row_start, int) and row_start == 0 and num_rows == h
    rows = jnp.clip(row_start + jnp.arange(num_rows), 0, h - 1)
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
    ys = (rows.astype(jnp.float32) + 0.5) / h
    sp_x, sp_y = jnp.meshgrid(xs, ys)  # normalized screen pos (band)

    def band(img):
        return img if full_image else img[rows]

    viewspace_z = lp(band(d0))
    pix_l = lp(band(_shift_clamp(d0, 0, -1)))
    pix_r = lp(band(_shift_clamp(d0, 0, 1)))
    pix_t = lp(band(_shift_clamp(d0, -1, 0)))
    pix_b = lp(band(_shift_clamp(d0, 1, 0)))
    normal_enc = band(normal_enc)

    edges = _calculate_edges(viewspace_z, pix_l, pix_r, pix_t, pix_b)
    edges_u8 = pack_edges(edges)

    # decode normals (main_pass.comp.hlsl:29-46); lpfloat3 argument (:246)
    n = normal_enc * 2.0 - 1.0
    viewspace_normal = lp(normalize(n))

    viewspace_z = viewspace_z * 0.99920  # fp16 depth offset (:284)

    def view_pos(spx, spy, z):
        x = (ndc_mul[0] * spx + ndc_add[0]) * z
        y = (ndc_mul[1] * spy + ndc_add[1]) * z
        return jnp.stack([x, y, z], axis=-1)

    pix_center_pos = view_pos(sp_x, sp_y, viewspace_z.astype(jnp.float32))
    view_vec = lp(-normalize(pix_center_pos))

    # lpfloat scalar block (:302-317)
    effect_radius = lp(consts["effect_radius"]) * lp(
        consts["radius_multiplier"])
    sample_distribution_power = lp(consts["sample_distribution_power"])
    thin_occluder_compensation = lp(consts["thin_occluder_compensation"])
    falloff_range = lp(consts["effect_falloff_range"]) * effect_radius
    falloff_from = effect_radius * (1.0 - lp(consts["effect_falloff_range"]))
    falloff_mul = -1.0 / falloff_range
    falloff_add = falloff_from / falloff_range + 1.0

    visibility = jnp.zeros((num_rows, w), lpdt)
    bent = jnp.zeros((num_rows, w, 3), lpdt)
    rot_to_view = _rot_from_minus_z(view_vec) if settings.bent_normals else None

    noise_slice, noise_sample = spatio_temporal_noise(
        num_rows, w, noise_index, rows=rows)
    noise_slice, noise_sample = lp(noise_slice), lp(noise_sample)

    pixel_too_close_threshold = 1.3
    ndc_mul_x_pix = jnp.asarray(consts["ndc_to_view_mul_x_pixel_size"],
                                jnp.float32)
    # float2 pixelDirRBViewspaceSizeAtCenterZ (:339); lpfloat radius (:341)
    pixel_dir_rb_viewspace_size = (viewspace_z.astype(jnp.float32)
                                   * ndc_mul_x_pix[0])
    screenspace_radius = effect_radius / lp(pixel_dir_rb_viewspace_size)

    visibility += jnp.clip((10.0 - screenspace_radius) / 100.0, 0.0, 1.0) * 0.5
    min_s = pixel_too_close_threshold / screenspace_radius

    flat, sizes, offsets = _mip_atlas(depth_mips)

    slice_count = settings.slice_count
    steps_per_slice = settings.steps_per_slice

    for slice_i in range(slice_count):
        slice_k = (slice_i + noise_slice) / slice_count
        phi = slice_k * PI
        cos_phi = jnp.cos(phi)
        sin_phi = jnp.sin(phi)
        omega_x = cos_phi * screenspace_radius
        omega_y = -sin_phi * screenspace_radius

        direction_vec = jnp.stack(
            [cos_phi, sin_phi, jnp.zeros_like(cos_phi)], axis=-1)
        ortho_direction_vec = direction_vec - (
            jnp.sum(direction_vec * view_vec, -1, keepdims=True) * view_vec)
        axis_vec = jnp.cross(ortho_direction_vec, view_vec)
        axis_vec = normalize(axis_vec)

        projected_normal = viewspace_normal - axis_vec * jnp.sum(
            viewspace_normal * axis_vec, -1, keepdims=True)
        sign_norm = jnp.sign(jnp.sum(ortho_direction_vec * projected_normal, -1))
        projected_normal_len = length(projected_normal)
        # f16 flushes the f32 guard epsilon to 0 — use the smallest f16
        # normal there (the reference divides unguarded; saturate() on a
        # GPU maps the resulting NaN/inf to [0,1], jnp.clip does not)
        pn_eps = 6.104e-05 if settings.fp16 else 1e-20
        cos_norm = jnp.clip(
            jnp.sum(projected_normal * view_vec, -1)
            / jnp.maximum(projected_normal_len, pn_eps), 0.0, 1.0)
        n_angle = sign_norm * lp(_fast_acos(cos_norm))

        low_horizon_cos0 = jnp.cos(n_angle + PI_HALF)
        low_horizon_cos1 = jnp.cos(n_angle - PI_HALF)
        horizon_cos0 = low_horizon_cos0
        horizon_cos1 = low_horizon_cos1

        for step in range(steps_per_slice):
            step_base_noise = ((slice_i + step * steps_per_slice)
                               * 0.6180339887498948482)
            step_noise = jnp.mod(noise_sample + step_base_noise, 1.0)
            s = (step + step_noise) / steps_per_slice
            s = jnp.power(s, sample_distribution_power) + min_s

            sample_offset_x = s * omega_x
            sample_offset_y = s * omega_y
            sample_offset_len = jnp.sqrt(sample_offset_x ** 2
                                         + sample_offset_y ** 2)
            mip_level = jnp.clip(
                jnp.log2(jnp.maximum(sample_offset_len, 1e-20))
                - consts["depth_mip_sampling_offset"],
                0, XE_GTAO_DEPTH_MIP_LEVELS)
            # MIN_MAG_MIP_POINT: nearest mip
            mip = jnp.clip(jnp.round(mip_level).astype(jnp.int32), 0,
                           XE_GTAO_DEPTH_MIP_LEVELS - 1)

            # sampleOffset = round(...) * (lpfloat2)ViewportPixelSize (:443)
            so_x = jnp.round(sample_offset_x) * lp(pixel_size[0])
            so_y = jnp.round(sample_offset_y) * lp(pixel_size[1])

            def horizon_sample(sx, sy, low_cos, horizon):
                # screen pos / SZ / samplePos / sampleDelta stay float32
                # (:459-468); dist, horizonVec, falloffBase are lpfloat
                sz = _sample_mip_point(flat, sizes, offsets,
                                       jnp.clip(sx, 0.0, 1.0),
                                       jnp.clip(sy, 0.0, 1.0), mip)
                sample_pos = view_pos(sx.astype(jnp.float32),
                                      sy.astype(jnp.float32), sz)
                delta = sample_pos - pix_center_pos
                dist = length(delta)
                horizon_vec = lp(delta / jnp.maximum(dist, 1e-20)[..., None])
                falloff_base = jnp.sqrt(
                    lp(delta[..., 0]) ** 2 + lp(delta[..., 1]) ** 2
                    + lp(delta[..., 2]
                         * (1.0 + thin_occluder_compensation)) ** 2)
                weight = jnp.clip(falloff_base * falloff_mul + falloff_add,
                                  0.0, 1.0)
                shc = jnp.sum(horizon_vec * view_vec, -1)
                shc = low_cos + (shc - low_cos) * weight
                return jnp.maximum(horizon, shc)

            horizon_cos0 = horizon_sample(sp_x + so_x, sp_y + so_y,
                                          low_horizon_cos0, horizon_cos0)
            horizon_cos1 = horizon_sample(sp_x - so_x, sp_y - so_y,
                                          low_horizon_cos1, horizon_cos1)

        projected_normal_len = projected_normal_len + (
            1.0 - projected_normal_len) * 0.05  # over-darkening fudge (:533)

        h0 = -lp(_fast_acos(jnp.clip(horizon_cos1, -1.0, 1.0)))
        h1 = lp(_fast_acos(jnp.clip(horizon_cos0, -1.0, 1.0)))
        sin_n = jnp.sin(n_angle)
        iarc0 = (cos_norm + 2.0 * h0 * sin_n - jnp.cos(2.0 * h0 - n_angle)) / 4.0
        iarc1 = (cos_norm + 2.0 * h1 * sin_n - jnp.cos(2.0 * h1 - n_angle)) / 4.0
        visibility += projected_normal_len * (iarc0 + iarc1)

        if settings.bent_normals:
            # "Algorithm 2" directional component (XeGTAO.hlsli:548-554)
            t0v = (6.0 * jnp.sin(h0 - n_angle) - jnp.sin(3.0 * h0 - n_angle)
                   + 6.0 * jnp.sin(h1 - n_angle) - jnp.sin(3.0 * h1 - n_angle)
                   + 16.0 * sin_n
                   - 3.0 * (jnp.sin(h0 + n_angle) + jnp.sin(h1 + n_angle))) / 12.0
            t1v = (-jnp.cos(3.0 * h0 - n_angle) - jnp.cos(3.0 * h1 - n_angle)
                   + 8.0 * jnp.cos(n_angle)
                   - 3.0 * (jnp.cos(h0 + n_angle) + jnp.cos(h1 + n_angle))) / 12.0
            local_bn = jnp.stack([direction_vec[..., 0] * t0v,
                                  direction_vec[..., 1] * t0v,
                                  -t1v], axis=-1)
            bent = bent + rot_to_view(local_bn) * projected_normal_len[..., None]

    visibility = visibility / slice_count
    visibility = jnp.power(jnp.maximum(visibility, 0.0),
                           consts["final_value_power"])
    visibility = jnp.maximum(0.03, visibility)

    # XeGTAO_OutputWorkingTerm (:199-207)
    vis_packed = jnp.clip(visibility / XE_GTAO_OCCLUSION_TERM_SCALE, 0.0, 1.0)
    if settings.bent_normals:
        bn = normalize(bent)
        return encode_visibility_bent_normal(vis_packed, bn), edges_u8
    # store conversion in f32 (uint(vis*255.0+0.5), float literals :206)
    ao_u8 = (vis_packed.astype(jnp.float32) * 255.0 + 0.5).astype(jnp.uint8)
    return ao_u8, edges_u8


# ---------------------------------------------------------------- denoise ---

def denoise_pass(ao_u8, edges_u8, settings: GtaoSettings, final_apply: bool):
    """One edge-aware denoise pass (XeGTAO_Denoise, :744-836). With bent
    normals enabled the AO term is the packed R8G8B8A8 (bn, vis) uint32 and
    the blur runs over the 4-vector (AOTermType, XeGTAO.hlsli:708-712).
    With settings.fp16 the blur computes in f16 (AO terms, edge weights and
    the weighted sums are all lpfloat in the reference)."""
    lp = _lp_caster(settings.fp16)
    lpdt = jnp.float16 if settings.fp16 else jnp.float32
    blur = settings.denoise_blur_beta if final_apply \
        else settings.denoise_blur_beta / 5.0
    diag_weight = 0.85 * 0.5

    if settings.bent_normals:
        v, bn = decode_visibility_bent_normal(ao_u8)
        vis = lp(jnp.concatenate([bn, v[..., None]], axis=-1))  # (..., 4)
    else:
        vis = lp(ao_u8.astype(jnp.float32) / 255.0)
    edges_c = lp(unpack_edges(edges_u8))
    edges_l = lp(unpack_edges(_shift_clamp(edges_u8, 0, -1)))
    edges_r = lp(unpack_edges(_shift_clamp(edges_u8, 0, 1)))
    edges_t = lp(unpack_edges(_shift_clamp(edges_u8, -1, 0)))
    edges_b = lp(unpack_edges(_shift_clamp(edges_u8, 1, 0)))

    # symmetry enforcement (:780)
    edges_c = edges_c * jnp.stack([edges_l[..., 1], edges_r[..., 0],
                                   edges_t[..., 3], edges_b[..., 2]], axis=-1)
    # AO leak for 3-4 edge pixels (:782-786)
    leak_threshold, leak_strength = 2.5, 0.5
    edginess = (jnp.clip(4.0 - leak_threshold - jnp.sum(edges_c, -1),
                         0.0, 1.0) / (4.0 - leak_threshold)) * leak_strength
    edges_c = jnp.clip(edges_c + edginess[..., None], 0.0, 1.0)

    w_tl = diag_weight * (edges_c[..., 0] * edges_l[..., 2]
                          + edges_c[..., 2] * edges_t[..., 0])
    w_tr = diag_weight * (edges_c[..., 2] * edges_t[..., 1]
                          + edges_c[..., 1] * edges_r[..., 2])
    w_bl = diag_weight * (edges_c[..., 3] * edges_b[..., 0]
                          + edges_c[..., 0] * edges_l[..., 3])
    w_br = diag_weight * (edges_c[..., 1] * edges_r[..., 3]
                          + edges_c[..., 3] * edges_b[..., 1])

    multi = settings.bent_normals

    def wmul(value, weight):
        return value * (weight[..., None] if multi else weight)

    sum_weight = jnp.full(vis.shape[:2], blur, lpdt)
    total = wmul(vis, sum_weight)

    def add(value, weight, total, sum_weight):
        return total + wmul(value, weight), sum_weight + weight

    total, sum_weight = add(_shift_clamp(vis, 0, -1), edges_c[..., 0], total, sum_weight)
    total, sum_weight = add(_shift_clamp(vis, 0, 1), edges_c[..., 1], total, sum_weight)
    total, sum_weight = add(_shift_clamp(vis, -1, 0), edges_c[..., 2], total, sum_weight)
    total, sum_weight = add(_shift_clamp(vis, 1, 0), edges_c[..., 3], total, sum_weight)
    total, sum_weight = add(_shift_clamp(vis, -1, -1), w_tl, total, sum_weight)
    total, sum_weight = add(_shift_clamp(vis, -1, 1), w_tr, total, sum_weight)
    total, sum_weight = add(_shift_clamp(vis, 1, -1), w_bl, total, sum_weight)
    total, sum_weight = add(_shift_clamp(vis, 1, 1), w_br, total, sum_weight)

    out = total / (sum_weight[..., None] if multi else sum_weight)
    if multi:
        # XeGTAO_Output, bent-normal branch (:722-728)
        v = out[..., 3] * (XE_GTAO_OCCLUSION_TERM_SCALE if final_apply else 1.0)
        bn = out[..., :3]
        bn = normalize(bn)
        return encode_visibility_bent_normal(v, bn)
    if final_apply:
        # XeGTAO_Output (:729-731): `uint(outputValue * 1.5 * 255 + 0.5)`
        # into an R32_UINT texture with NO saturate — the final AO term
        # legitimately reaches ~383 (visibility overshoots 1 on open
        # geometry; OCCLUSION_TERM_SCALE restores it), and the tonemap's
        # `float(ao)/255` then *brightens* those pixels. u16 keeps the
        # reference's unclamped range (round 1-2 clamped at 255 — a real
        # parity divergence caught by the config-4 oracle).
        # the store multiply promotes to float in the reference too
        # (float literals; and 383*255 would overflow f16)
        out = out.astype(jnp.float32) * XE_GTAO_OCCLUSION_TERM_SCALE
        return (jnp.maximum(out, 0.0) * 255.0 + 0.5).astype(jnp.uint16)
    return (jnp.clip(out, 0.0, 1.0).astype(jnp.float32) * 255.0
            + 0.5).astype(jnp.uint8)


def compute_ao_band(view_depth, normal_enc, consts, settings: GtaoSettings,
                    noise_index, row_start, band_rows: int):
    """GTAO restricted to a horizontal output band (multi-chip path): the
    main pass runs over the band plus a denoise halo, and the halo is
    trimmed after the denoise chain. Halo rows outside the image duplicate
    the edge rows exactly (incl. noise), reproducing single-device
    edge-clamping bit-exactly. `row_start` may be a traced value."""
    halo = settings.num_denoise_passes + 1
    mips = prefilter_depths(view_depth, consts, fp16=settings.fp16)
    main_rows = band_rows + 2 * halo

    ao, edges = main_pass(mips, normal_enc, consts, settings, noise_index,
                          row_start=row_start - halo, num_rows=main_rows)
    ao = _denoise_chain(ao, edges, settings)
    return ao[halo:halo + band_rows]


def ao_visibility_u8(ao, settings: GtaoSettings):
    """Final AO term -> u8 visibility (unpacks the bent-normal encoding)."""
    if settings.bent_normals:
        v, _ = decode_visibility_bent_normal(ao)
        return (jnp.clip(v, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
    return ao


def ao_bent_normals(ao, settings: GtaoSettings):
    """Final AO term -> view-space bent normals, or None."""
    if not settings.bent_normals:
        return None
    _, bn = decode_visibility_bent_normal(ao)
    return normalize(bn)


def gtao_debug_image(view_depth, normal_enc, consts, settings: GtaoSettings,
                     noise_index, mode: str = "normals"):
    """The debug-build RGBA16F debug image (vk_xe_gtao.rs's
    #[cfg(debug_assertions)] R16G16B16A16_SFLOAT target,
    vk_rendering_layers/vk_xe_gtao.rs:314-323) — the per-pass visual
    the XeGTAO shaders emit under their debug defines. Returns
    (H, W, 4) float16.

    * "normals": DisplayNormalSRGB(viewspaceNormal) = abs(n*0.5+0.5)
      (XE_GTAO_SHOW_NORMALS, XeGTAO.hlsli:293-295 + XeGTAO.h:146-148),
    * "edges": 1 - (e.l, e.r*0.5 + e.b*0.5, e.t, 1)
      (XE_GTAO_SHOW_EDGES, XeGTAO.hlsli:297-299 — the hlsl reads
      edgesLRTB.xywz as x, y*0.5+w*0.5, z),
    * "ao": denoise-side DisplayNormalSRGB of the working AO term
      broadcast to rgb (XE_GTAO_SHOW_DENOISE viz family, :825-833).
    """
    mips = prefilter_depths(view_depth, consts, fp16=settings.fp16)
    d0 = mips[0]
    ones = jnp.ones(d0.shape, jnp.float32)
    if mode == "normals":
        n = normal_enc * 2.0 - 1.0
        n = normalize(n)
        rgba = jnp.concatenate([jnp.abs(n * 0.5 + 0.5), ones[..., None]],
                               axis=-1)
    elif mode == "edges":
        e = _calculate_edges(d0, _shift_clamp(d0, 0, -1),
                             _shift_clamp(d0, 0, 1),
                             _shift_clamp(d0, -1, 0),
                             _shift_clamp(d0, 1, 0)).astype(jnp.float32)
        rgba = 1.0 - jnp.stack([e[..., 0], e[..., 1] * 0.5 + e[..., 3] * 0.5,
                                e[..., 2], ones], axis=-1)
    elif mode == "ao":
        ao, edges = main_pass(mips, normal_enc, consts, settings,
                              noise_index)
        v = ao_visibility_u8(ao, settings).astype(jnp.float32) / 255.0
        rgb = jnp.abs(v[..., None] * 0.5 + 0.5)
        rgba = jnp.concatenate([jnp.broadcast_to(rgb, (*v.shape, 3)),
                                ones[..., None]], axis=-1)
    else:
        raise ValueError(f"unknown debug image mode: {mode!r}")
    return rgba.astype(jnp.float16)


def _denoise_chain(ao, edges, settings: GtaoSettings):
    n_passes = settings.num_denoise_passes
    for i in range(n_passes):
        ao = denoise_pass(ao, edges, settings, final_apply=(i == n_passes - 1))
    return ao


def compute_ao(view_depth, normal_enc, consts, settings: GtaoSettings,
               noise_index):
    """Full GTAO chain (compute_ao, vk_xe_gtao.rs:416-642): prefilter ->
    main pass -> N denoise passes. Returns the final AO term: u8 visibility
    (255 = fully visible * occlusion-term scale), or the packed
    visibility+bent-normal uint32 when settings.bent_normals."""
    mips = prefilter_depths(view_depth, consts, fp16=settings.fp16)
    ao, edges = main_pass(mips, normal_enc, consts, settings, noise_index)
    return _denoise_chain(ao, edges, settings)
