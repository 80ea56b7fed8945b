"""Primary-hit shading: the fused XLA pass over the hit G-buffer.

Re-implements the reference's raygen shading loop
(raytrace.rgen.glsl:106-199) as one vectorized program over all pixels:

* barycentric interpolation of pos/uv/normal/tangent (:116-126),
* Gram-Schmidt TBN with bitangent handedness from v0's tangent.w (:128-131),
* bindless-equivalent texture fetches: layer 0 albedo (sRGB->linear pow 2.2),
  layer 1 ORM (g=roughness, b=metallic), layer 2 normal map (:132-137),
* F0 = mix(0.04, albedo, metallic), roughness^2 (:140-141),
* per light: Cook-Torrance GGX specular + Burley local-SSS diffuse (:146-162),
* shadow ray per shadow-casting light with attenuation 0.05 (:164-182),
* radiance * NdotL accumulation (:184-186),
* outputs: color, view depth = -(view * P).z, view normal encoded
  *0.5+0.5 with y,z negated (:188-199).

Shadow rays are wavefront-batched: one trace_any launch per light over the
whole pixel set, with inactive lanes given tmax = 0 so they exit the BVH in a
single step (the compaction analogue for this 1-bounce pipeline).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..kernels.trace import trace_any
from . import brdf
from .light import get_light_radiance, get_unnormalized_L_vec
from .vec import length, normalize

LOCAL_SSS_RATIO = 0.4
SHADOW_T_MIN = 0.01
SHADOW_ATTENUATION = 0.05
MISS_DEPTH = 10000.0


def sample_bilinear(tex_stack, tex_size, prim, layer: int, uv,
                    images_per_prim: int = 3):
    """Bilinear texture fetch with REPEAT addressing from the stacked
    per-primitive texture array. The reference's sampler is trilinear
    anisotropic, but every texture has one mip level
    (gltf copy info image_mip_levels=1), so it reduces to bilinear.

    tex_stack: (P*images_per_prim, H, W, C) u8; tex_size: (P, 2) i32;
    prim: (N,) i32; uv: (N, 2). Returns (N, C) float in [0, 1].
    images_per_prim=1 addresses the packed 12-channel stack directly.
    """
    size = tex_size[prim].astype(jnp.float32)  # (N, 2) = (h, w)
    h = size[:, 0]
    w = size[:, 1]
    px = uv[:, 0] * w - 0.5
    py = uv[:, 1] * h - 0.5
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    fx = px - x0
    fy = py - y0

    hi = tex_size[prim][:, 0]
    wi = tex_size[prim][:, 1]
    x0i = jnp.mod(x0.astype(jnp.int32), wi)
    y0i = jnp.mod(y0.astype(jnp.int32), hi)
    x1i = jnp.mod(x0i + 1, wi)
    y1i = jnp.mod(y0i + 1, hi)

    img = prim * images_per_prim + layer
    t00 = tex_stack[img, y0i, x0i].astype(jnp.float32)
    t10 = tex_stack[img, y0i, x1i].astype(jnp.float32)
    t01 = tex_stack[img, y1i, x0i].astype(jnp.float32)
    t11 = tex_stack[img, y1i, x1i].astype(jnp.float32)
    fx = fx[:, None]
    fy = fy[:, None]
    out = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
           + (t01 * (1 - fx) + t11 * fx) * fy)
    return out / 255.0


def _quad_rows_to_bytes(row):
    """Gathered u8 quad rows -> (N, 64) byte values as f32."""
    return row.astype(jnp.float32)


def sample_bilinear_quad(quad, hw, img, uv, *, gather=None, shape=None,
                         base=None):
    """Bilinear REPEAT fetch in ONE gather: quad (U, H, W, 64) u8 rows
    carry the full 2x2 footprint of their texel across the 3 packed layers
    in bytes 0..47 (REPEAT wrap baked in at scene-flatten time, scene.py;
    rows padded to 64 for the fast power-of-two gather path), so the fetch
    is a single flat row gather + the standard lerp. The leading axis is
    UNIQUE images (scene.dedup_images) — `img` is the per-hit unique-image
    slot (tri_attr column 39), which keeps the table at content size.
    hw: (N, 2) f32 valid (h, w) extents.
    Bit-identical to 4x sample_bilinear on the 12-stack.

    gather/shape: sharded-table injection (dist/geometry.py) — `gather`
    maps flat GLOBAL row indices -> rows when the quad table is row-sharded
    across chips and `quad` is absent; `shape` supplies (U, H, W, C) then.
    The default path (gather=None) is byte-identical to before the seam.

    base: streaming-arena addressing (engine/texture_arena.py) — `quad` is
    a flat (rows, 64) array, image `i`'s rows start at base[i] and are laid
    out row-major at ITS OWN extent (no slab padding), so
    flat = base[img] + y*w + x. Values are bit-identical to the slab
    layout; the table drops from U*Hmax*Wmax to content-size rows."""
    h = hw[:, 0]
    w = hw[:, 1]
    px = uv[:, 0] * w - 0.5
    py = uv[:, 1] * h - 0.5
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0i = jnp.mod(x0.astype(jnp.int32), w.astype(jnp.int32))
    y0i = jnp.mod(y0.astype(jnp.int32), h.astype(jnp.int32))
    if base is not None:
        flat = base[img] + y0i * w.astype(jnp.int32) + x0i
        U = H = W = None
        C = quad.shape[-1]
    else:
        U, H, W, C = quad.shape if shape is None else shape
        flat = (img * H + y0i) * W + x0i
    if gather is not None:
        row = _quad_rows_to_bytes(gather(flat))
    elif base is not None:
        row = _quad_rows_to_bytes(quad[flat])
    else:
        row = _quad_rows_to_bytes(quad.reshape(U * H * W, C)[flat])
    t00, t10, t01, t11 = (row[:, 0:12], row[:, 12:24],
                          row[:, 24:36], row[:, 36:48])
    out = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
           + (t01 * (1 - fx) + t11 * fx) * fy)
    return out / 255.0


def _sample_mip_bilinear(atlas, offsets, sizes, prim, layer: int, uv, level):
    """Bilinear REPEAT fetch at an integer mip `level` (per-pixel) from the
    flat mip atlas. atlas (N,4) u8; offsets (P*3,L) i32; sizes (P,L,2)."""
    img = prim * 3 + layer
    hw = sizes[prim, level]                  # (N, 2)
    h = hw[:, 0]
    w = hw[:, 1]
    hf = h.astype(jnp.float32)
    wf = w.astype(jnp.float32)
    px = uv[:, 0] * wf - 0.5
    py = uv[:, 1] * hf - 0.5
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    x1i = jnp.mod(x0i + 1, w)
    y1i = jnp.mod(y0i + 1, h)
    base = offsets[img, level]

    def tap(yi, xi):
        return atlas[base + yi * w + xi].astype(jnp.float32)

    out = ((tap(y0i, x0i) * (1 - fx) + tap(y0i, x1i) * fx) * (1 - fy)
           + (tap(y1i, x0i) * (1 - fx) + tap(y1i, x1i) * fx) * fy)
    return out / 255.0


def sample_trilinear(atlas, offsets, sizes, prim, layer: int, uv, lod):
    """Trilinear fetch: bilinear at floor/ceil mip levels, lerped by the
    fractional lod. The counterpart of the reference's immutable
    LINEAR/LINEAR/LINEAR sampler (vk_rt_descriptor_set.rs:76-97)."""
    levels = sizes.shape[1]
    lod = jnp.clip(lod, 0.0, float(levels - 1))
    l0 = jnp.floor(lod)
    frac = (lod - l0)[:, None]
    l0i = l0.astype(jnp.int32)
    l1i = jnp.minimum(l0i + 1, levels - 1)
    s0 = _sample_mip_bilinear(atlas, offsets, sizes, prim, layer, uv, l0i)
    s1 = _sample_mip_bilinear(atlas, offsets, sizes, prim, layer, uv, l1i)
    return s0 * (1 - frac) + s1 * frac


def _mip_quad_flat_index(qoffsets, sizes, prim, uv, level):
    """The flat atlas row index + lerp weights of a bilinear quad fetch at
    integer mip `level` (shared by the direct and gathered paths)."""
    hw = sizes[prim, level]                  # (N, 2)
    h = hw[:, 0]
    w = hw[:, 1]
    px = uv[:, 0] * w.astype(jnp.float32) - 0.5
    py = uv[:, 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    return qoffsets[prim, level] + y0i * w + x0i, fx, fy


def _quad_lerp(row, fx, fy):
    t00, t10, t01, t11 = (row[:, 0:12], row[:, 12:24],
                          row[:, 24:36], row[:, 36:48])
    out = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
           + (t01 * (1 - fx) + t11 * fx) * fy)
    return out / 255.0


def _sample_mip_bilinear_quad(qatlas, qoffsets, sizes, prim, uv, level):
    """Bilinear REPEAT fetch of ALL THREE layers at an integer mip `level`
    in ONE row gather: qatlas (N, 64) u8 quad rows (scene.py
    build_mip_quad_atlas — rows stored once per unique image; the per-prim
    qoffsets (P, L) i32 alias shared rows), sizes (P, L, 2). Returns
    (N, 12) floats [albedo4 | orm4 | normal4]. Bit-identical to 3x
    _sample_mip_bilinear."""
    flat, fx, fy = _mip_quad_flat_index(qoffsets, sizes, prim, uv, level)
    return _quad_lerp(_quad_rows_to_bytes(qatlas[flat]), fx, fy)


def sample_trilinear_quad(qatlas, qoffsets, sizes, prim, uv, lod, *,
                          gather=None):
    """Trilinear fetch of all three layers in TWO row gathers (vs 24
    narrow ones through the per-layer atlas) — same lerp structure as
    sample_trilinear, bit-identical per layer.

    gather: sharded-atlas injection — maps flat GLOBAL atlas row indices
    to rows (dist/geometry.py ring gather). Both mip levels' indices go
    out in ONE gather call (one ring tour); the row values, and hence the
    result, are bit-identical to the direct path."""
    levels = sizes.shape[1]
    lod = jnp.clip(lod, 0.0, float(levels - 1))
    l0 = jnp.floor(lod)
    frac = (lod - l0)[:, None]
    l0i = l0.astype(jnp.int32)
    l1i = jnp.minimum(l0i + 1, levels - 1)
    if gather is None:
        s0 = _sample_mip_bilinear_quad(qatlas, qoffsets, sizes, prim, uv, l0i)
        s1 = _sample_mip_bilinear_quad(qatlas, qoffsets, sizes, prim, uv, l1i)
    else:
        f0, fx0, fy0 = _mip_quad_flat_index(qoffsets, sizes, prim, uv, l0i)
        f1, fx1, fy1 = _mip_quad_flat_index(qoffsets, sizes, prim, uv, l1i)
        rows = _quad_rows_to_bytes(gather(jnp.concatenate([f0, f1])))
        n = f0.shape[0]
        s0 = _quad_lerp(rows[:n], fx0, fy0)
        s1 = _quad_lerp(rows[n:], fx1, fy1)
    return s0 * (1 - frac) + s1 * frac


def sample_anisotropic_quad(qatlas, qoffsets, sizes, prim, uv, lod_minor,
                            duv_major, taps: int, *, gather=None):
    """Anisotropic filtering through the quad mip atlas: `taps` trilinear
    quad fetches along the footprint's major axis, averaged."""
    acc = None
    for i in range(taps):
        f = (i + 0.5) / taps - 0.5
        s = sample_trilinear_quad(qatlas, qoffsets, sizes, prim,
                                  uv + duv_major * f, lod_minor,
                                  gather=gather)
        acc = s if acc is None else acc + s
    return acc / taps


def _pair_corners(poffsets, sizes, prim, uv, level):
    """Flat row indices + x-parity slots of a bilinear fetch through the
    pair mip tier (scene.build_mip_pair_atlas: one 64 B row per x-aligned
    texel pair carrying both texels AND their (y+1)%h wrap row). The two
    bilinear columns x0 and x1=(x0+1)%w live in rows (y, x0//2) and
    (y, x1//2) — the same row when x0 is even; the y dimension needs no
    second row (baked wrap, like the quad tier). Returns
    (flat0, flat1, x0par, x1par, fx, fy)."""
    hw = sizes[prim, level]                  # (N, 2)
    h = hw[:, 0]
    w = hw[:, 1]
    px = uv[:, 0] * w.astype(jnp.float32) - 0.5
    py = uv[:, 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    x1i = jnp.mod(x0i + 1, w)
    bw = (w + 1) // 2
    base = poffsets[prim, level] + y0i * bw
    return (base + x0i // 2, base + x1i // 2, x0i & 1, x1i & 1, fx, fy)


def _pair_lerp(row0, row1, x0par, x1par, fx, fy):
    """Slot-select each column's top/bottom texels from its pair row
    (bytes [0:12|12:24] = top x-even/x-odd, [24:36|36:48] = bottom), then
    the SAME bilinear expression as _quad_lerp — bit-identical texels,
    bit-identical result."""
    r0 = row0.astype(jnp.float32)
    r1 = row1.astype(jnp.float32)

    def col(r, par, half):
        lo = r[:, half:half + 12]
        hi = r[:, half + 12:half + 24]
        return jnp.where((par == 1)[:, None], hi, lo)

    t00 = col(r0, x0par, 0)
    t10 = col(r1, x1par, 0)
    t01 = col(r0, x0par, 24)
    t11 = col(r1, x1par, 24)
    out = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
           + (t01 * (1 - fx) + t11 * fx) * fy)
    return out / 255.0


def sample_trilinear_pair(pr, poffsets, sizes, prim, uv, lod, *,
                          gather=None):
    """Trilinear fetch through the pair tier: 4 row gathers (2 columns x
    2 mip levels) at 2.67x-source tables — the middle point of the
    quad (2 gathers, 5.33x) / block4 (8 gathers, 1.33x) frontier and the
    default at scale (scene.MIP_PAIR_BUDGET_BYTES). With an injected
    `gather` (sharded tables), all 4 index vectors ride ONE call."""
    levels = sizes.shape[1]
    lod = jnp.clip(lod, 0.0, float(levels - 1))
    l0 = jnp.floor(lod)
    frac = (lod - l0)[:, None]
    l0i = l0.astype(jnp.int32)
    l1i = jnp.minimum(l0i + 1, levels - 1)
    f00, f01, p00, p01, fx0, fy0 = _pair_corners(poffsets, sizes, prim, uv,
                                                 l0i)
    f10, f11, p10, p11, fx1, fy1 = _pair_corners(poffsets, sizes, prim, uv,
                                                 l1i)
    if gather is None:
        rows = [pr[f] for f in (f00, f01, f10, f11)]
    else:
        n = f00.shape[0]
        cat = gather(jnp.concatenate([f00, f01, f10, f11]))
        rows = [cat[i * n:(i + 1) * n] for i in range(4)]
    s0 = _pair_lerp(rows[0], rows[1], p00, p01, fx0, fy0)
    s1 = _pair_lerp(rows[2], rows[3], p10, p11, fx1, fy1)
    return s0 * (1 - frac) + s1 * frac


def sample_anisotropic_pair(pr, poffsets, sizes, prim, uv, lod_minor,
                            duv_major, taps: int, *, gather=None):
    """Anisotropic filtering through the pair tier: `taps` trilinear
    fetches along the footprint's major axis, averaged."""
    acc = None
    for i in range(taps):
        f = (i + 0.5) / taps - 0.5
        s = sample_trilinear_pair(pr, poffsets, sizes, prim,
                                  uv + duv_major * f, lod_minor,
                                  gather=gather)
        acc = s if acc is None else acc + s
    return acc / taps


def _block4_corners(boffsets, sizes, prim, uv, level):
    """Per-corner flat block-row indices + in-row slots of a bilinear
    fetch through the compact block4 mip tier (scene.build_mip_block4_atlas:
    one 64 B row per ALIGNED 2x2 texel block, texel (y, x) at slot
    (y&1)*2 + (x&1)). Returns (flats[4], slots[4], fx, fy) for corners in
    quad-row order [t00, t10, t01, t11]."""
    hw = sizes[prim, level]                  # (N, 2)
    h = hw[:, 0]
    w = hw[:, 1]
    px = uv[:, 0] * w.astype(jnp.float32) - 0.5
    py = uv[:, 1] * h.astype(jnp.float32) - 0.5
    x0 = jnp.floor(px)
    y0 = jnp.floor(py)
    fx = (px - x0)[:, None]
    fy = (py - y0)[:, None]
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    x1i = jnp.mod(x0i + 1, w)
    y1i = jnp.mod(y0i + 1, h)
    bw = (w + 1) // 2
    base = boffsets[prim, level]
    corners = [(y0i, x0i), (y0i, x1i), (y1i, x0i), (y1i, x1i)]
    flats = [base + (yi // 2) * bw + (xi // 2) for yi, xi in corners]
    slots = [(yi & 1) * 2 + (xi & 1) for yi, xi in corners]
    return flats, slots, fx, fy


def _block4_lerp(rows, slots, fx, fy):
    """Slot-select each corner's 12 texel bytes from its 64 B block row,
    then the SAME bilinear expression as _quad_lerp — bit-identical to the
    quad tier (both lerp the exact same texel bytes)."""
    taps = []
    for row, slot in zip(rows, slots):
        rb = row.astype(jnp.float32)
        parts = [rb[:, 12 * s:12 * (s + 1)] for s in range(4)]
        v = parts[0]
        for s in range(1, 4):
            v = jnp.where((slot == s)[:, None], parts[s], v)
        taps.append(v)
    t00, t10, t01, t11 = taps
    out = ((t00 * (1 - fx) + t10 * fx) * (1 - fy)
           + (t01 * (1 - fx) + t11 * fx) * fy)
    return out / 255.0


def sample_trilinear_block4(b4, boffsets, sizes, prim, uv, lod, *,
                            gather=None):
    """Trilinear fetch through the compact block4 tier: 8 row gathers
    (4 corners x 2 mip levels) instead of the quad tier's 2 — the
    automatic fallback when the quad atlas would blow the memory budget
    (5.33x vs 1.33x source bytes; scene.MIP_QUAD_BUDGET_BYTES). With an
    injected `gather` (sharded tables), all 8 index vectors ride ONE
    call (one ring tour)."""
    levels = sizes.shape[1]
    lod = jnp.clip(lod, 0.0, float(levels - 1))
    l0 = jnp.floor(lod)
    frac = (lod - l0)[:, None]
    l0i = l0.astype(jnp.int32)
    l1i = jnp.minimum(l0i + 1, levels - 1)
    f0, s0_, fx0, fy0 = _block4_corners(boffsets, sizes, prim, uv, l0i)
    f1, s1_, fx1, fy1 = _block4_corners(boffsets, sizes, prim, uv, l1i)
    flats = f0 + f1
    if gather is None:
        rows = [b4[f] for f in flats]
    else:
        n = flats[0].shape[0]
        cat = gather(jnp.concatenate(flats))
        rows = [cat[i * n:(i + 1) * n] for i in range(8)]
    s0 = _block4_lerp(rows[:4], s0_, fx0, fy0)
    s1 = _block4_lerp(rows[4:], s1_, fx1, fy1)
    return s0 * (1 - frac) + s1 * frac


def sample_anisotropic_block4(b4, boffsets, sizes, prim, uv, lod_minor,
                              duv_major, taps: int, *, gather=None):
    """Anisotropic filtering through the block4 tier: `taps` trilinear
    fetches along the footprint's major axis, averaged."""
    acc = None
    for i in range(taps):
        f = (i + 0.5) / taps - 0.5
        s = sample_trilinear_block4(b4, boffsets, sizes, prim,
                                    uv + duv_major * f, lod_minor,
                                    gather=gather)
        acc = s if acc is None else acc + s
    return acc / taps


def ray_cone_lod(t, direction, N, p0, p1, p2, uv0, uv1, uv2, tex_w, tex_h,
                 spread):
    """Texture LOD from the ray-cone footprint (Akenine-Moeller et al.,
    "Texture Level of Detail Strategies for Real-Time Ray Tracing"): cone
    diameter at the hit projected onto the surface, converted to texels via
    the triangle's uv-per-world-area density."""
    cone_diam = t * spread
    cos_in = jnp.abs(jnp.sum(N * direction, axis=-1))
    footprint = cone_diam / jnp.maximum(cos_in, 0.25)  # bounded anisotropy
    e1 = p1 - p0
    e2 = p2 - p0
    world_area = 0.5 * length(jnp.cross(e1, e2))
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    uv_area = 0.5 * jnp.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    texel_per_world = jnp.sqrt(
        uv_area * tex_w * tex_h / jnp.maximum(world_area, 1e-12))
    return jnp.log2(jnp.maximum(footprint * texel_per_world, 1e-6))


def ray_cone_aniso(t, direction, N, p0, p1, p2, uv0, uv1, uv2, tex_w, tex_h,
                   spread, max_aniso: int = 16):
    """Elliptical ray-cone footprint for anisotropic filtering (the
    reference's immutable sampler has max_anisotropy=16,
    vk_rt_descriptor_set.rs:76-97). The cone's circular cross-section
    elongates by 1/|N.D| along the view direction projected into the
    surface plane; the minor axis stays the cone diameter. Returns
    (lod_minor, duv_major): the minor-axis mip level and the FULL
    major-axis extent in UV space (to distribute taps along)."""
    cone_diam = t * spread
    d_dot_n = jnp.sum(N * direction, axis=-1)
    cos_in = jnp.abs(d_dot_n)

    # minor-axis footprint in texels -> base LOD (no 1/cos elongation)
    e1 = p1 - p0
    e2 = p2 - p0
    world_area = 0.5 * length(jnp.cross(e1, e2))
    duv1 = uv1 - uv0
    duv2 = uv2 - uv0
    uv_area = 0.5 * jnp.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
    texel_per_world = jnp.sqrt(
        uv_area * tex_w * tex_h / jnp.maximum(world_area, 1e-12))
    lod_minor = jnp.log2(jnp.maximum(cone_diam * texel_per_world, 1e-6))

    # major-axis direction: D projected into the surface plane
    proj = direction - d_dot_n[:, None] * N
    pdir = normalize(proj)
    aniso = jnp.clip(1.0 / jnp.maximum(cos_in, 1e-4), 1.0, float(max_aniso))
    major_len = cone_diam * aniso

    # world direction -> UV direction: solve pdir = a*e1 + b*e2 in the
    # triangle plane (2x2 Gram system), then duv = a*duv1 + b*duv2
    g11 = jnp.sum(e1 * e1, axis=-1)
    g12 = jnp.sum(e1 * e2, axis=-1)
    g22 = jnp.sum(e2 * e2, axis=-1)
    r1 = jnp.sum(pdir * e1, axis=-1)
    r2 = jnp.sum(pdir * e2, axis=-1)
    det = g11 * g22 - g12 * g12
    # degenerate triangles (near-parallel edges) make the Gram solve blow
    # up — fall back to an isotropic tap (duv = 0) instead of sampling
    # across the whole texture. Relative test: det/(g11*g22) = sin^2(angle)
    ok = (det > 1e-8 * g11 * g22)[:, None]
    inv_det = 1.0 / jnp.maximum(det, 1e-30)
    a = (r1 * g22 - r2 * g12) * inv_det
    b = (g11 * r2 - g12 * r1) * inv_det
    duv_per_world = a[:, None] * duv1 + b[:, None] * duv2
    duv_major = jnp.where(ok, duv_per_world * major_len[:, None], 0.0)
    return lod_minor, duv_major


def sample_anisotropic(atlas, offsets, sizes, prim, layer: int, uv,
                       lod_minor, duv_major, taps: int):
    """Anisotropic filtering as `taps` trilinear taps spread along the
    footprint's major axis (each at the minor-axis LOD), averaged — the
    software analogue of the reference sampler's anisotropy=16."""
    acc = None
    for i in range(taps):
        f = (i + 0.5) / taps - 0.5
        s = sample_trilinear(atlas, offsets, sizes, prim, layer,
                             uv + duv_major * f, lod_minor)
        acc = s if acc is None else acc + s
    return acc / taps


def shade(scene: dict, camera: dict, lights: dict, hits: dict,
          origin, direction, *, height: int = 0, width: int = 0,
          max_leaf: int = 4, shadow_trace_fn=None, aniso_taps: int = 1,
          image_rows: int = 0, attr_rows=None, quad_gather=None,
          quad_shape=None, light_eval: str = "loop"):
    """Shade one batch of primary hits.

    Returns dict(color (N,3), depth (N,), normal_enc (N,3)) — the unquantized
    G-buffer; the engine applies format quantization (B10G11R11F / R16F).
    Shadow rays go through the tracer entry (kernels/trace.py).
    shadow_trace_fn overrides the occlusion tracer entirely —
    (origin, dir, tmin, tmax) -> bool mask; the sharded-geometry mode
    passes its ring all-to-all tracer here (dist/geometry.py).
    image_rows: the FULL image height, used for the ray-cone spread — pass
    it when `height` is only a band of the frame (multi-chip path), or the
    cone comes out mesh-size× too wide.
    attr_rows / quad_gather / quad_shape: sharded-table injection
    (dist/geometry.py). attr_rows (N, >=40) replaces the tri_attr gather
    (the caller ring-gathered the rows of the hit triangles); quad_gather
    serves texture quad rows by flat GLOBAL index from a row-sharded
    table, with quad_shape = the full table's (U, H, W, C) when the local
    scene dict carries only a placeholder.
    """
    tri = hits["tri"]
    valid = tri >= 0
    tidx = jnp.maximum(tri, 0)

    u = hits["u"][:, None]
    v = hits["v"][:, None]
    w = 1.0 - u - v

    tex_hw = None
    if attr_rows is not None or "tri_attr" in scene:
        # gather-optimized path: ONE wide gather fetches all three
        # corners' attributes plus [prim, tex_h, tex_w] — the values are
        # byte-identical to the per-table path
        attr = (attr_rows if attr_rows is not None
                else scene["tri_attr"][tidx])  # (N, 40)
        p0, p1, p2 = attr[:, 0:3], attr[:, 12:15], attr[:, 24:27]
        uv0, uv1, uv2 = attr[:, 3:5], attr[:, 15:17], attr[:, 27:29]
        n0, n1, n2 = attr[:, 5:8], attr[:, 17:20], attr[:, 29:32]
        t0, t1, t2 = attr[:, 8:12], attr[:, 20:24], attr[:, 32:36]
        prim = attr[:, 36].astype(jnp.int32)  # exact small floats
        tex_hw = attr[:, 37:39]               # (N, 2) f32 (h, w)
        # unique-image slot for the deduped quad table (legacy 39-column
        # tables predate dedup: image axis == prim axis there)
        img = (attr[:, 39].astype(jnp.int32) if attr.shape[1] > 39
               else prim)
    else:
        prim = scene["tri_prim"][tidx]        # (N,)
        vids = scene["tri_vertex"][tidx]      # (N, 3)
        p0 = scene["vtx_pos"][vids[:, 0]]
        p1 = scene["vtx_pos"][vids[:, 1]]
        p2 = scene["vtx_pos"][vids[:, 2]]
        uv0 = scene["vtx_uv"][vids[:, 0]]
        uv1 = scene["vtx_uv"][vids[:, 1]]
        uv2 = scene["vtx_uv"][vids[:, 2]]
        n0 = scene["vtx_normal"][vids[:, 0]]
        n1 = scene["vtx_normal"][vids[:, 1]]
        n2 = scene["vtx_normal"][vids[:, 2]]
        t0 = scene["vtx_tangent"][vids[:, 0]]
        t1 = scene["vtx_tangent"][vids[:, 1]]
        t2 = scene["vtx_tangent"][vids[:, 2]]

    world_pos = p0 * w + p1 * u + p2 * v
    tex_coord = uv0 * w + uv1 * u + uv2 * v
    world_normal = normalize(n0 * w + n1 * u + n2 * v)
    world_tangent = normalize(t0[:, :3] * w + t1[:, :3] * u + t2[:, :3] * v)
    # Gram-Schmidt re-orthogonalization; handedness from v0's tangent.w
    world_tangent = normalize(
        world_tangent
        - jnp.sum(world_tangent * world_normal, -1, keepdims=True) * world_normal)
    world_binormal = jnp.cross(world_normal, world_tangent) * t0[:, 3:4]

    if "tex_mip_sizes" in scene:
        # trilinear mip sampling: LOD from the ray-cone footprint; pixel
        # cone spread angle recovered from proj[1][1] = 1/tan(fovy/2)
        rows = image_rows or height or int(round(float(
            np.sqrt(hits["t"].shape[0]))))
        spread = 2.0 / (camera["proj"][1, 1] * rows)
        tex_hw = scene["tex_mip_sizes"][prim, 0].astype(jnp.float32)
        quad_mips = scene.get("tex_mip_quad") is not None
        pair_mips = scene.get("tex_mip_pair") is not None
        block4 = scene.get("tex_mip_block4") is not None
        if aniso_taps > 1:
            lod_minor, duv_major = ray_cone_aniso(
                hits["t"], direction, world_normal, p0, p1, p2,
                uv0, uv1, uv2, tex_hw[:, 1], tex_hw[:, 0], spread,
                max_aniso=16)
            if block4:
                packed = sample_anisotropic_block4(
                    scene["tex_mip_block4"], scene["tex_mip_block4_offsets"],
                    scene["tex_mip_sizes"], prim, tex_coord, lod_minor,
                    duv_major, aniso_taps, gather=quad_gather)

                def fetch(layer):
                    return packed[:, layer * 4:layer * 4 + 4]
            elif pair_mips:
                packed = sample_anisotropic_pair(
                    scene["tex_mip_pair"], scene["tex_mip_pair_offsets"],
                    scene["tex_mip_sizes"], prim, tex_coord, lod_minor,
                    duv_major, aniso_taps, gather=quad_gather)

                def fetch(layer):
                    return packed[:, layer * 4:layer * 4 + 4]
            elif quad_mips:
                packed = sample_anisotropic_quad(
                    scene["tex_mip_quad"], scene["tex_mip_quad_offsets"],
                    scene["tex_mip_sizes"], prim, tex_coord, lod_minor,
                    duv_major, aniso_taps, gather=quad_gather)

                def fetch(layer):
                    return packed[:, layer * 4:layer * 4 + 4]
            else:
                def fetch(layer):
                    return sample_anisotropic(
                        scene["tex_atlas"], scene["tex_mip_offsets"],
                        scene["tex_mip_sizes"], prim, layer, tex_coord,
                        lod_minor, duv_major, aniso_taps)
        else:
            lod = ray_cone_lod(hits["t"], direction, world_normal, p0, p1,
                               p2, uv0, uv1, uv2, tex_hw[:, 1], tex_hw[:, 0],
                               spread)
            if block4:
                packed = sample_trilinear_block4(
                    scene["tex_mip_block4"], scene["tex_mip_block4_offsets"],
                    scene["tex_mip_sizes"], prim, tex_coord, lod,
                    gather=quad_gather)

                def fetch(layer):
                    return packed[:, layer * 4:layer * 4 + 4]
            elif pair_mips:
                packed = sample_trilinear_pair(
                    scene["tex_mip_pair"], scene["tex_mip_pair_offsets"],
                    scene["tex_mip_sizes"], prim, tex_coord, lod,
                    gather=quad_gather)

                def fetch(layer):
                    return packed[:, layer * 4:layer * 4 + 4]
            elif quad_mips:
                packed = sample_trilinear_quad(
                    scene["tex_mip_quad"], scene["tex_mip_quad_offsets"],
                    scene["tex_mip_sizes"], prim, tex_coord, lod,
                    gather=quad_gather)

                def fetch(layer):
                    return packed[:, layer * 4:layer * 4 + 4]
            else:
                def fetch(layer):
                    return sample_trilinear(scene["tex_atlas"],
                                            scene["tex_mip_offsets"],
                                            scene["tex_mip_sizes"], prim,
                                            layer, tex_coord, lod)
    elif "tex_quad48" in scene and tex_hw is not None:
        # quad rows: ONE gather fetches the whole 2x2 bilinear footprint of
        # albedo+ORM+normal at once
        packed = sample_bilinear_quad(scene["tex_quad48"], tex_hw, img,
                                      tex_coord, gather=quad_gather,
                                      shape=quad_shape,
                                      base=scene.get("tex_quad48_base"))

        def fetch(layer):
            return packed[:, layer * 4:layer * 4 + 4]
    elif "tex_stack12" in scene:
        # packed layers: 4 bilinear taps fetch albedo+ORM+normal together
        packed = sample_bilinear(scene["tex_stack12"], scene["tex_size"],
                                 prim, 0, tex_coord, images_per_prim=1)

        def fetch(layer):
            return packed[:, layer * 4:layer * 4 + 4]
    else:
        def fetch(layer):
            return sample_bilinear(scene["tex_stack"], scene["tex_size"],
                                   prim, layer, tex_coord)

    nmap = fetch(2)
    N_ts = normalize(nmap[:, :3] * 2.0 - 1.0)
    N = normalize(N_ts[:, 0:1] * world_tangent
                   + N_ts[:, 1:2] * world_binormal
                   + N_ts[:, 2:3] * world_normal)

    albedo = jnp.power(fetch(0)[:, :3], 2.2)
    orm = fetch(1)
    roughness = orm[:, 1]
    metallic = orm[:, 2]

    camera_pos = camera["camera_pos"]
    V = normalize(camera_pos[None, :] - world_pos)
    F0 = 0.04 * (1.0 - metallic[:, None]) + albedo * metallic[:, None]
    corrected_roughness = roughness * roughness

    nc_NdotV = jnp.sum(N * V, axis=-1)
    NdotV = jnp.clip(nc_NdotV, 1e-5, 1.0)

    num_lights = lights["pos"].shape[0]

    # Pre-pass: per-light L vectors + shadow wants (the inputs the shadow
    # traversal needs), so the hoisted schedules can launch every light's
    # shadow trace before the BRDF math.
    pre = []
    for i in range(num_lights):
        light = {k: arr[i] for k, arr in lights.items()}
        nn_L = get_unnormalized_L_vec(light, world_pos)
        L_len = length(nn_L)
        L = nn_L / jnp.maximum(L_len, 1e-20)[..., None]
        nc_NdotL = jnp.sum(N * L, axis=-1)
        wants_shadow = valid & (light["casts_shadows"] > 0) & (nc_NdotL > 0)
        # inactive lanes get tmax=0 -> they leave the BVH on the first step
        t_max = jnp.where(wants_shadow, L_len, 0.0)
        pre.append(dict(light=light, L=L, nc_NdotL=nc_NdotL,
                        wants_shadow=wants_shadow, t_max=t_max))

    def occlusion(L, t_max):
        if shadow_trace_fn is not None:
            return shadow_trace_fn(world_pos, L, SHADOW_T_MIN, t_max)
        return trace_any(scene["bvh"], scene["geom"], world_pos, L,
                         SHADOW_T_MIN, t_max, max_leaf=max_leaf)

    occ_all = None
    if light_eval in ("hoist", "batch") and num_lights > 1:
        # every light's shadow trace first, then ONE elementwise island for
        # the BRDF math of all lights (the loop interleaves them)
        occ_all = [occlusion(p["L"], p["t_max"]) for p in pre]

    if light_eval == "batch" and num_lights > 1 and occ_all is not None:
        # Batched evaluation: all K lights' radiance + BRDF as one stacked
        # (K, N, ...) computation (VERDICT r3 #1 candidate). The brdf/light
        # libraries are elementwise over leading axes, so the math is the
        # loop's verbatim with a lights axis in front; the final
        # accumulation is an explicit k-ordered chain so the sum order (and
        # the bits) match the loop exactly.
        L_all = jnp.stack([p["L"] for p in pre])                # (K, N, 3)
        ncl_all = jnp.stack([p["nc_NdotL"] for p in pre])       # (K, N)
        wants_all = jnp.stack([p["wants_shadow"] for p in pre])
        occ_stack = jnp.stack(list(occ_all))                    # (K, N)
        H_all = normalize(V[None] + L_all)
        NdotL_a = jnp.clip(ncl_all, 0.0, 1.0)
        NdotH_a = jnp.clip(jnp.sum(N[None] * H_all, axis=-1), 0.0, 1.0)
        LdotH_a = jnp.clip(jnp.sum(L_all * H_all, axis=-1), 0.0, 1.0)
        Ks_a = brdf.f_schlick(F0[None], LdotH_a)                # (K, N, 3)
        Kd = (1.0 - metallic[:, None]) * albedo
        rho_s_a = brdf.cook_torrance_specular(
            NdotL_a, NdotV, NdotH_a, corrected_roughness, Ks_a)
        rho_d_a = Kd[None] * brdf.burley_diffuse_local_sss(
            corrected_roughness, NdotV, nc_NdotV, ncl_all, LdotH_a,
            LOCAL_SSS_RATIO)[..., None]
        att_a = jnp.where(wants_all & occ_stack, SHADOW_ATTENUATION, 1.0)
        rad_a = jax.vmap(get_light_radiance, in_axes=(0, None, 0))(
            lights, world_pos, L_all)                           # (K, N, 3)
        act = lights.get("active")
        act_a = (jnp.ones((num_lights,), jnp.float32) if act is None
                 else act.astype(jnp.float32))
        contrib = ((rho_s_a + rho_d_a) * rad_a
                   * (att_a * NdotL_a * act_a[:, None])[..., None])
        rho = jnp.zeros_like(albedo)
        for k in range(num_lights):
            rho = rho + contrib[k]
        return _shade_outputs(rho, valid, camera, world_pos, N)

    rho = jnp.zeros_like(albedo)
    for i, p in enumerate(pre):
        light = p["light"]
        L = p["L"]
        nc_NdotL = p["nc_NdotL"]
        wants_shadow = p["wants_shadow"]
        t_max = p["t_max"]
        H = normalize(V + L)

        NdotL = jnp.clip(nc_NdotL, 0.0, 1.0)
        NdotH = jnp.clip(jnp.sum(N * H, axis=-1), 0.0, 1.0)
        LdotH = jnp.clip(jnp.sum(L * H, axis=-1), 0.0, 1.0)

        Ks = brdf.f_schlick(F0, LdotH)
        Kd = (1.0 - metallic[:, None]) * albedo

        rho_s = brdf.cook_torrance_specular(NdotL, NdotV, NdotH,
                                            corrected_roughness, Ks)
        rho_d = Kd * brdf.burley_diffuse_local_sss(
            corrected_roughness, NdotV, nc_NdotV, nc_NdotL, LdotH,
            LOCAL_SSS_RATIO)[..., None]

        shadow_attenuation = jnp.ones_like(NdotL)
        occluded = (occ_all[i] if occ_all is not None
                    else occlusion(L, t_max))
        shadow_attenuation = jnp.where(wants_shadow & occluded,
                                       SHADOW_ATTENUATION, shadow_attenuation)

        radiance = get_light_radiance(light, world_pos, L)
        active = light.get("active", jnp.float32(1.0))
        rho = rho + ((rho_s + rho_d) * radiance
                     * (shadow_attenuation * NdotL * active)[..., None])

    return _shade_outputs(rho, valid, camera, world_pos, N)


def _shade_outputs(rho, valid, camera, world_pos, N):
    """G-buffer encode shared by the loop and batched light paths
    (raytrace.rgen.glsl:188-199)."""
    out_color = jnp.where(valid[:, None], rho, 0.0)

    view = camera["view"]
    # HIGHEST: a GPU would otherwise run these f32 products in TF32
    view_z = jnp.matmul(world_pos, view[2, :3],
                        precision=jax.lax.Precision.HIGHEST) + view[2, 3]
    out_depth = jnp.where(valid, -view_z, MISS_DEPTH)

    normal_view = jnp.einsum("ij,nj->ni", view[:3, :3], N,
                             precision=jax.lax.Precision.HIGHEST)
    normal_view = normal_view * jnp.array([1.0, -1.0, -1.0])
    normal_enc = normalize(normal_view) * 0.5 + 0.5
    out_normal = jnp.where(valid[:, None], normal_enc, 0.5)

    return dict(color=out_color, depth=out_depth, normal_enc=out_normal)
