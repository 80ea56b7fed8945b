"""Scene flattening: models -> global device tables + world BVH.

The reference binds per-primitive vertex/index buffer device addresses and a
bindless 256-slot texture array through a descriptor set
(vk_rt_descriptor_set.rs:31-97) refreshed every frame with a running
instanceCustomIndex (renderer.rs:641-675). The equivalent here is a
*flattened scene pytree*: global vertex/index/texture tables with a global
primitive id per triangle, rebuilt only when the device-resident model set
changes (the analogue of re-recording uploads + BLAS builds), and consumed as
ordinary jit inputs.

Positions/normals/tangents are pre-transformed to world space at flatten time
(the per-instance 3x4 transform applied once per vertex, instead of per ray
hit as the hardware TLAS does) — with the uniform-scale transforms the
reference app uses, interpolated shading is identical.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import numpy as np

from ..bvh import build_bvh_sah
from ..bvh.flat import tri_aabbs
from .mesh import TextureType
from .model import Model

MAX_LEAF = 4

# Neutral defaults for models that lack ORM / normal / albedo textures.
# (The reference *requires* all three layers and would panic; synthesizing
# neutral layers is a strict superset of its behavior.)
_DEFAULT_TEXELS = {
    0: (255, 255, 255, 255),   # albedo: white
    1: (255, 255, 0, 255),     # ORM: occlusion 1, roughness 1, metallic 0
    2: (128, 128, 255, 255),   # normal map: +z
}
_LAYER_OF = {TextureType.ALBEDO: 0, TextureType.ORM: 1, TextureType.NORMAL: 2}


@dataclass
class FlatScene:
    """Static-shape pytree consumed by the jitted frame function."""

    bvh: dict        # FlatBVH arrays (world space)
    geom: dict       # traversal triangles: v0, e1, e2, tri_id
    tri_vertex: Any  # (T, 3) i32 global vertex ids (original tri order)
    tri_prim: Any    # (T,)  i32 global primitive id ("customIndex + geometryIndex")
    vtx_pos: Any     # (V, 3) f32 world space
    vtx_uv: Any      # (V, 2) f32
    vtx_normal: Any  # (V, 3) f32 world space, normalized
    vtx_tangent: Any  # (V, 4) f32 world xyz + handedness w
    tex_stack: Any   # (P*3, H, W, 4) u8 — layers albedo/orm/normal per prim
    tex_size: Any    # (P, 2) i32 (h, w) valid extent per prim
    num_prims: int = 0
    # optional mip chain (RendererConfig.mipmaps): flat texel atlas +
    # per-image/per-level offsets and sizes. The reference's sampler is
    # trilinear anisotropic-16 (vk_rt_descriptor_set.rs:76-97) but its
    # textures allocate a single mip; this is the capability superset.
    tex_atlas: Any = None        # (N, 4) u8 — all images, all mip levels
    tex_mip_offsets: Any = None  # (P*3, L) i32 texel offset into the atlas
    tex_mip_sizes: Any = None    # (P, L, 2) i32 per-level (h, w)
    tex_mip_quad: Any = None     # (N, 64) u8 quad rows (2x2 footprint x 3
    #                              layers; 48 data + 16 pad)
    tex_mip_quad_offsets: Any = None  # (P, L) i32 row offsets
    # compact mip tier (automatic cutover for big atlases): one 64 B row
    # per ALIGNED 2x2 texel block (4 texels x 12 B + 16 pad = 1.33x the
    # source bytes instead of the quad tier's 5.33x); a bilinear fetch
    # costs 4 row gathers + slot selects instead of 1 gather
    tex_mip_block4: Any = None         # (N4, 64) u8 block rows
    tex_mip_block4_offsets: Any = None  # (P, L) i32 block-row offsets
    # middle mip tier (2 gathers, 2.67x source): one 64 B row per
    # x-ALIGNED texel pair + its y+1 wrap row (build_mip_pair_atlas)
    tex_mip_pair: Any = None           # (N2, 64) u8 pair rows
    tex_mip_pair_offsets: Any = None   # (P, L) i32 pair-row offsets
    # gather-optimized tables (see flatten_scene): one wide row per hit
    tri_attr: Any = None         # (T, 40) f32 3x[pos, uv, normal, tangent]
    #                              + [prim, tex_h, tex_w, unique-image id]
    tex_stack12: Any = None      # (P, H, W, 12) u8 packed layers
    tex_quad48: Any = None       # (U, H, W, 64) u8 2x2-footprint quad rows
                                 # (48 data + 16 pad for the fast gather),
                                 # one slab per UNIQUE image (dedup_images)
    tex_img_of_prim: Any = None  # (P,) i32 prim -> unique-image slot
    # object-space tables for the dynamic (per-frame-rebuild) mode
    vtx_instance: Any = None   # (V,) i32 instance id per vertex
    obj_vtx_pos: Any = None    # (V, 3) f32 object space
    obj_vtx_normal: Any = None
    obj_vtx_tangent: Any = None
    transforms: Any = None     # (I, 3, 4) f32 instance transforms

    def as_pytree(self) -> dict:
        """Device-resident tables ONLY — exactly what the shade dispatch
        reads (passes/shade.py), nothing else. When the gather-optimized
        path is live (tri_attr + one texel tier) the per-vertex fallback
        tables (tri_vertex/tri_prim/vtx_*) and the padded per-prim
        tex_stack are NEVER read by any pass, so they are not shipped:
        on the bench scene tex_stack alone is most of the device
        footprint, bytes no kernel touches. The reference uploads each texture exactly once
        (vk_model.rs:553-706); this is the same economy. Use
        as_full_pytree() for the oracle / validation / host-side tools
        that want the raw tables too."""
        out = dict(bvh=self.bvh, geom=self.geom, tex_size=self.tex_size)
        mips = self.tex_mip_sizes is not None
        if mips:
            out.update(tex_mip_sizes=self.tex_mip_sizes)
            if self.tex_mip_block4 is not None:
                out.update(tex_mip_block4=self.tex_mip_block4,
                           tex_mip_block4_offsets=self.tex_mip_block4_offsets)
            elif self.tex_mip_pair is not None:
                out.update(tex_mip_pair=self.tex_mip_pair,
                           tex_mip_pair_offsets=self.tex_mip_pair_offsets)
            elif self.tex_mip_quad is not None:
                out.update(tex_mip_quad=self.tex_mip_quad,
                           tex_mip_quad_offsets=self.tex_mip_quad_offsets)
            else:  # per-layer fallback tier (no quad tables built)
                out.update(tex_atlas=self.tex_atlas,
                           tex_mip_offsets=self.tex_mip_offsets)
        fast = self.tri_attr is not None and (
            mips or self.tex_quad48 is not None)
        if self.tri_attr is not None:
            out.update(tri_attr=self.tri_attr)
            if not mips and self.tex_quad48 is not None:
                out.update(tex_quad48=self.tex_quad48)
        if not fast:
            # fallback shading path: per-vertex tables + padded stack
            out.update(
                tri_vertex=self.tri_vertex, tri_prim=self.tri_prim,
                vtx_pos=self.vtx_pos, vtx_uv=self.vtx_uv,
                vtx_normal=self.vtx_normal, vtx_tangent=self.vtx_tangent)
            if not mips:
                out.update(tex_stack=self.tex_stack)
        return out

    # (tex_img_of_prim intentionally not in as_pytree: shade reads the
    # unique-image id from tri_attr column 39)

    def as_full_pytree(self) -> dict:
        """The shipped tables PLUS the raw per-vertex/per-prim tables the
        lean as_pytree drops on the fast path — for the brute-force oracle
        (tests/oracle.py), deep validation, and host-side tooling. Never
        uploaded wholesale to the device."""
        out = self.as_pytree()
        out.update(
            tri_vertex=self.tri_vertex, tri_prim=self.tri_prim,
            vtx_pos=self.vtx_pos, vtx_uv=self.vtx_uv,
            vtx_normal=self.vtx_normal, vtx_tangent=self.vtx_tangent,
            tex_stack=self.tex_stack)
        return out

    def as_object_pytree(self) -> dict:
        """Inputs for the dynamic mode: object-space geometry + instance ids
        (transforms are passed separately per frame). Texture tables follow
        the same one-tier shipping policy as as_pytree."""
        out = dict(
            tri_vertex=self.tri_vertex, tri_prim=self.tri_prim,
            vtx_instance=self.vtx_instance, obj_vtx_pos=self.obj_vtx_pos,
            obj_vtx_normal=self.obj_vtx_normal,
            obj_vtx_tangent=self.obj_vtx_tangent,
            vtx_uv=self.vtx_uv,
            tex_size=self.tex_size,
        )
        fast_tex = (self.tex_img_of_prim is not None
                    and self.tri_attr is not None
                    and (self.tex_mip_sizes is not None
                         or self.tex_quad48 is not None))
        if not fast_tex:
            # fallback texel path only — the padded per-prim stack is
            # never read when a quad/pair/block4/mip tier serves texels
            # (same dead-weight economy as as_pytree)
            out["tex_stack"] = self.tex_stack
        if self.tex_img_of_prim is not None and self.tri_attr is not None:
            # the dynamic modes rebuild tri_attr in-jit from this mapping
            out["tex_img_of_prim"] = self.tex_img_of_prim
            if self.tex_quad48 is not None and self.tex_mip_sizes is None:
                # transform-independent packed quad rows (non-mip tier)
                out["tex_quad48"] = self.tex_quad48
        if self.tex_mip_sizes is not None:
            # mip tables are transform-independent too — forward the
            # SHIPPED tier so the dynamic modes keep mipmaps/trilinear/
            # aniso (round-2 dropped it silently; config-parity fix)
            out.update(tex_mip_sizes=self.tex_mip_sizes)
            if self.tex_mip_block4 is not None:
                out.update(tex_mip_block4=self.tex_mip_block4,
                           tex_mip_block4_offsets=self.tex_mip_block4_offsets)
            elif self.tex_mip_pair is not None:
                out.update(tex_mip_pair=self.tex_mip_pair,
                           tex_mip_pair_offsets=self.tex_mip_pair_offsets)
            elif self.tex_mip_quad is not None:
                out.update(tex_mip_quad=self.tex_mip_quad,
                           tex_mip_quad_offsets=self.tex_mip_quad_offsets)
            else:
                out.update(tex_atlas=self.tex_atlas,
                           tex_mip_offsets=self.tex_mip_offsets)
        return out


def _transform_points(m3x4: np.ndarray, pts: np.ndarray) -> np.ndarray:
    return pts @ m3x4[:, :3].T + m3x4[:, 3]


def _transform_normals(m3x4: np.ndarray, normals: np.ndarray) -> np.ndarray:
    inv_t = np.linalg.inv(m3x4[:, :3]).T
    out = normals @ inv_t.T
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


def _transform_directions(m3x4: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    out = dirs @ m3x4[:, :3].T
    norm = np.linalg.norm(out, axis=1, keepdims=True)
    return (out / np.maximum(norm, 1e-20)).astype(np.float32)


def _box_mip(arr: np.ndarray) -> np.ndarray:
    """2x2 box-filter downsample of a (H, W, 4) u8 image (round-to-nearest,
    odd trailing row/column clamped like GPU mip generation)."""
    h, w = arr.shape[:2]
    h2, w2 = max(h // 2, 1), max(w // 2, 1)
    # pad odd dims by edge-duplication so every output texel averages 2x2
    if h % 2 and h > 1:
        arr = np.concatenate([arr, arr[-1:]], axis=0)
    if w % 2 and w > 1:
        arr = np.concatenate([arr, arr[:, -1:]], axis=1)
    if h == 1 and w == 1:
        return arr
    a = arr[:h2 * 2, :w2 * 2].astype(np.uint16)
    q = a.reshape(h2, 2 if h > 1 else 1, w2, 2 if w > 1 else 1, 4)
    s = q.sum(axis=(1, 3))
    n = q.shape[1] * q.shape[3]
    return ((s + n // 2) // n).astype(np.uint8)


def build_mip_atlas(tex_stack: np.ndarray, tex_size: np.ndarray,
                    img_of_prim: np.ndarray | None = None,
                    uniq_prims=None):
    """Full mip chains for every image in the stack, packed into one flat
    texel atlas. Texels are stored once per UNIQUE image (dedup_images)
    when img_of_prim is given; duplicate prims' offsets alias the shared
    texels. Returns (atlas (N,4) u8, offsets (P*3, L) i32,
    sizes (P, L, 2) i32). Level count L covers the largest extent."""
    n_img = tex_stack.shape[0]
    n_prims = tex_size.shape[0]
    hmax = int(tex_size[:, 0].max(initial=1))
    wmax = int(tex_size[:, 1].max(initial=1))
    levels = max(int(np.ceil(np.log2(max(hmax, wmax, 1)))) + 1, 1)
    if img_of_prim is None:
        img_of_prim = np.arange(n_prims, dtype=np.int32)
        uniq_prims = list(range(n_prims))

    chunks = []
    offsets_u = np.zeros((len(uniq_prims) * 3, levels), np.int64)
    sizes_u = np.zeros((len(uniq_prims), levels, 2), np.int32)
    cursor = 0
    for ui, uprim in enumerate(uniq_prims):
        for layer in range(3):
            h, w = int(tex_size[uprim, 0]), int(tex_size[uprim, 1])
            cur = tex_stack[uprim * 3 + layer, :h, :w].copy()
            for lv in range(levels):
                offsets_u[ui * 3 + layer, lv] = cursor
                sizes_u[ui, lv] = cur.shape[:2]
                chunks.append(cur.reshape(-1, 4))
                cursor += cur.shape[0] * cur.shape[1]
                if cur.shape[0] > 1 or cur.shape[1] > 1:
                    cur = _box_mip(cur)
                # 1x1 repeats for remaining levels (clamp at max lod)
    atlas = np.concatenate(chunks, axis=0)
    # per-prim (P*3, L) offsets alias the unique images' chunks
    offsets = np.zeros((n_img, levels), np.int64)
    for p in range(n_prims):
        for layer in range(3):
            offsets[p * 3 + layer] = offsets_u[img_of_prim[p] * 3 + layer]
    return atlas, offsets.astype(np.int32), sizes_u[img_of_prim]


def dedup_images(tex_stack12: np.ndarray, tex_size: np.ndarray):
    """Map each primitive to a unique-image slot by content hash (glTF
    scenes commonly bind the same images to many primitives — the bench
    scene has 2 unique textures across 151 prims, so the per-prim quad
    table was 75x bigger than its content). Returns (img_of_prim (P,) i32,
    uniq_prims: list of representative prim indices)."""
    seen = {}
    img_of_prim = np.zeros(tex_size.shape[0], np.int32)
    uniq = []
    for p in range(tex_size.shape[0]):
        key = (tex_stack12[p].tobytes(), int(tex_size[p, 0]),
               int(tex_size[p, 1]))
        if key not in seen:
            seen[key] = len(uniq)
            uniq.append(p)
        img_of_prim[p] = seen[key]
    return img_of_prim, uniq


def build_mip_quad_atlas(tex_stack: np.ndarray, tex_size: np.ndarray,
                         img_of_prim: np.ndarray | None = None,
                         uniq_prims=None):
    """Quad-packed mip atlas: one 64-byte row per (image, level, y, x)
    texel carrying the full 2x2 bilinear footprint (REPEAT wrap at that
    level) across the 3 packed layers (albedo|orm|normal, 12 B x 4 corners
    = 48 B + 16 pad for the power-of-two gather fast path — see
    tex_quad48). A trilinear fetch of all three layers becomes TWO row
    gathers instead of 24. Rows are stored per UNIQUE image
    (dedup_images); the per-prim offsets of duplicates point at the shared
    rows. Returns (atlas (N, 64) u8, offsets (P, L) i32 row offsets,
    sizes (P, L, 2) i32)."""
    n_prims = tex_size.shape[0]
    hmax = int(tex_size[:, 0].max(initial=1))
    wmax = int(tex_size[:, 1].max(initial=1))
    levels = max(int(np.ceil(np.log2(max(hmax, wmax, 1)))) + 1, 1)
    if img_of_prim is None:
        img_of_prim = np.arange(n_prims, dtype=np.int32)
        uniq_prims = list(range(n_prims))

    chunks = []
    offsets_u = np.zeros((len(uniq_prims), levels), np.int64)
    sizes_u = np.zeros((len(uniq_prims), levels, 2), np.int32)
    cursor = 0
    for ui, prim in enumerate(uniq_prims):
        h, w = int(tex_size[prim, 0]), int(tex_size[prim, 1])
        mips = [tex_stack[prim * 3 + l, :h, :w].copy() for l in range(3)]
        for lv in range(levels):
            arr12 = np.concatenate(mips, axis=2)            # (h, w, 12)
            quad = np.zeros(arr12.shape[:2] + (64,), np.uint8)
            quad[..., :48] = np.concatenate(
                [arr12,
                 np.roll(arr12, -1, axis=1),
                 np.roll(arr12, -1, axis=0),
                 np.roll(np.roll(arr12, -1, 0), -1, 1)], axis=2)
            offsets_u[ui, lv] = cursor
            sizes_u[ui, lv] = arr12.shape[:2]
            chunks.append(quad.reshape(-1, 64))
            cursor += quad.shape[0] * quad.shape[1]
            if mips[0].shape[0] > 1 or mips[0].shape[1] > 1:
                mips = [_box_mip(m) for m in mips]
    atlas = np.concatenate(chunks, axis=0)
    return (atlas, offsets_u[img_of_prim].astype(np.int32),
            sizes_u[img_of_prim])


# Automatic tier cutover between THREE texel-table layouts (gather count
# per bilinear fetch vs memory amplification over the 12 B/texel source):
#   quad   1 gather, 5.33x source  (full 2x2 footprint per texel row)
#   pair   2 gathers, 2.67x source (x-ALIGNED 2x2 block per row: texel
#          pair + their y+1 wrap row; the two bilinear columns come from
#          up to two rows + slot selects)
#   block4 4 gathers, 1.33x source (fully aligned 2x2 blocks)
# quad is the speed tier for small atlases, pair the default at scale,
# block4 the capacity backstop. The byte budgets below have not been
# measured on a GPU yet (ROADMAP 1.7).
MIP_QUAD_BUDGET_BYTES = 256 * 1024 * 1024
MIP_PAIR_BUDGET_BYTES = 1024 * 1024 * 1024


def mip_quad_bytes(tex_size: np.ndarray, uniq_prims) -> int:
    """Exact size the quad mip atlas would be (64 B x every (image, level)
    texel), for the tier cutover decision — cheap, no table built."""
    total = 0
    for prim in uniq_prims:
        h, w = int(tex_size[prim, 0]), int(tex_size[prim, 1])
        hmax = max(h, w, 1)
        levels = max(int(np.ceil(np.log2(hmax))) + 1, 1)
        for _ in range(levels):
            total += h * w * 64
            h, w = max(h // 2, 1), max(w // 2, 1)
    return total


def mip_pair_bytes(tex_size: np.ndarray, uniq_prims) -> int:
    """Exact pair-tier atlas size (64 B x h x ceil(w/2) rows per (image,
    level)) for the cutover decision. Levels = the GLOBAL chain length
    (the builder emits 1x1 repeats up to it), so this matches
    build_mip_pair_atlas byte-for-byte."""
    hmax = int(tex_size[list(uniq_prims), 0].max(initial=1))
    wmax = int(tex_size[list(uniq_prims), 1].max(initial=1))
    levels = max(int(np.ceil(np.log2(max(hmax, wmax, 1)))) + 1, 1)
    total = 0
    for prim in uniq_prims:
        h, w = int(tex_size[prim, 0]), int(tex_size[prim, 1])
        for _ in range(levels):
            total += h * ((w + 1) // 2) * 64
            h, w = max(h // 2, 1), max(w // 2, 1)
    return total


def build_mip_pair_atlas(tex_stack: np.ndarray, tex_size: np.ndarray,
                         img_of_prim: np.ndarray, uniq_prims):
    """Middle mip tier: one 64-byte row per (image, level, y, x-pair) —
    [t(y,2xp) | t(y,2xp+1) | t((y+1)%h,2xp) | t((y+1)%h,2xp+1)] x 12 B
    packed layers + 16 pad. 2.67x the source bytes (vs quad 5.33x /
    block4 1.33x); a bilinear fetch needs the two rows holding columns
    x0 and (x0+1)%w at the hit's y (the SAME row when x0 is even) plus
    slot selects — 2 gathers per level instead of quad's 1 / block4's 4
    (shade._pair_corners). The y+1 REPEAT wrap is baked in like the quad
    tier; the x wrap falls out of indexing the second corner's own row.
    Odd-width tails leave slot 1 zeroed (never selected: texel x stays
    < w). Returns (atlas (N2, 64) u8, offsets (P, L) i32 row offsets,
    sizes (P, L, 2) i32)."""
    n_prims = tex_size.shape[0]
    hmax = int(tex_size[:, 0].max(initial=1))
    wmax = int(tex_size[:, 1].max(initial=1))
    levels = max(int(np.ceil(np.log2(max(hmax, wmax, 1)))) + 1, 1)

    chunks = []
    offsets_u = np.zeros((len(uniq_prims), levels), np.int64)
    sizes_u = np.zeros((len(uniq_prims), levels, 2), np.int32)
    cursor = 0
    for ui, prim in enumerate(uniq_prims):
        h, w = int(tex_size[prim, 0]), int(tex_size[prim, 1])
        mips = [tex_stack[prim * 3 + l, :h, :w].copy() for l in range(3)]
        for lv in range(levels):
            arr12 = np.concatenate(mips, axis=2)            # (h, w, 12)
            hh, ww = arr12.shape[:2]
            bw = (ww + 1) // 2
            wrap = np.roll(arr12, -1, axis=0)               # (y+1) % h
            both = np.concatenate([arr12, wrap], axis=2)    # (h, w, 24)
            pad = np.zeros((hh, bw * 2, 24), np.uint8)
            pad[:, :ww] = both
            # (h, bw, 2, 24) -> row = [x0 top | x1 top | x0 bot | x1 bot]
            blk = pad.reshape(hh, bw, 2, 24)
            rows = np.zeros((hh * bw, 64), np.uint8)
            rows[:, 0:12] = blk[:, :, 0, 0:12].reshape(-1, 12)
            rows[:, 12:24] = blk[:, :, 1, 0:12].reshape(-1, 12)
            rows[:, 24:36] = blk[:, :, 0, 12:24].reshape(-1, 12)
            rows[:, 36:48] = blk[:, :, 1, 12:24].reshape(-1, 12)
            offsets_u[ui, lv] = cursor
            sizes_u[ui, lv] = (hh, ww)
            chunks.append(rows)
            cursor += rows.shape[0]
            if mips[0].shape[0] > 1 or mips[0].shape[1] > 1:
                mips = [_box_mip(m) for m in mips]
    atlas = np.concatenate(chunks, axis=0)
    return (atlas, offsets_u[img_of_prim].astype(np.int32),
            sizes_u[img_of_prim])


def build_mip_block4_atlas(tex_stack: np.ndarray, tex_size: np.ndarray,
                           img_of_prim: np.ndarray, uniq_prims):
    """Compact mip tier: one 64-byte row per ALIGNED 2x2 texel block and
    level — [t(2y,2x) | t(2y,2x+1) | t(2y+1,2x) | t(2y+1,2x+1)] x 12 B
    packed layers + 16 pad (the power-of-two gather fast path). 1.33x the
    source bytes vs the quad tier's 5.33x; texel (y, x) lives in block
    (y//2, x//2) slot (y&1)*2+(x&1), so a bilinear fetch is 4 row gathers
    + slot selects (shade._block4_corners). Returns (atlas (N4, 64) u8,
    offsets (P, L) i32 block-row offsets, sizes (P, L, 2) i32)."""
    n_prims = tex_size.shape[0]
    hmax = int(tex_size[:, 0].max(initial=1))
    wmax = int(tex_size[:, 1].max(initial=1))
    levels = max(int(np.ceil(np.log2(max(hmax, wmax, 1)))) + 1, 1)

    chunks = []
    offsets_u = np.zeros((len(uniq_prims), levels), np.int64)
    sizes_u = np.zeros((len(uniq_prims), levels, 2), np.int32)
    cursor = 0
    for ui, prim in enumerate(uniq_prims):
        h, w = int(tex_size[prim, 0]), int(tex_size[prim, 1])
        mips = [tex_stack[prim * 3 + l, :h, :w].copy() for l in range(3)]
        for lv in range(levels):
            arr12 = np.concatenate(mips, axis=2)            # (h, w, 12)
            hh, ww = arr12.shape[:2]
            bh, bw = (hh + 1) // 2, (ww + 1) // 2
            # pad odd extents with zero texels (slots the index math can
            # never select: texel coords stay < h, w)
            pad = np.zeros((bh * 2, bw * 2, 12), np.uint8)
            pad[:hh, :ww] = arr12
            blk = pad.reshape(bh, 2, bw, 2, 12).transpose(0, 2, 1, 3, 4)
            rows = np.zeros((bh * bw, 64), np.uint8)
            rows[:, :48] = blk.reshape(bh * bw, 48)
            offsets_u[ui, lv] = cursor
            sizes_u[ui, lv] = (hh, ww)
            chunks.append(rows)
            cursor += rows.shape[0]
            if mips[0].shape[0] > 1 or mips[0].shape[1] > 1:
                mips = [_box_mip(m) for m in mips]
    atlas = np.concatenate(chunks, axis=0)
    return (atlas, offsets_u[img_of_prim].astype(np.int32),
            sizes_u[img_of_prim])


def flatten_scene(models: List[Model], mipmaps: bool = False) -> FlatScene:
    """Flatten all device-resident models; build the world BVH (binned SAH,
    the analogue of the driver's PREFER_FAST_TRACE build). mipmaps adds the
    per-image mip-chain atlas for trilinear sampling."""
    pos_l, uv_l, nrm_l, tan_l, inst_l = [], [], [], [], []
    tri_v_l, tri_p_l = [], []
    tex_entries = []  # (prim_idx, layer, ImageData)
    tex_sizes = []
    transforms = []

    vtx_base = 0
    prim_idx = 0
    inst_idx = 0
    for model in models:
        if not model.is_device_resident():
            continue
        transforms.append(model.model_matrix)
        for prim in model.primitives():
            n_vtx = len(prim["positions"])
            pos_l.append(np.asarray(prim["positions"], np.float32))
            uv_l.append(prim["tex_coords"] if prim["tex_coords"] is not None
                        else np.zeros((n_vtx, 2), np.float32))
            nrm_l.append(np.asarray(prim["normals"], np.float32)
                         if prim["normals"] is not None
                         else np.zeros((n_vtx, 3), np.float32))
            if prim["tangents"] is not None:
                tan_l.append(np.asarray(prim["tangents"], np.float32))
            else:
                # synthesize a tangent orthogonal-ish to the normal; the
                # Gram-Schmidt in the shading pass fixes it up
                tan_l.append(np.tile(np.array([[1, 0, 0, 1]], np.float32), (n_vtx, 1)))
            inst_l.append(np.full(n_vtx, inst_idx, np.int32))
            tri_v_l.append(prim["indices"].astype(np.int64) + vtx_base)
            tri_p_l.append(np.full(len(prim["indices"]), prim_idx, np.int32))
            vtx_base += n_vtx

            size = None
            for ttype, layer in _LAYER_OF.items():
                img = prim["textures"].get(ttype)
                if img is not None:
                    tex_entries.append((prim_idx, layer, img))
                    size = (img.height, img.width)
            tex_sizes.append(size if size is not None else (1, 1))
            prim_idx += 1
        inst_idx += 1

    if prim_idx == 0:
        raise ValueError("no device-resident models to flatten")

    obj_vtx_pos = np.concatenate(pos_l)
    vtx_uv = np.concatenate(uv_l).astype(np.float32)
    obj_vtx_normal = np.concatenate(nrm_l)
    obj_vtx_tangent = np.concatenate(tan_l)
    vtx_instance = np.concatenate(inst_l)
    tri_vertex = np.concatenate(tri_v_l).astype(np.int32)
    tri_prim = np.concatenate(tri_p_l)
    transforms = np.asarray(transforms, np.float32)

    # world-space tables (static path: transform once at flatten time)
    vtx_pos = np.empty_like(obj_vtx_pos)
    vtx_normal = np.empty_like(obj_vtx_normal)
    vtx_tangent = obj_vtx_tangent.copy()
    for i in range(inst_idx):
        sel = vtx_instance == i
        m = transforms[i]
        vtx_pos[sel] = _transform_points(m, obj_vtx_pos[sel]).astype(np.float32)
        vtx_normal[sel] = _transform_normals(m, obj_vtx_normal[sel])
        vtx_tangent[sel, :3] = _transform_directions(m, obj_vtx_tangent[sel, :3])

    hmax = max(max(h for h, w in tex_sizes), 1)
    wmax = max(max(w for h, w in tex_sizes), 1)
    tex_stack = np.zeros((prim_idx * 3, hmax, wmax, 4), np.uint8)
    for layer in range(3):
        tex_stack[layer::3, :, :] = _DEFAULT_TEXELS[layer]
    for p, layer, img in tex_entries:
        arr = img.as_array()
        if arr.shape[2] < 4:
            arr = np.concatenate(
                [arr, np.full((*arr.shape[:2], 4 - arr.shape[2]), 255, np.uint8)], axis=2)
        tex_stack[p * 3 + layer, :img.height, :img.width] = arr
    tex_size = np.asarray(tex_sizes, np.int32)

    v0 = vtx_pos[tri_vertex[:, 0]]
    v1 = vtx_pos[tri_vertex[:, 1]]
    v2 = vtx_pos[tri_vertex[:, 2]]
    amin, amax = tri_aabbs(v0, v1, v2)
    bvh = build_bvh_sah(amin, amax, max_leaf_size=MAX_LEAF)
    bvh_pt = bvh.as_pytree()

    order = np.asarray(bvh.tri_order)
    v0o = v0[order]
    geom = dict(v0=v0o, e1=(v1[order] - v0o), e2=(v2[order] - v0o),
                tri_id=order.astype(np.int32))

    # dedup prims sharing texture content: the gather tables below are
    # sized by UNIQUE images, which is what their gather cost scales with
    tex_stack12 = np.concatenate(
        [tex_stack[0::3], tex_stack[1::3], tex_stack[2::3]], axis=3)
    img_of_prim, uniq_prims = dedup_images(tex_stack12, tex_size)

    tex_atlas = tex_mip_offsets = tex_mip_sizes = None
    tex_mip_quad = tex_mip_quad_offsets = None
    tex_mip_pair = tex_mip_pair_offsets = None
    tex_mip_block4 = tex_mip_block4_offsets = None
    if mipmaps:
        # host-side per-layer atlas: the no-quad fallback/oracle path (and
        # the dynamic modes' source of truth); NOT shipped to the device
        # when a quad/pair/block4 tier exists (as_pytree)
        tex_atlas, tex_mip_offsets, tex_mip_sizes = build_mip_atlas(
            tex_stack, tex_size, img_of_prim, uniq_prims)
        # automatic tier cutover (see the budget constants above): quad
        # (1 gather, 5.33x) for small atlases, pair (2 gathers, 2.67x)
        # at scale, block4 (4 gathers, 1.33x) as the capacity backstop —
        # exactly ONE texel table ships
        if mip_quad_bytes(tex_size, uniq_prims) <= MIP_QUAD_BUDGET_BYTES:
            tex_mip_quad, tex_mip_quad_offsets, _ = build_mip_quad_atlas(
                tex_stack, tex_size, img_of_prim, uniq_prims)
        elif mip_pair_bytes(tex_size, uniq_prims) <= MIP_PAIR_BUDGET_BYTES:
            tex_mip_pair, tex_mip_pair_offsets, _ = build_mip_pair_atlas(
                tex_stack, tex_size, img_of_prim, uniq_prims)
        else:
            tex_mip_block4, tex_mip_block4_offsets, _ = \
                build_mip_block4_atlas(tex_stack, tex_size, img_of_prim,
                                       uniq_prims)

    # Gather-optimized tables: the shading pass is designed around exactly
    # TWO wide gathers per hit:
    # * tri_attr (T, 39): all three corners' [pos, uv, normal, tangent]
    #   plus [prim id, tex_h, tex_w] (exact small floats) -> one gather
    #   replaces 12 attribute + 1 prim + 1 extent gather;
    # * tex_quad48 (P, H, W, 48): each texel row carries its full 2x2
    #   bilinear footprint (REPEAT wrap baked in at build time) across the
    #   three layers -> ONE tap per pixel instead of 4 (and instead of the
    #   reference's 12 sampled fetches, vk_rt_descriptor_set.rs:42-97).
    corners = [np.concatenate([vtx_pos[tri_vertex[:, k]],
                               vtx_uv[tri_vertex[:, k]],
                               vtx_normal[tri_vertex[:, k]],
                               vtx_tangent[tri_vertex[:, k]]], axis=1)
               for k in range(3)]
    tri_attr = np.concatenate(
        corners + [tri_prim[:, None].astype(np.float32),
                   tex_size[tri_prim].astype(np.float32),
                   img_of_prim[tri_prim][:, None].astype(np.float32)],
        axis=1).astype(np.float32)
    # rows are padded 48 -> 64 bytes (power-of-two rows); the axis is
    # UNIQUE images, not prims, so the table stays at content size
    # (dedup_images).
    tex_quad48 = None
    if not mipmaps:
        # the mip tiers supersede these rows — shade never reads them in a
        # mip scene
        n_uniq = len(uniq_prims)
        tex_quad48 = np.zeros((n_uniq, hmax, wmax, 64), np.uint8)
        for ui, p in enumerate(uniq_prims):
            h, w = int(tex_size[p, 0]), int(tex_size[p, 1])
            reg = tex_stack12[p, :h, :w]
            tex_quad48[ui, :h, :w, :48] = np.concatenate(
                [reg,
                 np.roll(reg, -1, axis=1),            # (y,   x+1 mod w)
                 np.roll(reg, -1, axis=0),            # (y+1 mod h, x)
                 np.roll(np.roll(reg, -1, 0), -1, 1)  # (y+1, x+1)
                 ], axis=2)

    return FlatScene(
        bvh=bvh_pt, geom=geom, tri_vertex=tri_vertex,
        tri_prim=tri_prim, vtx_pos=vtx_pos, vtx_uv=vtx_uv,
        vtx_normal=vtx_normal, vtx_tangent=vtx_tangent,
        tex_stack=tex_stack, tex_size=tex_size, num_prims=prim_idx,
        vtx_instance=vtx_instance, obj_vtx_pos=obj_vtx_pos,
        obj_vtx_normal=obj_vtx_normal, obj_vtx_tangent=obj_vtx_tangent,
        transforms=transforms,
        tex_atlas=tex_atlas, tex_mip_offsets=tex_mip_offsets,
        tex_mip_sizes=tex_mip_sizes, tex_mip_quad=tex_mip_quad,
        tex_mip_quad_offsets=tex_mip_quad_offsets,
        tex_mip_block4=tex_mip_block4,
        tex_mip_block4_offsets=tex_mip_block4_offsets,
        tex_mip_pair=tex_mip_pair,
        tex_mip_pair_offsets=tex_mip_pair_offsets,
        tri_attr=tri_attr, tex_stack12=tex_stack12, tex_quad48=tex_quad48,
        tex_img_of_prim=img_of_prim,
    )
