"""Dynamic-scene frame: per-frame acceleration-structure rebuild inside jit.

The reference destroys and rebuilds its TLAS every frame from the instances'
3x4 transforms (vk_tlas_builder.rs:38-233, recreate_tlas called in
record_main_command, renderer.rs:651). This is the JAX equivalent:
instance transforms are ordinary per-frame jit inputs; the frame program
transforms object-space geometry to world, rebuilds the world LBVH (Morton
sort + Karras emit — bvh/lbvh.py) *inside the same jitted program*, and
traces against it. Nothing is recompiled when transforms change.

The static path (engine/frame.py) skips the rebuild entirely — the right
choice when transforms are constant — so the two modes bracket the
reference's BLAS(static)/TLAS(dynamic) split.

The instance transforms are f32 products pinned to HIGHEST precision: a GPU
would otherwise run them in TF32, which keeps about three decimal digits.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..bvh.lbvh import build_lbvh
from ..kernels.trace import trace_closest
from ..passes.encodings import pack_unorm8, quantize_r11g11b10f, quantize_r16f
from ..passes.gtao import GtaoSettings, compute_ao
from ..passes.rays import T_MAX, T_MIN, camera_rays
from ..passes.shade import shade
from ..passes.tonemap import tonemap_frame
from ..passes.vec import normalize


_HIGHEST = jax.lax.Precision.HIGHEST


def _transform_points(transforms, inst, pts):
    m = transforms[inst]                       # (V, 3, 4)
    return jnp.einsum("vij,vj->vi", m[:, :, :3], pts,
                      precision=_HIGHEST) + m[:, :, 3]


def _tri_attr(tv, tri_prim, vtx_pos, vtx_uv, vtx_normal, vtx_tangent,
              tex_size, img_of_prim):
    """In-jit rebuild of the gather-packed (T, 40) shading table
    (scene.py tri_attr layout, incl. the unique-image slot column) from
    the transformed vertex tables — 43k-row gathers, cheap next to
    per-pixel work; restores the 2-wide-gather shade path for the dynamic
    modes."""
    cs = []
    for k in range(3):
        vid = tv[:, k]
        cs.append(jnp.concatenate(
            [vtx_pos[vid], vtx_uv[vid], vtx_normal[vid], vtx_tangent[vid]],
            axis=1))
    return jnp.concatenate(
        cs + [tri_prim[:, None].astype(jnp.float32),
              tex_size[tri_prim].astype(jnp.float32),
              img_of_prim[tri_prim][:, None].astype(jnp.float32)], axis=1)


# transform-independent texture tables forwarded verbatim so the dynamic
# modes keep the full mipmaps/trilinear/aniso feature matrix
_MIP_KEYS = ("tex_atlas", "tex_mip_offsets", "tex_mip_sizes",
             "tex_mip_quad", "tex_mip_quad_offsets",
             "tex_mip_pair", "tex_mip_pair_offsets",
             "tex_mip_block4", "tex_mip_block4_offsets")


def _forward_mip_tables(scene: dict, obj_scene: dict):
    for k in _MIP_KEYS:
        if k in obj_scene:
            scene[k] = obj_scene[k]


def build_world_tables(obj_scene: dict, transforms):
    """Object-space tables + (I,3,4) transforms -> world tables + fresh BVH.
    Fully jittable (the per-frame 'TLAS rebuild')."""
    inst = obj_scene["vtx_instance"]
    vtx_pos = _transform_points(transforms, inst, obj_scene["obj_vtx_pos"])

    inv3t = jnp.transpose(jnp.linalg.inv(transforms[:, :, :3]), (0, 2, 1))
    vtx_normal = normalize(
        jnp.einsum("vij,vj->vi", inv3t[inst], obj_scene["obj_vtx_normal"],
                   precision=_HIGHEST))
    tan = obj_scene["obj_vtx_tangent"]
    tan_xyz = normalize(
        jnp.einsum("vij,vj->vi", transforms[inst][:, :, :3], tan[:, :3],
                   precision=_HIGHEST))
    vtx_tangent = jnp.concatenate([tan_xyz, tan[:, 3:4]], axis=1)

    tv = obj_scene["tri_vertex"]
    v0 = vtx_pos[tv[:, 0]]
    v1 = vtx_pos[tv[:, 1]]
    v2 = vtx_pos[tv[:, 2]]
    amin = jnp.minimum(jnp.minimum(v0, v1), v2)
    amax = jnp.maximum(jnp.maximum(v0, v1), v2)
    bvh = build_lbvh(amin, amax)
    order = bvh.tri_order
    v0o = v0[order]
    geom = dict(v0=v0o, e1=v1[order] - v0o, e2=v2[order] - v0o,
                tri_id=order.astype(jnp.int32))

    out = dict(
        bvh=bvh.as_pytree(), geom=geom,
        tri_vertex=tv, tri_prim=obj_scene["tri_prim"],
        vtx_pos=vtx_pos, vtx_uv=obj_scene["vtx_uv"],
        vtx_normal=vtx_normal, vtx_tangent=vtx_tangent,
        tex_size=obj_scene["tex_size"],
    )
    if "tex_stack" in obj_scene:  # fallback texel path (lean pytrees omit)
        out["tex_stack"] = obj_scene["tex_stack"]
    if "tex_img_of_prim" in obj_scene:
        out["tri_attr"] = _tri_attr(
            tv, obj_scene["tri_prim"], vtx_pos, obj_scene["vtx_uv"],
            vtx_normal, vtx_tangent, obj_scene["tex_size"],
            obj_scene["tex_img_of_prim"])
        if "tex_quad48" in obj_scene:
            out["tex_quad48"] = obj_scene["tex_quad48"]
    _forward_mip_tables(out, obj_scene)
    return out


@partial(jax.jit, static_argnames=("width", "height", "gtao_settings",
                                   "enable_gtao", "enable_tonemap",
                                   "aniso_taps"))
def render_frame_dynamic(obj_scene: dict, transforms, camera: dict,
                         lights: dict, gtao_consts: dict, lpm_derived: dict,
                         noise_index, *, width: int, height: int,
                         gtao_settings: GtaoSettings = GtaoSettings(),
                         enable_gtao: bool = True,
                         enable_tonemap: bool = True, aniso_taps: int = 1):
    """One frame with animated instance transforms: BVH rebuilt in-jit
    (LBVH leaves hold 1 triangle), traced through the tracer entry."""
    scene = build_world_tables(obj_scene, jnp.asarray(transforms, jnp.float32))

    origin, direction = camera_rays(camera, width, height)
    hits = trace_closest(scene["bvh"], scene["geom"], origin, direction,
                         T_MIN, T_MAX, max_leaf=1)
    g = shade(scene, camera, lights, hits, origin, direction,
              height=height, width=width, max_leaf=1,
              aniso_taps=aniso_taps)

    color = quantize_r11g11b10f(g["color"]).reshape(height, width, 3)
    depth = quantize_r16f(g["depth"]).reshape(height, width)
    normal = quantize_r11g11b10f(g["normal_enc"]).reshape(height, width, 3)

    if enable_gtao:
        ao = compute_ao(depth, normal, gtao_consts, gtao_settings, noise_index)
    else:
        ao = jnp.full((height, width), 255, jnp.uint16)

    if enable_tonemap:
        image = pack_unorm8(tonemap_frame(color, ao, lpm_derived))
    else:
        image = pack_unorm8(jnp.clip(color, 0.0, 1.0))
    return dict(image=image, color=color, depth=depth, normal=normal, ao=ao)
