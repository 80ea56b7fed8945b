"""The per-frame device program: one jitted function = one frame.

The reference's per-frame GPU command stream (record_main_command,
renderer.rs:617-693: TLAS rebuild -> descriptor refresh -> trace_rays ->
compute_ao -> tonemap/present) becomes a single jitted program whose pass
ordering is expressed by data dependencies — XLA is the barrier system.
Resolution and quality tiers are static arguments (jit specialization is the
analogue of the reference's SPIR-V specialization constants + pipeline
recreation on resize).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..kernels.trace import trace_closest
from ..passes.encodings import pack_unorm8, quantize_r11g11b10f, quantize_r16f
from ..passes.gtao import GtaoSettings, compute_ao
from ..passes.rays import T_MAX, T_MIN, camera_rays
from ..passes.shade import shade
from ..passes.tonemap import tonemap_frame

MAX_LEAF = 4


# R2 low-discrepancy sub-pixel offsets for multi-sample anti-aliasing
# (sample 0 stays at the pixel center so spp=1 matches the reference).
def _aa_jitters(spp: int):
    import numpy as _np

    g = 1.32471795724474602596  # plastic constant (2-D R2 sequence)
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    idx = _np.arange(spp, dtype=_np.float64)
    jit = _np.stack([_np.mod(0.5 + a1 * idx, 1.0) - 0.5,
                     _np.mod(0.5 + a2 * idx, 1.0) - 0.5], axis=1)
    jit[0] = 0.0
    return jnp.asarray(jit.astype(_np.float32))


# spp values up to this unroll inline; larger counts run the extra samples
# under lax.scan so the compiled program stays ~spp=4-sized at any spp.
SPP_UNROLL = 4


def render_gbuffer(scene: dict, camera: dict, lights: dict, *, width: int,
                   height: int, row_start=0, num_rows: int | None = None,
                   spp: int = 1, aniso_taps: int = 1):
    """Trace + shade the (optionally banded) pixel grid; returns the
    unquantized G-buffer dict (color spp-averaged, depth/normals from the
    center sample). Shared by the single-chip frame, the multi-chip
    shard_map body (dist/sharding.py), and the accumulation sampler."""
    band = height if num_rows is None else num_rows

    def trace_and_shade(origin, direction):
        hits = trace_closest(scene["bvh"], scene["geom"], origin, direction,
                             T_MIN, T_MAX, max_leaf=MAX_LEAF)
        return shade(scene, camera, lights, hits, origin, direction,
                     height=band, width=width, max_leaf=MAX_LEAF,
                     aniso_taps=aniso_taps, image_rows=height)

    origin, direction = camera_rays(camera, width, height,
                                    row_start=row_start, num_rows=num_rows)
    g = trace_and_shade(origin, direction)
    if spp > 1:
        jitters = _aa_jitters(spp)

        def sample_color(jit):
            o_s, d_s = camera_rays(camera, width, height, row_start=row_start,
                                   num_rows=num_rows, jitter=jit)
            return trace_and_shade(o_s, d_s)["color"]

        if spp <= SPP_UNROLL:
            acc = g["color"]
            for s in range(1, spp):
                acc = acc + sample_color(jitters[s])
        else:
            def body(acc, jit):
                return acc + sample_color(jit), None

            acc, _ = jax.lax.scan(body, g["color"], jitters[1:])
        g = dict(g, color=acc / spp)
    return g


@partial(jax.jit, static_argnames=("width", "height", "gtao_settings",
                                   "enable_gtao", "enable_tonemap", "spp",
                                   "aniso_taps"))
def render_frame(scene: dict, camera: dict, lights: dict, gtao_consts: dict,
                 lpm_derived: dict, noise_index, *, width: int, height: int,
                 gtao_settings: GtaoSettings = GtaoSettings(),
                 enable_gtao: bool = True, enable_tonemap: bool = True,
                 spp: int = 1, aniso_taps: int = 1):
    """Render one frame. Returns dict with:
    image (H,W,3) u8 sRGB, color/depth/normal G-buffer, ao (H,W) u8.
    spp > 1 averages R2-jittered HDR samples (anti-aliasing); the G-buffer
    for GTAO comes from the center sample.
    """
    g = render_gbuffer(scene, camera, lights, width=width, height=height,
                       spp=spp, aniso_taps=aniso_taps)

    # G-buffer storage-format quantization (B10G11R11F color+normal, R16F depth)
    color = quantize_r11g11b10f(g["color"]).reshape(height, width, 3)
    depth = quantize_r16f(g["depth"]).reshape(height, width)
    normal = quantize_r11g11b10f(g["normal_enc"]).reshape(height, width, 3)

    bent = None
    if enable_gtao:
        from ..passes.gtao import ao_bent_normals, ao_visibility_u8

        ao_term = compute_ao(depth, normal, gtao_consts, gtao_settings,
                             noise_index)
        ao = ao_visibility_u8(ao_term, gtao_settings)
        bent = ao_bent_normals(ao_term, gtao_settings)
    else:
        ao = jnp.full((height, width), 255, jnp.uint16)

    if enable_tonemap:
        rgb = tonemap_frame(color, ao, lpm_derived)
        image = pack_unorm8(rgb)
    else:
        image = pack_unorm8(jnp.clip(color, 0.0, 1.0))

    out = dict(image=image, color=color, depth=depth, normal=normal, ao=ao)
    if bent is not None:
        out["bent_normals"] = bent
    return out


@partial(jax.jit, static_argnames=("width", "height"))
def render_sample_hdr(scene: dict, camera: dict, lights: dict, jitter,
                      *, width: int, height: int):
    """One progressive-accumulation sample: linear HDR radiance with a
    sub-pixel camera jitter (jitter in [-0.5, 0.5]^2 pixels). Used by the
    accumulation / ground-truth mode (engine.accumulate)."""
    origin, direction = camera_rays(camera, width, height, jitter=jitter)
    hits = trace_closest(scene["bvh"], scene["geom"], origin, direction,
                         T_MIN, T_MAX, max_leaf=MAX_LEAF)
    g = shade(scene, camera, lights, hits, origin, direction, height=height,
              width=width, max_leaf=MAX_LEAF)
    return g["color"].reshape(height, width, 3)
