"""Multi-device frame rendering: pixel-band decomposition over a mesh.

The reference is single-GPU/single-queue (renderer.rs:188) — this layer has
no counterpart to translate (SURVEY.md §2.4):

* mesh axis "x" over devices (a flat axis: the cards of one host reach each
  other all to all); the image is decomposed into horizontal bands,
* the scene (BVH + geometry + textures) is replicated — the analogue of each
  device owning a full TLAS; rays never cross devices,
* ray tracing + shading (the dominant cost) run fully sharded inside
  shard_map, one band per device, through the SAME G-buffer producer as the
  single-device frame (engine.frame.render_gbuffer) — so the tracer, spp
  averaging, and max_leaf plumbing are identical,
* the quantized G-buffer is then all-gathered (a few MB at 1080p) because
  GTAO gathers depth samples up to its screen-space radius away — cheaper
  and simpler at this scale than per-pass halo exchanges,
* GTAO + LPM tonemap run on the gathered G-buffer per device for its own
  band, and the outputs are assembled by the out_specs (bands sharded on
  "x").

A replicated-BVH + sharded-rays strategy is the right first point in the
design space (geometry fits device memory comfortably; rays are
embarrassingly parallel). A sharded-geometry + ray ring mode (geometry.py)
covers scenes exceeding one device's memory.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # jax>=0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from ..engine.frame import render_gbuffer
from ..passes.encodings import pack_unorm8, quantize_r11g11b10f, quantize_r16f
from ..passes.gtao import (GtaoSettings, ao_bent_normals, ao_visibility_u8,
                           compute_ao_band)
from ..passes.tonemap import tonemap_frame


def make_mesh(n_devices: int | None = None, axis: str = "x") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices, (axis,))


@partial(jax.jit, static_argnames=("width", "height", "gtao_settings", "mesh",
                                   "axis", "enable_gtao", "enable_tonemap",
                                   "spp", "aniso_taps"))
def render_frame_sharded(scene: dict, camera: dict, lights: dict,
                         gtao_consts: dict, lpm_derived: dict, noise_index,
                         *, width: int, height: int,
                         gtao_settings: GtaoSettings, mesh: Mesh,
                         axis: str = "x", enable_gtao: bool = True,
                         enable_tonemap: bool = True, spp: int = 1,
                         aniso_taps: int = 1):
    """Render one frame over a device mesh; height must be divisible by the
    mesh size. Supports the full RendererConfig surface (spp, aniso_taps,
    gtao/tonemap toggles) and returns the same output dict as the
    single-device render_frame: image/color/depth/normal/ao
    (+bent_normals), every array band-sharded over `axis`."""
    n = mesh.shape[axis]
    assert height % n == 0, f"height {height} not divisible by mesh size {n}"
    band = height // n

    def per_chip(scene, camera, lights, gtao_consts, lpm_derived, noise_index):
        me = jax.lax.axis_index(axis)
        row0 = me * band

        g = render_gbuffer(scene, camera, lights, width=width, height=height,
                           row_start=row0, num_rows=band, spp=spp,
                           aniso_taps=aniso_taps)

        color = quantize_r11g11b10f(g["color"]).reshape(band, width, 3)
        depth = quantize_r16f(g["depth"]).reshape(band, width)
        normal = quantize_r11g11b10f(g["normal_enc"]).reshape(band, width, 3)

        bent = None
        if enable_gtao:
            # all-gather of the band G-buffer -> full-frame depth/normals,
            # needed because GTAO samples up to its screen-space radius away.
            depth_full = jax.lax.all_gather(depth, axis, axis=0, tiled=True)
            normal_full = jax.lax.all_gather(normal, axis, axis=0, tiled=True)

            # each device computes GTAO only for its band (+ denoise halo)
            ao_term = compute_ao_band(depth_full, normal_full, gtao_consts,
                                      gtao_settings, noise_index, row0, band)
            ao = ao_visibility_u8(ao_term, gtao_settings)
            bent = ao_bent_normals(ao_term, gtao_settings)
        else:
            ao = jnp.full((band, width), 255, jnp.uint16)

        if enable_tonemap:
            image = pack_unorm8(tonemap_frame(color, ao, lpm_derived))
        else:
            image = pack_unorm8(jnp.clip(color, 0.0, 1.0))

        out = dict(image=image, color=color, depth=depth, normal=normal, ao=ao)
        if bent is not None:
            out["bent_normals"] = bent
        return out

    out_spec = dict(image=P(axis, None, None), color=P(axis, None, None),
                    depth=P(axis, None), normal=P(axis, None, None),
                    ao=P(axis, None))
    if enable_gtao and gtao_settings.bent_normals:
        out_spec["bent_normals"] = P(axis, None, None)

    # check_vma off: the tracer's while_loop carries start from unvarying
    # constants and become device-varying inside the loop, which the VMA
    # checker (jax >= 0.8) rejects even though the program is correct SPMD.
    fn = shard_map(
        per_chip, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P()),
        out_specs=out_spec,
        check_vma=False,
    )
    return fn(scene, camera, lights, gtao_consts, lpm_derived,
              jnp.asarray(noise_index))
