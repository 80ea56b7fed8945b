"""Shared builders for the golden-frame fixtures (tests + regen tool).

Each builder returns a dict of numpy output planes. Regenerate the stored
.npz files DELIBERATELY (when a rendering change is intended) with:
    JAX_PLATFORMS=cpu python tests/regen_goldens.py
"""
import os

import numpy as np

from assets import box_path

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def spotarea_renderer():
    """The reference app's lights (main.rs:38-64) on the textured cube at 2x,
    128x128 ULTRA GTAO — the workload-shaped golden (scaled-down 800x800
    spot+area scene the VERDICT asked for)."""
    from tpurt.app.offline import default_scene
    from tpurt.engine import Renderer, RendererConfig
    from tpurt.passes.gtao import GtaoSettings

    cfg = RendererConfig(width=128, height=128,
                         gtao=GtaoSettings(slice_count=9, steps_per_slice=3,
                                           denoise=1))
    r = Renderer(cfg)
    default_scene(r, box_path())
    r.camera_mut().set_pos([0.0, 2.5, -2.5])
    d = np.array([0.0, -0.707, 0.707])
    r.camera_mut().set_dir(d / np.linalg.norm(d))
    r.prepare_first_frame()
    return r


def render_spotarea():
    r = spotarea_renderer()
    out = r.render()
    return dict(image=np.asarray(out["image"]),
                depth=np.asarray(out["depth"]),
                ao=np.asarray(out["ao"]))


def render_bent():
    """frame64 scene with bent normals enabled (XeGTAO v1.30 Alg. 2)."""
    import sys
    from dataclasses import replace

    sys.path.insert(0, os.path.dirname(__file__))
    from test_frame import make_renderer
    from tpurt.passes.gtao import GtaoSettings

    r = make_renderer()
    r.config = replace(r.config, gtao=GtaoSettings(
        slice_count=2, steps_per_slice=2, denoise=1, bent_normals=True))
    out = r.render()
    return dict(image=np.asarray(out["image"]),
                bent=np.asarray(out["bent_normals"]))


def render_dynamic():
    """frame64's model under a rotated per-frame transform through the
    in-jit LBVH dynamic mode."""
    import sys

    import jax.numpy as jnp

    sys.path.insert(0, os.path.dirname(__file__))
    from test_frame import SIZE, make_renderer
    from tpurt.engine.dynamic import render_frame_dynamic
    from tpurt.passes.gtao import gtao_constants

    r = make_renderer()
    cam = r.camera.uniform()
    consts = gtao_constants(SIZE, SIZE, r.camera.znear, r.camera.zfar,
                            r.camera.fovy, r.camera.aspect)
    ang = 0.7
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0]]], np.float32)
    out = render_frame_dynamic(
        r.scene.as_object_pytree(), jnp.asarray(rot), cam,
        r.lights.shader_arrays(), consts, r._lpm_derived, np.int32(3),
        width=SIZE, height=SIZE, gtao_settings=r.config.gtao)
    return dict(image=np.asarray(out["image"]),
                depth=np.asarray(out["depth"]))
