"""The ≤1% RMSE parity gate (BASELINE.json) against an INDEPENDENT oracle.

tests/oracle.py implements the reference's shader math directly from the
GLSL with brute-force intersection and shares no tpurt rendering code; these
tests render BASELINE configs 1-3 analogues both ways and gate the RMSE.
"""
import math

import numpy as np

from assets import box_path
from tpurt.engine import Renderer, RendererConfig
from tpurt.engine.frame import render_sample_hdr
from tpurt.passes.gtao import GtaoSettings
from tpurt.scene.lights import (AreaLight, DirectionalLight, PointLight,
                                SpotLight)

from oracle import oracle_render

SIZE = 128


def _renderer(width=SIZE, height=SIZE):
    cfg = RendererConfig(width=width, height=height,
                         gtao=GtaoSettings(1, 2, denoise=0),
                         enable_gtao=False, enable_tonemap=False)
    return Renderer(cfg)


def _compare(r: Renderer, min_hit_frac=0.15, min_lit_frac=0.05,
             require_shadow=True):
    r.prepare_first_frame()
    cam = r.camera.uniform()
    lights = r.lights.shader_arrays()
    scene = r.scene.as_pytree()
    w, h = r.config.width, r.config.height

    ours = np.asarray(render_sample_hdr(
        scene, cam, lights, np.zeros(2, np.float32), width=w, height=h),
        np.float64)
    full = r.scene.as_full_pytree()
    ref = oracle_render(
        {k: np.asarray(v) for k, v in full.items() if k not in ("bvh", "geom")},
        {k: np.asarray(v) for k, v in cam.items()}, lights, w, h)

    color_ref = ref["color"]
    # the scene must be meaningful: hits, lit pixels, and shadowed pixels
    hit_frac = (ref["depth"] < 9999.0).mean()
    lit_frac = (color_ref.sum(-1) > 1e-3).mean()
    assert hit_frac > min_hit_frac, f"scene too empty: {hit_frac:.2%} hits"
    assert lit_frac > min_lit_frac, f"scene too dark: {lit_frac:.2%} lit"

    # normalized RMSE over the linear HDR frame vs the oracle's dynamic range
    err = ours - color_ref
    rmse = math.sqrt(float(np.mean(err * err)))
    scale = float(color_ref.max())
    assert scale > 0
    rel = rmse / scale
    assert rel <= 0.01, f"RMSE {rel:.4%} of peak exceeds the 1% gate"

    # depth / normal G-buffer parity (unquantized, hit pixels, tolerance
    # gated): the oracle encodes view depth = -(view.P).z and view-space
    # normals *0.5+0.5 with y,z negated straight from rgen.glsl:188-199 —
    # this fails if tpurt's encoding regresses.
    from tpurt.engine.frame import render_gbuffer

    g = render_gbuffer(scene, cam, lights, width=w, height=h)
    our_depth = np.asarray(g["depth"], np.float64).reshape(h, w)
    our_nenc = np.asarray(g["normal_enc"], np.float64).reshape(h, w, 3)
    hit = ref["depth"] < 9999.0
    # agreement on which pixels hit at all (silhouette pixels may differ)
    our_hit = our_depth < 9999.0
    assert (our_hit != hit).mean() <= 5e-3, "hit masks diverge"
    both = hit & our_hit
    d_err = np.abs(our_depth - ref["depth"])[both]
    d_scale = float(ref["depth"][both].max())
    assert d_err.max() <= 0.01 * d_scale + 1e-3, \
        f"depth G-buffer deviates: max {d_err.max():.5f} vs scale {d_scale:.3f}"
    n_err = np.abs(our_nenc - ref["normal_enc"])[both]
    # normal-map bilinear taps are f32 vs the oracle's f64; allow 1% of the
    # [0,1] encoding on all but a silhouette-sized fraction of pixels
    assert np.quantile(n_err, 0.999) <= 0.01, \
        f"normal G-buffer deviates: p99.9 {np.quantile(n_err, 0.999):.5f}"
    return rel, ref


def test_config1_point_light_hard_shadows():
    """BASELINE config 1: single glTF cube + one point light, primary rays
    + hard shadows."""
    r = _renderer()
    eye = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]],
                   np.float32)
    r.add_model(box_path(), eye)
    # a small occluder cube floating between light and box -> real shadows
    m = np.array([[0.2, 0, 0, 0.3], [0, 0.2, 0, -0.4], [0, 0, 0.2, -1.2]],
                 np.float32)
    r.add_model(box_path(), m)
    r.camera_mut().set_pos([0.0, -0.5, -1.6])
    d = np.array([0.0, 0.2, 0.98])
    r.camera_mut().set_dir(d / np.linalg.norm(d))
    r.lights_mut().point_lights.append(PointLight(
        pos=[0.5, -1.5, -2.5], color=[4.0, 4.0, 4.0], falloff_distance=12.0,
        casts_shadows=True))
    rel, ref = _compare(r)
    # the occluder must actually shadow part of the face
    shadowed = ((ref["depth"] < 9999.0)
                & (ref["color"].sum(-1) < 0.02)).mean()
    assert shadowed > 0.01


def test_config2_pbr_point_spot_directional():
    """BASELINE config 2 analogue: multi-model scene, PBR direct lighting
    with point + spot + directional lights + RT shadows."""
    from tpurt.scene.procedural import box_field, ground_plane

    r = _renderer()
    r.models.append(box_field(nx=3, nz=3, subdiv=2))
    r.models.append(ground_plane())
    r.camera_mut().set_pos([0.0, -2.0, -5.0])
    d = np.array([0.0, 0.35, 1.0])
    r.camera_mut().set_dir(d / np.linalg.norm(d))
    r.lights_mut().directional_lights.append(DirectionalLight(
        dir=np.array([0.3, 0.9, 0.3]) / np.linalg.norm([0.3, 0.9, 0.3]),
        color=[1.2, 1.1, 1.0], casts_shadows=True))
    r.lights_mut().point_lights.append(PointLight(
        pos=[0.0, -3.0, 0.0], color=[6.0, 5.0, 4.0], falloff_distance=15.0,
        casts_shadows=True))
    r.lights_mut().spot_lights.append(SpotLight(
        pos=[2.0, -4.0, -2.0], dir=[-0.3, 0.9, 0.3],
        color=[10.0, 2.0, 12.0], falloff_distance=14.0,
        penumbra_umbra_angles=(math.radians(25), math.radians(40)),
        casts_shadows=True))
    _compare(r)


def test_config3_area_light_exclusion():
    """BASELINE config 3 analogue: area light (closest-point-on-rectangle
    radiance) + shadow-ray self-exclusion (tmin 0.01), multi-model."""
    r = _renderer()
    eye = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]],
                   np.float32)
    r.add_model(box_path(), eye)
    m2 = np.array([[0.5, 0, 0, 1.6], [0, 0.5, 0, 0.0], [0, 0, 0.5, 0.0]],
                  np.float32)
    r.add_model(box_path(), m2)
    r.camera_mut().set_pos([0.7, -0.75, -1.2])
    d = np.array([0.1, 0.75, 1.2])
    r.camera_mut().set_dir(d / np.linalg.norm(d))
    # rectangle plane deliberately tilted off-axis: an axis-aligned plane
    # makes N.L exactly 0 on cube faces, where the Burley SSS term is
    # singular in the reference GLSL itself (brdfs.glsl:93)
    r.lights_mut().area_lights.append(AreaLight(
        pos=[1.4, -2.0, -1.6], pos2=[0.2, -2.1, -1.7], pos3=[0.1, -1.3, -1.9],
        invert_normal=False, color=[8.0, 6.5, 5.0], falloff_distance=10.0,
        penumbra_umbra_angles=(math.radians(80), math.radians(89)),
        casts_shadows=True))
    r.lights_mut().spot_lights.append(SpotLight(
        pos=[0.0, -3.0, -2.0], dir=np.array([0.0, 0.8, 0.6]),
        color=[6.0, 6.0, 6.0], falloff_distance=10.0,
        penumbra_umbra_angles=(math.radians(30), math.radians(50)),
        casts_shadows=True))
    _compare(r)


def test_config1_packet_tracer_matches_oracle(gpu_kernel_path):
    """The GPU traversal kernel (Pallas interpreter on CPU) passes the same
    gate."""
    r = _renderer(64, 64)
    eye = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]],
                   np.float32)
    r.add_model(box_path(), eye)
    r.camera_mut().set_pos([0.0, -0.5, -1.6])
    d = np.array([0.0, 0.2, 0.98])
    r.camera_mut().set_dir(d / np.linalg.norm(d))
    r.lights_mut().point_lights.append(PointLight(
        pos=[0.5, -1.5, -2.5], color=[4.0, 4.0, 4.0], falloff_distance=12.0,
        casts_shadows=True))
    r.prepare_first_frame()
    cam = r.camera.uniform()
    lights = r.lights.shader_arrays()
    scene = r.scene.as_pytree()

    ours = np.asarray(render_sample_hdr(
        scene, cam, lights, np.zeros(2, np.float32), width=64, height=64),
        np.float64)
    full = r.scene.as_full_pytree()
    ref = oracle_render(
        {k: np.asarray(v) for k, v in full.items() if k not in ("bvh", "geom")},
        {k: np.asarray(v) for k, v in cam.items()}, lights, 64, 64)
    err = ours - ref["color"]
    rel = math.sqrt(float(np.mean(err * err))) / float(ref["color"].max())
    assert rel <= 0.01, f"packet tracer RMSE {rel:.4%} exceeds the 1% gate"
