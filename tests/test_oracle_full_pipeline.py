"""BASELINE config 4: the COMPLETE pipeline (shade -> XeGTAO -> LPM ->
sRGB u8) gated <=1% RMSE against the independent oracle.

tests/oracle.py re-derives the ray-gen/shading GLSL; tests/oracle_post.py
re-derives XeGTAO + the LPM filter from the HLSL/headers. Chained, they
render the reference frame with zero tpurt code — closing the last
self-referential verification loop (round-2 VERDICT item 3: GTAO and LPM
were previously verified only against this repo's own implementations).
"""
import math

import numpy as np
import pytest

from assets import box_path
from tpurt.engine import Renderer, RendererConfig
from tpurt.engine.frame import render_frame
from tpurt.passes.gtao import GtaoSettings, compute_ao, gtao_constants
from tpurt.passes.tonemap import LpmParams, lpm_filter, lpm_setup
from tpurt.scene.lights import DirectionalLight, PointLight

from oracle import oracle_render
from oracle_post import (lpm_filter_709_709, oracle_gtao_consts,
                         oracle_post_process, xegtao_full)
SIZE = 128

TIERS = {  # vk_xe_gtao.rs quality tiers
    "low": (1, 2),
    "medium": (2, 2),
    "high": (3, 3),
    "ultra": (9, 3),
}


def _scene():
    """Two boxes over a large floor box: guaranteed contact-AO creases,
    lit + shadowed regions."""
    cfg = RendererConfig(width=SIZE, height=SIZE)
    r = Renderer(cfg)
    eye = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]],
                   np.float32)
    r.add_model(box_path(), eye)
    m2 = np.array([[0.35, 0, 0, 0.75], [0, 0.35, 0, 0.3],
                   [0, 0, 0.35, -0.3]], np.float32)
    r.add_model(box_path(), m2)
    # floor: a wide flat box just under the cubes (y is down-positive)
    mf = np.array([[4.0, 0, 0, 0], [0, 0.1, 0, 0.62], [0, 0, 4.0, 0]],
                  np.float32)
    r.add_model(box_path(), mf)
    r.camera_mut().set_pos([0.4, -0.9, -2.1])
    d = np.array([-0.1, 0.4, 1.0])
    r.camera_mut().set_dir(d / np.linalg.norm(d))
    r.lights_mut().point_lights.append(PointLight(
        pos=[0.8, -2.0, -2.0], color=[5.0, 4.8, 4.5], falloff_distance=14.0,
        casts_shadows=True))
    r.lights_mut().directional_lights.append(DirectionalLight(
        dir=np.array([0.3, 0.85, 0.42]) / np.linalg.norm([0.3, 0.85, 0.42]),
        color=[0.8, 0.8, 0.75], casts_shadows=True))
    r.prepare_first_frame()
    return r


def _gbuffer_oracle(r):
    cam = r.camera.uniform()
    lights = r.lights.shader_arrays()
    scene = r.scene.as_pytree()
    full = r.scene.as_full_pytree()
    ref = oracle_render(
        {k: np.asarray(v) for k, v in full.items()
         if k not in ("bvh", "geom")},
        {k: np.asarray(v) for k, v in cam.items()}, lights, SIZE, SIZE)
    return scene, cam, lights, ref


@pytest.mark.parametrize("tier", ["low", "high", "ultra"])
@pytest.mark.parametrize("denoise", [0, 1, 3])
def test_config4_full_pipeline_oracle(tier, denoise):
    """Full frame vs the fully-independent oracle chain at <=1% RMSE."""
    if (tier, denoise) not in (("ultra", 1), ("low", 0), ("high", 3),
                               ("low", 3), ("ultra", 0)):
        pytest.skip("combination covered by the sampled grid")
    slices, steps = TIERS[tier]
    r = _scene()
    r.config.gtao = GtaoSettings(slices, steps, denoise=denoise)
    noise_index = 7

    scene, cam, lights, ref = _gbuffer_oracle(r)

    consts = gtao_constants(SIZE, SIZE, r.camera.znear, r.camera.zfar,
                            r.camera.fovy, r.camera.aspect)
    out = render_frame(scene, cam, lights, consts, r._lpm_derived,
                       np.int32(noise_index), width=SIZE, height=SIZE,
                       gtao_settings=r.config.gtao)
    ours = np.asarray(out["image"], np.float64)

    ctl, _ = lpm_setup(LpmParams())
    oc = oracle_gtao_consts(SIZE, SIZE, r.camera.fovy, r.camera.aspect)
    theirs = oracle_post_process(
        ref["color"], ref["depth"], ref["normal_enc"], oc, ctl,
        slices, steps, denoise, noise_index).astype(np.float64)

    # the scene must exercise the pipeline: real AO variation + real hits
    assert (ref["depth"] < 9999.0).mean() > 0.3
    ao_or = xegtao_full(ref["depth"].astype(np.float32),
                        ref["normal_enc"].astype(np.float32), oc,
                        slices, steps, denoise, noise_index)
    assert ao_or.min() < 200 and int(ao_or.max()) > 260, \
        "scene has neither dark creases nor >1.0 open-surface AO"

    rmse = math.sqrt(float(np.mean((ours - theirs) ** 2))) / 255.0
    assert rmse <= 0.01, f"config-4 RMSE {rmse:.4%} exceeds the 1% gate"


def test_gtao_chain_matches_oracle_synthetic():
    """compute_ao vs the scalar oracle on a synthetic G-buffer (depth bumps
    + analytic normals), all quality tiers, bit-level AO comparison."""
    h = w = 64
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth = (2.0 + 0.35 * np.sin(xs * 0.22) * np.cos(ys * 0.17)
             + 0.002 * xs).astype(np.float32)
    # plausible encoded normals: mostly -z facing with a wobble
    nx = 0.25 * np.sin(ys * 0.13)
    nz = -np.sqrt(np.maximum(1.0 - nx ** 2 - 0.01, 0.0))
    n = np.stack([nx, np.full_like(nx, 0.1), nz], -1)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    normal_enc = (n * 0.5 + 0.5).astype(np.float32)

    consts = gtao_constants(w, h, 0.05, 100.0, math.radians(60.0), 1.0)
    oc = oracle_gtao_consts(w, h, math.radians(60.0), 1.0)
    for slices, steps in TIERS.values():
        for denoise in (0, 2):
            ours = np.asarray(compute_ao(
                depth, normal_enc, consts, GtaoSettings(slices, steps,
                                                        denoise=denoise),
                np.int32(11)))
            theirs = xegtao_full(depth, normal_enc, oc, slices, steps,
                                 denoise, 11)
            diff = np.abs(ours.astype(np.int64) - theirs.astype(np.int64))
            assert (diff <= 1).mean() > 0.995, \
                f"tier {slices}x{steps} d{denoise}: {(diff > 1).mean():.2%}" \
                f" pixels differ by >1 step (max {diff.max()})"


def test_lpm_filter_matches_scalar_oracle():
    """Vectorized lpm_filter vs the ctl-block-consuming scalar LpmMap on
    random HDR colors (incl. blacks, single-channel, huge values)."""
    ctl, derived = lpm_setup(LpmParams())
    rng = np.random.default_rng(3)
    colors = np.concatenate([
        rng.uniform(0.0, 4.0, (500, 3)),
        rng.uniform(0.0, 300.0, (200, 3)),
        np.zeros((8, 3)),
        np.eye(3) * 50.0,
        np.array([[1e-8, 0, 0], [0.18, 0.18, 0.18]]),
    ]).astype(np.float32)
    ours = np.asarray(lpm_filter(colors, derived), np.float64)
    theirs = lpm_filter_709_709(colors, ctl).astype(np.float64)
    assert np.max(np.abs(ours - theirs)) < 2e-5


def test_final_ao_term_is_unclamped():
    """The reference's final AO store has no saturate (XeGTAO.hlsli:729-731)
    — open surfaces legitimately exceed 255/255 and BRIGHTEN in the
    tonemap. Guards against regressing to the round-1/2 clamp."""
    h = w = 32
    depth = np.full((h, w), 3.0, np.float32)  # flat wall, zero occlusion
    normal_enc = np.tile(np.array([0.5, 0.5, 0.0], np.float32), (h, w, 1))
    consts = gtao_constants(w, h, 0.05, 100.0, math.radians(60.0), 1.0)
    ao = np.asarray(compute_ao(depth, normal_enc, consts,
                               GtaoSettings(3, 3, denoise=1), np.int32(0)))
    assert ao.dtype == np.uint16
    assert int(ao.max()) > 255
