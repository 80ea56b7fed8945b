"""End-to-end frame tests: the minimum slice (BASELINE config 1 analogue) —
a glTF cube + one point light, primary rays + hard shadows — plus the full
pipeline with GTAO and LPM tonemap. The reference has no render tests at all
(SURVEY.md §4); these golden-behavior checks are new coverage.
"""
import numpy as np
import pytest

from assets import box_path
from tpurt.engine import Renderer, RendererConfig
from tpurt.passes.gtao import GtaoSettings
from tpurt.passes.rays import camera_rays
from tpurt.scene.lights import PointLight

SIZE = 64


def make_renderer(**kw):
    cfg = RendererConfig(width=SIZE, height=SIZE,
                         gtao=GtaoSettings(slice_count=2, steps_per_slice=2,
                                           denoise=1), **kw)
    r = Renderer(cfg)
    scale = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], np.float32)
    r.add_model(box_path(), scale)
    r.camera_mut().set_pos([0.0, 0.0, -3.0])
    r.camera_mut().set_dir([0.0, 0.0, 1.0])
    r.lights_mut().point_lights.append(
        PointLight(pos=[0.0, 0.0, -2.0], color=[3.0, 3.0, 3.0],
                   falloff_distance=10.0, casts_shadows=True))
    r.prepare_first_frame()
    return r


@pytest.fixture(scope="module")
def frame():
    r = make_renderer()
    out = r.render()
    return {k: np.asarray(v) for k, v in out.items()}


def test_camera_ray_center_matches_dir():
    from tpurt.scene.camera import Camera
    cam = Camera(aspect=1.0)
    cam.set_pos([1.0, 2.0, 3.0])
    cam.set_dir([0.0, 0.0, 1.0])
    o, d = camera_rays(cam.uniform(), 65, 65)  # odd size -> exact center pixel
    center = 32 * 65 + 32
    np.testing.assert_allclose(np.asarray(o)[center], [1, 2, 3], atol=1e-5)
    np.testing.assert_allclose(np.asarray(d)[center], [0, 0, 1], atol=1e-3)


def test_depth_hit_and_miss(frame):
    depth = frame["depth"]
    c = SIZE // 2
    # cube front face at z = -0.5, camera at z = -3 -> view depth 2.5
    assert abs(depth[c, c] - 2.5) < 0.01
    assert depth[0, 0] == 10000.0  # miss


def test_color_lit_center_dark_corners(frame):
    img = frame["image"]
    c = SIZE // 2
    assert img[c, c].max() > 10, "lit cube face must be visible"
    assert np.all(img[0, 0] == 0) and np.all(img[-1, -1] == 0), "misses are black"


def test_normal_encoding(frame):
    # front face normal (0,0,-1) in world; view dir +z with up -Y:
    # view-space normal (0,0,-1)->encoded via *0.5+0.5 with y,z negated
    c = SIZE // 2
    n = frame["normal"][c, c]
    # camera-facing normal is +z in view space; the y/z negation then maps it
    # to -1, encoding to 0 (GTAO's decoded viewspace has +z into the screen)
    assert abs(n[0] - 0.5) < 0.02 and abs(n[1] - 0.5) < 0.02 and n[2] < 0.05
    # miss pixels encode 0.5
    np.testing.assert_allclose(frame["normal"][0, 0], 0.5, atol=1e-3)


def test_ao_range(frame):
    ao = frame["ao"]
    c = SIZE // 2
    assert ao[c, c] > 150, "flat face should be mostly unoccluded"
    # u16: the final AO store is unclamped (0..~383, XeGTAO.hlsli:729-731)
    assert ao.dtype == np.uint16


def test_shadowing_darkens():
    """A light whose rays toward the camera-facing face are blocked by the
    cube itself (light behind the cube) must produce the 0.05 shadow
    attenuation on that face."""
    r = make_renderer()
    out_front = {k: np.asarray(v) for k, v in r.render().items()}

    r2 = make_renderer()
    r2.lights_mut().point_lights[0].pos = np.array([0.0, 0.0, 2.0], np.float32)
    out_back = {k: np.asarray(v) for k, v in r2.render().items()}

    c = SIZE // 2
    front = out_front["color"][c, c].max()
    back = out_back["color"][c, c].max()
    assert back < front * 0.2, f"shadowed face not dark: {back} vs {front}"


def test_async_dispatch_returns_future():
    r = make_renderer()
    out = r.render(block=False)
    out["image"].block_until_ready()
    assert np.asarray(out["image"]).shape == (SIZE, SIZE, 3)


def test_msaa_spp_smooths_edges():
    r1 = make_renderer()
    img1 = np.asarray(r1.render()["image"]).astype(int)

    r4 = make_renderer()
    r4.config.spp = 4
    img4 = np.asarray(r4.render()["image"]).astype(int)

    # interiors agree, but some silhouette pixels must change
    assert (img1 != img4).any(), "4-spp must differ at edges"
    diff = np.abs(img1 - img4).max(axis=-1)
    assert (diff > 0).mean() < 0.2, "AA should only affect a minority of pixels"
    c = SIZE // 2
    assert abs(int(img1[c, c].sum()) - int(img4[c, c].sum())) <= 30, \
        "face interior should be nearly unchanged"


def test_spp_scan_matches_unrolled():
    """spp beyond SPP_UNROLL runs the extra samples under lax.scan in one
    program; the result must match an explicit per-jitter accumulation."""
    from tpurt.engine.frame import _aa_jitters, render_sample_hdr
    from tpurt.passes.encodings import quantize_r11g11b10f

    spp = 6
    r = make_renderer()
    r.config.spp = spp
    out = np.asarray(r.render()["color"])

    r2 = make_renderer()
    scene = r2.scene_device
    cam = r2.camera.uniform()
    lights = r2.lights.shader_arrays()
    jitters = _aa_jitters(spp)
    acc = 0
    for s in range(spp):
        acc = acc + render_sample_hdr(scene, cam, lights, jitters[s],
                                      width=SIZE, height=SIZE)
    ref = np.asarray(quantize_r11g11b10f(acc / spp))
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_quad48_matches_stack12_bilinear():
    """The one-gather quad-row fetch must be bit-identical to 4x bilinear
    taps on the 12-channel stack (same weights, same expression order)."""
    import jax.numpy as jnp

    from tpurt.passes.shade import sample_bilinear, sample_bilinear_quad
    from tpurt.scene.scene import flatten_scene

    r = make_renderer()
    fs = flatten_scene(r.models)
    rng = np.random.default_rng(11)
    n = 512
    uv = jnp.asarray(rng.uniform(-1.5, 2.5, (n, 2)), jnp.float32)
    prim = jnp.asarray(rng.integers(0, fs.num_prims, n), jnp.int32)
    hw = jnp.asarray(fs.tex_size, jnp.float32)[prim]

    ref = sample_bilinear(jnp.asarray(fs.tex_stack12),
                          jnp.asarray(fs.tex_size), prim, 0, uv,
                          images_per_prim=1)
    img = jnp.asarray(fs.tex_img_of_prim)[prim]
    got = sample_bilinear_quad(jnp.asarray(fs.tex_quad48), hw, img, uv)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def test_light_eval_schedules_bit_identical():
    """The three light-evaluation schedules in the shade pass (loop /
    hoisted shadow launches / batched (K,N) light math — VERDICT r3 #1
    candidates) must produce bit-identical G-buffers; the knob stays for
    A/B on the GPU."""
    import jax
    import jax.numpy as jnp

    from tpurt.engine.frame import MAX_LEAF
    from tpurt.kernels.trace import trace_closest
    from tpurt.passes.rays import T_MAX, T_MIN
    from tpurt.passes.shade import shade
    from tpurt.scene.lights import SpotLight

    r = make_renderer()
    # second + third shadow-casting lights so the multi-light paths differ
    r.lights_mut().point_lights.append(
        PointLight(pos=[1.0, 1.0, -2.0], color=[1.0, 2.0, 0.5],
                   falloff_distance=8.0, casts_shadows=True))
    r.lights_mut().spot_lights.append(SpotLight(
        pos=[0.0, 1.5, 0.0], dir=[0.0, -1.0, 0.0], color=[2.0, 1.0, 1.0],
        falloff_distance=5.0,
        penumbra_umbra_angles=(np.radians(30.0), np.radians(45.0)),
        casts_shadows=True))
    cam = r.camera.uniform()
    lights = r.lights.shader_arrays()
    scene = jax.tree.map(jnp.asarray, r._scene.as_pytree())
    o, d = camera_rays(cam, SIZE, SIZE)
    hits = trace_closest(scene["bvh"], scene["geom"], o, d, T_MIN, T_MAX,
                         max_leaf=MAX_LEAF)
    outs = {}
    for ev in ("loop", "hoist", "batch"):
        g = shade(scene, cam, lights, hits, o, d, height=SIZE, width=SIZE,
                  max_leaf=MAX_LEAF, light_eval=ev)
        outs[ev] = {k: np.asarray(v) for k, v in g.items()}
    for ev in ("hoist", "batch"):
        for k in outs["loop"]:
            np.testing.assert_array_equal(
                outs["loop"][k], outs[ev][k],
                err_msg=f"light_eval={ev} diverges on {k}")
