"""Dynamic mode: in-jit LBVH rebuild from per-frame instance transforms."""
import numpy as np
import jax.numpy as jnp

from assets import box_path
from tpurt.engine.dynamic import render_frame_dynamic
from tpurt.passes.gtao import gtao_constants

from test_frame import make_renderer, SIZE


def _args(r):
    cam = r.camera.uniform()
    consts = gtao_constants(SIZE, SIZE, r.camera.znear, r.camera.zfar,
                            r.camera.fovy, r.camera.aspect)
    return cam, r.lights.shader_arrays(), consts, r._lpm_derived


def test_dynamic_matches_static_at_rest():
    r = make_renderer()
    static = {k: np.asarray(v) for k, v in r.render().items()}

    r2 = make_renderer()
    cam, lights, consts, lpm = _args(r2)
    out = render_frame_dynamic(
        r2.scene.as_object_pytree(), r2.scene.transforms, cam, lights,
        consts, lpm, np.int32(0), width=SIZE, height=SIZE,
        gtao_settings=r2.config.gtao)
    dyn = {k: np.asarray(v) for k, v in out.items()}

    # same geometry, different BVH builder -> same hits except possible
    # tie-breaks on shared edges; images must agree at (nearly) every pixel
    diff = np.abs(dyn["depth"] - static["depth"])
    assert (diff < 1e-3).mean() > 0.999
    img_diff = np.abs(dyn["image"].astype(int) - static["image"].astype(int))
    assert (img_diff <= 1).mean() > 0.995


def test_dynamic_transform_moves_object():
    r = make_renderer()
    cam, lights, consts, lpm = _args(r)
    obj = r.scene.as_object_pytree()
    t0 = r.scene.transforms

    out0 = render_frame_dynamic(obj, t0, cam, lights, consts, lpm,
                                np.int32(0), width=SIZE, height=SIZE,
                                gtao_settings=r.config.gtao)
    # translate the cube out of view
    t1 = np.array(t0, np.float32)
    t1[0, 0, 3] += 100.0
    out1 = render_frame_dynamic(obj, jnp.asarray(t1), cam, lights, consts,
                                lpm, np.int32(0), width=SIZE, height=SIZE,
                                gtao_settings=r.config.gtao)

    c = SIZE // 2
    assert np.asarray(out0["depth"])[c, c] < 100.0   # hit
    assert np.asarray(out1["depth"])[c, c] == 10000.0  # moved away: miss
    # no recompile needed between transform changes (same shapes) — both
    # calls above share one jit cache entry by construction


def test_renderer_render_dynamic_api():
    """Renderer.render_dynamic (in-jit LBVH rebuild) agrees with the static
    frame at the rest transforms."""
    r = make_renderer()
    static = np.asarray(r.render()["image"]).astype(int)

    r2 = make_renderer()
    rest = r2.scene.transforms
    out = np.asarray(r2.render_dynamic(rest)["image"]).astype(int)
    assert (np.abs(out - static) <= 1).mean() > 0.99


def test_dynamic_random_transforms_match_static():
    """The in-jit rebuild under random affine instance transforms (rotation
    + scale + translation) hits what a static scene flattened with the same
    model matrices hits: different trees, same hits up to shared-edge
    tie-breaks."""
    from tpurt.engine import Renderer

    r = make_renderer()
    cam, lights, consts, lpm = _args(r)
    obj = r.scene.as_object_pytree()
    rng = np.random.default_rng(11)
    base = np.asarray(r.scene.transforms)

    for trial in range(2):
        t = base.copy()
        ang = rng.uniform(-1.2, 1.2)
        c, s = np.cos(ang), np.sin(ang)
        m = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        scale = rng.uniform(0.6, 1.5)
        t[:, :, :3] = np.einsum("ij,njk->nik", m * scale, t[:, :, :3])
        t[:, :, 3] += rng.uniform(-0.5, 0.5, size=t[:, :, 3].shape)

        dyn = render_frame_dynamic(
            obj, jnp.asarray(t), cam, lights, consts, lpm, np.int32(0),
            width=SIZE, height=SIZE, gtao_settings=r.config.gtao)

        st = Renderer(r.config)
        st.add_model(box_path(), t[0])
        st.camera = r.camera
        st.lights = r.lights
        st.prepare_first_frame()
        static = st.render()
        d_depth = np.abs(np.asarray(dyn["depth"])
                         - np.asarray(static["depth"]))
        assert (d_depth < 1e-3).mean() > 0.999, f"trial {trial}"
