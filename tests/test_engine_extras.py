"""Accumulation/checkpoint, profiler, camera controller, validation layer."""

import numpy as np
import pytest

from tpurt.app.controller import SPEED, FlyCameraController
from tpurt.engine.accumulate import (
    accumulate_samples,
    init_accumulation,
    load_checkpoint,
    save_checkpoint,
)
from tpurt.scene.camera import Camera
from tpurt.utils import validate_camera, validate_scene, validation

from test_frame import make_renderer, SIZE


@pytest.fixture(scope="module")
def renderer():
    return make_renderer()


def test_accumulation_first_sample_matches_frame(renderer):
    scene = renderer.scene.as_pytree()
    cam = renderer.camera.uniform()
    lights = renderer.lights.shader_arrays()
    state = init_accumulation(SIZE, SIZE)
    state = accumulate_samples(state, scene, cam, lights, 1,
                               width=SIZE, height=SIZE)
    assert state.num_samples == 1
    # sample 0 is unjittered -> equals the real-time frame's HDR color
    frame = renderer.render()
    got = np.asarray(state.mean)
    # compare against unquantized HDR is impossible post-hoc; check the
    # quantized color agrees within B10G11R11F precision
    ref = np.asarray(frame["color"])
    mask = ref > 1e-3
    rel = np.abs(got - ref)[mask] / ref[mask]
    assert rel.max() < 0.02


def test_accumulation_converges_and_checkpoints(tmp_path, renderer):
    scene = renderer.scene.as_pytree()
    cam = renderer.camera.uniform()
    lights = renderer.lights.shader_arrays()

    state = init_accumulation(SIZE, SIZE, seed=3)
    state = accumulate_samples(state, scene, cam, lights, 4,
                               width=SIZE, height=SIZE)
    path = str(tmp_path / "accum.npz")
    save_checkpoint(path, state)
    resumed = load_checkpoint(path)
    assert resumed.num_samples == 4
    np.testing.assert_allclose(np.asarray(resumed.color_sum),
                               np.asarray(state.color_sum))
    more = accumulate_samples(resumed, scene, cam, lights, 2,
                              width=SIZE, height=SIZE)
    assert more.num_samples == 6
    assert np.isfinite(np.asarray(more.mean)).all()


def test_profiler_reports_passes(renderer):
    from tpurt.engine.profiler import profile_frame

    stats = profile_frame(renderer)
    for name in ("rays", "trace", "shade+shadows", "gtao", "tonemap"):
        assert name in stats.ms_per_pass
        assert stats.ms_per_pass[name] >= 0
    assert stats.rays_traced == SIZE * SIZE * 2  # 1 primary + 1 light
    assert "Mrays/s" in stats.pretty()


def test_fly_controller_forward_and_mouse():
    cam = Camera()
    ctl = FlyCameraController(cam)
    ctl.key("w", elapsed_ms=100.0)
    # W = forward: with dir (0,0,1), forward is +z
    np.testing.assert_allclose(cam.pos, [0, 0, SPEED * 100], atol=1e-6)
    ctl.mouse(dx=np.pi / 2 / 0.002, dy=0.0)  # yaw 90 degrees
    np.testing.assert_allclose(cam.dir, [1, 0, 0], atol=1e-5)


def test_validation_layer(renderer):
    validate_scene(renderer.scene.as_pytree())
    validate_camera(renderer.camera.uniform())
    with validation(nan_checks=True):
        import jax.numpy as jnp

        _ = jnp.asarray(1.0) + 1.0


def test_validation_catches_broken_scene(renderer):
    # lean pytree: corrupt the tri_attr prim column
    scene = renderer.scene.as_pytree()
    broken = dict(scene)
    attr = np.asarray(scene["tri_attr"]).copy()
    attr[:, 36] += 10_000
    broken["tri_attr"] = attr
    with pytest.raises(AssertionError):
        validate_scene(broken)
    # full pytree: corrupt the fallback tri_prim table
    full = renderer.scene.as_full_pytree()
    broken2 = dict(full)
    broken2["tri_prim"] = np.asarray(full["tri_prim"]) + 10_000
    with pytest.raises(AssertionError):
        validate_scene(broken2)


def test_renderer_stats(renderer):
    stats = renderer.stats()
    assert stats["tris"] > 0 and stats["bvh_nodes"] > 0
    assert stats["rays_per_frame"] == 64 * 64 * 2  # 1 primary + 1 shadow light
    assert stats["tracer"] == "xla"   # the GPU kernel only on a GPU
    assert stats["device_resident_models"] == 1


def test_accumulation_scan_matches_loop_shape(renderer):
    from tpurt.engine.accumulate import accumulate_samples_scan

    scene = renderer.scene_device
    cam = renderer.camera.uniform()
    lights = renderer.lights.shader_arrays()
    state = init_accumulation(SIZE, SIZE, seed=7)
    state = accumulate_samples_scan(state, scene, cam, lights, 3,
                                    width=SIZE, height=SIZE)
    assert state.num_samples == 3
    mean = np.asarray(state.mean)
    assert np.isfinite(mean).all() and mean.max() > 0


def test_checkpoint_path_without_npz_suffix(tmp_path, renderer):
    """np.savez appends '.npz' to bare paths; save/load must still agree
    (a mismatch silently restarted long renders from sample 0)."""
    from tpurt.engine.accumulate import load_checkpoint, save_checkpoint

    state = init_accumulation(SIZE, SIZE, seed=1)
    bare = str(tmp_path / "accum.ckpt")
    save_checkpoint(bare, state)
    resumed = load_checkpoint(bare)
    assert resumed is not None
    assert resumed.num_samples == 0


def test_device_profile():
    """device_profile: honest per-pass attribution API (device-scan)."""
    import sys

    sys.path.insert(0, __file__.rsplit("/", 1)[0])
    from test_frame import make_renderer
    from tpurt.engine.profiler import device_profile

    r = make_renderer()
    stats = device_profile(r, reps=2)
    assert set(stats.ms_per_pass) == {"trace", "shade", "gtao", "tonemap"}
    assert stats.rays_traced == 64 * 64 * 2
    assert stats.ms_per_pass["trace"] > 0
    assert all(np.isfinite(v) for v in stats.ms_per_pass.values())
