"""Model residency state machine round-trip.

The reference's device test (vk_model.rs:1014-1214, test_water_bottle) moves
a model disk->host->device->host by camera distance and byte-compares the
re-uploaded data. Same here: residency transitions at the 10/20 distances,
scene tables rebuilt on re-entry must be bit-identical, and resize
re-specializes the frame.
"""
import numpy as np

from assets import box_path
from tpurt.engine import Renderer, RendererConfig
from tpurt.passes.gtao import GtaoSettings
from tpurt.scene.lights import PointLight
from tpurt.scene.model import Residency


def _renderer(size=64):
    cfg = RendererConfig(width=size, height=size,
                         gtao=GtaoSettings(1, 2, denoise=1))
    r = Renderer(cfg)
    eye = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], np.float32)
    r.add_model(box_path(), eye)
    r.lights_mut().point_lights.append(
        PointLight([0, 0, -2], [3, 3, 3], 10.0, True))
    r.camera_mut().set_dir([0.0, 0.0, 1.0])
    return r


def test_residency_distance_policy():
    r = _renderer()
    model = r.models[0]

    model.update_model_status(np.array([0.0, 0.0, -5.0]))
    assert model.state == Residency.DEVICE
    model.update_model_status(np.array([0.0, 0.0, -15.0]))
    assert model.state == Residency.HOST
    model.update_model_status(np.array([0.0, 0.0, -50.0]))
    assert model.state == Residency.STORAGE
    assert model._primitives is None, "storage must drop decoded arrays"
    model.update_model_status(np.array([0.0, 0.0, -5.0]))
    assert model.state == Residency.DEVICE


def test_scene_roundtrip_bitexact():
    r = _renderer()
    r.camera_mut().set_pos([0.0, 0.0, -3.0])
    r.prepare_first_frame()
    first = {k: np.asarray(v).copy()
             for k, v in r.scene.as_pytree().items() if not isinstance(v, dict)}

    # evict to storage, then bring back
    r.camera_mut().set_pos([0.0, 0.0, -60.0])
    r._update_models()
    assert r.models[0].state == Residency.STORAGE

    r.camera_mut().set_pos([0.0, 0.0, -3.0])
    r._update_models()
    assert r.models[0].state == Residency.DEVICE
    again = r.scene.as_pytree()
    for k, v in first.items():
        np.testing.assert_array_equal(v, np.asarray(again[k]),
                                      err_msg=f"scene table {k} changed")


def test_visibility_exclusion_changes_image():
    r = _renderer()
    r.camera_mut().set_pos([0.0, 0.0, -3.0])
    r.prepare_first_frame()
    lit = r.render_image()
    assert lit.any()

    r.models[0].set_visible(False)
    # all models excluded -> scene would be empty; renderer keeps the last
    # scene only if something is resident, so re-adding a second visible
    # model exercises the rebuild path
    eye2 = np.array([[1.0, 0, 0, 5.0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]],
                    np.float32)
    r.add_model(box_path(), eye2)  # off to the side
    img = r.render_image()
    center = img[32, 32]
    assert not center.any(), "hidden model still visible at the center"


def test_resize_respecializes():
    r = _renderer(size=64)
    r.camera_mut().set_pos([0.0, 0.0, -3.0])
    r.prepare_first_frame()
    img64 = r.render_image()
    assert img64.shape == (64, 64, 3)
    r.resize(96, 96)
    img96 = r.render_image()
    assert img96.shape == (96, 96, 3)
    assert img96.any()
