"""Live interactive delivery (app/live.py): HTTP surface + event->camera
plumbing, driven end-to-end with a real renderer on a tiny scene."""
import json
import threading
import urllib.request

import numpy as np

from assets import box_path
from tpurt.app.live import LiveApp, serve
from tpurt.engine import Renderer, RendererConfig
from tpurt.passes.gtao import GtaoSettings
from tpurt.scene.lights import PointLight


def _make_app():
    cfg = RendererConfig(width=64, height=64,
                         gtao=GtaoSettings(1, 2, denoise=0))
    r = Renderer(cfg)
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
    return LiveApp(r)


def test_live_server_end_to_end():
    app = _make_app()
    server = serve(app, 64, 64, port=0, host="127.0.0.1")
    port = server.server_address[1]
    base = f"http://127.0.0.1:{port}"
    try:
        app.render_once()  # first frame (compiles)

        # index page with the stream + input wiring
        html = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"/stream" in html and b"keydown" in html

        # latest-frame endpoint returns a real JPEG
        jpg = urllib.request.urlopen(f"{base}/frame.jpg", timeout=10).read()
        assert jpg[:2] == b"\xff\xd8"

        # events reach the fly controller before the next frame
        pos0 = np.array(app.renderer.camera.pos, np.float64)
        for _ in range(5):
            req = urllib.request.Request(
                f"{base}/event", method="POST",
                data=json.dumps(dict(type="key", name="w",
                                     ms=100.0)).encode())
            assert urllib.request.urlopen(req, timeout=10).status == 200
        req = urllib.request.Request(
            f"{base}/event", method="POST",
            data=json.dumps(dict(type="mouse", dx=30.0, dy=0.0)).encode())
        urllib.request.urlopen(req, timeout=10)
        app.render_once()
        pos1 = np.array(app.renderer.camera.pos, np.float64)
        assert np.linalg.norm(pos1 - pos0) > 1e-4, "W key did not move cam"

        # MJPEG stream yields at least one multipart frame
        got = {}

        def read_stream():
            resp = urllib.request.urlopen(f"{base}/stream", timeout=10)
            got["head"] = resp.read(100)

        t = threading.Thread(target=read_stream, daemon=True)
        t.start()
        app.render_once()
        t.join(timeout=15)
        assert b"--tpurtframe" in got.get("head", b"")
    finally:
        server.shutdown()


def test_pipelined_loop_matches_blocking():
    """The bounded frames-in-flight loop (pipeline_depth=2, the
    reference's renderer.rs:300-318 overlap) must publish the same
    per-frame sequence as the blocking loop for a static camera (GTAO
    noise advances with the frame index, so frames are compared
    index-for-index), and drain its queue on stop."""
    import time

    def record(app):
        frames = []
        orig = app.publish

        def wrapper(image):
            frames.append(image.copy())
            orig(image)

        app.publish = wrapper
        return frames

    app = _make_app()
    blocking = record(app)
    for _ in range(4):
        app.render_once()

    app2 = _make_app()
    app2.pipeline_depth = 2
    pipelined = record(app2)
    t = threading.Thread(target=app2.run, daemon=True)
    t.start()
    t0 = time.monotonic()
    while app2.frames_rendered < 4 and time.monotonic() - t0 < 120.0:
        time.sleep(0.05)
    app2.stop()
    t.join(timeout=120.0)
    assert not t.is_alive()
    assert app2.frames_rendered >= 4
    for i in range(4):
        np.testing.assert_array_equal(blocking[i], pipelined[i])


def test_render_stream_bit_matches_sequential():
    """Renderer.render_stream (depth 3) yields bit-identical outputs to
    sequential blocking renders at the same frame indices."""
    app = _make_app()
    seq = [np.asarray(app.renderer.render(block=True)["image"])
           for _ in range(4)]

    app2 = _make_app()
    got = [np.asarray(o["image"])
           for o in app2.renderer.render_stream(4, depth=3)]
    assert len(got) == 4
    for a, b in zip(seq, got):
        np.testing.assert_array_equal(a, b)
