"""Offline CLI smoke test (the app layer, main.rs analogue)."""
import os

import numpy as np

from assets import box_path
from tpurt.app import offline


def test_cli_single_frame(tmp_path):
    out = str(tmp_path / "frame.png")
    offline.main([
        "--model", box_path(), "--width", "64", "--height", "64",
        "--frames", "1", "--quality", "low", "--out", out,
        "--cam-pos", "0", "0", "-3",
    ])
    assert os.path.exists(out)
    from PIL import Image

    img = np.asarray(Image.open(out))
    assert img.shape == (64, 64, 3)


def test_cli_accumulation_with_checkpoint(tmp_path):
    out = str(tmp_path / "truth.png")
    ckpt = str(tmp_path / "accum.npz")
    offline.main([
        "--model", box_path(), "--width", "32", "--height", "32",
        "--spp", "3", "--checkpoint", ckpt, "--checkpoint-every", "2",
        "--quality", "low", "--out", out, "--cam-pos", "0", "0", "-3",
    ])
    assert os.path.exists(out) and os.path.exists(ckpt)
    data = np.load(ckpt)
    assert int(data["num_samples"]) == 3


def test_interactive_replay_moves_camera(tmp_path):
    """The replay loop (app layer L8, main.rs:78-130 analogue) drives the
    camera through recorded events and renders every frame."""
    import numpy as np

    from tpurt.app.interactive import load_replay, record_orbit, run_replay
    from tpurt.app.offline import default_scene
    from tpurt.engine import Renderer, RendererConfig
    from tpurt.passes.gtao import GtaoSettings

    replay_path = str(tmp_path / "events.jsonl")
    record_orbit(replay_path, frames=6)
    replay = load_replay(replay_path)
    assert sum(len(v) for v in replay.values()) > 6

    cfg = RendererConfig(width=32, height=32,
                         gtao=GtaoSettings(1, 2, denoise=0))
    r = Renderer(cfg)
    default_scene(r, box_path())
    r.camera_mut().set_pos([0.0, 0.0, -3.0])
    r.prepare_first_frame()
    pos0 = np.array(r.camera.pos)
    dir0 = np.array(r.camera.dir)

    img = run_replay(r, replay, frames=6, fps=None)
    assert img.shape == (32, 32, 3)
    assert r.rendered_frames == 6
    # the orbit events must have moved and rotated the camera
    assert not np.allclose(pos0, r.camera.pos)
    assert not np.allclose(dir0, r.camera.dir)


def test_interactive_cli_main(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from tpurt.app.interactive import main

    main(["--model", box_path(),
          "--frames", "3", "--width", "32", "--height", "32",
          "--quality", "low", "--save-every", "2",
          "--out-prefix", str(tmp_path / "f")])
    import os
    assert os.path.exists(str(tmp_path / "f_00000.png"))
    assert os.path.exists(str(tmp_path / "f_00002.png"))
