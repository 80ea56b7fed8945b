"""Wider golden-frame coverage: the reference-light (spot+area)
workload-shaped frame, bent normals, dynamic mode, and a full-frame
GPU-kernel-vs-XLA tracer cross-check.
Regenerate deliberately with tests/regen_goldens.py."""
import os

import numpy as np

import golden_scenes as gs


def _load(name):
    return np.load(os.path.join(gs.GOLDEN_DIR, f"{name}.npz"))


def _assert_image_close(img, ref, frac=0.99, tol=1):
    img = img.astype(np.int32)
    ref = ref.astype(np.int32)
    close = (np.abs(img - ref) <= tol).all(axis=-1)
    assert close.mean() > frac, f"golden drift: {1 - close.mean():.4f}"
    rmse = np.sqrt(((img - ref) ** 2).mean()) / 255.0
    assert rmse < 0.01, f"golden RMSE {rmse:.4f}"


def test_spotarea_golden():
    """128x128 ULTRA frame with the reference app's spot+area lights
    (main.rs:38-64) — the workload-shaped golden."""
    g = _load("spotarea128")
    assert (g["image"].sum(-1) > 0).sum() > 100  # the spot pool is lit
    out = gs.render_spotarea()
    _assert_image_close(out["image"], g["image"])
    np.testing.assert_allclose(out["depth"], g["depth"], rtol=1e-4,
                               atol=1e-3)
    assert (np.abs(out["ao"].astype(int) - g["ao"].astype(int))
            <= 2).mean() > 0.99


def test_bent_normals_golden():
    g = _load("bent64")
    out = gs.render_bent()
    _assert_image_close(out["image"], g["image"])
    d = np.abs(out["bent"].astype(np.float64) - g["bent"].astype(np.float64))
    assert d.max() < 2e-2, f"bent-normal drift {d.max():.4f}"


def test_dynamic_golden():
    g = _load("dynamic64")
    out = gs.render_dynamic()
    _assert_image_close(out["image"], g["image"])
    np.testing.assert_allclose(out["depth"], g["depth"], rtol=1e-4,
                               atol=1e-3)


def test_packet_tracer_full_frame_matches_xla(request):
    """The whole frame pipeline through the GPU traversal kernel (Pallas
    interpreter on CPU) vs the XLA tracer — full-frame equivalence, not
    just per-kernel parity."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_frame import make_renderer

    r_xla = make_renderer()
    out_xla = np.asarray(r_xla.render()["image"]).astype(np.int32)

    request.getfixturevalue("gpu_kernel_path")
    r_pk = make_renderer()
    out_pk = np.asarray(r_pk.render()["image"]).astype(np.int32)

    close = (np.abs(out_pk - out_xla) <= 1).all(axis=-1)
    assert close.mean() > 0.995, f"packet-vs-xla drift {1 - close.mean():.4f}"
