"""Validation layer — the analogue of the reference's debug tooling.

The reference enables VK_LAYER_KHRONOS_validation with GPU-assisted +
synchronization validation in debug builds (vk_base.rs:47-63) plus a
debug-utils message callback (helper.rs:8-30). The JAX equivalents:

* `validation()` context manager: jax_debug_nans + jax_debug_infs (traps the
  class of bug GPU-assisted validation catches — garbage reads showing up as
  non-finite math), optional disable_jit for eager stepping,
* `validate_scene` / `validate_camera`: structural shape/dtype/invariant
  checks over the pytrees that cross the host->device boundary (the analogue
  of descriptor/layout validation at bind time).
"""
from __future__ import annotations

import contextlib

import jax
import numpy as np


@contextlib.contextmanager
def validation(nan_checks: bool = True, eager: bool = False):
    """Enable the debug validation mode within a scope."""
    ctxs = []
    if nan_checks:
        ctxs.append(("jax_debug_nans", True))
        ctxs.append(("jax_debug_infs", False))  # miss depth is 1e4, inf legal in slabs
    if eager:
        ctxs.append(("jax_disable_jit", True))
    old = {}
    try:
        for name, value in ctxs:
            old[name] = getattr(jax.config, name)
            jax.config.update(name, value)
        yield
    finally:
        for name, value in old.items():
            jax.config.update(name, value)


def _is_finite(a) -> bool:
    return bool(np.isfinite(np.asarray(a)).all())


def validate_scene(scene: dict):
    """Invariant checks for a flattened scene pytree (raises AssertionError)."""
    bvh = scene["bvh"]
    geom = scene["geom"]
    m = bvh["aabb_min"].shape[0]
    t = geom["v0"].shape[0]

    assert bvh["aabb_max"].shape == (m, 3)
    for k in ("entry", "skip", "first_tri", "tri_count"):
        assert bvh[k].shape == (m,), f"bvh.{k} wrong shape"
        assert np.asarray(bvh[k]).dtype == np.int32
    skip = np.asarray(bvh["skip"])
    entry = np.asarray(bvh["entry"])
    count = np.asarray(bvh["tri_count"])
    first = np.asarray(bvh["first_tri"])
    assert skip.min() >= -1 and skip.max() < m, "skip link out of range"
    internal = count == 0
    assert entry[internal].min() >= 0 and entry[internal].max() < m
    leaves = ~internal
    assert (first[leaves] >= 0).all()
    assert (first[leaves] + count[leaves] <= t).all(), "leaf range out of bounds"
    assert np.all(np.asarray(bvh["aabb_min"]) <= np.asarray(bvh["aabb_max"]) + 1e-6)

    assert geom["e1"].shape == (t, 3) and geom["e2"].shape == (t, 3)
    order = np.sort(np.asarray(geom["tri_id"]))
    assert (order == np.arange(t)).all(), "tri_id must be a permutation"
    for k in ("v0", "e1", "e2"):
        assert _is_finite(geom[k]), f"geom.{k} non-finite"

    p = scene["tex_size"].shape[0]
    if "tri_vertex" in scene:  # fallback-path tables (full pytrees)
        n_tris = scene["tri_vertex"].shape[0]
        assert n_tris == t
        v = scene["vtx_pos"].shape[0]
        tv = np.asarray(scene["tri_vertex"])
        assert tv.min() >= 0 and tv.max() < v, "vertex index out of range"
        tp = np.asarray(scene["tri_prim"])
        assert tp.min() >= 0 and tp.max() < p, "primitive index out of range"
        assert _is_finite(scene["vtx_pos"]) and _is_finite(scene["vtx_uv"])
    if "tri_attr" in scene:  # gather-optimized rows (lean pytrees)
        attr = np.asarray(scene["tri_attr"])
        assert attr.shape[0] == t and attr.shape[1] in (39, 40), \
            "tri_attr row shape"
        assert _is_finite(attr), "tri_attr non-finite"
        ap = attr[:, 36].astype(np.int64)
        assert ap.min() >= 0 and ap.max() < p, \
            "tri_attr primitive index out of range"
    else:
        assert "tri_vertex" in scene, \
            "scene ships neither tri_attr nor the per-vertex tables"
    if "tex_stack" in scene:  # mip scenes ship one mip tier instead
        assert scene["tex_stack"].shape[0] == p * 3, \
            "texture stack layer count"
        assert np.asarray(scene["tex_stack"]).dtype == np.uint8


def validate_camera(camera: dict):
    for k in ("view", "view_inv", "proj", "proj_inv"):
        assert camera[k].shape == (4, 4), f"camera.{k} shape"
        assert _is_finite(camera[k]), f"camera.{k} non-finite"
    vi = np.asarray(camera["view"]) @ np.asarray(camera["view_inv"])
    assert np.allclose(vi, np.eye(4), atol=1e-4), "view * view_inv != I"
    assert camera["camera_pos"].shape == (3,)
