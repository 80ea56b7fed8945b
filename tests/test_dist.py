"""Multi-device sharding: an 8- or 4-virtual-device CPU mesh must reproduce
the single-device frame bit-exactly (replicated scene, band-sharded rays,
all-gather for the post passes) — for the XLA tracer, the GPU traversal
kernel (Pallas interpreter on CPU), spp > 1, and every output buffer."""
import jax
import numpy as np

from tpurt.dist import make_mesh, render_frame_sharded
from tpurt.passes.gtao import gtao_constants

from test_frame import make_renderer


def _sharded_out(r2, mesh, **kw):
    cfg = r2.config
    cam = r2.camera.uniform()
    consts = gtao_constants(cfg.width, cfg.height, r2.camera.znear,
                            r2.camera.zfar, r2.camera.fovy, r2.camera.aspect)
    return render_frame_sharded(
        r2.scene.as_pytree(), cam, r2.lights.shader_arrays(), consts,
        r2._lpm_derived, np.int32(0),
        width=cfg.width, height=cfg.height, gtao_settings=cfg.gtao, mesh=mesh,
        **kw)


def test_sharded_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    r = make_renderer()
    single = r.render()

    # fresh renderer state so noise_index matches frame 0
    r2 = make_renderer()
    out = _sharded_out(r2, make_mesh(8))
    # the full output surface, not just the image
    for key in ("image", "color", "depth", "normal", "ao"):
        np.testing.assert_array_equal(np.asarray(single[key]),
                                      np.asarray(out[key]), err_msg=key)


def test_sharded_packet_tracer_matches_single(gpu_kernel_path):
    """The GPU traversal kernel must work under shard_map (Pallas
    interpreter on CPU) and agree bit-exactly with the single-device frame
    traced by the same kernel."""
    r = make_renderer()
    single = np.asarray(r.render()["image"])

    r2 = make_renderer()
    out = _sharded_out(r2, make_mesh(8))
    np.testing.assert_array_equal(single, np.asarray(out["image"]))


def test_sharded_spp_and_toggles_match_single():
    r = make_renderer()
    r.config.spp = 2
    r.config.enable_tonemap = False
    single = np.asarray(r.render()["image"])

    r2 = make_renderer()
    out = _sharded_out(r2, make_mesh(8), spp=2, enable_tonemap=False)
    np.testing.assert_array_equal(single, np.asarray(out["image"]))


def test_renderer_mesh_api():
    """RendererConfig.mesh routes frames through the sharded path, honoring
    the full config surface (spp, toggles)."""
    r = make_renderer()
    r.config.spp = 2
    single = np.asarray(r.render()["image"])

    r2 = make_renderer()
    r2.config.spp = 2
    r2.config.mesh = make_mesh(8)
    out = r2.render()
    np.testing.assert_array_equal(single, np.asarray(out["image"]))


def test_sharded_bent_normals_matches_single():
    from tpurt.passes.gtao import GtaoSettings

    r = make_renderer()
    r.config.gtao = GtaoSettings(2, 2, denoise=1, bent_normals=True)
    single = r.render()

    r2 = make_renderer()
    r2.config.gtao = GtaoSettings(2, 2, denoise=1, bent_normals=True)
    r2.config.mesh = make_mesh(8)
    sharded = r2.render()
    np.testing.assert_array_equal(np.asarray(single["image"]),
                                  np.asarray(sharded["image"]))
    np.testing.assert_array_equal(np.asarray(single["bent_normals"]),
                                  np.asarray(sharded["bent_normals"]))


def test_sharded_geometry_ring_matches_replicated():
    """Geometry partitioned across 8 chips + ray ring all-to-all
    (dist/geometry.py) must reproduce the replicated-BVH frame bit-exactly
    — primary hits, shadows, and the post passes."""
    from tpurt.dist.geometry import (render_frame_sharded_geometry,
                                     shard_geometry)

    r = make_renderer()
    single = r.render()

    r2 = make_renderer()
    cfg = r2.config
    scene = r2.scene.as_pytree()
    shards = shard_geometry(scene, 8)
    assert shards["bvh"]["aabb_min"].shape[0] == 8
    cam = r2.camera.uniform()
    consts = gtao_constants(cfg.width, cfg.height, r2.camera.znear,
                            r2.camera.zfar, r2.camera.fovy, r2.camera.aspect)
    out = render_frame_sharded_geometry(
        scene, shards, cam, r2.lights.shader_arrays(), consts,
        r2._lpm_derived, np.int32(0),
        width=cfg.width, height=cfg.height, gtao_settings=cfg.gtao,
        mesh=make_mesh(8))
    for key in ("image", "color", "depth", "normal", "ao"):
        np.testing.assert_array_equal(np.asarray(single[key]),
                                      np.asarray(out[key]), err_msg=key)


def test_sharded_bvh8_tier_matches_single():
    """The four-device mesh the GPU path runs (chip_smoke.py --multi):
    bit-exact vs the single-device frame across the output surface."""
    r = make_renderer()
    single = r.render()

    r2 = make_renderer()
    out = _sharded_out(r2, make_mesh(4))
    for key in ("image", "color", "depth", "normal", "ao"):
        np.testing.assert_array_equal(np.asarray(single[key]),
                                      np.asarray(out[key]), err_msg=key)


def test_sharded_pallas_gtao_matches_single_chip():
    """The banded GTAO main pass at ULTRA (9x3) with medium denoise under
    shard_map (traced band origins, a 3-row halo) matches the single-device
    frame; FMA contraction under shard_map allows <=0.1% of pixels off by
    >1 ulp of u8."""
    from tpurt.passes.gtao import GtaoSettings

    gtao = GtaoSettings(9, 3, denoise=2)
    r = make_renderer()
    r.config.gtao = gtao
    single = r.render()

    r2 = make_renderer()
    r2.config.gtao = gtao
    out = _sharded_out(r2, make_mesh(4))
    for key in ("image", "ao"):
        a = np.asarray(single[key]).astype(np.int64)
        b = np.asarray(out[key]).astype(np.int64)
        diff = np.abs(a - b)
        assert (diff <= 1).mean() > 0.999, \
            f"{key}: {(diff > 1).mean():.4%} px differ by >1 (max {diff.max()})"
