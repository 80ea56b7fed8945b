"""Sharded-geometry mode (dist/geometry.py): the ray ring through the
tracer entry + row-sharded shading tables served by ring_gather, on an
8-virtual-device CPU mesh. The frame must be bit-exact vs the single-device
frame, and per-device memory must actually drop ~D× (the mode exists to
remove the replicated-scene ceiling, SURVEY.md §2.4)."""
import jax
import jax.numpy as jnp
import numpy as np

from tpurt.dist import make_mesh
from tpurt.dist.geometry import (freeze_meta, hbm_accounting, ring_gather,
                                 render_frame_sharded_geometry,
                                 shard_geometry, shard_tables)
from tpurt.passes.gtao import gtao_constants
from tpurt.scene.lights import PointLight

from test_frame import make_renderer


def _geometry_out(r2, n, **renderer_kw):
    cfg = r2.config
    scene = r2.scene.as_pytree()
    shards = shard_geometry(scene, n)
    tbl, meta = shard_tables(scene, n)
    consts = gtao_constants(cfg.width, cfg.height, r2.camera.znear,
                            r2.camera.zfar, r2.camera.fovy, r2.camera.aspect)
    out = render_frame_sharded_geometry(
        scene, shards, r2.camera.uniform(), r2.lights.shader_arrays(),
        consts, r2._lpm_derived, np.int32(0),
        width=cfg.width, height=cfg.height, gtao_settings=cfg.gtao,
        mesh=make_mesh(n), shade_tables=tbl, meta=freeze_meta(meta),
        **renderer_kw)
    return out, scene, shards, tbl


def _add_lights(r):
    # two more shadow-casting lights: three shadow tours per frame
    r.lights_mut().point_lights.append(
        PointLight(pos=[1.5, 1.0, -2.0], color=[1.0, 2.0, 0.5],
                   falloff_distance=8.0, casts_shadows=True))
    r.lights_mut().point_lights.append(
        PointLight(pos=[-1.5, -1.0, -2.5], color=[0.5, 0.5, 2.0],
                   falloff_distance=8.0, casts_shadows=True))


def test_ring_gather_matches_direct():
    """ring_gather over a row-sharded table == direct global gather, for
    f32 wide rows and u8 rows, including out-of-range (padded) indices."""
    from jax.sharding import PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    rng = np.random.default_rng(3)
    rows = 103                          # deliberately not divisible by 8
    table = rng.standard_normal((rows, 40)).astype(np.float32)
    idx = rng.integers(0, rows, size=257).astype(np.int32)

    d = 8
    chunk = -(-rows // d)
    padded = np.zeros((d * chunk, 40), np.float32)
    padded[:rows] = table
    mesh = make_mesh(d)

    def body(tbl, idx):
        return ring_gather(tbl[0], chunk, idx, "x", d)

    out = shard_map(body, mesh=mesh,
                    in_specs=(P("x"), P()), out_specs=P(),
                    check_vma=False)(
        jnp.asarray(padded.reshape(d, chunk, 40)), jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(out), table[idx])


def test_geometry_bvh8_matches_single_chip():
    """Ray ring + sharded shading tables, 3 shadow-casting lights:
    bit-exact vs the single-device frame across the full output surface."""
    r = make_renderer()
    _add_lights(r)
    single = r.render()

    r2 = make_renderer()
    _add_lights(r2)
    out, _, _, _ = _geometry_out(r2, 8)
    for key in ("image", "color", "depth", "normal", "ao"):
        np.testing.assert_array_equal(np.asarray(single[key]),
                                      np.asarray(out[key]), err_msg=key)


def test_geometry_bvh8_mipmaps_matches_single_chip():
    """The mip-atlas texture path (tex_mip_quad) through the sharded quad
    ring gather: bit-exact vs single device."""
    r = make_renderer(mipmaps=True)
    single = r.render()

    r2 = make_renderer(mipmaps=True)
    out, _, _, _ = _geometry_out(r2, 8)
    for key in ("image", "color"):
        np.testing.assert_array_equal(np.asarray(single[key]),
                                      np.asarray(out[key]), err_msg=key)


def test_geometry_hbm_ceiling_drops():
    """Per-chip residency of every big component must be ~1/D of the
    replicated scene (plus the small replicated remainder)."""
    r = make_renderer()
    scene = r.scene.as_pytree()
    n = 8
    shards = shard_geometry(scene, n)
    tbl, _ = shard_tables(scene, n)
    acct = hbm_accounting(scene, shards, tbl, n)

    rep = acct["replicated_bytes"]
    per = acct["sharded_per_chip"]
    # each sharded component is at most ~1/D of its replicated size plus
    # padding slack (each shard's BVH is built on its own, so traversal is
    # compared against its own stacked size, not the flat one)
    assert per["tri_attr"] * n <= rep["tri_attr"] * 1.25 + 4096
    big_tex = max(rep["tex_quad48"], rep["tex_mip_quad"])
    assert per["texture_rows"] * n <= big_tex * 1.25 + 4096
    assert acct["ceiling_ratio"] > 1.0
    assert acct["sharded_total"] < acct["replicated_total"]


def test_geometry_xla_tier_still_works():
    """Replicated shading tables (no shade_tables) keep their contract."""
    r = make_renderer()
    single = r.render()

    r2 = make_renderer()
    cfg = r2.config
    scene = r2.scene.as_pytree()
    shards = shard_geometry(scene, 8)
    consts = gtao_constants(cfg.width, cfg.height, r2.camera.znear,
                            r2.camera.zfar, r2.camera.fovy, r2.camera.aspect)
    out = render_frame_sharded_geometry(
        scene, shards, r2.camera.uniform(), r2.lights.shader_arrays(),
        consts, r2._lpm_derived, np.int32(0),
        width=cfg.width, height=cfg.height, gtao_settings=cfg.gtao,
        mesh=make_mesh(8))
    np.testing.assert_array_equal(np.asarray(single["image"]),
                                  np.asarray(out["image"]))


def test_geometry_bvh8_pair_tier_matches_single_chip():
    """The pair mip tier through the sharded row ring gather: bit-exact
    vs single device."""
    import tpurt.scene.scene as scene_mod

    old = scene_mod.MIP_QUAD_BUDGET_BYTES
    scene_mod.MIP_QUAD_BUDGET_BYTES = 0   # force the pair tier
    try:
        r = make_renderer(mipmaps=True)
        assert r.scene.tex_mip_pair is not None
        single = r.render()

        r2 = make_renderer(mipmaps=True)
        out, _, _, tbl = _geometry_out(r2, 8)
    finally:
        scene_mod.MIP_QUAD_BUDGET_BYTES = old
    assert "quad_rows" in tbl   # the pair rows sharded like the others
    for key in ("image", "color"):
        np.testing.assert_array_equal(np.asarray(single[key]),
                                      np.asarray(out[key]), err_msg=key)
