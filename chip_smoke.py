"""Smoke run of the whole frame on one NVIDIA GPU, through the entry points a
user calls. The quickest proof that the system still starts on the card.

  python chip_smoke.py           one card: the phases below
  python chip_smoke.py --multi   four cards: the band-sharded frame and the
                                 sharded-geometry ray ring against the
                                 single-device frame, and nothing else

Phases (one process; any failure exits non-zero):
  device    the first JAX device must be a GPU; prints device_kind, count,
            jax version, XLA_FLAGS and the card's name and power limit
  offline   tpurt.app.offline.main at 800x800 --quality ultra on the
            generated textured cube; the PNG is read back and must light
            enough pixels
  headline  the bench.py scene (~43k tris, 8 textured cubes, 3 shadow
            lights) through Renderer.render(block=True) at 800x800 and
            1920x1080: 3 frames each, finite and lit, with no compile inside
            the timed frames; the median wall ms is a smoke figure
  tracer    the 800x800 headline rays (closest hit + 3 shadow sets) through
            the tracer entry against kernels/traverse.py on the same card
  golden    the golden frames of tests/golden_scenes.py against their CPU
            goldens, under the tolerances of tests/test_golden*.py
  dynamic   one Renderer.render_dynamic frame of the dynamic golden scene

The last line of stdout is the JSON result; everything else comes before.
"""
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

# The offline view (tests/golden_scenes.spotarea_renderer at 128^2 lights
# 218 of 16384 pixels, ~8.5k at 800^2): half of that is the floor.
OFFLINE_MIN_LIT = 4000
TRACE_AGREE = 0.9999      # hit masks / tri / occlusion equal on this share
TRACE_T_RTOL = 1e-5       # t where both hit
OFFLINE_SIZE = 800
HEADLINE_SIZES = [(800, 800), (1920, 1080)]
MULTI_SIZE = 800


def log(msg):
    print(msg, flush=True)


class CompileCounter:
    """Counts JAX trace/lower/compile events (jax.monitoring)."""

    def __init__(self):
        import jax

        self.n = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw):
        if event.startswith("/jax/core/compile/"):
            self.n += 1


def phase_device():
    import jax

    from tpurt.utils.device import require_gpu

    info = require_gpu()
    log(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']} jax={info['jax']} "
        f"XLA_FLAGS={info['xla_flags']!r}")
    log(f"card: {info['card']}")
    return info, jax.devices()[0]


def phase_offline(out_dir):
    from tpurt.app.offline import main as offline_main
    from tpurt.scene.procedural import textured_box_file
    from tpurt.utils.png import decode_png

    path = os.path.join(out_dir, "offline_800.png")
    t0 = time.perf_counter()
    n = OFFLINE_SIZE
    offline_main(["--model", textured_box_file(), "--width", str(n),
                  "--height", str(n), "--quality", "ultra",
                  "--cam-pos", "0", "2.5", "-2.5",
                  "--cam-dir", "0", "-0.707", "0.707", "--out", path])
    with open(path, "rb") as f:
        img = decode_png(f.read())
    lit = int((img.sum(-1) > 0).sum())
    log(f"offline: {path} {img.shape} lit={lit} (floor at 800^2: "
        f"{OFFLINE_MIN_LIT}) "
        f"in {time.perf_counter() - t0:.1f} s")
    assert img.shape == (n, n, 3), img.shape
    floor = OFFLINE_MIN_LIT * n * n // (800 * 800)
    assert lit >= floor, f"offline PNG lights only {lit} pixels"


def phase_headline(card, device, compiles):
    import jax
    import jax.numpy as jnp

    from bench import build_scene
    from tpurt.engine.frame import render_frame
    from tpurt.passes.gtao import gtao_constants

    renderers = {}
    for w, h in HEADLINE_SIZES:
        r = build_scene(w, h)
        renderers[(w, h)] = r
        c = r.config
        t0 = time.perf_counter()
        out = r.render(block=True)          # compile + first frame
        first = time.perf_counter() - t0
        before = compiles.n
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = r.render(block=True)
            times.append((time.perf_counter() - t0) * 1e3)
        inside = compiles.n - before
        lit = float(jnp.sum(out["image"].astype(jnp.float32)))
        finite = bool(jnp.isfinite(out["color"]).all()
                      & jnp.isfinite(out["depth"]).all())
        cam = r._cached("camera", r.camera.uniform())
        lights = r._cached("lights", r.lights.shader_arrays())
        consts = gtao_constants(w, h, r.camera.znear, r.camera.zfar,
                                r.camera.fovy, r.camera.aspect)
        mem = render_frame.lower(
            r.scene_device, cam, lights, consts, r._lpm_derived,
            np.int32(0), width=w, height=h, gtao_settings=c.gtao,
            enable_gtao=c.enable_gtao, enable_tonemap=c.enable_tonemap,
            spp=c.spp, aniso_taps=c.aniso_taps).compile().memory_analysis()
        peak = (device.memory_stats() or {}).get("peak_bytes_in_use")
        log(f"headline {w}x{h}: tris={r.stats()['tris']} "
            f"tracer={r.stats()['tracer']} first frame {first:.1f} s, "
            f"median of 3 blocked frames {statistics.median(times):.3f} ms "
            f"on [{card}] (smoke figure, not a benchmark); compiles inside "
            f"timed frames: {inside}")
        log(f"headline {w}x{h}: memory_analysis: {mem}")
        log(f"headline {w}x{h}: peak_bytes_in_use={peak}")
        assert out["image"].shape == (h, w, 3)
        assert lit > 0, "headline frame is black"
        assert finite, "headline frame has non-finite values"
        assert inside == 0, f"{inside} compiles inside the timed frames"
        jax.block_until_ready(out)
    return renderers[HEADLINE_SIZES[0]]


def phase_tracer(r):
    import jax
    import jax.numpy as jnp

    from tpurt.engine.frame import MAX_LEAF
    from tpurt.kernels import trace, traverse
    from tpurt.passes.light import get_unnormalized_L_vec
    from tpurt.passes.rays import T_MAX, T_MIN, camera_rays
    from tpurt.passes.shade import SHADOW_T_MIN
    from tpurt.passes.vec import length

    c = r.config
    scene = r.scene_device
    cam = r._cached("camera", r.camera.uniform())
    lights = r._cached("lights", r.lights.shader_arrays())
    assert trace.use_gpu_kernel(), "the tracer entry must pick the kernel"
    o, d = jax.jit(camera_rays, static_argnums=(1, 2))(cam, c.width,
                                                       c.height)
    bvh, geom = scene["bvh"], scene["geom"]
    got = jax.jit(lambda o, d: trace.trace_closest(
        bvh, geom, o, d, T_MIN, T_MAX, max_leaf=MAX_LEAF))(o, d)
    ref = jax.jit(lambda o, d: traverse.trace_closest(
        bvh, geom, o, d, T_MIN, T_MAX, max_leaf=MAX_LEAF))(o, d)
    n = o.shape[0]
    g_hit, r_hit = np.asarray(got["tri"]) >= 0, np.asarray(ref["tri"]) >= 0
    mask_bad = int((g_hit != r_hit).sum())
    tri_bad = int((np.asarray(got["tri"]) != np.asarray(ref["tri"])).sum())
    both = g_hit & r_hit
    gt, rt = np.asarray(got["t"])[both], np.asarray(ref["t"])[both]
    t_bad = int((np.abs(gt - rt) > TRACE_T_RTOL * np.abs(rt)).sum())
    log(f"tracer closest: {n} rays, {int(r_hit.sum())} hits; mismatches: "
        f"hit mask {mask_bad}, tri {tri_bad}, t beyond rtol "
        f"{TRACE_T_RTOL}: {t_bad}")
    assert mask_bad <= (1 - TRACE_AGREE) * n and \
        tri_bad <= (1 - TRACE_AGREE) * n and t_bad == 0

    # the frame's shadow rays: from the primary hit toward every light
    attr = scene["tri_attr"][jnp.maximum(ref["tri"], 0)]
    u, v = ref["u"][:, None], ref["v"][:, None]
    pos = attr[:, 0:3] * (1 - u - v) + attr[:, 12:15] * u + attr[:, 24:27] * v
    casts = np.asarray(lights["casts_shadows"]) > 0
    for i in np.nonzero(casts)[0]:
        light = {k: a[i] for k, a in lights.items()}
        vec = get_unnormalized_L_vec(light, pos)
        dist = length(vec)
        L = vec / jnp.maximum(dist, 1e-20)[:, None]
        t_max = jnp.where(jnp.asarray(r_hit), dist, 0.0)
        occ_k = np.asarray(trace.trace_any(bvh, geom, pos, L, SHADOW_T_MIN,
                                           t_max, max_leaf=MAX_LEAF))
        occ_x = np.asarray(traverse.trace_any(bvh, geom, pos, L,
                                              SHADOW_T_MIN, t_max,
                                              max_leaf=MAX_LEAF))
        bad = int((occ_k != occ_x).sum())
        log(f"tracer shadow light {i}: {int(occ_x.sum())} occluded; "
            f"mismatches {bad}")
        assert bad <= (1 - TRACE_AGREE) * n


def _image_close(img, ref, tag):
    img, ref = img.astype(np.int32), ref.astype(np.int32)
    close = (np.abs(img - ref) <= 1).all(axis=-1).mean()
    rmse = float(np.sqrt(((img - ref) ** 2).mean()) / 255.0)
    log(f"golden {tag}: {close:.4%} px within 1 step, RMSE {rmse:.5f}")
    assert close > 0.99 and rmse < 0.01, f"golden {tag} drifted"


def phase_golden():
    import golden_scenes as gs
    from test_frame import make_renderer

    def load(name):
        return np.load(os.path.join(gs.GOLDEN_DIR, f"{name}.npz"))

    out = {k: np.asarray(v) for k, v in make_renderer().render().items()}
    for name, got in (("frame64", out), ("spotarea128", gs.render_spotarea())):
        g = load(name)
        _image_close(got["image"], g["image"], name)
        np.testing.assert_allclose(got["depth"], g["depth"], rtol=1e-4,
                                   atol=1e-3, err_msg=name)
        ao_ok = (np.abs(got["ao"].astype(int) - g["ao"].astype(int))
                 <= 2).mean()
        log(f"golden {name}: depth within rtol 1e-4/atol 1e-3; AO within 2 "
            f"on {ao_ok:.4%}")
        assert ao_ok > 0.99
    g, got = load("bent64"), gs.render_bent()
    _image_close(got["image"], g["image"], "bent64")
    drift = float(np.abs(got["bent"].astype(np.float64)
                         - g["bent"].astype(np.float64)).max())
    log(f"golden bent64: bent-normal drift {drift:.5f} (< 0.02)")
    assert drift < 2e-2
    g, got = load("dynamic64"), gs.render_dynamic()
    _image_close(got["image"], g["image"], "dynamic64")
    np.testing.assert_allclose(got["depth"], g["depth"], rtol=1e-4,
                               atol=1e-3, err_msg="dynamic64")


def phase_dynamic():
    import jax.numpy as jnp

    from test_frame import make_renderer

    r = make_renderer()
    ang = 0.7
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0]]], np.float32)
    out = r.render_dynamic(jnp.asarray(rot))
    img = np.asarray(out["image"])
    lit = int((img.sum(-1) > 0).sum())
    log(f"dynamic: Renderer.render_dynamic frame {img.shape}, lit={lit}")
    assert lit > 0 and np.isfinite(np.asarray(out["color"])).all()


def multi(card):
    """The four-card path: band-sharded frame and sharded-geometry ring at
    800x800 against the single-device frame."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from bench import build_scene
    from tpurt.dist.geometry import (freeze_meta,
                                     render_frame_sharded_geometry,
                                     shard_geometry, shard_tables)
    from tpurt.passes.gtao import gtao_constants

    devices = jax.devices()
    assert len(devices) >= 4, f"--multi needs 4 GPUs, found {len(devices)}"
    mesh = Mesh(devices[:4], ("x",))

    r = build_scene(MULTI_SIZE, MULTI_SIZE)
    t0 = time.perf_counter()
    single = {k: np.asarray(v) for k, v in r.render(block=True).items()}
    log(f"multi: single-device frame in {time.perf_counter() - t0:.1f} s")

    # the replicated scene must live on every card, not only the first
    scene_rep = jax.device_put(r.scene.as_pytree(), NamedSharding(mesh, P()))
    for leaf in jax.tree.leaves(scene_rep):
        assert leaf.sharding.device_set == set(devices[:4]) \
            and leaf.is_fully_replicated, leaf.sharding
    log(f"multi: replicated scene on {len(devices[:4])} devices "
        f"({len(jax.tree.leaves(scene_rep))} arrays)")

    r.config.mesh = mesh
    r._scene_device = scene_rep
    r._frame_idx = 0
    t0 = time.perf_counter()
    band = {k: np.asarray(v) for k, v in r.render(block=True).items()}
    log(f"multi: band-sharded frame in {time.perf_counter() - t0:.1f} s")

    c = r.config
    consts = gtao_constants(c.width, c.height, r.camera.znear, r.camera.zfar,
                            r.camera.fovy, r.camera.aspect)
    scene = r.scene.as_pytree()
    shards = shard_geometry(scene, 4)
    tbl, meta = shard_tables(scene, 4)
    t0 = time.perf_counter()
    ring = render_frame_sharded_geometry(
        scene, shards, r.camera.uniform(), r.lights.shader_arrays(), consts,
        r._lpm_derived, np.int32(0), width=c.width, height=c.height,
        gtao_settings=c.gtao, mesh=mesh, shade_tables=tbl,
        meta=freeze_meta(meta))
    ring = {k: np.asarray(v) for k, v in ring.items()}
    log(f"multi: sharded-geometry frame in {time.perf_counter() - t0:.1f} s")

    ok = True
    for tag, out in (("band-sharded", band), ("geometry-ring", ring)):
        for key in ("image", "color", "depth", "normal", "ao"):
            a, b = single[key], out[key]
            diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
            same = bool(np.array_equal(a, b))
            log(f"multi {tag} {key}: bit-equal={same} "
                f"differing={int((diff > 0).sum())} max|d|={diff.max()}")
            ok &= same
    log(f"multi: on [{card}]")
    assert ok, "a sharded frame differs from the single-device frame"


def main():
    import jax

    if "--multi" in sys.argv[1:]:
        info, _ = phase_device()
        from tpurt.utils.cache import setup_compile_cache

        setup_compile_cache()
        multi(info["card"])
        print(json.dumps(dict(ok=True, device=dict(
            platform="gpu", kind=info["kind"], count=4))))
        return

    info, device = phase_device()
    from tpurt.utils.cache import setup_compile_cache

    setup_compile_cache()
    compiles = CompileCounter()
    out_dir = os.path.join(ROOT, "smoke_out")
    os.makedirs(out_dir, exist_ok=True)
    import assets

    assets.write_assets(os.path.join(ROOT, ".assets"))
    phase_offline(out_dir)
    r = phase_headline(info["card"], device, compiles)
    phase_tracer(r)
    phase_golden()
    phase_dynamic()
    print(json.dumps(dict(ok=True, device=dict(
        platform=jax.devices()[0].platform, kind=info["kind"],
        count=len(jax.devices())))))


if __name__ == "__main__":
    main()
