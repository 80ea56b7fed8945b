"""Headline frame timing on one GPU.

The full pipeline (camera rays, closest-hit trace, shade with one shadow ray
per shadow-casting light, G-buffer quantize, XeGTAO ULTRA 9x3 + sharp
denoise, LPM tonemap) on the headline scene — a ~43k-triangle box field,
a ground plane, 8 textured cubes and 3 shadow-casting lights — at 800x800,
then at 1920x1080, through `Renderer.render(block=True)`. Each size: warm-up
frames, then the median of blocked frames (block_until_ready synchronises
on CUDA). Prints ONE JSON line; progress goes to stderr.

  python bench.py              the headline numbers
  python bench.py --tracers    frame and trace times with the Triton
                               traversal kernel and with the XLA tracer, in
                               one process, plus the kernel's block-size
                               sweep and the XLA GTAO main/denoise times

Rays/frame = W*H primary + W*H per shadow-casting light. Needs a GPU: with
none it exits non-zero and prints no result.
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402

SIZES = [(800, 800), (1920, 1080)]   # the headline first
WARMUP = 3
FRAMES = 20


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def build_scene(width, height):
    from tpurt.engine import Renderer, RendererConfig
    from tpurt.passes.gtao import GtaoSettings
    from tpurt.scene.lights import AreaLight, DirectionalLight, SpotLight
    from tpurt.scene.procedural import (box_field, ground_plane,
                                        textured_box_file)

    cfg = RendererConfig(width=width, height=height,
                         gtao=GtaoSettings(slice_count=9, steps_per_slice=3,
                                           denoise=1))  # ULTRA + Sharp
    r = Renderer(cfg)

    # Sponza-scale stand-in: a 12x12 field of subdivided boxes (~43k tris)
    # + ground, plus textured glTF cubes for the material/texture path —
    # multi-model with running custom indices (renderer.rs:641-650).
    box = textured_box_file()
    r.models.append(box_field(nx=12, nz=12, subdiv=5))
    r.models.append(ground_plane())
    for i in range(8):
        m = np.array([[0.45, 0, 0, (i - 3.5) * 1.4],
                      [0, 0.45, 0, -2.2],
                      [0, 0, 0.45, 0.0]], np.float32)
        r.add_model(box, m)

    r.camera_mut().set_pos([0.0, -2.5, -9.5])
    d = np.array([0.0, 0.3, 1.0])
    r.camera_mut().set_dir(d / np.linalg.norm(d))

    # the reference app's two lights (main.rs:38-64) repositioned for scale,
    # plus a directional sun so the whole field participates
    r.lights_mut().directional_lights.append(DirectionalLight(
        dir=np.array([0.35, 0.85, 0.4]) / np.linalg.norm([0.35, 0.85, 0.4]),
        color=[1.4, 1.3, 1.1], casts_shadows=True))
    r.lights_mut().spot_lights.append(SpotLight(
        pos=[0.0, -4.0, 0.0], dir=[0.0, 1.0, 0.0],
        color=np.array([1.36, 0.16, 2.22]) * 10.0, falloff_distance=12.0,
        penumbra_umbra_angles=(np.radians(30), np.radians(45)),
        casts_shadows=True))
    r.lights_mut().area_lights.append(AreaLight(
        pos=[-2.0, -3.0, 0.2], pos2=[-2.0, -3.0, -0.8], pos3=[-2.0, -2.2, -0.8],
        invert_normal=False, color=np.array([1.96, 0.06, 0.41]) * 3.0,
        falloff_distance=12.0,
        penumbra_umbra_angles=(np.radians(90), np.radians(90.1)),
        casts_shadows=True))
    r.prepare_first_frame()
    return r


def _median_ms(fn, frames=FRAMES, warmup=WARMUP):
    """Median wall ms of `frames` blocked calls after `warmup` calls."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(frames):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def time_frames(renderer, frames=FRAMES):
    """Median ms of blocked Renderer.render frames; checks the last frame
    is lit and finite."""
    import jax.numpy as jnp

    ms = _median_ms(lambda: renderer.render(block=True)["image"], frames)
    out = renderer.render(block=True)
    assert float(jnp.sum(out["image"].astype(jnp.float32))) > 0, \
        "benchmark rendered a black frame"
    assert bool(jnp.isfinite(out["color"]).all())
    return ms


def time_primary_trace(renderer, frames=FRAMES, block=None):
    """Median ms of the closest-hit trace of the frame's primary rays
    through the tracer entry (the tracer the frame uses), or through the
    kernel at an explicit block size."""
    import jax

    from tpurt.engine.frame import MAX_LEAF
    from tpurt.kernels import trace, traverse_gpu
    from tpurt.passes.rays import T_MAX, T_MIN, camera_rays

    c = renderer.config
    cam = renderer._cached("camera", renderer.camera.uniform())
    scene = renderer.scene_device
    o, d = jax.jit(camera_rays, static_argnums=(1, 2))(cam, c.width,
                                                       c.height)
    if block is None:
        fn = jax.jit(lambda s, o, d: trace.trace_closest(
            s["bvh"], s["geom"], o, d, T_MIN, T_MAX, max_leaf=MAX_LEAF))
    else:
        fn = jax.jit(lambda s, o, d: traverse_gpu.trace_closest(
            s["bvh"], s["geom"], o, d, T_MIN, T_MAX, max_leaf=MAX_LEAF,
            block=block))
    return _median_ms(lambda: fn(scene, o, d)["t"], frames)


def time_gtao(renderer, frames=FRAMES):
    """Median ms of the XLA GTAO main pass (prefilter + horizon slices) and
    of the denoise chain on the frame's own G-buffer."""
    import jax

    from tpurt.passes import gtao

    c = renderer.config
    out = renderer.render(block=True)
    consts = gtao.gtao_constants(c.width, c.height, renderer.camera.znear,
                                 renderer.camera.zfar, renderer.camera.fovy,
                                 renderer.camera.aspect)

    @jax.jit
    def main(depth, normal):
        mips = gtao.prefilter_depths(depth, consts)
        return gtao.main_pass(mips, normal, consts, c.gtao, 0)

    ao, edges = main(out["depth"], out["normal"])
    denoise = jax.jit(lambda a, e: gtao._denoise_chain(a, e, c.gtao))
    return dict(
        main_ms=_median_ms(lambda: main(out["depth"], out["normal"]),
                           frames),
        denoise_ms=_median_ms(lambda: denoise(ao, edges), frames))


def _with_tracer(kernel: bool):
    """Route the tracer entry to the kernel (True) or to the XLA tracer;
    drops compiled frames so the next call traces afresh."""
    import jax

    from tpurt.kernels import trace

    jax.clear_caches()
    trace.use_gpu_kernel = (lambda: True) if kernel else (lambda: False)


def tracers_main(device):
    import jax

    from tpurt.kernels import trace

    default = trace.use_gpu_kernel
    report = dict(device=device, frames=FRAMES, warmup=WARMUP)
    for w, h in SIZES:
        _log(f"tracers: building {w}x{h} scene...")
        r = build_scene(w, h)
        cell = {}
        for name, kernel in (("triton", True), ("xla", False),
                             ("triton_again", True)):
            _with_tracer(kernel)
            frame = time_frames(r)
            primary = time_primary_trace(r)
            cell[name] = dict(frame_ms=frame, primary_trace_ms=primary)
            _log(f"tracers {w}x{h} {name}: frame {frame:.3f} ms, "
                 f"primary trace {primary:.3f} ms")
        trace.use_gpu_kernel = default
        jax.clear_caches()
        cell["kernel_block_sweep_ms"] = {
            str(b): time_primary_trace(r, block=b) for b in (64, 128, 256)}
        cell["gtao_xla"] = time_gtao(r)
        _log(f"tracers {w}x{h}: sweep {cell['kernel_block_sweep_ms']}, "
             f"gtao {cell['gtao_xla']}")
        report[f"{w}x{h}"] = cell
    print(json.dumps(report))


def main():
    from tpurt.utils.cache import setup_compile_cache
    from tpurt.utils.device import peaks, require_gpu

    device = require_gpu()
    _log(f"bench: {device}")
    setup_compile_cache()
    if "--tracers" in sys.argv:
        tracers_main(device)
        return
    device_peaks = peaks(device["kind"])

    result = dict(device=device, peaks=device_peaks,
                  pipeline="primary+shadow, GTAO ULTRA 9x3 + sharp denoise, "
                           "LPM tonemap",
                  timing=f"median of {FRAMES} blocked Renderer.render "
                         f"frames after {WARMUP} warm-up frames")
    for w, h in SIZES:
        _log(f"bench: building {w}x{h} scene...")
        r = build_scene(w, h)
        shadow_lights = sum(1 for light in r.lights.all_lights()
                            if light.casts_shadows)
        rays = w * h * (1 + shadow_lights)
        ms = time_frames(r)
        trace_ms = time_primary_trace(r)
        _log(f"bench {w}x{h}: {ms:.3f} ms/frame, primary trace "
             f"{trace_ms:.3f} ms")
        result[f"{w}x{h}"] = dict(
            ms_per_frame=ms, mrays_per_s=rays / ms / 1e3,
            rays_per_frame=rays, primary_trace_ms=trace_ms,
            tris=int(r.scene.geom["v0"].shape[0]),
            tracer=r.stats()["tracer"])
    w, h = SIZES[0]
    print(json.dumps(dict(metric=f"Mrays/s (primary+shadow), full pipeline "
                                 f"{w}x{h}",
                          value=result[f"{w}x{h}"]["mrays_per_s"],
                          unit="Mrays/s", **result)))


if __name__ == "__main__":
    main()
