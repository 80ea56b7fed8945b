"""Per-pass profiling and frame statistics.

The reference's only instrumentation is the once-per-second FPS print
(frame_timer.rs:16-28). This adds structured per-pass timing (each pass
run to completion with block_until_ready between segments), Mrays/s
counters, and optional jax.profiler trace capture.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import jax


@dataclass
class FrameStats:
    ms_per_pass: dict = field(default_factory=dict)
    rays_traced: int = 0

    @property
    def ms_total(self) -> float:
        return sum(self.ms_per_pass.values())

    def mrays_per_s(self) -> float:
        total_s = self.ms_total / 1000.0
        return self.rays_traced / total_s / 1e6 if total_s > 0 else 0.0

    def pretty(self) -> str:
        parts = [f"{k}: {v:.3f} ms" for k, v in self.ms_per_pass.items()]
        line = ", ".join(parts)
        return (f"{line} | total {self.ms_total:.3f} ms"
                + (f" | {self.mrays_per_s():.1f} Mrays/s"
                   if self.rays_traced else ""))


class PassTimer:
    """Times device passes by synchronizing on their outputs. Use only for
    profiling — the sync points serialize the pipeline."""

    def __init__(self):
        self.stats = FrameStats()

    @contextlib.contextmanager
    def time_pass(self, name: str, count_rays: int = 0):
        start = time.perf_counter()
        out = _Box()
        yield out
        if out.value is not None:
            jax.block_until_ready(out.value)
        self.stats.ms_per_pass[name] = (time.perf_counter() - start) * 1000.0
        self.stats.rays_traced += count_rays


class _Box:
    value = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace (TensorBoard format) around a block."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def _pass_fns(width, height, gtao_settings):
    """Individually jitted pass segments (cached per static config)."""
    from functools import partial

    import jax.numpy as jnp

    from ..kernels.trace import trace_closest
    from ..passes.encodings import quantize_r11g11b10f, quantize_r16f
    from ..passes.gtao import compute_ao
    from ..passes.rays import T_MAX, T_MIN, camera_rays
    from ..passes.shade import shade
    from ..passes.tonemap import tonemap_frame

    @partial(jax.jit)
    def rays_fn(cam):
        return camera_rays(cam, width, height)

    @partial(jax.jit)
    def trace_fn(scene, o, d):
        return trace_closest(scene["bvh"], scene["geom"], o, d,
                             T_MIN, T_MAX, max_leaf=4)

    @partial(jax.jit)
    def shade_fn(scene, cam, lights, hits, o, d):
        g = shade(scene, cam, lights, hits, o, d, height=height, width=width,
                  max_leaf=4)
        color = quantize_r11g11b10f(g["color"]).reshape(height, width, 3)
        depth = quantize_r16f(g["depth"]).reshape(height, width)
        normal = quantize_r11g11b10f(g["normal_enc"]).reshape(height, width, 3)
        return color, depth, normal

    @partial(jax.jit)
    def gtao_fn(depth, normal, consts):
        return compute_ao(depth, normal, consts, gtao_settings, jnp.int32(0))

    @partial(jax.jit)
    def tonemap_fn(color, ao, lpm):
        return tonemap_frame(color, ao, lpm)

    return rays_fn, trace_fn, shade_fn, gtao_fn, tonemap_fn


def profile_frame(renderer, repeats: int = 1) -> FrameStats:
    """Timed, synchronized breakdown of the renderer's frame passes. Each
    pass is its own jitted program (the fused frame is faster; this isolates
    where time goes). The first call pays per-pass compiles."""
    from ..passes.gtao import gtao_constants

    c = renderer.config
    cam = renderer.camera.uniform()
    lights = renderer.lights.shader_arrays()
    consts = gtao_constants(c.width, c.height, renderer.camera.znear,
                            renderer.camera.zfar, renderer.camera.fovy,
                            renderer.camera.aspect)
    scene = renderer.scene_device
    n_lights = renderer.lights.get_lights_count()
    rays_fn, trace_fn, shade_fn, gtao_fn, tonemap_fn = _pass_fns(
        c.width, c.height, c.gtao)

    # warm-up (compile) pass, untimed
    o, d = rays_fn(cam)
    hits = trace_fn(scene, o, d)
    color, depth, normal = shade_fn(scene, cam, lights, hits, o, d)
    ao = gtao_fn(depth, normal, consts)
    jax.block_until_ready(tonemap_fn(color, ao, renderer._lpm_derived))

    timer = PassTimer()
    for _ in range(repeats):
        with timer.time_pass("rays") as box:
            o, d = rays_fn(cam)
            box.value = (o, d)
        with timer.time_pass("trace", count_rays=c.width * c.height) as box:
            hits = trace_fn(scene, o, d)
            box.value = hits
        with timer.time_pass("shade+shadows",
                             count_rays=c.width * c.height * n_lights) as box:
            color, depth, normal = shade_fn(scene, cam, lights, hits, o, d)
            box.value = (color, depth, normal)
        with timer.time_pass("gtao") as box:
            ao = gtao_fn(depth, normal, consts)
            box.value = ao
        with timer.time_pass("tonemap") as box:
            rgb = tonemap_fn(color, ao, renderer._lpm_derived)
            box.value = rgb
    if repeats > 1:
        timer.stats.ms_per_pass = {
            k: v / repeats for k, v in timer.stats.ms_per_pass.items()}
        timer.stats.rays_traced //= repeats
    return timer.stats


def device_profile(renderer, reps: int = 8, k: int = 3) -> FrameStats:
    """Per-pass frame attribution without sync points between passes.

    Runs the frame pipeline as cumulative prefixes (trace; trace+shade;
    ...) each inside a device-side lax.scan of `reps` iterations ending in
    a scalar checksum readback, and reports per-pass cost as consecutive
    differences. Compiles one program per prefix on first use. Each prefix
    is timed min-of-`k`, and the cumulative curve is clamped monotonic
    before differencing so timing noise never yields a negative pass."""
    import jax.numpy as jnp

    from ..passes.encodings import (pack_unorm8, quantize_r11g11b10f,
                                    quantize_r16f)
    from ..passes.gtao import (ao_visibility_u8, compute_ao, gtao_constants)
    from ..passes.rays import T_MAX, T_MIN, camera_rays
    from ..passes.shade import shade
    from ..passes.tonemap import tonemap_frame
    from ..kernels.trace import trace_closest
    from .frame import MAX_LEAF

    c = renderer.config
    w, h = c.width, c.height
    cam = renderer._cached("camera", renderer.camera.uniform())
    lights = renderer._cached("lights", renderer.lights.shader_arrays())
    consts = gtao_constants(w, h, renderer.camera.znear, renderer.camera.zfar,
                            renderer.camera.fovy, renderer.camera.aspect)
    scene = renderer.scene_device
    gtao = c.gtao
    lpm = renderer._lpm_derived

    jits = jnp.linspace(-0.25, 0.25, reps).reshape(reps, 1) \
        * jnp.ones((1, 2), jnp.float32)

    def _trace(scene, cam, jit):
        o, d = camera_rays(cam, w, h, jitter=jit)
        hits = trace_closest(scene["bvh"], scene["geom"], o, d,
                             T_MIN, T_MAX, max_leaf=MAX_LEAF)
        return o, d, hits

    def stage_trace(scene, cam, lights, consts, lpm, jit, ni):
        _, _, hits = _trace(scene, cam, jit)
        return jnp.sum(jnp.where(jnp.isfinite(hits["t"]), hits["t"], 0.0))

    def _gbuf(scene, cam, lights, jit):
        o, d, hits = _trace(scene, cam, jit)
        return shade(scene, cam, lights, hits, o, d, height=h, width=w,
                     max_leaf=MAX_LEAF)

    def stage_shade(scene, cam, lights, consts, lpm, jit, ni):
        return jnp.sum(_gbuf(scene, cam, lights, jit)["color"])

    def _ao(scene, cam, lights, consts, jit, ni):
        g = _gbuf(scene, cam, lights, jit)
        depth = quantize_r16f(g["depth"]).reshape(h, w)
        normal = quantize_r11g11b10f(g["normal_enc"]).reshape(h, w, 3)
        ao_term = compute_ao(depth, normal, consts, gtao, ni)
        return g, ao_visibility_u8(ao_term, gtao)

    def stage_gtao(scene, cam, lights, consts, lpm, jit, ni):
        g, ao = _ao(scene, cam, lights, consts, jit, ni)
        return jnp.sum(g["color"]) + jnp.sum(ao.astype(jnp.float32))

    def stage_tonemap(scene, cam, lights, consts, lpm, jit, ni):
        g, ao = _ao(scene, cam, lights, consts, jit, ni)
        color = quantize_r11g11b10f(g["color"]).reshape(h, w, 3)
        image = pack_unorm8(tonemap_frame(color, ao, lpm))
        return jnp.sum(image.astype(jnp.float32))

    def stage_null(scene, cam, lights, consts, lpm, jit, ni):
        # the scan + dispatch + readback floor alone, so that it is not
        # charged to the first stage
        return jnp.sum(jit) + ni.astype(jnp.float32)

    stages = [("null", stage_null),
              ("trace", stage_trace), ("shade", stage_shade)]
    if c.enable_gtao:
        stages.append(("gtao", stage_gtao))
    if c.enable_tonemap:
        stages.append(("tonemap", stage_tonemap))

    cum = {}
    for name, fn in stages:
        @jax.jit
        def run(scene, cam, lights, consts, lpm, fn=fn):
            def body(acc, xs):
                jit, ni = xs
                return acc + fn(scene, cam, lights, consts, lpm, jit,
                                ni), None

            import jax.numpy as jnp
            acc, _ = jax.lax.scan(
                body, jnp.float32(0),
                (jits, jnp.arange(reps, dtype=jnp.int32) % 64))
            return acc

        args = (scene, cam, lights, consts, lpm)
        float(run(*args))  # compile + settle
        best = float("inf")
        for _ in range(max(1, k)):
            start = time.perf_counter()
            float(run(*args))
            best = min(best, (time.perf_counter() - start) * 1000 / reps)
        cum[name] = best

    stats = FrameStats()
    prev = cum["null"]
    for name, _ in stages[1:]:
        # monotonic clamp: a longer prefix can never truly be cheaper than
        # a shorter one; residual jitter is attributed as 0, not negative
        cur = max(cum[name], prev)
        stats.ms_per_pass[name] = cur - prev
        prev = cur
    n_lights = int(lights["pos"].shape[0])
    stats.rays_traced = w * h * (1 + n_lights)
    return stats
