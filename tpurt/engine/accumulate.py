"""Progressive accumulation with checkpoint/resume.

The ground-truth configuration (BASELINE.json config 5: 1024 spp converged
at 1080p) renders many jittered samples of the frame and averages them in
linear HDR. The reference app is stateless per frame and has no
checkpointing (SURVEY.md §5); long restartable renders are this renderer's
addition: the accumulation state (sum buffer + sample counter + RNG key) is
a pytree that can be saved/loaded mid-render.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .frame import render_sample_hdr


@dataclass
class AccumulationState:
    color_sum: jnp.ndarray   # (H, W, 3) f32 linear HDR sum
    num_samples: int
    key: jax.Array

    @property
    def mean(self) -> jnp.ndarray:
        return self.color_sum / max(self.num_samples, 1)


def init_accumulation(height: int, width: int, seed: int = 0) -> AccumulationState:
    return AccumulationState(
        color_sum=jnp.zeros((height, width, 3), jnp.float32),
        num_samples=0,
        key=jax.random.PRNGKey(seed),
    )


def accumulate_samples(state: AccumulationState, scene: dict, camera: dict,
                       lights: dict, num_samples: int, *, width: int,
                       height: int) -> AccumulationState:
    """Add `num_samples` stratified-jitter samples to the accumulator.
    Sample 0 uses the pixel center (so 1-spp equals the real-time frame)."""
    color_sum = state.color_sum
    key = state.key
    for s in range(num_samples):
        if state.num_samples == 0 and s == 0:
            jitter = jnp.zeros(2, jnp.float32)
        else:
            key, sub = jax.random.split(key)
            jitter = jax.random.uniform(sub, (2,), minval=-0.5, maxval=0.5)
        color_sum = color_sum + render_sample_hdr(
            scene, camera, lights, jitter, width=width, height=height)
    return AccumulationState(color_sum=color_sum,
                             num_samples=state.num_samples + num_samples,
                             key=key)


@partial(jax.jit, static_argnames=("width", "height", "num_samples",
                                   "include_center"))
def _accumulate_scan(color_sum, key, scene, camera, lights, *, width, height,
                     num_samples, include_center):
    """num_samples jittered samples in ONE device program (lax.scan) —
    avoids a host round-trip per sample."""
    def body(carry, s):
        acc, key = carry
        key, sub = jax.random.split(key)
        jitter = jax.random.uniform(sub, (2,), minval=-0.5, maxval=0.5)
        if include_center:
            jitter = jnp.where(s == 0, jnp.zeros(2), jitter)
        acc = acc + render_sample_hdr(scene, camera, lights, jitter,
                                      width=width, height=height)
        return (acc, key), None

    (color_sum, key), _ = jax.lax.scan(
        body, (color_sum, key), jnp.arange(num_samples))
    return color_sum, key


def accumulate_samples_scan(state: AccumulationState, scene: dict,
                            camera: dict, lights: dict, num_samples: int, *,
                            width: int, height: int) -> AccumulationState:
    """Scan-based accumulation: the whole batch runs as one jitted program,
    with no host round trip per sample."""
    color_sum, key = _accumulate_scan(
        state.color_sum, state.key, scene, camera, lights, width=width,
        height=height, num_samples=num_samples,
        include_center=(state.num_samples == 0))
    return AccumulationState(color_sum=color_sum,
                             num_samples=state.num_samples + num_samples,
                             key=key)


def _ckpt_path(path: str) -> str:
    """np.savez appends '.npz' to bare paths; normalize so save and load
    always agree (a mismatch silently restarts long renders from sample 0)."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, state: AccumulationState):
    path = _ckpt_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, color_sum=np.asarray(state.color_sum),
             num_samples=state.num_samples, key=np.asarray(state.key))


def load_checkpoint(path: str) -> Optional[AccumulationState]:
    path = _ckpt_path(path)
    if not os.path.exists(path):
        return None
    data = np.load(path)
    return AccumulationState(
        color_sum=jnp.asarray(data["color_sum"]),
        num_samples=int(data["num_samples"]),
        key=jnp.asarray(data["key"]),
    )
