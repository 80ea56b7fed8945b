"""The one tracer entry: every pass that casts rays calls these two functions.

On a GPU backend they run the Pallas Triton traversal kernel
(`traverse_gpu`), compiled. Everywhere else they run the XLA wavefront tracer
(`traverse`), which is also the plain reference the kernel is checked
against. The choice follows the backend the program is traced for; there is
no user knob.

Contract (both tracers): origin/direction (N, 3); t_min/t_max scalars or
(N,). `trace_closest` returns dict(t, tri, u, v) with tri = -1 and t = t_max
on a miss; `trace_any` returns the (N,) occlusion mask.
"""
from __future__ import annotations

import jax

from . import traverse, traverse_gpu


def use_gpu_kernel() -> bool:
    return jax.default_backend() == "gpu"


def _impl():
    return traverse_gpu if use_gpu_kernel() else traverse


def trace_closest(bvh: dict, geom: dict, origin, direction, t_min, t_max,
                  max_leaf: int = 4):
    return _impl().trace_closest(bvh, geom, origin, direction, t_min, t_max,
                                 max_leaf=max_leaf)


def trace_any(bvh: dict, geom: dict, origin, direction, t_min, t_max,
              max_leaf: int = 4):
    return _impl().trace_any(bvh, geom, origin, direction, t_min, t_max,
                             max_leaf=max_leaf)
