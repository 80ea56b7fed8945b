"""Flattened BVH representation shared by every builder and traversal kernel.

The reference delegates BLAS/TLAS construction and traversal to the Vulkan
driver (vk_blas_builder.rs:88-170, vk_tlas_builder.rs:38-233,
`traceRayEXT`). Here we own both; the layout chosen here is a *threaded*
(skip-link) BVH so traversal is stackless:

  node entered & internal  -> go to `entry[node]` (left child)
  node missed / leaf done  -> go to `skip[node]`  (next subtree or -1 = exit)

Per-lane state is a single node pointer (i32), which maps cleanly onto both
an XLA `while_loop` over ray batches and a GPU kernel that keeps the pointer
in a register. Leaves reference ranges of a reordered triangle buffer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np


@dataclass
class FlatBVH:
    """Arrays may be numpy (host-built) or jnp (device-built); all static
    shapes. M nodes, T reordered triangles.

    aabb_min / aabb_max : (M, 3) f32
    entry               : (M,)  i32   left child for internal nodes
    skip                : (M,)  i32   next node on miss / after leaf (-1 exits)
    first_tri           : (M,)  i32   leaf triangle range start (into order)
    tri_count           : (M,)  i32   0 for internal nodes
    tri_order           : (T,)  i32   reordered triangle -> original index
    """

    aabb_min: Any
    aabb_max: Any
    entry: Any
    skip: Any
    first_tri: Any
    tri_count: Any
    tri_order: Any

    @property
    def num_nodes(self) -> int:
        return int(self.aabb_min.shape[0])

    @property
    def num_tris(self) -> int:
        return int(self.tri_order.shape[0])

    def as_pytree(self) -> dict:
        return dict(
            aabb_min=self.aabb_min, aabb_max=self.aabb_max, entry=self.entry,
            skip=self.skip, first_tri=self.first_tri, tri_count=self.tri_count,
            tri_order=self.tri_order,
        )

    def validate_host(self, tri_aabb_min: np.ndarray, tri_aabb_max: np.ndarray):
        """Structural invariants (host-side, for tests): every triangle in
        exactly one leaf; every node's box contains its leaf triangles."""
        amin = np.asarray(self.aabb_min)
        amax = np.asarray(self.aabb_max)
        entry = np.asarray(self.entry)
        skip = np.asarray(self.skip)
        first = np.asarray(self.first_tri)
        count = np.asarray(self.tri_count)
        order = np.asarray(self.tri_order)

        seen = np.zeros(len(order), bool)
        for n in range(len(entry)):
            if count[n] > 0:
                tris = order[first[n]:first[n] + count[n]]
                assert not seen[tris].any(), "triangle in two leaves"
                seen[tris] = True
                assert np.all(np.asarray(tri_aabb_min)[tris] >= amin[n] - 1e-4)
                assert np.all(np.asarray(tri_aabb_max)[tris] <= amax[n] + 1e-4)
        assert seen.all(), "triangle missing from all leaves"
        assert skip.min() >= -1 and skip.max() < len(entry)


def tri_aabbs(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray):
    amin = np.minimum(np.minimum(v0, v1), v2)
    amax = np.maximum(np.maximum(v0, v1), v2)
    return amin, amax
