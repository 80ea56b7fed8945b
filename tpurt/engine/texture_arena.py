"""Streaming-texture row arena: the buddy sub-allocator's production home.

The reference suballocates model/texture buffers from large backing
allocations (vk_buffers_suballocator.rs:84-146) so streaming doesn't
reallocate device memory. The analogue here: mip-atlas ROWS of all
resident unique images live inside ONE persistent device array whose
slots are managed by utils.pool.BuddySubAllocator (row units). On model
residency changes (scene/model.py LOD state machine) the renderer
re-flattens host-side, but texture rows already resident keep their
offsets — only JOINING images upload (donated dynamic_update_slice,
in place on the device) and LEAVING images merely free their slots. Two wins
over re-uploading every table on any change:

  * upload volume per residency event drops to the delta,
  * the atlas argument SHAPE is the arena capacity, stable across scene
    changes -> the jitted frame does not respecialize when a model
    streams in (same program, new offsets).

Capacity rounds the first working set up to a power of two and grows by
doubling (full re-upload on growth only); the rounding at most doubles
the table the gathers see.
"""
from __future__ import annotations

from functools import partial

import numpy as np

from ..utils.pool import BuddySubAllocator

# buddy granularity in rows: 64 B rows -> 16 KB blocks
_MIN_BLOCK_ROWS = 256


def _write_rows(atlas, rows, offset):
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, donate_argnums=(0,))
    def upd(a, r, off):
        return jax.lax.dynamic_update_slice(a, r, (off, jnp.int32(0)))

    return upd(atlas, rows, np.int32(offset))


class TextureRowArena:
    """Content-keyed row residency inside one persistent device array."""

    def __init__(self, row_width: int = 64, dtype=np.uint8):
        self.row_width = row_width
        self.dtype = dtype
        self.capacity = 0
        self.atlas = None            # (capacity, row_width) device array
        self._alloc = None
        self._live = {}              # key -> (offset, rows)

    def _reset(self, capacity_rows: int):
        import jax.numpy as jnp

        cap = _MIN_BLOCK_ROWS
        while cap < capacity_rows:
            cap <<= 1
        self.capacity = cap
        self.atlas = jnp.zeros((cap, self.row_width), self.dtype)
        self._alloc = BuddySubAllocator(cap, min_block=_MIN_BLOCK_ROWS)
        self._live = {}

    def ensure(self, chunks: dict):
        """chunks: {content_key: (rows_np, None) | (None, row_count)} —
        rows_np for images that may need uploading (the caller passes the
        freshly flattened rows), row_count alone is not allowed for new
        keys. Uploads every key not already resident, frees every
        resident key not in `chunks`, and returns {key: row_offset}.
        Stats: (uploaded_rows, freed_keys) retrievable from
        .last_uploaded_rows / .last_freed."""
        import jax.numpy as jnp

        need = {k: rows for k, (rows, _) in chunks.items()}
        total = sum(int(r.shape[0]) for r in need.values())
        if self.atlas is None or total > self.capacity:
            self._reset(max(total, 1))

        # free leavers first (their buddies may merge for the joiners)
        self.last_freed = 0
        for k in list(self._live):
            if k not in need:
                off, _ = self._live.pop(k)
                self._alloc.free(off)
                self.last_freed += 1

        self.last_uploaded_rows = 0
        out = {}
        retry = True
        while retry:
            retry = False
            for k, rows in need.items():
                if k in self._live:
                    out[k] = self._live[k][0]
                    continue
                n = int(rows.shape[0])
                try:
                    off = self._alloc.allocate(max(n, 1))
                except MemoryError:
                    # fragmentation or growth: double capacity and
                    # re-upload the full working set (rare)
                    live_rows = {k2: need[k2] for k2 in need}
                    self._reset(self.capacity * 2)
                    need = live_rows
                    out = {}
                    self.last_uploaded_rows = 0
                    retry = True
                    break
                self.atlas = _write_rows(self.atlas,
                                         jnp.asarray(np.ascontiguousarray(
                                             rows)), off)
                self._live[k] = (off, n)
                self.last_uploaded_rows += n
                out[k] = off
        return out
