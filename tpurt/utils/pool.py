"""Buddy sub-allocator over a linear arena.

Counterpart of the reference's VkBuffersSubAllocator
(vk_buffers_suballocator.rs: power-of-two buddy over large backing buffers
with size-keyed free lists, recursive split on allocate and buddy-merge on
free). Here the runtime (XLA) owns real device memory, so this manages
*slot lifetimes inside preallocated pooled arrays* — staging pools,
streaming-texture arenas — instead of raw buffers. The hot path is the C++
implementation in tpurt.native; a pure-Python twin serves as fallback and
as the reference for tests.
"""
from __future__ import annotations


class BuddySubAllocator:
    def __init__(self, total_size: int, min_block: int = 256,
                 force_python: bool = False):
        self._native = None
        self._handle = None
        if not force_python:
            try:
                from ..native import get_lib

                lib = get_lib()
                if lib is not None:
                    h = lib.tpurt_buddy_create(total_size, min_block)
                    if h:
                        self._native = lib
                        self._handle = h
            except Exception:
                pass
        # python twin (also used to mirror state for introspection)
        mb = 1
        while mb < min_block:
            mb <<= 1
        tot = mb
        while tot * 2 <= total_size:
            tot <<= 1
        self.min_block = mb
        self.total = tot
        self._orders = (tot // mb).bit_length()
        if self._native is None:
            self._free = [set() for _ in range(self._orders)]
            self._free[-1].add(0)
            self._live = {}

    # -- python twin --------------------------------------------------------

    def _order_of(self, size: int) -> int:
        b, o = self.min_block, 0
        while b < size:
            b <<= 1
            o += 1
        return o

    def _order_size(self, o: int) -> int:
        return self.min_block << o

    def allocate(self, size: int, alignment: int = 1) -> int:
        """Returns the arena offset, or raises MemoryError. Power-of-two
        blocks are naturally aligned to their size."""
        if self._native is not None:
            off = self._native.tpurt_buddy_alloc(self._handle, size, alignment)
            if off < 0:
                raise MemoryError("arena exhausted")
            return off
        size = max(size, alignment, 1)
        want = self._order_of(size)
        if want >= self._orders:
            raise MemoryError("allocation larger than arena")
        o = want
        while o < self._orders and not self._free[o]:
            o += 1
        if o == self._orders:
            raise MemoryError("arena exhausted")
        off = self._free[o].pop()
        while o > want:  # recursive split (vk_buffers_suballocator.rs:208-232)
            o -= 1
            self._free[o].add(off + self._order_size(o))
        self._live[off] = want
        return off

    def free(self, offset: int):
        if self._native is not None:
            if self._native.tpurt_buddy_free(self._handle, offset) != 0:
                raise ValueError(f"offset {offset} not allocated")
            return
        order = self._live.pop(offset, None)
        if order is None:
            raise ValueError(f"offset {offset} not allocated")
        off, o = offset, order
        while o + 1 < self._orders:  # buddy merge (:235-272)
            buddy = off ^ self._order_size(o)
            if buddy not in self._free[o]:
                break
            self._free[o].discard(buddy)
            off = min(off, buddy)
            o += 1
        self._free[o].add(off)

    def free_bytes(self) -> int:
        if self._native is not None:
            return self._native.tpurt_buddy_free_bytes(self._handle)
        return sum(len(s) * self._order_size(o)
                   for o, s in enumerate(self._free))

    def __del__(self):
        if self._native is not None and self._handle:
            try:
                self._native.tpurt_buddy_destroy(self._handle)
            except Exception:
                pass
            self._handle = None
