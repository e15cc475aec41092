"""The KV-pool index: block allocation plus the prefix-hash map.

Counterpart of tinygpt_tpu/engine/native_pool.py. The JAX package binds a
C++ core (csrc/kvpool.cpp) beside this pure-Python index; its ctypes
binding in this package is still to come (ROADMAP.md queue 1, item 10),
so the Python index is the only one here. Allocation order and eviction
order are those of the JAX index (LIFO free list, oldest-tick eviction),
block for block.
"""

from __future__ import annotations

from typing import List, Optional

from tinygpt_tpu_torch.engine.paged_kv import BlockAllocator


class PythonPoolIndex:
    """Refcounted blocks, the idle-cached LRU tier for registered prompt
    prefixes, and the hash -> block prefix index, over BlockAllocator."""

    def __init__(self, n_blocks: int):
        self._a = BlockAllocator(n_blocks)
        self._prefix = {}
        self._block_hash = {}
        self.n_blocks = n_blocks

        def on_evict(b):
            h = self._block_hash.pop(b, None)
            if h is not None:
                self._prefix.pop(h, None)

        self._a.on_evict = on_evict

    @property
    def n_free(self) -> int:
        return self._a.n_free

    @property
    def n_idle_cached(self) -> int:
        return len(self._a.cached_idle)

    def alloc(self, n: int) -> Optional[List[int]]:
        return self._a.alloc(n)

    def share(self, blocks) -> None:
        self._a.share(list(blocks))

    def release(self, blocks, keep_cached=()) -> None:
        self._a.release(list(blocks), keep_cached=keep_cached)

    def register_prefix(self, h: int, block: int) -> None:
        # h is a 128-bit chain digest (scheduler._block_hashes)
        if h not in self._prefix:
            self._prefix[h] = block
            self._block_hash[block] = h

    def lookup_prefix(self, h: int) -> Optional[int]:
        return self._prefix.get(h)

    def is_registered(self, block: int) -> bool:
        return block in self._block_hash


def create_pool_index(n_blocks: int) -> PythonPoolIndex:
    """The pool index of `n_blocks` blocks: always the Python index (the
    binding of the C++ core is not ported yet, ROADMAP.md queue 1,
    item 10)."""
    return PythonPoolIndex(n_blocks)
