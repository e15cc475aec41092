"""Paged KV cache: block pool + per-sequence block tables.

Counterpart of tinygpt_tpu/engine/paged_kv.py. K/V live in a global pool
of fixed-size blocks [L, n_blocks, Nk, block_size, D], each sequence owns
an ordered block table, and the allocator is a host-side free list
(allocation happens at request admission, on the host).

The layouts are the JAX package's, byte for byte: block tables
[B_max, max_blocks] int32 (0 = unallocated; block 0 is reserved as the
null block and never handed out), lengths and starts [B_max] int32, and
active [B_max] bool, so one decode quantum serves any mix of live rows.

Unlike the JAX state, an immutable value threaded through each program,
PagedKVState is a small object whose tensors are UPDATED IN PLACE: the
pools by admission and by the end of each decode quantum, the metadata
by being replaced with fresh uploads (engine/scheduler.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch

from tinygpt_tpu_torch.hf.config import ModelConfig


@dataclass
class PagedKVState:
    """Device-side state of the paged cache."""

    k_pool: torch.Tensor        # [L, n_blocks, Nk, bs, D]
    v_pool: torch.Tensor        # [L, n_blocks, Nk, bs, D]
    block_tables: torch.Tensor  # [B_max, max_blocks] int32 (0 = null)
    lengths: torch.Tensor       # [B_max] int32 slots used per row (incl. pads)
    starts: torch.Tensor        # [B_max] int32 first real slot (left-pad skip)
    active: torch.Tensor        # [B_max] bool

    @property
    def block_size(self) -> int:
        return self.k_pool.shape[3]

    @property
    def max_blocks(self) -> int:
        return self.block_tables.shape[1]


def create_paged_state(
    cfg: ModelConfig,
    n_blocks: int,
    block_size: int,
    batch_capacity: int,
    max_blocks_per_seq: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
) -> PagedKVState:
    """Zero-filled pools (the null block reads as zeros until an inactive
    row's final scatter lands there) and empty metadata."""
    shape = (cfg.num_hidden_layers, n_blocks, cfg.num_kv_heads,
             block_size, cfg.head_dim)
    return PagedKVState(
        k_pool=torch.zeros(shape, dtype=dtype, device=device),
        v_pool=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.zeros((batch_capacity, max_blocks_per_seq),
                                 dtype=torch.int32, device=device),
        lengths=torch.zeros((batch_capacity,), dtype=torch.int32, device=device),
        starts=torch.zeros((batch_capacity,), dtype=torch.int32, device=device),
        active=torch.zeros((batch_capacity,), dtype=torch.bool, device=device),
    )


@dataclass
class BlockAllocator:
    """Host-side allocator over the pool with reference counting and an
    idle-cached tier (prefix caching). Block 0 is the reserved null block.

    A block is in exactly one state: free (on the free list), live
    (refcount > 0), or idle-cached (refcount 0 but its contents are a
    registered prompt prefix — reclaimable under pressure, LRU order).
    """

    n_blocks: int
    free: List[int] = field(default_factory=list)
    refcount: dict = field(default_factory=dict)      # block -> rc > 0
    cached_idle: dict = field(default_factory=dict)   # block -> lru tick
    _tick: int = 0
    # eviction callback set by the prefix index so hash entries die with
    # their blocks
    on_evict = None

    def __post_init__(self):
        self.free = list(range(self.n_blocks - 1, 0, -1))  # 0 reserved

    @property
    def n_free(self) -> int:
        return len(self.free) + len(self.cached_idle)

    def _reclaim(self, n: int) -> bool:
        """Evict idle-cached blocks (oldest first) until free >= n."""
        if len(self.free) >= n:
            return True
        need = n - len(self.free)
        victims = sorted(self.cached_idle.items(), key=lambda kv: kv[1])
        if len(victims) < need:
            return False
        for b, _ in victims[:need]:
            del self.cached_idle[b]
            if self.on_evict is not None:
                self.on_evict(b)
            self.free.append(b)
        return True

    def alloc(self, n: int) -> Optional[List[int]]:
        if not self._reclaim(n):
            return None
        out = []
        for _ in range(n):
            b = self.free.pop()
            self.refcount[b] = 1
            out.append(b)
        return out

    def share(self, blocks: List[int]) -> None:
        """Take an extra reference on live or idle-cached blocks."""
        for b in blocks:
            if b == 0:
                continue
            if b in self.cached_idle:  # revive
                del self.cached_idle[b]
                self.refcount[b] = 1
            else:
                self.refcount[b] = self.refcount.get(b, 0) + 1

    def release(self, blocks: List[int], keep_cached=()) -> None:
        """Drop one reference per block; rc==0 blocks go to the free list,
        or to the idle-cached tier when listed in keep_cached."""
        keep = set(keep_cached)
        for b in blocks:
            if b == 0:
                continue
            rc = self.refcount.get(b, 1) - 1
            if rc > 0:
                self.refcount[b] = rc
                continue
            self.refcount.pop(b, None)
            if b in keep:
                self._tick += 1
                self.cached_idle[b] = self._tick
            else:
                if self.on_evict is not None:
                    self.on_evict(b)
                self.free.append(b)


def blocks_needed(n_tokens: int, block_size: int) -> int:
    return max(1, -(-n_tokens // block_size))
