"""Dense preallocated KV cache.

Counterpart of tinygpt_tpu/engine/kv_cache.py. The cache is one
preallocated buffer per K and V, [L, B, Nk, T, D]: each (layer, batch row,
KV head) holds a contiguous [T, D] slab, the layout the attention kernels
read. Slots vs positions: the slot index is the physical write offset
(identical across a left-padded batch); `kv_pos` is each token's logical
position (what RoPE and causality use); `valid` marks real (non-pad) slots.

Unlike the JAX cache, which is an immutable value passed through each
step, this one is UPDATED IN PLACE: `forward` and `decode_steps` write K/V,
`kv_pos` and `valid` into these tensors and advance `length` (a host int,
so no step reads it back from the device).

The cache is of the compute dtype, or fp8 (torch.float8_e4m3fn: half the
bytes of bf16). Every write into a cache or a paged pool goes through
`kv_cast`, which saturates e4m3 at +-448 on the CPU and on the card alike.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from tinygpt_tpu_torch.hf.config import ModelConfig

E4M3_MAX = 448.0  # the largest finite float8_e4m3fn


def kv_cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x in a KV cache's dtype. An e4m3 cache saturates: a value past
    +-448 is written as +-448 (where JAX's cast, and torch's before it
    saturated, give NaN); NaN stays NaN. Casting first is also what the
    CPU's index_put into a float8 tensor needs: it refuses another dtype."""
    if dtype == torch.float8_e4m3fn and x.dtype != dtype:
        return x.clamp(-E4M3_MAX, E4M3_MAX).to(dtype)
    return x.to(dtype)


@dataclass
class KVCache:
    k: torch.Tensor       # [L, B, Nk, T, D]
    v: torch.Tensor       # [L, B, Nk, T, D]
    kv_pos: torch.Tensor  # [B, T] int32 logical position of each slot
    valid: torch.Tensor   # [B, T] bool — slot holds a real (non-pad) token
    length: int = 0       # next free slot

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def create_kv_cache(
    cfg: ModelConfig,
    batch_size: int,
    max_len: int,
    dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
) -> KVCache:
    """Zero-filled cache. Zeros, not torch.empty: masked slots still enter
    p @ v as 0 * value, and uninitialised memory may hold NaN, which
    0 * NaN would carry into the output."""
    shape = (
        cfg.num_hidden_layers,
        batch_size,
        cfg.num_kv_heads,
        max_len,
        cfg.head_dim,
    )
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        kv_pos=torch.zeros((batch_size, max_len), dtype=torch.int32, device=device),
        valid=torch.zeros((batch_size, max_len), dtype=torch.bool, device=device),
        length=0,
    )
