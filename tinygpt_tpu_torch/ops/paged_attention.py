"""Paged decode attention over the block pool: the frozen-pool quantum's
kernel and its plain version.

Counterpart of tinygpt_tpu/ops/paged_attention.py, for the kernel that the
continuous batcher's decode quantum runs (K8, paged_decode_frozen_tpu),
written in CUDA C++ for sm_90a (``csrc/paged_decode_frozen.cu``) and bound
with ctypes (``ops/cuda_build.py``).

During an n-step decode quantum the pools stay FROZEN: each step's K/V go
to a small in-flight buffer [B, Nk, N, D] per layer, and attention merges
the pool slots of each row (through its block table) with the in-flight
slots 0..step in one online softmax. The kernel reads the STACKED
[L, n_blocks, Nk, bs, D] pools at layer `l` by pointer offset.

The wrapper dispatches on the device of its tensors: on the CPU it runs
the plain version, on a CUDA device it launches the kernel or raises; it
never falls back from one to the other. Every launch adds one to
``LAUNCHES["paged_decode_frozen"]`` (the counter of
``ops/attention_kernels.py``).

Not ported yet: the fp8 (e4m3) pools (ROADMAP.md queue 1, item 7), the
single-layer paged decode K9 (with GPT-2, item 9) and the speculative
verify attention K10 (with speculation, item 10).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from tinygpt_tpu_torch.ops.attention_kernels import (
    _DTYPE_CODE,
    _HEAD_DIMS,
    _MAX_GROUP,
    LAUNCHES,
    _check_cuda_operands,
    _masked_softmax_av,
    _ptr,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature (csrc/paged_decode_frozen.cu): 9 pointers, 11 ints, scale,
# window, stream
_FROZEN_ARGS = [_P] * 9 + [_I] * 11 + [_F, _I, _P]


def paged_gather_dense(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[n_blocks, Nk, bs, D] pool + [B, MB] tables -> dense [B, Nk, MB*bs, D]."""
    g = pool[block_tables.long()]  # [B, MB, Nk, bs, D]
    B, MB, Nk, bs, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Nk, MB * bs, D)


def _check_fp8(name: str, pool: torch.Tensor) -> None:
    if pool.element_size() < 2:
        raise NotImplementedError(
            f"{name}: fp8 KV pools are not ported to tinygpt_tpu_torch yet "
            f"(ROADMAP.md queue 1, item 7)")


def paged_decode_frozen_plain(
    q: torch.Tensor,             # [B, Nq, D]
    k_pools: torch.Tensor,       # [L, n_blocks, Nk, bs, D] STACKED pools
    v_pools: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    lengths0: torch.Tensor,      # [B] int32 slots used at quantum start
    starts: torch.Tensor,        # [B] int32 first real slot
    k_infl: torch.Tensor,        # [B, Nk, N, D] this layer's in-flight K
    v_infl: torch.Tensor,
    l: int,
    step: int,
    scale: float,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of paged_decode_frozen (the JAX
    paged_decode_frozen_xla on layer l): gather the table into a dense
    view, then one fp32 softmax over the visible pool slots
    (starts <= t < lengths0, and t > lengths0 + step - window) and the
    in-flight slots j <= step (and step - j < window). Masked slots enter
    by select, never as 0 * value, so whatever a dead table entry's block
    holds never reaches the output; a row that sees nothing gives zeros."""
    _check_fp8("paged_decode_frozen", k_pools)
    B, Nq, D = q.shape
    Nk = k_pools.shape[2]
    N = k_infl.shape[2]
    G = Nq // Nk
    k = paged_gather_dense(k_pools[l], block_tables).float()
    v = paged_gather_dense(v_pools[l], block_tables).float()
    T = k.shape[2]
    t = torch.arange(T, device=q.device)[None, :]
    lengths0 = lengths0.to(q.device)[:, None]
    mask_f = (t < lengths0) & (t >= starts.to(q.device)[:, None])       # [B, T]
    j = torch.arange(N, device=q.device)
    mask_i = (j <= step).expand(B, N)
    if window is not None:
        mask_f = mask_f & (t > lengths0 + step - window)
        mask_i = mask_i & ((step - j) < window)
    mask = torch.cat([mask_f, mask_i], dim=1)                           # [B, T+N]
    kk = torch.cat([k, k_infl.float()], dim=2)
    vv = torch.where(mask[:, None, :, None], torch.cat([v, v_infl.float()], dim=2), 0.0)
    s = torch.einsum("bkgd,bktd->bkgt", q.float().reshape(B, Nk, G, D), kk) * scale
    out = _masked_softmax_av(s, mask[:, None, None, :], vv)
    return out.reshape(B, Nq, D).to(q.dtype)


def paged_decode_frozen(
    q: torch.Tensor,             # [B, Nq, D] — one query position per row
    k_pools: torch.Tensor,       # [L, n_blocks, Nk, bs, D] FROZEN stacked pools
    v_pools: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    lengths0: torch.Tensor,      # [B] int32 (quantum start)
    starts: torch.Tensor,        # [B] int32
    k_infl: torch.Tensor,        # [B, Nk, N, D]
    v_infl: torch.Tensor,
    l: int,                      # layer index into the stacks
    step: int,                   # current in-flight slot
    scale: float,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention of the frozen-pool quantum: layer `l` of the
    stacked pools through the block tables, merged with the in-flight
    slots j <= step. Returns [B, Nq, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_frozen_plain(q, k_pools, v_pools, block_tables,
                                         lengths0, starts, k_infl, v_infl,
                                         l, step, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_frozen: no kernel for device {q.device}")
    _check_fp8("paged_decode_frozen", k_pools)
    B, Nq, D = q.shape
    L, n_blocks, Nk, bs, _ = k_pools.shape
    MB = block_tables.shape[1]
    N = k_infl.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode_frozen: head dim {D} not in {_HEAD_DIMS}")
    if k_pools.shape != (L, n_blocks, Nk, bs, D) or v_pools.shape != k_pools.shape:
        raise ValueError(f"paged_decode_frozen: pools {tuple(k_pools.shape)} / "
                         f"{tuple(v_pools.shape)} do not fit q {tuple(q.shape)}")
    if k_infl.shape != (B, Nk, N, D) or v_infl.shape != k_infl.shape:
        raise ValueError(f"paged_decode_frozen: in-flight {tuple(k_infl.shape)} / "
                         f"{tuple(v_infl.shape)} != {(B, Nk, N, D)}")
    if Nk == 0 or Nq % Nk or Nq // Nk > _MAX_GROUP:
        raise ValueError(f"paged_decode_frozen: {Nq} query heads over {Nk} KV "
                         f"heads (at most {_MAX_GROUP} per KV head)")
    if block_tables.shape != (B, MB) or lengths0.shape != (B,) or starts.shape != (B,):
        raise ValueError(f"paged_decode_frozen: tables {tuple(block_tables.shape)}, "
                         f"lengths0 {tuple(lengths0.shape)}, starts "
                         f"{tuple(starts.shape)} do not fit {B} rows")
    if not 0 <= l < L or not 0 <= step < N:
        raise ValueError(f"paged_decode_frozen: layer {l} of {L} / step {step} "
                         f"of {N} out of range")
    i32 = (torch.int32,)
    _check_cuda_operands(
        "paged_decode_frozen", q, ("q", q, None),
        ("k_pools", k_pools, (q.dtype,)), ("v_pools", v_pools, (q.dtype,)),
        ("block_tables", block_tables, i32), ("lengths0", lengths0, i32),
        ("starts", starts, i32),
        ("k_infl", k_infl, (q.dtype,)), ("v_infl", v_infl, (q.dtype,)))
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("paged_decode_frozen.cu", "tg_paged_decode_frozen",
                             _FROZEN_ARGS)
    out = torch.empty_like(q)
    win = int(window) if window else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_ptr(q), _ptr(k_pools), _ptr(v_pools), _ptr(block_tables),
                 _ptr(lengths0), _ptr(starts), _ptr(k_infl), _ptr(v_infl), _ptr(out),
                 B, Nq, Nk, n_blocks, bs, MB, N, D, _DTYPE_CODE[q.dtype], int(l),
                 int(step), float(scale), win, ctypes.c_void_p(stream))
    cuda_build.check("paged_decode_frozen.cu", err, "paged_decode_frozen")
    LAUNCHES["paged_decode_frozen"] += 1
    return out
