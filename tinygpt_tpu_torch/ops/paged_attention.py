"""Paged decode attention over the block pool: the kernels of the
continuous batcher's quanta and their plain versions.

Counterpart of tinygpt_tpu/ops/paged_attention.py, for its three kernels,
written in CUDA C++ for sm_90a and bound with ctypes
(``ops/cuda_build.py``):

  * K9, paged_decode_tpu (``csrc/paged_decode.cu``): one query position
    per row over ONE layer's pool [n_blocks, Nk, bs, D], the row's own K/V
    already written into it; the stepwise decode step (forward_paged) of
    the batcher's stepwise quantum, selected by the dispatcher
    paged_decode;
  * K8, paged_decode_frozen_tpu (``csrc/paged_decode_frozen.cu``): one
    query position per row, the frozen decode quantum (decode_paged_steps,
    every family, GPT-2 included). K8 and K9 are one kernel
    (``csrc/paged_split.cuh``), K9 without the in-flight slots, each
    launched on clusters of paged_decode_split blocks;
  * K10, paged_decode_spec_tpu (``csrc/paged_decode_spec.cu``): S verify
    positions per row, the speculative quantum; bf16 and fp16 q run both
    products on the tensor cores, on clusters of paged_spec_split blocks.

During a frozen quantum the pools stay FROZEN: each step's (or round's)
K/V go to a small in-flight buffer [B, Nk, N, D] per layer, and attention
merges the pool slots of each row (through its block table) with the
in-flight slots in one online softmax. K8 and K10 read the STACKED
[L, n_blocks, Nk, bs, D] pools at layer `l` by pointer offset; K9 takes a
layer's pool, a view of the stack. Pools are of q's dtype, or fp8
(torch.float8_e4m3fn) beside bf16 in-flight K/V.

Each wrapper dispatches on the device of its tensors: on the CPU it runs
the plain version, on a CUDA device it launches the kernel or raises; it
never falls back from one to the other. Every launch adds one to
``LAUNCHES[name]`` (the counter of ``ops/attention_kernels.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from tinygpt_tpu_torch.ops.attention_kernels import (
    _DTYPE_CODE,
    _HEAD_DIMS,
    _MAX_GROUP,
    LAUNCHES,
    _check_cuda_operands,
    _masked_softmax_av,
    _ptr,
    _sm_count,
    kv_operands,
    paged_decode_split,
    paged_spec_split,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures: csrc/paged_decode.cu (7 pointers, 9 ints, scale, window,
# split, stream), csrc/paged_decode_frozen.cu (9 pointers, 12 ints, scale,
# window, split, stream) and csrc/paged_decode_spec.cu (12 pointers, 13
# ints, scale, window, split, stream)
_DECODE_ARGS = [_P] * 7 + [_I] * 9 + [_F, _I, _I, _P]
_FROZEN_ARGS = [_P] * 9 + [_I] * 12 + [_F, _I, _I, _P]
_SPEC_ARGS = [_P] * 12 + [_I] * 13 + [_F, _I, _I, _P]
_I32 = (torch.int32,)


def paged_gather_dense(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """[n_blocks, Nk, bs, D] pool + [B, MB] tables -> dense [B, Nk, MB*bs, D]."""
    g = pool[block_tables.long()]  # [B, MB, Nk, bs, D]
    B, MB, Nk, bs, D = g.shape
    return g.permute(0, 2, 1, 3, 4).reshape(B, Nk, MB * bs, D)


# the library (K8's, K9's) and its export of what a launch takes
_PLAN_SYMBOL = {"paged_decode_frozen.cu": "tg_paged_decode_frozen_plan",
                "paged_decode.cu": "tg_paged_decode_plan"}


@functools.lru_cache(maxsize=256)  # a few pool shapes a run; called every launch
def _paged_per_sm(Nq: int, Nk: int, MB: int, D: int, dtype: int, kv_dtype: int,
                  device: int, source: str = "paged_decode_frozen.cu") -> Tuple[int, ...]:
    """The blocks an SM runs at once of K8's (source
    "paged_decode_frozen.cu") or K9's ("paged_decode.cu") instantiation for
    these types and sizes, at each cluster size 1 .. 8 (the library's
    tg_paged_decode_frozen_plan or tg_paged_decode_plan: the kernel's
    occupancy)."""
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function(source, _PLAN_SYMBOL[source], [_I] * 7 + [_P])
    per_sm = []
    with torch.cuda.device(device):
        for C in range(1, 9):
            out = (ctypes.c_int * 2)()
            cuda_build.check(source, fn(Nq, Nk, MB, D, dtype, kv_dtype, C, out),
                             _PLAN_SYMBOL[source])
            per_sm.append(out[1])
    return tuple(per_sm)


# -- the single-layer paged decode (K9) ----------------------------------------


def paged_decode_plain(
    q: torch.Tensor,             # [B, Nq, D]
    k_pool: torch.Tensor,        # [n_blocks, Nk, bs, D] ONE layer's pool
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    lengths: torch.Tensor,       # [B] int32 slots used per row (incl. current)
    starts: torch.Tensor,        # [B] int32 first real slot
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of paged_decode (the JAX paged_decode_xla):
    gather the table into a dense view, then one fp32 softmax over the
    visible slots starts <= t < lengths (and t > lengths - 1 - window: the
    query sits at slot lengths - 1). Masked slots enter by select, never as
    0 * value, so whatever a dead table entry's block holds never reaches
    the output; a row that sees nothing gives zeros (the JAX oracle's
    softmax gives the uniform mean there)."""
    B, Nq, D = q.shape
    Nk = k_pool.shape[1]
    G = Nq // Nk
    k = paged_gather_dense(k_pool, block_tables).float()     # [B, Nk, T, D]
    v = paged_gather_dense(v_pool, block_tables).float()
    t = torch.arange(k.shape[2], device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    mask = (t < lengths) & (t >= starts.to(q.device)[:, None])          # [B, T]
    if sliding_window is not None:
        mask = mask & (t > lengths - 1 - sliding_window)
    v = torch.where(mask[:, None, :, None], v, 0.0)
    s = torch.einsum("bkgd,bktd->bkgt", q.float().reshape(B, Nk, G, D), k) * scale
    out = _masked_softmax_av(s, mask[:, None, None, :], v)
    return out.reshape(B, Nq, D).to(q.dtype)


def paged_decode_cuda(
    q: torch.Tensor,             # [B, Nq, D] — one query position per row
    k_pool: torch.Tensor,        # [n_blocks, Nk, bs, D] one layer's pool
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    lengths: torch.Tensor,       # [B] int32
    starts: torch.Tensor,        # [B] int32
    scale: float,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """K9 (the counterpart of paged_decode_tpu): decode attention over one
    layer's pool through the block tables, on clusters of
    paged_decode_split blocks. A layer of the stacked pools is passed as
    the view k_pools[l], which the kernel reads in place. Returns
    [B, Nq, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, block_tables, lengths, starts,
                                  scale, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: no kernel for device {q.device}")
    B, Nq, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape[3] != D or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_decode: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q {tuple(q.shape)} (one "
                         f"layer's [n_blocks, Nk, bs, D])")
    n_blocks, Nk, bs, _ = k_pool.shape
    MB = block_tables.shape[1]
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode: head dim {D} not in {_HEAD_DIMS}")
    if Nk == 0 or Nq % Nk or Nq // Nk > _MAX_GROUP:
        raise ValueError(f"paged_decode: {Nq} query heads over {Nk} KV heads "
                         f"(at most {_MAX_GROUP} per KV head)")
    if block_tables.shape != (B, MB) or lengths.shape != (B,) or starts.shape != (B,):
        raise ValueError(f"paged_decode: tables {tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)}, starts {tuple(starts.shape)} do not "
                         f"fit {B} rows")
    kv_code, _ = kv_operands("paged_decode", q, k_pool)
    _check_cuda_operands(
        "paged_decode", q, ("q", q, None),
        ("k_pool", k_pool, (k_pool.dtype,)), ("v_pool", v_pool, (k_pool.dtype,)),
        ("block_tables", block_tables, _I32), ("lengths", lengths, _I32),
        ("starts", starts, _I32))
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("paged_decode.cu", "tg_paged_decode", _DECODE_ARGS)
    out = torch.empty_like(q)
    win = int(sliding_window) if sliding_window else 0
    dev = q.device.index or 0
    C = paged_decode_split(B, Nk, Nq // Nk, MB * bs,
                           _paged_per_sm(Nq, Nk, MB, D, _DTYPE_CODE[q.dtype], kv_code, dev,
                                         "paged_decode.cu"),
                           _sm_count(dev))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(block_tables), _ptr(lengths),
                 _ptr(starts), _ptr(out), B, Nq, Nk, n_blocks, bs, MB, D,
                 _DTYPE_CODE[q.dtype], kv_code, float(scale), win, C,
                 ctypes.c_void_p(stream))
    cuda_build.check("paged_decode.cu", err, "paged_decode")
    LAUNCHES["paged_decode"] += 1
    return out


def paged_decode(q, k_pool, v_pool, block_tables, lengths, starts, scale,
                 sliding_window: Optional[int] = None,
                 kernel: str = "kernel") -> torch.Tensor:
    """The dispatcher of the JAX paged_decode: K9 (paged_decode_cuda, whose
    CPU tensors take the plain version) under kernel="kernel", the plain
    version under "plain"."""
    if kernel == "kernel":
        fn = paged_decode_cuda
    elif kernel == "plain":
        fn = paged_decode_plain
    else:
        raise ValueError(f"unknown attention route {kernel!r}")
    return fn(q, k_pool, v_pool, block_tables, lengths, starts, scale, sliding_window)


# -- the frozen-pool decode quantum (K8) ---------------------------------------


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
    slots j <= step (K8, on clusters of paged_decode_split blocks).
    Returns [B, Nq, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_frozen_plain(q, k_pools, v_pools, block_tables,
                                         lengths0, starts, k_infl, v_infl,
                                         l, step, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_frozen: no kernel for device {q.device}")
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
    kv_code, infl_dtype = kv_operands("paged_decode_frozen", q, k_pools)
    _check_cuda_operands(
        "paged_decode_frozen", q, ("q", q, None),
        ("k_pools", k_pools, (k_pools.dtype,)), ("v_pools", v_pools, (k_pools.dtype,)),
        ("block_tables", block_tables, _I32), ("lengths0", lengths0, _I32),
        ("starts", starts, _I32),
        ("k_infl", k_infl, (infl_dtype,)), ("v_infl", v_infl, (infl_dtype,)))
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("paged_decode_frozen.cu", "tg_paged_decode_frozen",
                             _FROZEN_ARGS)
    out = torch.empty_like(q)
    win = int(window) if window else 0
    dev = q.device.index or 0
    C = paged_decode_split(B, Nk, Nq // Nk, MB * bs + N,
                           _paged_per_sm(Nq, Nk, MB, D, _DTYPE_CODE[q.dtype], kv_code, dev),
                           _sm_count(dev))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_ptr(q), _ptr(k_pools), _ptr(v_pools), _ptr(block_tables),
                 _ptr(lengths0), _ptr(starts), _ptr(k_infl), _ptr(v_infl), _ptr(out),
                 B, Nq, Nk, n_blocks, bs, MB, N, D, _DTYPE_CODE[q.dtype], kv_code, int(l),
                 int(step), float(scale), win, C, ctypes.c_void_p(stream))
    cuda_build.check("paged_decode_frozen.cu", err, "paged_decode_frozen")
    LAUNCHES["paged_decode_frozen"] += 1
    return out


# -- the speculative verify (K10) --------------------------------------------


def _spec_window(window: Optional[int], block_tables: torch.Tensor,
                 k_pools: torch.Tensor) -> Optional[int]:
    """A window that cannot bind is no window: every key slot lives in
    [0, MB * bs) and every query slot below MB * bs, so a window of at
    least MB * bs masks nothing (the JAX dispatch drops it the same way)."""
    if window is not None and window >= block_tables.shape[1] * k_pools.shape[3]:
        return None
    return window


def paged_decode_spec_plain(
    q: torch.Tensor,             # [B, S, Nq, D] — S verify positions per row
    k_pools: torch.Tensor,       # [L, n_blocks, Nk, bs, D] STACKED pools
    v_pools: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    lengths0: torch.Tensor,      # [B] int32 slots used at quantum start
    starts: torch.Tensor,        # [B] int32 first real slot
    k_infl: torch.Tensor,        # [B, Nk, N, D] this layer's in-flight K
    v_infl: torch.Tensor,
    infl_valid: torch.Tensor,    # [B, N] bool — earlier rounds' ACCEPTED slots
    l: int,
    base: int,                   # the own round's first in-flight slot
    scale: float,
    window: Optional[int] = None,
    q_slots: Optional[torch.Tensor] = None,     # [B, S] pool slot of each
                                                # verify position (window)
    infl_slots: Optional[torch.Tensor] = None,  # [B, N] pool slot of each
                                                # accepted in-flight entry
) -> torch.Tensor:
    """Plain PyTorch version of paged_decode_spec (the JAX
    paged_decode_spec_xla on layer l): gather the table into a dense view,
    then one fp32 softmax per verify position s over the visible pool
    slots (starts <= t < lengths0), the accepted in-flight slots and the
    own round's slots base <= j <= base + s; with a window w, only slots
    whose pool slot is > q_slots[b, s] - w (slot deltas equal logical
    deltas within a row). A slot no position sees enters by select, never
    as 0 * value; a position that sees nothing gives zeros (the JAX oracle's
    softmax gives the uniform mean there)."""
    window = _spec_window(window, block_tables, k_pools)
    B, S, Nq, D = q.shape
    Nk = k_pools.shape[2]
    N = k_infl.shape[2]
    G = Nq // Nk
    dev = q.device
    k = paged_gather_dense(k_pools[l], block_tables).float()     # [B, Nk, T, D]
    v = paged_gather_dense(v_pools[l], block_tables).float()
    T = k.shape[2]
    t = torch.arange(T, device=dev)[None, None, :]                  # [1, 1, T]
    mask_f = ((t < lengths0.to(dev)[:, None, None])
              & (t >= starts.to(dev)[:, None, None])).expand(B, S, T)
    j = torch.arange(N, device=dev)[None, None, :]                  # [1, 1, N]
    s_idx = torch.arange(S, device=dev)[None, :, None]              # [1, S, 1]
    own = (j >= base) & (j <= base + s_idx)                         # [1, S, N]
    mask_i = infl_valid.to(dev)[:, None, :].bool() | own            # [B, S, N]
    if window is not None:
        if q_slots is None or infl_slots is None:
            raise ValueError("paged_decode_spec: a binding window needs "
                             "q_slots and infl_slots")
        qs = q_slots.to(dev)[:, :, None]                            # [B, S, 1]
        mask_f = mask_f & (t > qs - window)
        jj = torch.arange(N, device=dev)[None, :]
        own_slot = q_slots.to(dev).gather(
            1, (jj - base).clamp(0, S - 1).expand(B, N))
        slot_j = torch.where(jj >= base, own_slot, infl_slots.to(dev))
        mask_i = mask_i & (slot_j[:, None, :] > qs - window)
    mask = torch.cat([mask_f, mask_i], dim=2)                       # [B, S, T+N]
    kk = torch.cat([k, k_infl.float()], dim=2)                      # [B, Nk, T+N, D]
    seen = mask.any(dim=1)                                          # [B, T+N]
    vv = torch.where(seen[:, None, :, None],
                     torch.cat([v, v_infl.float()], dim=2), 0.0)
    qg = q.float().reshape(B, S, Nk, G, D).permute(0, 2, 3, 1, 4)   # [B, Nk, G, S, D]
    sc = torch.einsum("bkgsd,bktd->bkgst", qg, kk) * scale
    out = _masked_softmax_av(sc, mask[:, None, None], vv[:, :, None])  # [B, Nk, G, S, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Nq, D).to(q.dtype)


@functools.lru_cache(maxsize=256)  # a few pool shapes a run; called every launch
def _spec_plan(Nq: int, Nk: int, S: int, MB: int, D: int, dtype: int, kv_dtype: int,
               device: int) -> Tuple[Tuple[int, ...], int]:
    """(the blocks an SM runs at once at each cluster size 1 .. 8, the row
    groups of a KV head) of K10's instantiation for these types and sizes
    (the library's tg_paged_decode_spec_plan: the kernel's occupancy)."""
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("paged_decode_spec.cu", "tg_paged_decode_spec_plan",
                             [_I] * 8 + [_P])
    per_sm, n_rg = [], 1
    with torch.cuda.device(device):
        for C in range(1, 9):
            out = (ctypes.c_int * 4)()
            cuda_build.check("paged_decode_spec.cu",
                             fn(Nq, Nk, S, MB, D, dtype, kv_dtype, C, out),
                             "tg_paged_decode_spec_plan")
            per_sm.append(out[1])
            n_rg = out[3]
    return tuple(per_sm), n_rg


def paged_decode_spec(
    q: torch.Tensor,             # [B, S, Nq, D]
    k_pools: torch.Tensor,       # [L, n_blocks, Nk, bs, D] FROZEN stacked pools
    v_pools: torch.Tensor,
    block_tables: torch.Tensor,  # [B, MB] int32
    lengths0: torch.Tensor,      # [B] int32 (quantum start)
    starts: torch.Tensor,        # [B] int32
    k_infl: torch.Tensor,        # [B, Nk, N, D]
    v_infl: torch.Tensor,
    infl_valid: torch.Tensor,    # [B, N] bool
    l: int,                      # layer index into the stacks
    base: int,                   # the own round's first in-flight slot
    scale: float,
    window: Optional[int] = None,
    q_slots: Optional[torch.Tensor] = None,     # [B, S] int32
    infl_slots: Optional[torch.Tensor] = None,  # [B, N] int32
) -> torch.Tensor:
    """Speculative-verify attention of the spec quantum: S positions per
    row over layer `l` of the stacked pools through the block tables,
    merged with the accepted and the own round's in-flight slots (K10; bf16
    and fp16 q on clusters of paged_spec_split blocks). The device tensors
    (lengths0, infl_valid, q_slots, infl_slots) are read by the kernel,
    never on the host; base and l are host ints, and the plan takes host
    ints only. A binding window goes through the kernel too, which masks in
    slot space. Returns [B, S, Nq, D] in q's dtype."""
    if q.device.type == "cpu":
        return paged_decode_spec_plain(q, k_pools, v_pools, block_tables, lengths0,
                                       starts, k_infl, v_infl, infl_valid, l, base,
                                       scale, window, q_slots, infl_slots)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_spec: no kernel for device {q.device}")
    window = _spec_window(window, block_tables, k_pools)
    B, S, Nq, D = q.shape
    L, n_blocks, Nk, bs, _ = k_pools.shape
    MB = block_tables.shape[1]
    N = k_infl.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"paged_decode_spec: head dim {D} not in {_HEAD_DIMS}")
    if k_pools.shape != (L, n_blocks, Nk, bs, D) or v_pools.shape != k_pools.shape:
        raise ValueError(f"paged_decode_spec: pools {tuple(k_pools.shape)} / "
                         f"{tuple(v_pools.shape)} do not fit q {tuple(q.shape)}")
    if k_infl.shape != (B, Nk, N, D) or v_infl.shape != k_infl.shape:
        raise ValueError(f"paged_decode_spec: in-flight {tuple(k_infl.shape)} / "
                         f"{tuple(v_infl.shape)} != {(B, Nk, N, D)}")
    if Nk == 0 or Nq % Nk:
        raise ValueError(f"paged_decode_spec: {Nq} query heads over {Nk} KV heads")
    if (block_tables.shape != (B, MB) or lengths0.shape != (B,) or starts.shape != (B,)
            or infl_valid.shape != (B, N)):
        raise ValueError(f"paged_decode_spec: tables {tuple(block_tables.shape)}, "
                         f"lengths0 {tuple(lengths0.shape)}, starts "
                         f"{tuple(starts.shape)}, infl_valid {tuple(infl_valid.shape)} "
                         f"do not fit {B} rows of {N} in-flight slots")
    if not 0 <= l < L or not 0 <= base < N:
        raise ValueError(f"paged_decode_spec: layer {l} of {L} / base {base} of {N} "
                         f"out of range")
    kv_code, infl_dtype = kv_operands("paged_decode_spec", q, k_pools)
    slots = ()
    if window is not None:
        if q_slots is None or infl_slots is None:
            raise ValueError("paged_decode_spec: a binding window needs q_slots "
                             "and infl_slots")
        if q_slots.shape != (B, S) or infl_slots.shape != (B, N):
            raise ValueError(f"paged_decode_spec: q_slots {tuple(q_slots.shape)} / "
                             f"infl_slots {tuple(infl_slots.shape)} != {(B, S)} / "
                             f"{(B, N)}")
        slots = (("q_slots", q_slots, _I32), ("infl_slots", infl_slots, _I32))
    _check_cuda_operands(
        "paged_decode_spec", q, ("q", q, None),
        ("k_pools", k_pools, (k_pools.dtype,)), ("v_pools", v_pools, (k_pools.dtype,)),
        ("block_tables", block_tables, _I32), ("lengths0", lengths0, _I32),
        ("starts", starts, _I32),
        ("k_infl", k_infl, (infl_dtype,)), ("v_infl", v_infl, (infl_dtype,)),
        ("infl_valid", infl_valid, (torch.bool, torch.uint8)), *slots)
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("paged_decode_spec.cu", "tg_paged_decode_spec", _SPEC_ARGS)
    out = torch.empty_like(q)
    null = ctypes.c_void_p(None)
    dev = q.device.index or 0
    per_sm, n_rg = _spec_plan(Nq, Nk, S, MB, D, _DTYPE_CODE[q.dtype], kv_code, dev)
    C = paged_spec_split(B, Nk, n_rg, MB * bs + N, per_sm, _sm_count(dev))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_ptr(q), _ptr(k_pools), _ptr(v_pools), _ptr(block_tables),
                 _ptr(lengths0), _ptr(starts), _ptr(k_infl), _ptr(v_infl),
                 _ptr(infl_valid), _ptr(q_slots) if slots else null,
                 _ptr(infl_slots) if slots else null, _ptr(out),
                 B, S, Nq, Nk, n_blocks, bs, MB, N, D, _DTYPE_CODE[q.dtype], kv_code,
                 int(l), int(base), float(scale), int(window or 0), C,
                 ctypes.c_void_p(stream))
    cuda_build.check("paged_decode_spec.cu", err, "paged_decode_spec")
    LAUNCHES["paged_decode_spec"] += 1
    return out
