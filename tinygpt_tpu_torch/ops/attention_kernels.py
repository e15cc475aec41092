"""Hopper attention kernels: flash prefill (K1), frozen-cache GQA decode
(K2) and one-layer GQA decode (K13).

Counterparts of the TPU kernels in tinygpt_tpu/ops/attention_kernels.py,
written in CUDA C++ for sm_90a (``csrc/flash_prefill.cu``,
``csrc/flash_decode_frozen.cu``, ``csrc/flash_decode.cu``) and bound with
ctypes (``ops/cuda_build.py``).

The kernels run over the engine's dense slot cache. K1 and K2 take
causality from SLOT indices: with left padding every token of a row shares
one pad offset, so (logical kv_pos <= logical q_pos) <=> (kv slot <= q
slot); their only mask inputs are a per-slot validity byte and the slot of
the first query row (K2: a frozen-slot mask). K13, the per-token step's
attention, takes one [B, T] mask that its caller folds validity, causality
and the window into, shared by the layers of a step.

The cache is of q's dtype, or fp8 (torch.float8_e4m3fn, the fp8 KV cache):
then q and the output keep their dtype, the kernels decode the e4m3 slots
exactly (K1 to q's type for its tensor-core products, the decode kernels
to fp32), and the decode kernel's in-flight K/V are bf16, as the JAX
package keeps the newest tokens before they are merged into an fp8 cache
(``kv_operands``).

K1 computes bf16 and fp16 queries on the tensor cores (P rounded to q's
type before P V, fp32 softmax state; fp32 queries keep an FMA body). K13
and K2 (one kernel template, ``csrc/decode_split.cuh``) split each row's
visible slots, K2's in-flight slots included, over the blocks of a
thread-block cluster of ``decode_split`` blocks and merge their softmax
states in the same launch.

Each wrapper dispatches on the device of its tensors: on the CPU it runs
its plain PyTorch version (``*_plain``), on a CUDA device it launches the
kernel or raises. It never falls back from one to the other. Every launch
adds one to ``LAUNCHES[name]``; callers reset the counts with
``reset_launches``.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# kernel launches since the last reset_launches(), by kernel name
LAUNCHES: Counter = Counter()

_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
E4M3 = torch.float8_e4m3fn
_E4M3_CODE = 3  # tg::kE4M3 (csrc/attention_common.cuh): a cache type only
_HEAD_DIMS = (64, 128)
_MAX_GROUP = 16  # query heads per KV head the decode kernels (K2, K8, K9, K13) take

# C signatures (csrc/*.cu): pointers, ints, scale, trailing ints, stream
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PREFILL_ARGS = [_P] * 5 + [_I] * 8 + [_F, _I, _I, _P]
_DECODE_ARGS = [_P] * 7 + [_I] * 10 + [_F, _I, _I, _P]
_DECODE_ONE_ARGS = [_P] * 5 + [_I] * 7 + [_F, _I, _P]

# K13's and K2's split over the slots (csrc/decode_split.cuh): a tile is 32 slots (one
# 32-bit word of the mask's bits), a block's share at least _SPLIT_MIN_TILES
# tiles unless the visible span is shorter, a cluster at most
# _SPLIT_MAX_BLOCKS blocks (the portable cluster size)
_SPLIT_TILE = 32
_SPLIT_MIN_TILES = 2
_SPLIT_MAX_BLOCKS = 8
_MAX_GROUP_TILE = 8  # query heads a decode block holds (tg::kMaxGroupTile)


def reset_launches() -> None:
    LAUNCHES.clear()


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def kv_operands(name: str, q: torch.Tensor, cache: torch.Tensor):
    """(the kernel's dtype code of the cache, the in-flight K/V dtype) for
    a cache beside queries q: a cache of q's dtype with in-flight K/V of
    q's dtype, or an e4m3 cache with bf16 in-flight K/V. Any other pair
    raises."""
    if cache.dtype == q.dtype:
        return _DTYPE_CODE.get(q.dtype, -1), q.dtype
    if cache.dtype == E4M3:
        return _E4M3_CODE, torch.bfloat16
    raise TypeError(f"{name}: a cache of {cache.dtype} beside q of {q.dtype} "
                    f"(the cache takes q's dtype or float8_e4m3fn)")


def check_kernel_shapes(cfg, device) -> None:
    """Raises ValueError, before any weight is used, for a model whose
    attention shapes no kernel on the card takes: a head dim other than 64
    and 128 (K1, K2, K8, K9, K10 and K13 each take those two, the head dims
    of every published config of the six families), query heads that are
    not a multiple of the KV heads, or more than _MAX_GROUP query heads per
    KV head (K2, K8, K9, K13). The engine and the batcher call it at start, so
    that such a model fails there and not in its first decode step. On
    the CPU the plain versions take any shape: nothing is checked."""
    if torch.device(device).type != "cuda":
        return
    D, Nq, Nk = cfg.head_dim, cfg.num_attention_heads, cfg.num_kv_heads
    name = cfg.model_type
    if D not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D}: the attention kernels (K1, K2, K8, "
                         f"K9, K10, K13) take head dims {_HEAD_DIMS}")
    if Nk <= 0 or Nq % Nk:
        raise ValueError(f"{name}: {Nq} query heads over {Nk} KV heads")
    if Nq // Nk > _MAX_GROUP:
        raise ValueError(f"{name}: {Nq // Nk} query heads per KV head: the decode "
                         f"kernels (K2, K8, K9, K13) take at most {_MAX_GROUP}")


def _check_cuda_operands(name: str, dtype_ref: torch.Tensor, *tensors) -> None:
    """Device, dtype, contiguity and alignment checks shared by the
    wrappers; `tensors` are (label, tensor, expected_dtype or None)."""
    dev = dtype_ref.device
    if dtype_ref.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype_ref.dtype} not supported "
                        f"(float32, float16, bfloat16)")
    for label, t, want in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, expected {dev}")
        if want is not None and t.dtype not in want:
            raise TypeError(f"{name}: {label} has dtype {t.dtype}, "
                            f"expected one of {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def _masked_softmax_av(s: torch.Tensor, mask: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """softmax(s) @ v over the visible columns in fp32; a row with no
    visible column gives zeros (the kernels' safe_l rule)."""
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    return (p @ v) / torch.where(l == 0, torch.ones_like(l), l)


# -- prefill ------------------------------------------------------------------


def flash_prefill_plain(
    q: torch.Tensor,        # [B, Nq, S, D]
    k_cache: torch.Tensor,  # [B, Nk, T, D]
    v_cache: torch.Tensor,  # [B, Nk, T, D]
    valid: torch.Tensor,    # [B, T] bool/uint8
    scale: float,
    q_slot: int = 0,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of flash_prefill, same semantics."""
    B, Nq, S, D = q.shape
    Nk, T = k_cache.shape[1], k_cache.shape[2]
    G = Nq // Nk
    qf = q.float().reshape(B, Nk, G, S, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qf, k_cache.float()) * scale
    rows = q_slot + torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    mask = cols <= rows
    if sliding_window is not None:
        mask = mask & (cols > rows - sliding_window)
    mask = mask[None] & (valid[:, None, :] != 0)          # [B, S, T]
    out = _masked_softmax_av(s, mask[:, None, None], v_cache.float()[:, :, None])
    return out.reshape(B, Nq, S, D).to(q.dtype)


def flash_prefill(
    q: torch.Tensor,        # [B, Nq, S, D]
    k_cache: torch.Tensor,  # [B, Nk, T, D]
    v_cache: torch.Tensor,  # [B, Nk, T, D]
    valid: torch.Tensor,    # [B, T] bool/uint8 — slot holds a real token
    scale: float,
    q_slot: int = 0,        # slot index of the first query row
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal GQA attention of S query rows over the dense slot cache.
    Returns [B, Nq, S, D] in q's dtype."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k_cache, v_cache, valid, scale,
                                   q_slot, sliding_window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: no kernel for device {q.device}")
    B, Nq, S, D = q.shape
    Nk, T = k_cache.shape[1], k_cache.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_prefill: head dim {D} not in {_HEAD_DIMS}")
    if k_cache.shape != (B, Nk, T, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_prefill: cache shapes {tuple(k_cache.shape)}"
                         f" / {tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if Nk == 0 or Nq % Nk:
        raise ValueError(f"flash_prefill: {Nq} query heads over {Nk} KV heads")
    if valid.shape != (B, T):
        raise ValueError(f"flash_prefill: valid {tuple(valid.shape)} != {(B, T)}")
    if not 0 <= q_slot <= T - S:
        raise ValueError(f"flash_prefill: rows at slots {q_slot}..{q_slot + S}"
                         f" do not fit a cache of {T} slots")
    kv_code, _ = kv_operands("flash_prefill", q, k_cache)
    _check_cuda_operands(
        "flash_prefill", q, ("q", q, None), ("k_cache", k_cache, (k_cache.dtype,)),
        ("v_cache", v_cache, (k_cache.dtype,)),
        ("valid", valid, (torch.bool, torch.uint8)))
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("flash_prefill.cu", "tg_flash_prefill",
                             _PREFILL_ARGS)
    out = torch.empty_like(q)
    window = int(sliding_window) if sliding_window else 0
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(valid), _ptr(out),
                 B, Nq, Nk, S, T, D, _DTYPE_CODE[q.dtype], kv_code, float(scale),
                 int(q_slot), window, ctypes.c_void_p(stream))
    cuda_build.check("flash_prefill.cu", err, "flash_prefill")
    LAUNCHES["flash_prefill"] += 1
    return out


# -- decode -------------------------------------------------------------------


def _infl_visible(N: int, step: int, window: Optional[int],
                  device) -> torch.Tensor:
    j = torch.arange(N, device=device)
    vis = j <= step
    if window is not None:
        vis = vis & ((step - j) < window)
    return vis


def flash_decode_frozen_plain(
    q: torch.Tensor,        # [B, Nq, D]
    k_stack: torch.Tensor,  # [L, B, Nk, T, D]
    v_stack: torch.Tensor,  # [L, B, Nk, T, D]
    mask: torch.Tensor,     # [B, T] bool/uint8
    k_infl: torch.Tensor,   # [B, Nk, N, D]
    v_infl: torch.Tensor,   # [B, Nk, N, D]
    l: int,
    step: int,
    scale: float,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of flash_decode_frozen, same semantics."""
    B, Nq, D = q.shape
    Nk, T = k_stack.shape[2], k_stack.shape[3]
    N = k_infl.shape[2]
    G = Nq // Nk
    k = torch.cat([k_stack[l].float(), k_infl.float()], dim=2)  # [B,Nk,T+N,D]
    v = torch.cat([v_stack[l].float(), v_infl.float()], dim=2)
    qf = q.float().reshape(B, Nk, G, D)
    s = torch.einsum("bkgd,bktd->bkgt", qf, k) * scale
    vis = torch.cat([mask != 0, _infl_visible(N, step, window, q.device)
                     .expand(B, N)], dim=1)                  # [B, T+N]
    out = _masked_softmax_av(s, vis[:, None, None, :], v)
    return out.reshape(B, Nq, D).to(q.dtype)


def flash_decode_frozen(
    q: torch.Tensor,        # [B, Nq, D] — single query position
    k_stack: torch.Tensor,  # [L, B, Nk, T, D] FROZEN stacked cache
    v_stack: torch.Tensor,  # [L, B, Nk, T, D]
    mask: torch.Tensor,     # [B, T] bool — frozen validity & window & causal
    k_infl: torch.Tensor,   # [B, Nk, N, D] — this layer's in-flight K
    v_infl: torch.Tensor,   # [B, Nk, N, D]
    l: int,                 # layer index into the stacks
    step: int,              # current in-flight slot
    scale: float,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention for the frozen-cache chunked loop: layer `l` of
    the stacked cache under `mask`, merged with in-flight slots
    j <= step (and step - j < window). Returns [B, Nq, D]."""
    if q.device.type == "cpu":
        return flash_decode_frozen_plain(q, k_stack, v_stack, mask, k_infl,
                                         v_infl, l, step, scale, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_frozen: no kernel for device {q.device}")
    B, Nq, D = q.shape
    L, _, Nk, T, _ = k_stack.shape
    N = k_infl.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_decode_frozen: head dim {D} not in {_HEAD_DIMS}")
    if k_stack.shape != (L, B, Nk, T, D) or v_stack.shape != k_stack.shape:
        raise ValueError(f"flash_decode_frozen: stacks {tuple(k_stack.shape)} /"
                         f" {tuple(v_stack.shape)} do not fit q {tuple(q.shape)}")
    if k_infl.shape != (B, Nk, N, D) or v_infl.shape != k_infl.shape:
        raise ValueError(f"flash_decode_frozen: in-flight {tuple(k_infl.shape)}"
                         f" / {tuple(v_infl.shape)} != {(B, Nk, N, D)}")
    if Nk == 0 or Nq % Nk or Nq // Nk > _MAX_GROUP:
        raise ValueError(f"flash_decode_frozen: {Nq} query heads over {Nk} KV "
                         f"heads (at most {_MAX_GROUP} per KV head)")
    if mask.shape != (B, T):
        raise ValueError(f"flash_decode_frozen: mask {tuple(mask.shape)} != {(B, T)}")
    if not 0 <= l < L or not 0 <= step < N:
        raise ValueError(f"flash_decode_frozen: layer {l} of {L} / step {step}"
                         f" of {N} out of range")
    kv_code, infl_dtype = kv_operands("flash_decode_frozen", q, k_stack)
    _check_cuda_operands(
        "flash_decode_frozen", q, ("q", q, None),
        ("k_stack", k_stack, (k_stack.dtype,)), ("v_stack", v_stack, (k_stack.dtype,)),
        ("mask", mask, (torch.bool, torch.uint8)),
        ("k_infl", k_infl, (infl_dtype,)), ("v_infl", v_infl, (infl_dtype,)))
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("flash_decode_frozen.cu",
                             "tg_flash_decode_frozen", _DECODE_ARGS)
    out = torch.empty_like(q)
    win = int(window) if window else 0
    C = decode_split(B, Nk, Nq // Nk, T + N, _sm_count(q.device.index or 0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_ptr(q), _ptr(k_stack), _ptr(v_stack), _ptr(mask),
                 _ptr(k_infl), _ptr(v_infl), _ptr(out),
                 B, Nq, Nk, T, N, D, _DTYPE_CODE[q.dtype], kv_code, int(l), int(step),
                 float(scale), win, C, ctypes.c_void_p(stream))
    cuda_build.check("flash_decode_frozen.cu", err, "flash_decode_frozen")
    LAUNCHES["flash_decode_frozen"] += 1
    return out


# -- one-layer decode (K13) ----------------------------------------------------


def flash_decode_plain(
    q: torch.Tensor,        # [B, Nq, D]
    k_cache: torch.Tensor,  # [B, Nk, T, D]
    v_cache: torch.Tensor,  # [B, Nk, T, D]
    mask: torch.Tensor,     # [B, T] bool/uint8
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch version of flash_decode, same semantics."""
    B, Nq, D = q.shape
    Nk = k_cache.shape[1]
    qf = q.float().reshape(B, Nk, Nq // Nk, D)
    s = torch.einsum("bkgd,bktd->bkgt", qf, k_cache.float()) * scale
    out = _masked_softmax_av(s, (mask != 0)[:, None, None, :], v_cache.float())
    return out.reshape(B, Nq, D).to(q.dtype)


def group_tile(G: int) -> int:
    """Query heads one block of the decode kernels holds: the largest
    divisor of G that is at most 8 (tg::group_tile)."""
    return next(gt for gt in range(min(G, _MAX_GROUP_TILE), 0, -1) if G % gt == 0)


@functools.lru_cache(maxsize=1024)  # a few cache lengths a run; called every launch
def decode_split(B: int, Nk: int, G: int, T: int, sms: int = 132) -> int:
    """K13's and K2's split plan: the blocks C of each (batch row, KV head,
    group tile)'s cluster. Enough blocks to fill the card's `sms` SMs, at
    most 8, and no more than the T slots can give shares of at least 64
    slots (K2 passes its frozen slots plus its N in-flight ones). The host
    knows T, not the visible span (reading the mask would synchronise the
    stream): each block cuts the span it finds in the mask into at most C
    shares of at least _SPLIT_MIN_TILES tiles."""
    groups = B * Nk * (G // group_tile(G))
    tiles = -(-T // _SPLIT_TILE)
    return max(1, min(_SPLIT_MAX_BLOCKS, sms // max(groups, 1),
                      tiles // _SPLIT_MIN_TILES))


@functools.lru_cache(maxsize=1024)  # a few pool shapes a run; called every launch
def paged_decode_split(B: int, Nk: int, G: int, T: int, per_sm: Tuple[int, ...],
                       sms: int = 132) -> int:
    """K8's split plan: the blocks C of each (batch row, KV head, group
    tile)'s cluster, which cut the row's visible span of 32-slot tiles into
    C shares. per_sm[c - 1] is the blocks of a cluster of c that an SM runs
    at once, registers and shared memory counted (the kernel's occupancy,
    which the library exports as tg_paged_decode_frozen_plan). C grows
    from 1 while the B * Nk * (G / GT) clusters give fewer than two blocks
    an SM, as long as all the clusters of C + 1 still run at once (no block
    waits for a second wave) and the T = MB * bs + N slots give shares of
    _SPLIT_MIN_TILES tiles. The host knows T and not the rows' lengths
    (reading them would synchronise the stream). On an H100 the serve shape
    (16 rows, 8 KV heads, G = 4, D = 128: two blocks an SM, by registers)
    takes C = 2, GPT-2's (12 KV heads, G = 1, D = 64: six an SM) 2, G = 16
    (one an SM) 1: the fastest of the split sweep each (PERF.md).
    Unlike decode_split (one block an SM), it counts the blocks an SM runs:
    at the serve shape's 128 clusters that one gives C = 1."""
    groups = B * Nk * (G // group_tile(G))
    tiles = -(-T // _SPLIT_TILE)
    C = 1
    while (C < _SPLIT_MAX_BLOCKS and groups * C < 2 * sms
           and C + 1 <= tiles // _SPLIT_MIN_TILES and groups * (C + 1) <= sms * per_sm[C]):
        C += 1
    return C


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_decode(
    q: torch.Tensor,        # [B, Nq, D] — single query position
    k_cache: torch.Tensor,  # [B, Nk, T, D] one layer's cache
    v_cache: torch.Tensor,  # [B, Nk, T, D]
    mask: torch.Tensor,     # [B, T] bool/uint8 — valid & causal & window
    scale: float,
) -> torch.Tensor:
    """One-token GQA decode over one layer's dense cache at the slots
    `mask` shows (the caller folds validity, causality and the window into
    it). A query that sees no slot gives zeros. Returns [B, Nq, D] in q's
    dtype."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    B, Nq, D = q.shape
    Nk, T = k_cache.shape[1], k_cache.shape[2]
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_decode (K13): head dim {D} not in {_HEAD_DIMS}")
    if k_cache.shape != (B, Nk, T, D) or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode (K13): cache shapes {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not fit q {tuple(q.shape)}")
    if Nk == 0 or Nq % Nk or Nq // Nk > _MAX_GROUP:
        raise ValueError(f"flash_decode (K13): {Nq} query heads over {Nk} KV heads "
                         f"(at most {_MAX_GROUP} per KV head)")
    if mask.shape != (B, T):
        raise ValueError(f"flash_decode (K13): mask {tuple(mask.shape)} != {(B, T)}")
    kv_code, _ = kv_operands("flash_decode", q, k_cache)
    _check_cuda_operands(
        "flash_decode", q, ("q", q, None), ("k_cache", k_cache, (k_cache.dtype,)),
        ("v_cache", v_cache, (k_cache.dtype,)), ("mask", mask, (torch.bool, torch.uint8)))
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("flash_decode.cu", "tg_flash_decode", _DECODE_ONE_ARGS)
    out = torch.empty_like(q)
    C = decode_split(B, Nk, Nq // Nk, T, _sm_count(q.device.index or 0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(mask), _ptr(out),
                 B, Nq, Nk, T, D, _DTYPE_CODE[q.dtype], kv_code, float(scale), C,
                 ctypes.c_void_p(stream))
    cuda_build.check("flash_decode.cu", err, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
