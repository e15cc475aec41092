"""Hopper gathered-expert matmuls for the MoE decode step, each beside its
plain version, and the routed MoE MLP that runs them.

Counterparts of the TPU kernels in tinygpt_tpu/ops/moe_kernels.py, written
in CUDA C++ for sm_90a (``csrc/moe_gather_matmul.cu``, one library with
three entry points) and bound with ctypes (ops/cuda_build.py):

  moe_gather_matmul       K12   bf16 (or fp32) expert stacks [L, E, IN, OUT]
  moe_gather_matmul_int8  K11a  int8 [L, E, IN, OUT], fp32 scales
                                [L, E, IN/group, OUT]
  moe_gather_matmul_int4  K11b  packed int4 [L, E, IN/2, OUT] (biased,
                                half-split nibbles), the same scales

Each computes out[r] = x[r] @ W[l, idx[r]] for x [R, IN] (bf16 or fp32) and
idx [R] int32, in x's dtype: any R, any expert ids (repeats included; ids
outside [0, E) are clamped). The layer and the expert are pointer offsets
into the stack. The int4 stack may be row-padded at quantize time
(quant.quantize_weight): x then keeps its unpadded width and the pad reads
as zeros, as the JAX wrapper pads x.

Each wrapper dispatches on the device of its tensors: on the CPU it runs
its plain PyTorch version (``*_plain``: the routed experts dequantized
exactly in fp32, products in fp32, one rounding at the end), on a CUDA
device it launches its kernel or raises. It never falls back from one to
the other. Every launch adds one to ``LAUNCHES[name]`` (the counter shared
with ops/attention_kernels.py).

``moe_mlp_gathered`` is the routed Mixtral MLP of one decode step (the JAX
moe_mlp_gathered): fp32 router logits, full softmax, top-k, renormalized
weights, slot-major repeated rows, two gathered matmuls, silu(gate) * up
in fp32 cast back, and the weighted slot sum in fp32. ``moe_route`` is its
routing, shared with models/causal_lm.moe_mlp and the AWQ statistics.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from tinygpt_tpu_torch.ops.attention_kernels import LAUNCHES, _ptr, _sm_count
from tinygpt_tpu_torch.ops.quant import QuantizedTensor, pad_x_to
from tinygpt_tpu_torch.ops.quant_kernels import (
    _DTYPE_CODE,
    _check_operands,
    _stream,
    dequant_fp32,
    unpack_int4,
)

_SOURCE = "moe_gather_matmul.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_FLOAT_ARGS = [_P] * 4 + [_I] * 8 + [_P]  # tg_moe_gather_float
_INT8_ARGS = [_P] * 5 + [_I] * 9 + [_P]   # tg_moe_gather_int8
_INT4_ARGS = [_P] * 5 + [_I] * 10 + [_P]  # tg_moe_gather_int4

# The tensor-core bodies (csrc/moe_gather_matmul.cu): K12 on bf16 stacks
# (moe_gather_tc_kernel), K11a and K11b on int8 and int4 stacks
# (moe_gather_q_kernel). A block owns a tile of one expert's columns
# (K12's 4 warps _TC_COLS; K11's, _q_shape), and the SK blocks of a cluster
# (one of _MOE_SPLITS) split the stored rows in _TC_UNIT-row units; the plan
# wants the live experts' blocks to number at least _MOE_FILL an SM. What a
# launch takes at a split comes from the library (tg_moe_gather_plan);
# moe_gather_plan models it for the CPU with the kernels' constants: the
# warps' cp.async rings (K12's _TC_RING, K11's _Q_WARP_RING a warp), then
# the pass's rows (8 an n-tile) staged as bf16 parts at the block's share
# of the stored rows (both nibble planes for int4), K12's rows padded by 16
# bytes, K11's to an odd multiple of 32; two blocks fit an SM while a block
# takes at most _TC_PAIR bytes, one up to _TC_SMEM (227 KB less 1 KB for
# the kernels' static shared memory).
_TC_COLS = 128
_TC_UNIT = 16
_TC_RING = 4 * 5 * _TC_UNIT * 64 * 2
_Q_WARP_RING = 5 * 2048  # a K11 warp's ring
_TC_PAIR = 112640
_TC_SMEM = 231424
_MOE_SPLITS = (1, 2, 4, 8, 16)
_MOE_FILL = 2
# K11 above _Q_FEW rows: the experts that at most _Q_FEW rows name take
# passes of one n-tile, in a launch of their own
_Q_FEW = 8
# The CPU model of K11's occupancy: an SM's 228 KB of shared memory, 1 KB
# of it reserved a block, a block's static shared memory (4 bytes a row of
# a pass, 16 more) and allocation in 128-byte units; and the blocks an SM
# the registers allow, as ptxas gives them on sm_90a for both activation
# types, by (bits, n-tiles): 4-warp blocks of int8 (157 to 168 registers a
# thread) three, of int4 (204 to 255) two; the 8-warp blocks of 4 n-tiles
# one.
_SM_SMEM = 233472
_Q_REG_BLOCKS = {(8, 1): 3, (8, 2): 3, (8, 4): 1, (4, 1): 2, (4, 2): 2, (4, 4): 1}


# -- routing -------------------------------------------------------------------


def moe_route(h2: torch.Tensor, router_w: torch.Tensor,
              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """HF Mixtral routing of tokens h2 [T, H] by router_w [H, E]: fp32
    logits, full softmax, the top k, renormalized. Returns (weights [T, k]
    fp32, expert ids [T, k] int64). Equal probabilities rank by the lower
    expert id first, as lax.top_k ranks them (a stable descending sort)."""
    probs = torch.softmax(h2.float() @ router_w.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w_top = vals[..., :k]
    return w_top / w_top.sum(dim=-1, keepdim=True), idx[..., :k]


# -- plain versions -------------------------------------------------------------


def _gathered_plain(x: torch.Tensor, idx: torch.Tensor, E: int,
                    weight: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """out[r] = x[r] @ weight(idx[r]) in fp32, one rounding to x's dtype;
    weight(e) is expert e's fp32 [IN, OUT]. Each routed expert is
    dequantized once."""
    ids = idx.long().clamp(0, E - 1)
    xf = x.float()
    out = None
    for e in torch.unique(ids).tolist():
        rows = (ids == e).nonzero()[:, 0]
        we = weight(e)
        if out is None:
            out = torch.zeros((x.shape[0], we.shape[1]), dtype=torch.float32,
                              device=x.device)
        out[rows] = xf[rows] @ we
    return out.to(x.dtype)


def moe_gather_matmul_plain(x, w, l: int, idx) -> torch.Tensor:
    """Plain version of moe_gather_matmul: x [R, IN] @ w[l, idx[r]]."""
    return _gathered_plain(x, idx, w.shape[1], lambda e: w[l, e].float())


def moe_gather_matmul_int8_plain(x, data, scales, l: int, idx, group: int) -> torch.Tensor:
    """Plain version of moe_gather_matmul_int8."""
    return _gathered_plain(x, idx, data.shape[1],
                           lambda e: dequant_fp32(data[l, e], scales[l, e], group))


def moe_gather_matmul_int4_plain(x, data, scales, l: int, idx, group: int) -> torch.Tensor:
    """Plain version of moe_gather_matmul_int4: x is zero-padded to a
    row-padded stack's IN, whose pad rows are zeros."""
    x = pad_x_to(x, 2 * data.shape[2])
    return _gathered_plain(x, idx, data.shape[1],
                           lambda e: dequant_fp32(unpack_int4(data[l, e]), scales[l, e], group))


# -- the kernels ---------------------------------------------------------------


def _check(name: str, x: torch.Tensor, data: torch.Tensor, scales, idx: torch.Tensor,
           l: int, group: int, bits: int) -> Tuple[int, int, int]:
    """Operand checks shared by the three wrappers; returns (E, stored rows,
    OUT). The kernels read 8 columns of a row at a time (OUT % 8 == 0) and,
    quantized, 16 rows inside one group (group % 16 == 0, rows % group ==
    0)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: activations of dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    want_w = tuple(_DTYPE_CODE) if bits == 16 else (torch.int8,)
    if data.dtype not in want_w or (scales is not None and scales.dtype != torch.float32):
        raise TypeError(f"{name}: want a stack of {want_w}"
                        + ("" if scales is None else " and float32 scales")
                        + f", got {data.dtype}"
                        + ("" if scales is None else f" / {scales.dtype}"))
    if idx.dtype != torch.int32:
        raise TypeError(f"{name}: expert ids must be int32, got {idx.dtype}")
    if x.ndim != 2 or data.ndim != 4 or idx.shape != (x.shape[0],):
        raise ValueError(f"{name}: want x [R, IN], a stack [L, E, rows, OUT] and idx "
                         f"[R], got {tuple(x.shape)} / {tuple(data.shape)} / "
                         f"{tuple(idx.shape)}")
    L, E, rows, out = data.shape
    IN = 2 * rows if bits == 4 else rows
    if x.shape[0] == 0 or out % 8:
        raise ValueError(f"{name}: {x.shape[0]} rows and OUT {out}; want rows > 0 and "
                         f"OUT % 8 == 0")
    if (x.shape[1] > IN) if bits == 4 else (x.shape[1] != IN):
        raise ValueError(f"{name}: x has {x.shape[1]} columns for a stack of IN {IN}")
    if scales is not None:
        if group <= 0 or group % 16 or rows % group:
            raise ValueError(f"{name}: group {group} and {rows} stored rows need "
                             f"group % 16 == 0 and rows % group == 0")
        if scales.shape != (L, E, IN // group, out):
            raise ValueError(f"{name}: scales {tuple(scales.shape)} != "
                             f"{(L, E, IN // group, out)}")
    if not 0 <= l < L:
        raise ValueError(f"{name}: layer {l} of {L}")
    _check_operands(name, x.device, ("x", x, None), ("data", data, None),
                    ("scales", scales, None), ("idx", idx, None))
    return E, rows, out


def _q_shape(nt: int) -> Tuple[int, int]:
    """K11's block at nt n-tiles of 8 rows a pass: (warps, columns)."""
    return (8, 256) if nt == 4 else (4, 256 if nt == 2 else 128)


def _stored_rows(IN: int, bits: int) -> int:
    """Rows of a stack's data for contraction dim IN: packed int4 holds two
    rows in one."""
    return IN // 2 if bits == 4 else IN


def moe_gather_plan(R: int, IN: int, parts: int, split: int, bits: int = 16
                    ) -> Tuple[int, int]:
    """The CPU model of what a gathered kernel launches at split `split`
    over a stack of `bits` (16: K12 on bf16; 8: K11a; 4: K11b) with
    contraction dim IN (the kernel's tc_ntiles / q_ntiles and tc_smem /
    q_smem, which the library exports as tg_moe_gather_plan, read on the
    card by _library_plan): (the n-tiles of 8 rows a pass, a block's shared
    memory bytes). K12's n-tiles are those of R (1 for R <= 8, 2 <= 16, 4
    <= 32, else 8), halved while the staged rows, `parts` bf16 parts of the
    largest rank's share of IN, keep a second block off the SM (_TC_PAIR),
    but never below those of min(R, 32); K11's are those of min(R, 32): an
    expert's first 32 rows are one pass however the rows fall. (0, 0) where
    those do not fit a block."""
    n16 = -(-_stored_rows(IN, bits) // _TC_UNIT)
    nk = -(-n16 // split) * _TC_UNIT  # the largest rank's rows
    if bits != 16:
        nt = 1 if R <= 8 else 2 if R <= 16 else 4
        planes = 2 if bits == 4 else 1
        smem = (_q_shape(nt)[0] * _Q_WARP_RING
                + parts * planes * 8 * nt * ((2 * nk & ~63) + 32))
        return (nt, smem) if smem <= _TC_SMEM else (0, 0)
    nt = 1 if R <= 8 else 2 if R <= 16 else 4 if R <= 32 else 8
    least = min(nt, 4)
    xbytes = lambda n: parts * 8 * n * (2 * nk + 16)  # noqa: E731
    while nt > least and _TC_RING + xbytes(nt) > _TC_PAIR:
        nt //= 2
    if _TC_RING + xbytes(nt) > _TC_SMEM:
        return 0, 0
    return nt, _TC_RING + xbytes(nt)


def _q_per_sm(nt: int, smem: int, bits: int) -> int:
    """The CPU model of the blocks of K11 an SM runs at once (the kernel's
    occupancy, which the library reports as tg_moe_gather_plan's out[2])."""
    block = -(-(smem + 32 * nt + 16) // 128) * 128 + 1024
    return min(_SM_SMEM // block, _Q_REG_BLOCKS[bits, nt])


def _model_plan(R: int, IN: int, parts: int, split: int, bits: int = 16) -> Tuple[int, int, int]:
    """moe_gather_plan with K11's blocks an SM (_q_per_sm; 0 for K12): the
    CPU tests' stand-in for _library_plan."""
    nt, smem = moe_gather_plan(R, IN, parts, split, bits)
    return nt, smem, _q_per_sm(nt, smem, bits) if nt and bits != 16 else 0


@functools.lru_cache(maxsize=1024)  # a few shapes a model, a few splits each
def _library_plan(R: int, IN: int, parts: int, split: int, bits: int = 16
                  ) -> Tuple[int, int, int]:
    """What a gathered kernel launches at split `split` over a stack of
    `bits`, as the library reports it (tg_moe_gather_plan): the n-tiles a
    pass, a block's shared memory bytes and, for K11, the blocks an SM runs
    at once (registers counted); (0, 0, 0) where the rows fit no block at
    that split."""
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function(_SOURCE, "tg_moe_gather_plan", [_I] * 5 + [_P])
    out = (ctypes.c_int * 3)()
    code = _DTYPE_CODE[torch.float32 if parts == 2 else torch.bfloat16]
    cuda_build.check(_SOURCE, fn(R, IN, code, bits, split, out), "tg_moe_gather_plan")
    return out[0], out[1], out[2]


@functools.lru_cache(maxsize=1024)  # a few shapes a model; called every launch
def moe_gather_split(R: int, E: int, IN: int, OUT: int, parts: int, sms: int = 132,
                     plan: Callable[..., Tuple[int, int, int]] = _model_plan,
                     bits: int = 16) -> int:
    """The split plan of K12 (bf16 stack, bits 16), K11a (8) or K11b (4):
    the blocks SK of each cluster, which split the stored rows between them.
    `plan(R, IN, parts, SK, bits)` says what a launch at SK takes (the
    wrappers pass _library_plan, the kernel's own numbers; the CPU tests its
    model, _model_plan). The host never reads idx, so it counts min(R, E)
    live experts, the rows spread evenly over them. In order: the fewest
    passes over an expert's rows; for K11, the most blocks an SM (registers
    and shared memory counted); a portable cluster (at most 8 blocks: 16
    only for rows that fit no smaller split, or, for K11, where it runs more
    blocks an SM); for K12, where a pass holds more than 8 rows, two blocks
    an SM (_TC_PAIR); then the smallest SK whose live blocks (experts x
    column tiles x SK) number _MOE_FILL an SM, else the largest. At most one
    block a 16-row unit, and powers of two (clusters of 6 and 12 won no case
    of K12's sweep). On an H100 (PERF.md), K12 at Mixtral-8x7B's gate_up
    (4096 -> 28672) takes SK 1 at R = 8 and 4 at 32 and 160, at down (14336
    -> 4096) 2 at 8 and 8 at 32 and 160: the fastest of the split sweep (SK
    1 to 16) in each case, on even and uneven draws, but down at R = 160,
    which ties with SK 16 (0.4477 against 0.4475 ms). Where a pass holds 8
    rows, one block an SM streamed as fast (down at R = 8: SK 2 0.266
    against SK 4's 0.274); where it holds 32, the second block paid
    (gate_up at R = 32: SK 4 0.649 against SK 2's 0.672). K11 streams
    fastest at the most blocks an SM (K11b gate_up at R = 8: SK 1 and 2 two
    blocks, by registers, SK 1 0.178 against SK 2's 0.193; K11a three from
    SK 2 on: SK 2 0.279 against SK 1's 0.291). Raises ValueError for a
    shape whose rows fit no split."""
    n16 = -(-_stored_rows(IN, bits) // _TC_UNIT)
    live = min(R, E)
    rows = -(-R // live)  # an expert's rows
    best = None
    for S in _MOE_SPLITS:
        if S > max(1, n16):
            break
        nt, smem, per_sm = plan(R, IN, parts, S, bits)
        if not nt:
            continue
        cols = _TC_COLS if bits == 16 else _q_shape(nt)[1]
        short = live * -(-OUT // cols) * S < _MOE_FILL * sms
        if bits == 16:
            key = (-(-rows // (8 * nt)), S > 8, nt > 1 and smem > _TC_PAIR, short,
                   -S if short else S)
        else:
            key = (-(-rows // (8 * nt)), -per_sm, S > 8, short, -S if short else S)
        best = min(best or key, key)
    if best is None:
        raise ValueError(f"moe_gather_matmul: the rows of IN = {IN} ({parts} parts, {bits} "
                         f"bits) fit no split of up to {_MOE_SPLITS[-1]} blocks")
    return abs(best[-1])


def _launch(name: str, symbol: str, argtypes, x, idx, out_cols, tensors, ints, *codes):
    """Launches `symbol`: (x, tensors..., idx, out, ints..., x's dtype code,
    codes..., stream)."""
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function(_SOURCE, symbol, argtypes)
    out = torch.empty((x.shape[0], out_cols), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), *(_ptr(t) for t in tensors), _ptr(idx), _ptr(out), *ints,
                 _DTYPE_CODE[x.dtype], *codes, _stream(x.device))
    cuda_build.check(_SOURCE, err, name)
    LAUNCHES[name] += 1
    return out


def _split(x: torch.Tensor, E: int, IN: int, OUT: int, bits: int, R: int = 0) -> int:
    """The plan's split for x (or R of its rows) over a stack of `bits` on
    x's card."""
    return moe_gather_split(R or x.shape[0], E, IN, OUT, 2 if x.dtype == torch.float32 else 1,
                            _sm_count(x.device.index or 0), _library_plan, bits)


def _q_splits(x: torch.Tensor, E: int, IN: int, OUT: int, bits: int) -> Tuple[int, int]:
    """K11's splits: the call's, and that of its launch over the experts
    that at most _Q_FEW rows name (planned as a call of _Q_FEW rows)."""
    return (_split(x, E, IN, OUT, bits),
            _split(x, E, IN, OUT, bits, min(x.shape[0], _Q_FEW)))


def moe_gather_matmul(
    x: torch.Tensor,    # [R, IN] bf16/fp32, one row per (token, expert slot)
    w: torch.Tensor,    # [L, E, IN, OUT] bf16 (or fp32) expert stack
    l: int,             # layer
    idx: torch.Tensor,  # [R] int32 expert of each row
) -> torch.Tensor:
    """out[r] = x[r] @ w[l, idx[r]] (K12). A bf16 stack runs on the
    tensor cores, on clusters of moe_gather_split blocks; an fp32 stack on
    the CUDA cores."""
    if x.device.type == "cpu":
        return moe_gather_matmul_plain(x, w, l, idx)
    name = "moe_gather_matmul"
    E, rows, out = _check(name, x, w, None, idx, l, 0, 16)
    split = 1
    if w.dtype == torch.bfloat16:
        split = _split(x, E, rows, out, 16)
    return _launch(name, "tg_moe_gather_float", _FLOAT_ARGS, x, idx, out, (w,),
                   (x.shape[0], rows, out, E, int(l)), _DTYPE_CODE[w.dtype], split)


def moe_gather_matmul_int8(
    x: torch.Tensor,       # [R, IN]
    data: torch.Tensor,    # [L, E, IN, OUT] int8
    scales: torch.Tensor,  # [L, E, IN/group, OUT] fp32
    l: int,
    idx: torch.Tensor,     # [R] int32
    group: int,
) -> torch.Tensor:
    """out[r] = x[r] @ dequant(data[l, idx[r]]) for an int8 stack (K11a), on
    the tensor cores, on clusters of moe_gather_split blocks (_q_splits)."""
    if x.device.type == "cpu":
        return moe_gather_matmul_int8_plain(x, data, scales, l, idx, group)
    name = "moe_gather_matmul_int8"
    E, rows, out = _check(name, x, data, scales, idx, l, group, 8)
    return _launch(name, "tg_moe_gather_int8", _INT8_ARGS, x, idx, out, (data, scales),
                   (x.shape[0], rows, out, E, group, int(l)), *_q_splits(x, E, rows, out, 8))


def moe_gather_matmul_int4(
    x: torch.Tensor,       # [R, in_x], in_x <= IN (a row-padded stack's pad is zeros)
    data: torch.Tensor,    # [L, E, IN/2, OUT] packed int4
    scales: torch.Tensor,  # [L, E, IN/group, OUT] fp32
    l: int,
    idx: torch.Tensor,     # [R] int32
    group: int,
) -> torch.Tensor:
    """out[r] = x[r] @ dequant(data[l, idx[r]]) for a packed int4 stack
    (K11b), on the tensor cores, on clusters of moe_gather_split blocks
    (_q_splits)."""
    if x.device.type == "cpu":
        return moe_gather_matmul_int4_plain(x, data, scales, l, idx, group)
    name = "moe_gather_matmul_int4"
    E, rows, out = _check(name, x, data, scales, idx, l, group, 4)
    return _launch(name, "tg_moe_gather_int4", _INT4_ARGS, x, idx, out, (data, scales),
                   (x.shape[0], x.shape[1], 2 * rows, out, E, group, int(l)),
                   *_q_splits(x, E, 2 * rows, out, 4))


# -- the routed MLP ------------------------------------------------------------------


def _gmm(x: torch.Tensor, w, l: int, idx: torch.Tensor, impl: str) -> torch.Tensor:
    """x @ w[l, idx[r]] through K11b / K11a (quantized stacks) or K12, or
    their plain versions under impl="plain"."""
    x = x.contiguous()
    if isinstance(w, QuantizedTensor):
        fn = {(4, "kernel"): moe_gather_matmul_int4, (4, "plain"): moe_gather_matmul_int4_plain,
              (8, "kernel"): moe_gather_matmul_int8,
              (8, "plain"): moe_gather_matmul_int8_plain}[(w.bits, impl)]
        return fn(x, w.data, w.scales, l, idx, w.group_size)
    fn = moe_gather_matmul if impl == "kernel" else moe_gather_matmul_plain
    return fn(x, w, l, idx)


def local_experts(idx: torch.Tensor, experts: Tuple[int, int]):
    """Expert ids [R] of the whole model -> (ids into a rank's stack of
    experts e0 .. e0 + n - 1, the rows routed there). A row routed to
    another rank reads local expert 0; its output is zeroed by the
    caller."""
    e0, n = experts
    loc = idx - e0
    hit = (loc >= 0) & (loc < n)
    return torch.where(hit, loc, torch.zeros_like(loc)), hit


def moe_gather_local(x: torch.Tensor, w, l: int, idx: torch.Tensor,
                     experts: Tuple[int, int], impl: str = "kernel") -> torch.Tensor:
    """The gathered matmul of a rank that holds experts e0 .. e0 + n - 1
    (expert parallelism): global ids [R] int32 remapped to the local stack
    around the kernel (K12, K11a or K11b, or their plain versions), and the
    rows routed to another rank given 0."""
    ids, hit = local_experts(idx, experts)
    out = _gmm(x, w, l, ids.to(torch.int32), impl)
    return out * hit[:, None].to(out.dtype)


def moe_mlp_gathered(
    h: torch.Tensor,    # [B, 1, H] or [B, H] post-norm activations
    router_w: torch.Tensor,  # [H, E] this layer's router
    gate_up_w,          # [L, E, H, 2I] stack (tensor or QuantizedTensor)
    down_w,             # [L, E, I, H] stack
    l: int,             # layer
    cfg,
    impl: str = "kernel",  # "kernel" | "plain"
    experts: Optional[Tuple[int, int]] = None,  # (e0, n): the stacks' experts
) -> torch.Tensor:
    """The routed Mixtral MLP of a decode step: routing (moe_route), the
    B * k slot-major rows through two gathered matmuls (only the routed
    experts' bytes are read), silu(gate) * up in fp32 cast back, and the
    routing-weighted slot sum in fp32. With `experts` the stacks hold
    those experts only (expert parallelism): routing runs over every
    expert, the rows routed elsewhere give 0 (moe_gather_local), and the
    result is this rank's partial sum. Returns h's shape and dtype."""
    lead, H = h.shape[:-1], h.shape[-1]
    h2 = h.reshape(-1, H)
    B, k = h2.shape[0], cfg.num_experts_per_tok
    w_top, idx = moe_route(h2, router_w, k)
    xr = h2.repeat_interleave(k, dim=0)                  # [B*k, H] slot-major
    ids = idx.reshape(-1).to(torch.int32)
    if experts is None:
        gmm = lambda x, w: _gmm(x, w, l, ids, impl)  # noqa: E731
    else:
        gmm = lambda x, w: moe_gather_local(x, w, l, ids, experts, impl)  # noqa: E731
    gate, up = gmm(xr, gate_up_w).chunk(2, dim=-1)
    act = F.silu(gate.float()).to(up.dtype) * up
    down = gmm(act, down_w)                              # [B*k, H]
    out = (w_top.reshape(-1, 1) * down.float()).reshape(B, k, H).sum(dim=1)
    return out.to(h.dtype).reshape(*lead, H)
