"""Hopper dequant-matmul kernels (int8 and int4), each beside its plain
version.

Counterparts of the TPU kernels in tinygpt_tpu/ops/quant_kernels.py,
written in CUDA C++ for sm_90a and bound with ctypes (ops/cuda_build.py):

  matmul_dequant_int8                K3   csrc/int8_matmul.cu (layer 0)
  matmul_dequant_int8_stacked        K5a  csrc/int8_matmul.cu
  matmul_dequant_int4                K4   csrc/int4_matmul.cu (layer 0)
  matmul_dequant_int4_stacked        K5b  csrc/int4_matmul.cu
  matmul_dequant_int4_stacked_fused  K6   csrc/int4_fused.cu
  mlp_fused_int4_stacked             K7   csrc/int4_mlp.cu

Weights keep the JAX package's layout (ops/quant.py): int8 [L, IN, OUT]
or packed int4 [L, IN/2, OUT] holding biased, half-split nibbles, and
fp32 scales [L, IN/group, OUT]. A layer is an offset into the stack; no
layer's bytes are copied. The kernels dequantize on chip and accumulate
in fp32; they take bf16 and fp32 activations. With bf16 activations at
M > 32 (the prefill regime, csrc/dequant_mm_tc.cuh) each dequantized
weight is rounded to bf16 before its product, as the TPU kernels' bm > 32
branch does; elsewhere no dequantized weight is rounded.

Each wrapper dispatches on the device of its tensors: on the CPU it runs
its plain PyTorch version (``*_plain``: weights dequantized exactly in
fp32, products in fp32, one rounding at the end), on a CUDA device it
launches its kernel or raises. It never falls back from one to the
other. Every call on the card adds one to ``LAUNCHES[name]`` (the
counter shared with ops/attention_kernels.py). The Mosaic tile pickers
and VMEM budgets of the TPU kernels have no counterpart here; the shape
rules the Hopper kernels do have are checked in ``_check_weight``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from tinygpt_tpu_torch.ops.attention_kernels import LAUNCHES, _ptr, _sm_count

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_ROPE_DIMS = (32, 64, 128)  # head dims the fused RoPE epilogue takes
MAX_DECODE_ROWS = 32        # rows of the decode-shaped kernels (K6, K7)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_MATMUL_ARGS = [_P] * 4 + [_I] * 8 + [_P]  # ..., split, tile, stream
_FUSED_ARGS = [_P] * 12 + [_I] * 10 + [_F, _I, _I, _P]  # ..., eps, dtype, split, stream
_MLP_ARGS = [_P] * 9 + [_I] * 11 + [_P]  # ..., dtype, residual, split_a, split_b, stream

# the int8 GEMV's split (csrc/int8_matmul.cu, M <= 32): a block owns
# _GEMV_COLS columns of up to 4 (M <= 4) or 8 activation rows; the blocks of
# a cluster split IN in _GEMV_UNIT-row units, a cluster of one of
# _GEMV_SPLITS blocks (a non-portable cluster above 8), each block staging
# at most about _GEMV_MAX_ROWS rows of activations in shared memory
_GEMV_COLS = 256
_GEMV_UNIT = 16
_GEMV_SPLITS = (1, 2, 4, 6, 8, 12, 16)
_GEMV_BLOCKS_PER_SM = 0.75
_GEMV_MAX_ROWS = 4096

# the int4 GEMV's split (csrc/int4_common.cuh, M <= 32): a block owns
# _I4_COLS columns of all the call's rows (8, 16 or 32 a pass: 1, 2 or 4
# n-tiles); the C blocks of a cluster, one of _I4_SPLITS, split IN/2 in
# _I4_UNIT-row units. A block's shared memory (_i4_smem) is its warps'
# cp.async rings and, on the staged route (_i4_route), its activations,
# within _I4_SMEM; its fixed cost (launch, first loads, the cluster's
# reduction) is about _I4_BLOCK_COST units of rows. A block on a ring route
# is 4 warps, two an SM (registers); a staged block 8 warps, one an SM
# (shared memory); the H100 runs at most _I4_CLUSTERS[C] clusters of C
# blocks of one an SM at once, about twice as many of two an SM
# (cudaOccupancyMaxActiveClusters on its 132 SMs: a cluster must fit one
# GPC)
_I4_COLS = 128
_I4_UNIT = 16
_I4_SPLITS = (1, 2, 4, 6, 8, 12, 16)
_I4_SMEM = 232448
_I4_BLOCK_COST = 12
_I4_CLUSTERS = {1: 132, 2: 66, 4: 30, 6: 17, 8: 15, 12: 7, 16: 7}

# the prefill regime's plan (csrc/dequant_mm_tc.cuh, M > 32, bf16): a block
# owns _TC_COLS weight columns and `tile` rows of x (wgmma's N, one of
# _TC_TILES) and walks its share of the stages of _TC_STAGE weight rows
# (int8) or packed rows (int4); the C blocks of a cluster (at most
# _TC_MAX_SPLIT) split the stages and sum their tiles through distributed
# shared memory, which costs a block about _TC_SPLIT_COST int8 stages
_TC_COLS = 128
_TC_STAGE = 64
_TC_TILES = (128, 256)
_TC_MAX_SPLIT = 3
_TC_SPLIT_COST = 6


def _opt_ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


# -- plain versions -------------------------------------------------------------


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of quant.pack_int4 along axis -2: [..., in/2, out] packed
    int8 → [..., in, out] int8 q in [-8, 7], original row order."""
    u = packed.view(torch.uint8)
    lo = (u & 0x0F).to(torch.int8) - 8
    hi = (u >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-2)


def dequant_fp32(q: torch.Tensor, scales: torch.Tensor, group: int) -> torch.Tensor:
    """q [..., in, out] int8 and scales [..., in/group, out] → the weight in
    fp32, each element q * scale rounded once."""
    *lead, in_dim, out = q.shape
    w = (q.float().reshape(*lead, in_dim // group, group, out)
         * scales.float()[..., :, None, :])
    return w.reshape(*lead, in_dim, out)


def _weight(data: torch.Tensor, scales: torch.Tensor, group: int) -> torch.Tensor:
    return dequant_fp32(unpack_int4(data), scales, group)


def _pad_cols(a: torch.Tensor, width: int) -> torch.Tensor:
    return torch.nn.functional.pad(a, (0, width - a.shape[-1]))


def matmul_dequant_int8_plain(x, data, scales, group: int) -> torch.Tensor:
    """Plain version of matmul_dequant_int8: x [M, IN] @ W → x's dtype."""
    return (x.float() @ dequant_fp32(data, scales, group)).to(x.dtype)


def matmul_dequant_int8_stacked_plain(x, data, scales, l: int,
                                      group: int) -> torch.Tensor:
    """Plain version of matmul_dequant_int8_stacked."""
    return matmul_dequant_int8_plain(x, data[l], scales[l], group)


def matmul_dequant_int4_plain(x, data, scales, group: int) -> torch.Tensor:
    """Plain version of matmul_dequant_int4: x [M, IN] @ W → x's dtype."""
    return (x.float() @ _weight(data, scales, group)).to(x.dtype)


def matmul_dequant_int4_stacked_plain(x, data, scales, l: int,
                                      group: int) -> torch.Tensor:
    """Plain version of matmul_dequant_int4_stacked."""
    return matmul_dequant_int4_plain(x, data[l], scales[l], group)


def _rows(t: Optional[torch.Tensor], L: int) -> Optional[torch.Tensor]:
    """[L, 1, n] or [L, n] per-layer rows → [L, n]."""
    return None if t is None else t.reshape(L, -1)


def matmul_dequant_int4_stacked_fused_plain(
    x, data, scales, l: int, group: int, ln=None, invrms=None, res=None,
    bias=None, silu: bool = False, rope_cos=None, rope_sin=None,
    rope_heads: int = 0, rope_dim: int = 0, qk_norm_w=None, qk_heads: int = 0,
    eps: float = 0.0,
) -> torch.Tensor:
    """Plain version of matmul_dequant_int4_stacked_fused, same semantics:
    prologue, matmul and epilogue in fp32, one rounding to the output
    type (res's when res is given, else x's)."""
    L, inp, _ = data.shape
    xf = x.float()
    if silu:
        n = x.shape[1] // 2
        g, u = xf[:, :n], xf[:, n:]
        a = g * torch.sigmoid(g) * u
    else:
        a = xf
    if ln is not None:
        a = a * invrms.float().reshape(-1, 1) * _rows(ln, L)[l].float()
    acc = _pad_cols(a, 2 * inp) @ _weight(data[l], scales[l], group)
    if bias is not None:
        acc = acc + _rows(bias, L)[l].float()
    if rope_cos is not None:
        M, D = acc.shape[0], rope_dim
        cols = rope_heads * D
        h = acc[:, :cols].reshape(M, rope_heads, D)
        if qk_norm_w is not None:
            qn, kn = (w.reshape(L, -1)[l].float() for w in qk_norm_w)
            inv = torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
            nw = torch.where(torch.arange(rope_heads, device=h.device)[:, None]
                             < qk_heads, qn, kn)
            h = h * inv * nw
        rot = torch.cat([-h[..., D // 2:], h[..., : D // 2]], dim=-1)
        h = h * rope_cos.float()[:, None, :] + rot * rope_sin.float()[:, None, :]
        acc = torch.cat([h.reshape(M, cols), acc[:, cols:]], dim=1)
    if res is not None:
        acc = acc + res.float()
    return acc.to(res.dtype if res is not None else x.dtype)


def mlp_fused_int4_stacked_plain(x, gu_data, gu_scales, dn_data, dn_scales,
                                 ln, invrms, l: int, group: int,
                                 residual: bool = True) -> torch.Tensor:
    """Plain version of mlp_fused_int4_stacked: the gate_up activation
    stays fp32 between the two matmuls."""
    L = gu_data.shape[0]
    a = x.float() * invrms.float().reshape(-1, 1) * _rows(ln, L)[l].float()
    gu = (_pad_cols(a, 2 * gu_data.shape[1])
          @ _weight(gu_data[l], gu_scales[l], group))
    i = gu.shape[1] // 2
    act = torch.nn.functional.silu(gu[:, :i]) * gu[:, i:]
    act = _pad_cols(act, 2 * dn_data.shape[1])
    out = act @ _weight(dn_data[l], dn_scales[l], group)
    if residual:
        out = x.float() + out
    return out.to(x.dtype)


# -- operand checks -------------------------------------------------------------


def _check_weight(name: str, x: torch.Tensor, data: torch.Tensor,
                  scales: torch.Tensor, group: int, bits: int = 4) -> Tuple[int, int, int]:
    """Shared checks of a kernel's activation and weight stack; returns
    (L, IN, OUT). The kernels read 8 columns of a row at a time (OUT % 8
    == 0) and 16 rows inside one group at a time (group % 16 == 0, rows %
    group == 0). The int4 GEMV also splits the packed rows over 8 blocks
    of a cluster in such steps ((IN/2) % 128 == 0, which
    quant.quantize_weight's row padding gives every int4 weight); the int8
    kernels split whatever rows there are, so every int8 weight that
    quant.quantize_weight makes with such a group passes."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: activations of dtype {x.dtype} not supported "
                        f"(float32, bfloat16)")
    if data.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{name}: weight must be int8 and scales float32, "
                        f"got {data.dtype} / {scales.dtype}")
    if data.ndim != 3 or x.ndim != 2:
        raise ValueError(f"{name}: want x [M, IN] and a weight stack [L, rows, "
                         f"OUT], got {tuple(x.shape)} / {tuple(data.shape)}")
    L, rows, out = data.shape
    IN = rows * (8 // bits)
    if group <= 0 or group % 16 or rows % group or out % 8 or (bits == 4 and rows % 128):
        rule = "(IN/2) % group == 0, (IN/2) % 128 == 0" if bits == 4 else "IN % group == 0"
        raise ValueError(f"{name}: group {group} and weight [{IN}, {out}] need "
                         f"group % 16 == 0, {rule}, OUT % 8 == 0")
    if scales.shape != (L, IN // group, out):
        raise ValueError(f"{name}: scales {tuple(scales.shape)} != "
                         f"{(L, IN // group, out)}")
    return L, IN, out


def _check_operands(name: str, dev: torch.device, *tensors) -> None:
    """Device, dtype, contiguity and 16-byte alignment of every operand;
    `tensors` are (label, tensor or None, allowed dtypes or None)."""
    for label, t, want in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: {label} on {t.device}, expected {dev}")
        if want is not None and t.dtype not in want:
            raise TypeError(f"{name}: {label} has dtype {t.dtype}, expected one "
                            f"of {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")


def _check_rows(name: str, M: int) -> None:
    if not 0 < M <= MAX_DECODE_ROWS:
        raise ValueError(f"{name}: {M} rows; the decode-shaped kernel takes "
                         f"1 to {MAX_DECODE_ROWS}")


# -- K3 / K5a, K4 / K5b -------------------------------------------------------------

_MATMUL_LIBS = {8: ("int8_matmul.cu", "tg_int8_matmul"),
                4: ("int4_matmul.cu", "tg_int4_matmul")}


@functools.lru_cache(maxsize=1024)  # a few shapes a model; called every launch
def gemv_split(M: int, IN: int, OUT: int, sms: int = 132) -> int:
    """The int8 GEMV's split plan (M <= 32): the blocks C of each cluster,
    which split IN between them. The size in _GEMV_SPLITS nearest (by
    ratio) to _GEMV_BLOCKS_PER_SM blocks for each of the card's `sms` SMs
    (the blocks are the column tiles times the row tiles of M, times C),
    but enough that no block stages more than _GEMV_MAX_ROWS activation
    rows, and at most one a 16-row unit of IN. On the H100 a sweep of C
    from 1 to 16 (chip_smoke.py's int8 phase times the plan against the
    other sizes) put the fastest split near three blocks for four SMs, and
    clusters of 3, 5, 7 and 9 to 11 blocks slower than their neighbours."""
    tiles = -(-OUT // _GEMV_COLS) * -(-M // (4 if M <= 4 else 8))
    want = _GEMV_BLOCKS_PER_SM * sms / tiles
    fits = [c for c in _GEMV_SPLITS if c * _GEMV_MAX_ROWS >= IN] or [_GEMV_SPLITS[-1]]
    C = min(fits, key=lambda c: abs(math.log(c / want)))
    return max(1, min(C, IN // _GEMV_UNIT))


def _i4_route(M: int, parts: int, staged: bool) -> int:
    """How an int4 GEMV block gets its activation rows (the kernel's
    gv_plan): 0, bf16 x rides the ring with the weights; 2, an activation
    in parts is formed chunk by chunk from what rides the ring (at most 16
    rows); 1, the block stages all its rows once (`staged`: the silu
    prologue or x rows not 16-byte aligned; or 32 rows)."""
    if parts == 1:
        return 0
    return 2 if M <= 16 and not staged else 1


def _i4_smem(nt: int, nk: int, parts: int, route: int) -> int:
    """Shared memory of an int4 GEMV block (the kernel's gv_bytes): its
    warps' rings of 2 nt + 1 slots, each a chunk's 16 packed rows of 128 /
    nt columns, both planes' scale rows and the chunk's activation payload;
    staged (route 1), the nk packed rows' activations and norm weights."""
    w = _I4_COLS // nt
    pay = {0: 512 * nt, 1: 0, 2: max(512 * parts * nt, 1024 * nt + 128)}[route]
    ring = (8 if route == 1 else 4) * (2 * nt + 1) * (_I4_UNIT * w + 8 * w + pay)
    return ring + (nk * (32 * parts * nt + 8) if route == 1 else 0)


def int4_gemv_plan(M: int, IN: int, C: int, parts: int,
                   staged: bool = False) -> Tuple[int, int, int]:
    """What the int4 GEMV launches at split C (the kernel's gv_describe,
    which the libraries export as tg_int4_*_plan): (the n-tiles of 8 rows a
    pass, the route (_i4_route), a block's shared memory bytes). The
    n-tiles are those of M (1 for M <= 8, 2 for M <= 16, else 4), fewer
    where a staged block's activations would not fit its shared memory, 0
    (and 0 bytes) where even one does not."""
    nk = -(-(IN // 2 // _I4_UNIT) // C) * _I4_UNIT
    nt = 1 if M <= 8 else 2 if M <= 16 else 4
    route = _i4_route(M, parts, staged)
    while nt and _i4_smem(nt, nk, parts, route) > _I4_SMEM:
        nt //= 2
    return nt, route, _i4_smem(nt, nk, parts, route) if nt else 0


@functools.lru_cache(maxsize=1024)  # a few shapes a model; called every launch
def int4_gemv_split(M: int, IN: int, OUT: int, parts: int, sms: int = 132,
                    staged: bool = False) -> int:
    """The int4 GEMV's split plan (M <= 32): the blocks C of each cluster,
    which split IN/2 between them. One pass over the rows first (the
    fewest passes at which a block's activations, `parts` bf16 parts, fit);
    then the least waves of clusters (_I4_CLUSTERS at once, scaled to the
    card's `sms` SMs and the blocks an SM: two on the ring routes, one
    staged, _i4_route) times a block's rows plus its fixed cost
    (_I4_BLOCK_COST units); ties go to the smaller C. At most one block a
    16-row unit. Raises ValueError for a shape whose activations fit at no
    split."""
    n16 = IN // 2 // _I4_UNIT
    tiles = -(-OUT // _I4_COLS)
    best = None
    for C in _I4_SPLITS:
        if C > max(1, n16):
            break
        nt = int4_gemv_plan(M, IN, C, parts, staged)[0]
        if not nt:
            continue
        passes = -(-M // (8 * nt))
        per_sm = 1 if _i4_route(M, parts, staged) == 1 else 2
        waves = -(-tiles * passes // max(1, per_sm * _I4_CLUSTERS[C] * sms // 132))
        key = (passes, waves * (-(-n16 // C) + _I4_BLOCK_COST), C)
        best = min(best or key, key)
    if best is None:
        raise ValueError(f"int4 GEMV: the activations of IN = {IN} ({parts} parts) "
                         f"fit no split of up to {_I4_SPLITS[-1]} blocks")
    return best[2]


def _int4_parts(dtype: torch.dtype, fp32_act: bool) -> int:
    """The bf16 parts the int4 GEMV splits its activation into: three in
    fp32 (exact), two for an fp32-valued activation with bf16 outputs (a
    prologue's, or staged x), one for bf16 x as it is."""
    return 3 if dtype == torch.float32 else 2 if fp32_act else 1


def _fused_act(dtype: torch.dtype, silu: bool, has_ln: bool, in_x: int) -> Tuple[int, bool]:
    """K6's activation (csrc/int4_fused.cu's fused_parts): its bf16 parts
    and whether the block stages it (the silu prologue, or x rows not
    16-byte aligned)."""
    staged = silu or in_x % 8 != 0
    return _int4_parts(dtype, staged or has_ln), staged


def _mlp_act(dtype: torch.dtype, H: int, I2: int) -> Tuple[int, bool, bool]:
    """K7's activations (csrc/int4_mlp.cu's mlp_plan): their bf16 parts,
    whether gate_up stages x (rows not 16-byte aligned), and whether down
    stages silu(g) * u with its prologue (I % 16 != 0) instead of copying
    the fragments gate_up's epilogue wrote (the plan gives down one pass
    over its rows wherever that is possible)."""
    return _int4_parts(dtype, True), H % 8 != 0, (I2 // 2) % 16 != 0


@functools.lru_cache(maxsize=1024)  # a few shapes a model; called every launch
def _fused_split(M, in_x, IN, OUT, dtype, silu, has_ln, device) -> int:
    """K6's split on card `device`."""
    parts, staged = _fused_act(dtype, silu, has_ln, in_x)
    return int4_gemv_split(M, IN, OUT, parts, _sm_count(device), staged)


@functools.lru_cache(maxsize=1024)  # a few shapes a model; called every launch
def _mlp_splits(M, H, Hp, I2, Ip, dtype, device) -> Tuple[int, int, int]:
    """K7's two splits on card `device` and its scratch's fp32 words."""
    parts, staged_a, staged_b = _mlp_act(dtype, H, I2)
    sms = _sm_count(device)
    return (int4_gemv_split(M, Hp, I2, parts, sms, staged_a),
            int4_gemv_split(M, Ip, H, parts, sms, staged_b),
            _mlp_act_bytes(M, I2, Ip, parts) // 4)


@functools.lru_cache(maxsize=1024)  # a few shapes a model; called every launch
def dequant_mm_plan(M: int, IN: int, OUT: int, bits: int, sms: int = 132) -> Tuple[int, int]:
    """The prefill regime's plan (M > 32, bf16 activations): (tile, C),
    tile the rows of x a block takes (128 up to M = 128, else 256) and C
    the blocks of a cluster splitting the k walk's stages. C minimises the
    waves of blocks on the card's `sms` SMs times a block's stages (its
    share, plus the split's reduction, _TC_SPLIT_COST int8 stages or half
    as many int4 stages); ties go to the smaller C. On the H100 a sweep of
    both tiles and C from 1 to 8 at M = 80 and 512 (the Mistral-7B shapes,
    both formats; chip_smoke.py's quant phases time the plan against every
    split) put this pick at the fastest in all 16 cases; clusters of 4 and
    more read slower than the model (as some of the int8 GEMV's do), so C
    stops at _TC_MAX_SPLIT."""
    tile = _TC_TILES[0] if M <= _TC_TILES[0] else _TC_TILES[1]
    stages = -(-(IN if bits == 8 else IN // 2) // _TC_STAGE)
    tiles = -(-OUT // _TC_COLS) * -(-M // tile)
    split_cost = _TC_SPLIT_COST * bits / 8

    def cost(C):
        waves = -(-tiles * C // sms)
        return waves * (-(-stages // C) + (split_cost if C > 1 else 0))

    return tile, min(range(1, min(_TC_MAX_SPLIT, stages) + 1), key=cost)


def _launch_matmul(name, x, data, scales, l, group, bits):
    L, IN, OUT = _check_weight(name, x, data, scales, group, bits)
    M = x.shape[0]
    if x.shape[1] != IN:
        raise ValueError(f"{name}: x has {x.shape[1]} columns, the weight "
                         f"{IN} rows (pad x with quant.pad_x_to)")
    if not 0 <= l < L:
        raise ValueError(f"{name}: layer {l} of {L}")
    _check_operands(name, x.device, ("x", x, None), ("data", data, None),
                    ("scales", scales, None))
    from tinygpt_tpu_torch.ops import cuda_build

    source, symbol = _MATMUL_LIBS[bits]
    out = torch.empty((M, OUT), dtype=x.dtype, device=x.device)
    sms = _sm_count(x.device.index or 0)
    if M <= MAX_DECODE_ROWS:
        C = (gemv_split(M, IN, OUT, sms) if bits == 8
             else int4_gemv_split(M, IN, OUT, _int4_parts(x.dtype, False), sms))
        plan = (C, 0)
    else:
        tile, C = dequant_mm_plan(M, IN, OUT, bits, sms)
        plan = (C, tile)
    fn = cuda_build.function(source, symbol, _MATMUL_ARGS)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(data), _ptr(scales), _ptr(out), M, IN, OUT, group, int(l),
                 _DTYPE_CODE[x.dtype], *plan, _stream(x.device))
    cuda_build.check(source, err, name)
    LAUNCHES[name] += 1
    return out


def matmul_dequant_int8(
    x: torch.Tensor,       # [M, IN] bf16/fp32
    data: torch.Tensor,    # [IN, OUT] int8
    scales: torch.Tensor,  # [IN/group, OUT] fp32
    group: int,
) -> torch.Tensor:
    """x @ dequant(int8 weight) → [M, OUT] in x's dtype (K3)."""
    if x.device.type == "cpu":
        return matmul_dequant_int8_plain(x, data, scales, group)
    return _launch_matmul("matmul_dequant_int8", x, data[None], scales[None],
                          0, group, bits=8)


def matmul_dequant_int8_stacked(
    x: torch.Tensor,       # [M, IN]
    data: torch.Tensor,    # [L, IN, OUT] int8
    scales: torch.Tensor,  # [L, IN/group, OUT]
    l: int,                # layer index into the stack
    group: int,
) -> torch.Tensor:
    """x @ dequant(layer l of a stacked int8 weight) (K5a). M <= 32 runs
    the GEMV kernel, larger M the tensor-core kernel (bf16: wgmma, planned
    by dequant_mm_plan)."""
    if x.device.type == "cpu":
        return matmul_dequant_int8_stacked_plain(x, data, scales, l, group)
    return _launch_matmul("matmul_dequant_int8_stacked", x, data, scales, l,
                          group, bits=8)


def matmul_dequant_int4(
    x: torch.Tensor,       # [M, IN] bf16/fp32
    data: torch.Tensor,    # [IN/2, OUT] packed int8
    scales: torch.Tensor,  # [IN/group, OUT] fp32
    group: int,
) -> torch.Tensor:
    """x @ dequant(int4 weight) → [M, OUT] in x's dtype (K4)."""
    if x.device.type == "cpu":
        return matmul_dequant_int4_plain(x, data, scales, group)
    return _launch_matmul("matmul_dequant_int4", x, data[None], scales[None],
                          0, group, bits=4)


def matmul_dequant_int4_stacked(
    x: torch.Tensor,       # [M, IN]
    data: torch.Tensor,    # [L, IN/2, OUT]
    scales: torch.Tensor,  # [L, IN/group, OUT]
    l: int,                # layer index into the stack
    group: int,
) -> torch.Tensor:
    """x @ dequant(layer l of a stacked int4 weight) (K5b). M <= 32 runs
    the GEMV kernel, larger M the tensor-core kernel (bf16: wgmma, planned
    by dequant_mm_plan)."""
    if x.device.type == "cpu":
        return matmul_dequant_int4_stacked_plain(x, data, scales, l, group)
    return _launch_matmul("matmul_dequant_int4_stacked", x, data, scales, l,
                          group, bits=4)


# -- K6 -------------------------------------------------------------------------


def matmul_dequant_int4_stacked_fused(
    x: torch.Tensor,       # [M, IN] (with silu: [M, 2 * IN] = gate || up)
    data: torch.Tensor,    # [L, IN_p/2, OUT], IN_p >= IN (row-padded)
    scales: torch.Tensor,  # [L, IN_p/group, OUT]
    l: int,
    group: int,
    ln: Optional[torch.Tensor] = None,      # [L, IN] or [L, 1, IN], x's dtype
    invrms: Optional[torch.Tensor] = None,  # [M, 1] fp32 per-row 1/rms
    res: Optional[torch.Tensor] = None,     # [M, OUT], x's dtype
    bias: Optional[torch.Tensor] = None,    # [L, OUT] or [L, 1, OUT]
    silu: bool = False,
    rope_cos: Optional[torch.Tensor] = None,  # [M, D] fp32 gathered rows
    rope_sin: Optional[torch.Tensor] = None,
    rope_heads: int = 0,                   # leading heads to rotate (Nq + Nk)
    rope_dim: int = 0,                     # head dim D
    qk_norm_w=None,                        # (q_norm [L, D], k_norm [L, D])
    qk_heads: int = 0,                     # q heads (the q / k norm boundary)
    eps: float = 0.0,
) -> torch.Tensor:
    """The decode-shaped int4 matmul of layer l with its elementwise steps
    fused (K6): prologue x * invrms * ln[l] or silu(gate) * up; epilogue
    + bias[l], per-head qk RMS-norm, RoPE on heads below rope_heads,
    + res. M <= 32; RoPE heads of 32, 64 or 128 columns (a kernel tile
    of 256 columns holds whole heads), not with res."""
    args = (x, data, scales, l, group, ln, invrms, res, bias, silu, rope_cos,
            rope_sin, rope_heads, rope_dim, qk_norm_w, qk_heads, eps)
    if x.device.type == "cpu":
        return matmul_dequant_int4_stacked_fused_plain(*args)
    name = "matmul_dequant_int4_stacked_fused"
    L, IN, OUT = _check_weight(name, x, data, scales, group)
    M = x.shape[0]
    _check_rows(name, M)
    in_x = x.shape[1] // 2 if silu else x.shape[1]
    if in_x > IN or (silu and x.shape[1] % 2):
        raise ValueError(f"{name}: x {tuple(x.shape)} does not fit a weight of "
                         f"{IN} rows")
    if (ln is None) != (invrms is None) or (silu and ln is not None):
        raise ValueError(f"{name}: ln needs invrms, and silu takes no ln")
    ln, bias = _rows(ln, L), _rows(bias, L)
    if ln is not None and ln.shape != (L, in_x):
        raise ValueError(f"{name}: ln {tuple(ln.shape)} != {(L, in_x)}")
    if bias is not None and bias.shape != (L, OUT):
        raise ValueError(f"{name}: bias {tuple(bias.shape)} != {(L, OUT)}")
    if invrms is not None and invrms.numel() != M:
        raise ValueError(f"{name}: invrms has {invrms.numel()} values for {M} rows")
    if res is not None and res.shape != (M, OUT):
        raise ValueError(f"{name}: res {tuple(res.shape)} != {(M, OUT)}")
    rope_cols = qk_cols = 0
    qn = kn = None
    if rope_cos is not None:
        D = rope_dim
        if (D not in _ROPE_DIMS or OUT % D or not 0 < rope_heads * D <= OUT
                or res is not None):
            raise ValueError(f"{name}: RoPE needs a head dim in {_ROPE_DIMS} "
                             f"dividing OUT, 0 < rope_heads * D <= OUT and no res")
        if rope_cos.shape != (M, D) or rope_sin.shape != (M, D):
            raise ValueError(f"{name}: rope rows {tuple(rope_cos.shape)} != {(M, D)}")
        rope_cols = rope_heads * D
        if qk_norm_w is not None:
            qn, kn = (w.reshape(L, -1) for w in qk_norm_w)
            if qn.shape != (L, D) or kn.shape != (L, D):
                raise ValueError(f"{name}: qk norm weights must be [L, {D}]")
            qk_cols = qk_heads * D
    elif qk_norm_w is not None:
        raise ValueError(f"{name}: the fused qk norm rides the RoPE epilogue")
    xt = (x.dtype,)
    _check_operands(
        name, x.device, ("x", x, None), ("data", data, None),
        ("scales", scales, None), ("ln", ln, xt),
        ("invrms", invrms, (torch.float32,)), ("res", res, xt),
        ("bias", bias, xt), ("rope_cos", rope_cos, (torch.float32,)),
        ("rope_sin", rope_sin, (torch.float32,)), ("q_norm", qn, xt),
        ("k_norm", kn, xt))
    if not 0 <= l < L:
        raise ValueError(f"{name}: layer {l} of {L}")
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("int4_fused.cu", "tg_int4_fused", _FUSED_ARGS)
    out = torch.empty((M, OUT), dtype=x.dtype, device=x.device)
    split = _fused_split(M, in_x, IN, OUT, x.dtype, bool(silu), ln is not None,
                         x.get_device())
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(data), _ptr(scales), _opt_ptr(ln), _opt_ptr(invrms),
                 _opt_ptr(res), _opt_ptr(bias), _opt_ptr(rope_cos),
                 _opt_ptr(rope_sin), _opt_ptr(qn), _opt_ptr(kn), _ptr(out),
                 M, in_x, IN, OUT, group, int(l), int(bool(silu)), rope_cols,
                 int(rope_dim), qk_cols, float(eps), _DTYPE_CODE[x.dtype], split,
                 _stream(x.device))
    cuda_build.check("int4_fused.cu", err, name)
    LAUNCHES[name] += 1
    return out


# -- K7 -------------------------------------------------------------------------


def _mlp_act_bytes(M: int, I2: int, Ip: int, parts: int) -> int:
    """Bytes of K7's scratch between its two launches: the fp32 [M, 2I]
    gate || up, or silu(g) * u as `parts` bf16 parts in the down call's
    fragment order (16 Ip parts n-tiles bytes, up to 4 n-tiles), whichever
    the kernel forms (csrc/int4_mlp.cu)."""
    return max(4 * M * I2, 64 * Ip * parts)


def mlp_fused_int4_stacked(
    x: torch.Tensor,          # [M, H] residual stream (post-attention)
    gu_data: torch.Tensor,    # [L, H_p/2, 2I] packed int4
    gu_scales: torch.Tensor,  # [L, H_p/group, 2I]
    dn_data: torch.Tensor,    # [L, I_p/2, H]
    dn_scales: torch.Tensor,  # [L, I_p/group, H]
    ln: torch.Tensor,         # [L, H] or [L, 1, H] post-attention norm weight
    invrms: torch.Tensor,     # [M, 1] fp32 per-row 1/rms of x
    l: int,
    group: int,                # the group of both weights
    residual: bool = True,     # False: no "x +" (a tp rank's partial sum)
) -> torch.Tensor:
    """x + down(silu(g) * u) with [g || u] = gate_up(x * invrms * ln[l]),
    the gate_up activation kept in fp32 (K7); without the "x +" where
    residual is False. M <= 32. On the card one call makes two device
    launches (gate_up, then down) on the stream."""
    if x.device.type == "cpu":
        return mlp_fused_int4_stacked_plain(x, gu_data, gu_scales, dn_data,
                                            dn_scales, ln, invrms, l, group, residual)
    name = "mlp_fused_int4_stacked"
    L, Hp, I2 = _check_weight(name, x, gu_data, gu_scales, group)
    _, Ip, H = _check_weight(name, x, dn_data, dn_scales, group)
    M = x.shape[0]
    _check_rows(name, M)
    ln = _rows(ln, L)
    if (x.shape[1] != H or H > Hp or I2 // 2 > Ip or dn_data.shape[0] != L
            or ln.shape != (L, H) or invrms.numel() != M):
        raise ValueError(f"{name}: shapes x {tuple(x.shape)}, gate_up "
                         f"{tuple(gu_data.shape)}, down {tuple(dn_data.shape)}, "
                         f"ln {tuple(ln.shape)} do not fit")
    if not 0 <= l < L:
        raise ValueError(f"{name}: layer {l} of {L}")
    _check_operands(
        name, x.device, ("x", x, None), ("gu_data", gu_data, None),
        ("gu_scales", gu_scales, None), ("dn_data", dn_data, None),
        ("dn_scales", dn_scales, None), ("ln", ln, (x.dtype,)),
        ("invrms", invrms, (torch.float32,)))
    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("int4_mlp.cu", "tg_int4_mlp", _MLP_ARGS)
    split_a, split_b, words = _mlp_splits(M, H, Hp, I2, Ip, x.dtype, x.get_device())
    act = torch.empty(words, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = fn(_ptr(x), _ptr(gu_data), _ptr(gu_scales), _ptr(dn_data),
                 _ptr(dn_scales), _ptr(ln), _ptr(invrms), _ptr(act), _ptr(out),
                 M, H, Hp, I2, Ip, group, int(l), _DTYPE_CODE[x.dtype], int(residual),
                 split_a, split_b, _stream(x.device))
    cuda_build.check("int4_mlp.cu", err, name)
    LAUNCHES[name] += 1
    return out
