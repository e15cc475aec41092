"""Weight-only quantization: INT8 / INT4 with per-group scales, and the
dequant-matmul entry points the model layers call.

Counterpart of tinygpt_tpu/ops/quant.py, with the same layout byte for
byte. Weights are stored [in, out]; quantization groups run along `in`
(the contraction dim):

  data   int8  [in, out]             (int4: two biased nibbles a byte,
                                      [in/2, out], see pack_int4)
  scales fp32  [in/group, out]
  dequant: w[i, o] = q[i, o] * scales[i // group, o]

Stacked layer weights carry a leading [L] axis on both arrays, MoE
expert stacks [L, E] (ops/moe_kernels.py runs them). The
matmuls run the Hopper kernels of ops/quant_kernels.py (int8: K3, K5a;
int4: K4, K5b) on a CUDA tensor, or their plain versions (on a CPU
tensor, or when the caller asks for the plain route).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from tinygpt_tpu_torch.ops import quant_kernels as qk
from tinygpt_tpu_torch.ops.quant_kernels import dequant_fp32, unpack_int4
from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("quant")


class QuantizedTensor:
    """A quantized [in, out] weight, or a stack of them ([L, ...] on both
    arrays). `in_dim` is the (possibly row-padded) contraction dim."""

    def __init__(self, data: torch.Tensor, scales: torch.Tensor, bits: int,
                 group_size: int, in_dim: int):
        self.data = data          # int8 [..., in, out] or packed [..., in/2, out]
        self.scales = scales      # fp32 [..., in/group, out]
        self.bits = bits
        self.group_size = group_size
        self.in_dim = in_dim

    @property
    def out_dim(self) -> int:
        return self.data.shape[-1]

    @property
    def shape(self):
        return (self.in_dim, self.out_dim)

    def __repr__(self):
        return (f"QuantizedTensor(int{self.bits}, {self.shape}, "
                f"group={self.group_size})")


def pack_int4(q: np.ndarray) -> np.ndarray:
    """Pack int4 values in [-8, 7] along axis 0, HALF-SPLIT and BIASED:
    values are stored as u = q + 8 in [0, 15]; packed row p holds
    original row p in the low nibble and row p + in/2 in the high
    nibble."""
    if q.shape[0] % 2:
        raise ValueError(f"pack_int4: {q.shape[0]} rows, want an even count")
    half = q.shape[0] // 2
    u = (q.astype(np.int16) + 8).astype(np.uint8)
    return ((u[:half] & 0x0F) | (u[half:] << 4)).astype(np.int8)


def _pack_int4_torch(q: torch.Tensor) -> torch.Tensor:
    """pack_int4 on the tensor's device, along axis -2."""
    half = q.shape[-2] // 2
    u = (q.to(torch.int16) + 8).to(torch.uint8)
    return ((u[..., :half, :] & 0x0F) | (u[..., half:, :] << 4)).view(torch.int8)


def group_quant(w: torch.Tensor, bits: int, g: int):
    """Symmetric per-group quantization of one [in, out] weight in fp32:
    scale = absmax / qmax (1e-8 for an all-zero group), q = round half to
    even of w / scale, clipped to [-qmax-1, qmax]. The scale is absmax
    times the fp32 reciprocal of qmax: XLA computes the JAX package's
    absmax / qmax that way, and the bytes must be the same. Returns q as
    fp32 integers [in/g, g, out] and the scales [in/g, out]."""
    in_dim, out_dim = w.shape
    qmax = 127.0 if bits == 8 else 7.0
    wg = w.to(torch.float32).reshape(in_dim // g, g, out_dim)
    absmax = wg.abs().amax(dim=1)                            # [in/g, out]
    recip = torch.tensor(1.0 / qmax, dtype=torch.float32, device=w.device)
    scales = torch.where(absmax == 0, torch.full_like(absmax, 1e-8),
                         absmax * recip)
    q = torch.clamp(torch.round(wg / scales[:, None, :]), -qmax - 1, qmax)
    return q, scales


def _quantize_2d(w: torch.Tensor, bits: int, g: int):
    q, scales = group_quant(w, bits, g)
    q = q.to(torch.int8).reshape(w.shape)
    return (_pack_int4_torch(q) if bits == 4 else q), scales


def quantize_weight(w, bits: int = 8,
                    group_size: Optional[int] = None) -> QuantizedTensor:
    """Symmetric per-group (per-channel when group_size is None)
    quantization of w [in, out] or [L, in, out] (a tensor, on any device,
    or a numpy array), one layer at a time so the fp32 working set stays
    one layer large.

    int4 contraction dims whose half is not a multiple of 128 (H=896 →
    448 packed rows) are zero-padded to the next multiple of 256, as the
    JAX package does; `in_dim` reports the padded dim, and the matmuls
    pad x with zeros to match, so pad rows contribute exactly 0."""
    if bits not in (8, 4):
        raise ValueError(f"quantize_weight: {bits} bits, want 8 or 4")
    if isinstance(w, np.ndarray):
        w = torch.from_numpy(np.ascontiguousarray(w))
    in_dim, out_dim = w.shape[-2], w.shape[-1]
    if bits == 4 and (in_dim // 2) % 128:
        in_p = -(-in_dim // 256) * 256
        pad = torch.zeros((*w.shape[:-2], in_p - in_dim, out_dim),
                          dtype=w.dtype, device=w.device)
        w = torch.cat([w, pad], dim=-2)
        in_dim = in_p
    g = min(group_size or in_dim, in_dim)
    if bits == 4:
        g = min(g, in_dim // 2)  # whole groups inside each nibble plane
    if in_dim % g:
        raise ValueError(f"in_dim {in_dim} not divisible by group {g}")
    if w.ndim == 2:
        data, scales = _quantize_2d(w, bits, g)
    else:
        rows = in_dim // 2 if bits == 4 else in_dim
        data = torch.empty((w.shape[0], rows, out_dim), dtype=torch.int8,
                           device=w.device)
        scales = torch.empty((w.shape[0], in_dim // g, out_dim),
                             dtype=torch.float32, device=w.device)
        for i in range(w.shape[0]):
            data[i], scales[i] = _quantize_2d(w[i], bits, g)
    return QuantizedTensor(data, scales, bits=bits, group_size=g, in_dim=in_dim)


def dequantize(qt: QuantizedTensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Full dequantization in fp32, cast to `dtype` (tests and plain
    routes). Any leading dims."""
    data = qt.data if qt.bits == 8 else unpack_int4(qt.data)
    return dequant_fp32(data, qt.scales, qt.group_size).to(dtype)


def pad_x_to(x2: torch.Tensor, in_dim: int) -> torch.Tensor:
    """Zero-pad activations to a quantized weight's (row-padded)
    contraction dim; the pad rows of the weight are zero."""
    pad = in_dim - x2.shape[-1]
    if not pad:
        return x2
    return torch.nn.functional.pad(x2, (0, pad))


# bits -> (kernel wrapper, its plain version), 2-D and stacked
_MATMUL = {8: (qk.matmul_dequant_int8, qk.matmul_dequant_int8_plain),
           4: (qk.matmul_dequant_int4, qk.matmul_dequant_int4_plain)}
_MATMUL_STACKED = {
    8: (qk.matmul_dequant_int8_stacked, qk.matmul_dequant_int8_stacked_plain),
    4: (qk.matmul_dequant_int4_stacked, qk.matmul_dequant_int4_stacked_plain)}


def matmul_dequant(x: torch.Tensor, qt: QuantizedTensor,
                   impl: str = "kernel") -> torch.Tensor:
    """x [..., in] @ dequant(qt) → [..., out] in x's dtype, through K3
    (matmul_dequant_int8) or K4 (matmul_dequant_int4). impl="plain" runs
    the plain version."""
    lead = x.shape[:-1]
    x2 = pad_x_to(x.reshape(-1, x.shape[-1]), qt.in_dim).contiguous()
    kernel, plain = _MATMUL[qt.bits]
    fn = plain if impl == "plain" else kernel
    out = fn(x2, qt.data, qt.scales, qt.group_size)
    return out.reshape(*lead, qt.out_dim)


def matmul_any(x: torch.Tensor, w, impl: str = "kernel") -> torch.Tensor:
    """Matmul against a plain tensor or a QuantizedTensor."""
    if isinstance(w, QuantizedTensor):
        return matmul_dequant(x, w, impl)
    return x @ w


def matmul_dequant_stacked(x: torch.Tensor, qt: QuantizedTensor, l: int,
                           impl: str = "kernel") -> torch.Tensor:
    """x [..., in] @ dequant(qt[l]) for a stacked [L, in, out] weight,
    through K5a (matmul_dequant_int8_stacked) or K5b
    (matmul_dequant_int4_stacked). The layer is an offset into the stack:
    no layer's bytes are copied."""
    lead = x.shape[:-1]
    x2 = pad_x_to(x.reshape(-1, x.shape[-1]), qt.in_dim).contiguous()
    kernel, plain = _MATMUL_STACKED[qt.bits]
    fn = plain if impl == "plain" else kernel
    out = fn(x2, qt.data, qt.scales, l, qt.group_size)
    return out.reshape(*lead, qt.out_dim)


# -- whole-model quantization --------------------------------------------------

# stacked per-layer matmul weights ([L, in, out]) that are quantized: the
# llama family's and GPT-2's (qkv_w, o_w, fc_w, proj_w)
_QUANT_KEYS = {"qkv_w", "o_w", "gate_up_w", "down_w", "fc_w", "proj_w"}
# MoE expert stacks ([L, E, in, out]): quantized over the flattened
# [L*E, in, out] form (groups run along `in`, so expert by expert) and
# reshaped back, so the gathered kernels index (layer, expert)
_QUANT_MOE_KEYS = {"moe_gate_up_w", "moe_down_w"}
HEAD_PAD_MULTIPLE = 2048


def _quantize_moe_stacked(w: torch.Tensor, bits: int,
                          group_size: Optional[int]) -> QuantizedTensor:
    L, E, in_dim, out_dim = w.shape
    qt = quantize_weight(w.reshape(L * E, in_dim, out_dim), bits=bits,
                         group_size=group_size)
    # qt.in_dim, not the caller's: a row-padded int4 stack reports its pad
    return QuantizedTensor(qt.data.reshape(L, E, -1, out_dim),
                           qt.scales.reshape(L, E, -1, out_dim), qt.bits,
                           qt.group_size, qt.in_dim)


def pad_head_out(w: torch.Tensor) -> torch.Tensor:
    """Zero-pad the lm_head's OUT (vocab) dim to a multiple of 2048 before
    quantization, as the JAX package lays it out. Zero columns stay exact
    zeros (q = 0 under the +8 bias, scale 1e-8), and every head path
    slices [..., :vocab_size] after the matmul."""
    pad = -w.shape[-1] % HEAD_PAD_MULTIPLE
    if not pad:
        return w
    return torch.nn.functional.pad(w, (0, pad))


def quantize_params(params: Dict, bits: int = 8,
                    group_size: Optional[int] = 128,
                    quantize_lm_head: bool = True) -> Dict:
    """Weight-only quantization of a params dict (causal_lm or gpt2
    layout). Norms, biases, embeddings and rope tables stay in float. With
    tied embeddings (an `embed` table and no lm_head) the head becomes a
    quantized TRANSPOSED copy of the embedding table; the float table stays
    for the embedding gather. GPT-2's tied head (x @ wte.T) stays in float,
    as in the JAX package. quantize_lm_head=False leaves the head as it is
    (None when tied).

    MoE expert stacks (moe_gate_up_w, moe_down_w) quantize expert by
    expert into [L, E, rows, out] stacks. At int4, an expert stack whose
    contraction dim has (in/2) % 128 != 0 is quantized at int8 instead, as
    the JAX package does (its gathered int4 kernel takes no row padding
    there), so that the same params quantize to the same bytes in both
    packages."""
    out = dict(params)
    layers = dict(params["layers"])
    for key, w in layers.items():
        if key in _QUANT_KEYS:
            layers[key] = quantize_weight(w, bits=bits, group_size=group_size)
        elif key in _QUANT_MOE_KEYS:
            moe_bits = 8 if bits == 4 and (w.shape[-2] // 2) % 128 else bits
            if moe_bits != bits:
                log.warning("MoE expert stack %s: contraction dim %d is not a multiple "
                            "of 256, quantized at int8 (as the JAX package does)",
                            key, w.shape[-2])
            layers[key] = _quantize_moe_stacked(w, moe_bits, group_size)
    out["layers"] = layers
    head = params.get("lm_head")
    if head is None and "embed" in params:
        head = params["embed"].T
    if quantize_lm_head and head is not None:
        out["lm_head"] = quantize_weight(pad_head_out(head), bits=bits,
                                         group_size=group_size)
    return out
