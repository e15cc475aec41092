"""Int4 matrices drawn on the device from a generator, in the form the
program serves them: each matrix of a stack is `data` int8 [..., in/2,
out], two biased nibbles a byte (u = q + 8; packed row p holds row p in
the low nibble and row p + in/2 in the high one), and `scales` fp32
[..., in/group, out]; w = q * scale. q is uniform over -7..7 and a scale
0.02 / sqrt(E[q^2]) * U(0.5, 1.5), so a weight has a standard deviation of
about 0.02, as a trained model's initialisation has. Shared by the weight
modules of every family."""

from __future__ import annotations

import math

import torch

HEAD_PAD = 2048   # a head's vocabulary is padded to a multiple of this
ZERO = -120       # 0x88: both nibbles q = 0
_Q_RMS = math.sqrt(sum(q * q for q in range(-7, 8)) / 15)   # E[q^2] of U{-7..7}


def int4_stack(gen, lead, in_dim, out_dim, group, device):
    """(data, scales) of a stack of int4 [in, out] matrices, drawn a
    leading index at a time."""
    if in_dim % 2 or in_dim % group:
        raise ValueError(f"in_dim {in_dim}: want even and a multiple of {group}")
    data = torch.empty((*lead, in_dim // 2, out_dim), dtype=torch.int8, device=device)
    scales = torch.empty((*lead, in_dim // group, out_dim), dtype=torch.float32,
                         device=device)
    flat_d = data.view(-1, in_dim // 2, out_dim)
    flat_s = scales.view(-1, in_dim // group, out_dim)
    base = 0.02 / _Q_RMS
    for i in range(flat_d.shape[0]):
        lo = torch.randint(1, 16, (in_dim // 2, out_dim), generator=gen, device=device,
                           dtype=torch.uint8)
        hi = torch.randint(1, 16, (in_dim // 2, out_dim), generator=gen, device=device,
                           dtype=torch.uint8)
        flat_d[i] = (lo | (hi << 4)).view(torch.int8)
        del lo, hi
        flat_s[i] = base * (0.5 + torch.rand((in_dim // group, out_dim), generator=gen,
                                             device=device))
    return data, scales


def padded_head(gen, in_dim, vocab, group, device):
    """An int4 head [in, vocab] with its vocabulary padded by zero columns
    (q = 0, scale 1e-8) to a multiple of HEAD_PAD."""
    data, scales = int4_stack(gen, (), in_dim, vocab, group, device)
    pad = -vocab % HEAD_PAD
    if pad:
        data = torch.nn.functional.pad(data, (0, pad), value=ZERO)
        scales = torch.nn.functional.pad(scales, (0, pad), value=1e-8)
    return data, scales
