"""Rotary position embeddings, HF rotate-half convention.

Counterpart of tinygpt_tpu/ops/rope.py. Frequencies (with the Llama-3
scaling) are computed once on the host in float64 numpy and kept as fp32
[max_positions, head_dim] tables on the device; a step gathers its rows.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from tinygpt_tpu_torch.hf.config import RopeScaling


def _llama3_scale_freqs(inv_freq: np.ndarray, scaling: RopeScaling) -> np.ndarray:
    """Llama-3 piecewise frequency scaling (public HF algorithm)."""
    factor = scaling.factor
    low = scaling.low_freq_factor
    high = scaling.high_freq_factor
    orig = scaling.original_max_position_embeddings
    wavelen = 2 * math.pi / inv_freq
    low_wavelen = orig / low
    high_wavelen = orig / high
    out = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
    smooth = (orig / wavelen - low) / (high - low)
    smoothed = (1 - smooth) / factor * inv_freq + smooth * inv_freq
    is_medium = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(is_medium, smoothed, out)


def compute_rope_freqs(
    head_dim: int,
    max_positions: int,
    theta: float = 10000.0,
    scaling: Optional[RopeScaling] = None,
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (cos, sin) tables of shape [max_positions, head_dim] in fp32,
    already duplicated across the two rotate-half halves."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if scaling is not None and scaling.rope_type in ("llama3",):
        inv_freq = _llama3_scale_freqs(inv_freq, scaling)
    t = np.arange(max_positions, dtype=np.float64)
    freqs = np.outer(t, inv_freq)  # [P, D/2]
    emb = np.concatenate([freqs, freqs], axis=-1)  # [P, D]
    return (
        torch.from_numpy(np.cos(emb).astype(np.float32)).to(device),
        torch.from_numpy(np.sin(emb).astype(np.float32)).to(device),
    )


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def gather_rope(
    cos: torch.Tensor,  # [P, D] table
    sin: torch.Tensor,
    positions: torch.Tensor,  # [B, S] absolute positions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the per-position rotation rows once per step ([B, S, 1, D]);
    every layer reuses them through apply_rope_gathered. A position past
    the table takes its last row, as the JAX gather clamps: a paged decode
    quantum may run a row (or an inactive row's stale length) past the
    model's context, and an out-of-range index on the card is a device
    assert that loses the CUDA context."""
    positions = positions.long().clamp(max=cos.shape[0] - 1)
    return cos[positions][:, :, None, :], sin[positions][:, :, None, :]


def apply_rope_gathered(
    q: torch.Tensor,  # [B, S, Nq, D]
    k: torch.Tensor,  # [B, S, Nk, D]
    c: torch.Tensor,  # [B, S, 1, D] gathered rows (gather_rope)
    s: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    qf = q.float()
    kf = k.float()
    q_out = qf * c + _rotate_half(qf) * s
    k_out = kf * c + _rotate_half(kf) * s
    return q_out.to(q.dtype), k_out.to(k.dtype)


def apply_rope(
    q: torch.Tensor,  # [B, S, Nq, D]
    k: torch.Tensor,  # [B, S, Nk, D]
    cos: torch.Tensor,  # [P, D] table
    sin: torch.Tensor,
    positions: torch.Tensor,  # [B, S] absolute positions
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q and k at `positions`: gather_rope, then apply_rope_gathered
    (a model step gathers once and reuses the rows in every layer)."""
    c, s = gather_rope(cos, sin, positions)
    return apply_rope_gathered(q, k, c, s)
