"""Sampling: greedy / temperature / top-k / top-p / min-p.

Counterpart of tinygpt_tpu/ops/sampling.py: greedy argmax when no knob is
set; otherwise temperature-scale → top-k → top-p (always keeping the top-1
token) → min-p (threshold = max_prob · min_p) → categorical draw. The
draw takes an explicit `torch.Generator` (on the logits' device), so a
seeded engine is reproducible; it does not reproduce jax.random's bits.
`sample_batched` takes the knobs per row, as tensors, for the continuous
batcher, whose decode step mixes requests with different settings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -1e30


@dataclass(frozen=True)
class SamplerConfig:
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None

    @property
    def is_greedy(self) -> bool:
        """No knob set → greedy argmax; temperature == 0 is also greedy."""
        return (
            (self.temperature is None or self.temperature == 0.0)
            and self.top_k is None
            and self.top_p is None
            and self.min_p is None
        ) or self.temperature == 0.0


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit."""
    k = max(1, min(k, logits.shape[-1]))
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus: keep the smallest prefix of descending-prob tokens whose
    cumulative probability reaches p; the top-1 token always survives."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # drop a token if the cumulative mass BEFORE it already reached p
    keep_sorted = (cum - probs) < p
    keep_sorted[..., 0] = True
    # threshold logit = smallest kept logit
    kth = torch.where(keep_sorted, sorted_logits, torch.inf).amin(
        dim=-1, keepdim=True)
    return torch.where(logits < kth, NEG_INF, logits)


def apply_min_p(logits: torch.Tensor, min_p: float) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1)
    threshold = probs.amax(dim=-1, keepdim=True) * min_p
    return torch.where(probs < threshold, NEG_INF, logits)


def masked_logits(logits: torch.Tensor, cfg: SamplerConfig) -> torch.Tensor:
    """The processed sampling distribution as logits: temperature-scaled,
    with the top-k / top-p / min-p losers at NEG_INF."""
    if cfg.temperature is not None and cfg.temperature > 0:
        logits = logits / cfg.temperature
    if cfg.top_k is not None and cfg.top_k > 0:
        logits = apply_top_k(logits, cfg.top_k)
    if cfg.top_p is not None and 0 < cfg.top_p < 1.0:
        logits = apply_top_p(logits, cfg.top_p)
    if cfg.min_p is not None and cfg.min_p > 0:
        logits = apply_min_p(logits, cfg.min_p)
    return logits


def sample(
    logits: torch.Tensor,  # [B, V] fp32
    cfg: SamplerConfig,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Returns sampled token ids [B] (int32) on the logits' device."""
    if cfg.is_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("stochastic sampling requires a torch.Generator")
    probs = torch.softmax(masked_logits(logits.float(), cfg), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def masked_logits_batched(
    logits: torch.Tensor,       # [B, V] fp32
    temperature: torch.Tensor,  # [B] — <= 0 treated as 1.0 here (the caller
                                # routes greedy rows to argmax)
    top_k: torch.Tensor,        # [B] int32 — 0 ⇒ disabled
    top_p: torch.Tensor,        # [B] — 1.0 ⇒ disabled
    min_p: torch.Tensor,        # [B] — 0.0 ⇒ disabled
) -> torch.Tensor:
    """Each row's processed sampling distribution as masked logits:
    temperature-scaled, with the top-k / top-p / min-p losers at NEG_INF.
    One descending sort; every knob becomes a value threshold on it (the
    tie semantics of apply_top_k / apply_top_p)."""
    V = logits.shape[-1]
    t = torch.where(temperature <= 0, 1.0, temperature)[:, None]
    scaled = logits / t
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values

    # top-k threshold: the k-th largest value (k == 0 disables)
    k_eff = torch.where(top_k <= 0, V, top_k).clamp(1, V)
    kth_k = sorted_desc.gather(-1, (k_eff - 1)[:, None].long())

    # top-p threshold: the smallest value whose preceding cumulative mass
    # is still below p (rank 0 always kept)
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = (cum - probs_sorted) < top_p[:, None]
    keep_sorted[:, 0] = True
    kth_p = torch.where(keep_sorted, sorted_desc, torch.inf).amin(
        dim=-1, keepdim=True)

    # min-p threshold in probability space
    probs = torch.softmax(scaled, dim=-1)
    thr_min = probs.amax(dim=-1, keepdim=True) * min_p[:, None]

    keep = (scaled >= kth_k) & (scaled >= kth_p) & (probs >= thr_min)
    return torch.where(keep, scaled, NEG_INF)


def sample_batched(
    logits: torch.Tensor,       # [B, V] fp32
    temperature: torch.Tensor,  # [B] — 0 ⇒ greedy for that row
    top_k: torch.Tensor,        # [B] int32 — 0 ⇒ disabled
    top_p: torch.Tensor,        # [B] — 1.0 ⇒ disabled
    min_p: torch.Tensor,        # [B] — 0.0 ⇒ disabled
    generator: torch.Generator,
) -> torch.Tensor:
    """Per-row sampling knobs in one call. Returns token ids [B] int32 on
    the logits' device; rows with temperature <= 0 take the argmax."""
    logits = logits.float()
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    masked = masked_logits_batched(logits, temperature, top_k, top_p, min_p)
    sampled = torch.multinomial(torch.softmax(masked, dim=-1), 1,
                                generator=generator)[:, 0].to(torch.int32)
    return torch.where(temperature <= 0, greedy_tok, sampled)
