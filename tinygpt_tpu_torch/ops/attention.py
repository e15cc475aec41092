"""Attention over the dense slot cache: plain PyTorch versions and the
dispatch to the Hopper kernels.

Counterpart of tinygpt_tpu/ops/attention.py. `sdpa_with_cache` and
`sdpa_decode_frozen` mask by LOGICAL position (kv_pos / q_pos); they are
the numerics oracles, computed in fp32. The kernel route
(`attention_kernels.flash_prefill` / `flash_decode_frozen`) masks by SLOT,
which agrees with positions on the real rows of a left-padded batch;
`attention_kernels.flash_decode` (K13, one query row) takes the
position mask `decode_mask` computes.
"""

from __future__ import annotations

from typing import Optional

import torch

from tinygpt_tpu_torch.ops.attention_kernels import flash_decode, flash_prefill

NEG_INF = -1e30


def sdpa_with_cache(
    q: torch.Tensor,         # [B, S, Nq, D] (RoPE already applied)
    k_cache: torch.Tensor,   # [B, Nk, T, D] full cache buffer
    v_cache: torch.Tensor,   # [B, Nk, T, D]
    q_pos: torch.Tensor,     # [B, S] logical position of each query token
    kv_pos: torch.Tensor,    # [B, T] logical position of each cache slot
    kv_valid: torch.Tensor,  # [B, T] bool: slot holds a real token
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Grouped-query attention of S query tokens against the cache.

    A query at position p sees key slots with kv_pos <= p and kv_valid;
    with a sliding window w also kv_pos > p - w. A query that sees no slot
    gets the uniform mean (softmax over all-NEG_INF scores), as in the JAX
    oracle. Returns [B, S, Nq, D]."""
    B, S, Nq, D = q.shape
    Nk, T = k_cache.shape[1], k_cache.shape[2]
    G = Nq // Nk
    if scale is None:
        scale = D ** -0.5
    qg = q.float().reshape(B, S, Nk, G, D)
    scores = torch.einsum("bskgd,bktd->bkgst", qg, k_cache.float()) * scale
    t_pos = kv_pos[:, None, :]       # [B, 1, T]
    p = q_pos[:, :, None]            # [B, S, 1]
    mask = t_pos <= p
    if sliding_window is not None:
        mask = mask & (t_pos > p - sliding_window)
    mask = mask & kv_valid[:, None, :]                       # [B, S, T]
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bskgd", probs, v_cache.float())
    return out.reshape(B, S, Nq, D).to(q.dtype)


def sdpa_decode_frozen(
    q: torch.Tensor,         # [B, 1, Nq, D] (RoPE applied)
    k_frozen: torch.Tensor,  # [B, Nk, T, D] cache as of chunk start (FROZEN)
    v_frozen: torch.Tensor,  # [B, Nk, T, D]
    kv_pos: torch.Tensor,    # [B, T] logical position per frozen slot
    kv_valid: torch.Tensor,  # [B, T] frozen-slot validity (chunk start)
    k_infl: torch.Tensor,    # [B, Nk, N, D] in-flight K (this chunk's tokens)
    v_infl: torch.Tensor,    # [B, Nk, N, D]
    step: int,               # index of the CURRENT token in the in-flight
                             # buffer (slots 0..step are real)
    q_pos: torch.Tensor,     # [B, 1]
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Decode attention for a chunk that does not rewrite the big cache:
    one softmax over the frozen slots (logical-position mask) and the
    in-flight slots j <= step (window permitting). Returns [B, 1, Nq, D]."""
    B, _, Nq, D = q.shape
    Nk, T = k_frozen.shape[1], k_frozen.shape[2]
    N = k_infl.shape[2]
    G = Nq // Nk
    if scale is None:
        scale = D ** -0.5
    qg = q.float().reshape(B, Nk, G, D)
    sf = torch.einsum("bkgd,bktd->bkgt", qg, k_frozen.float()) * scale
    si = torch.einsum("bkgd,bkjd->bkgj", qg, k_infl.float()) * scale
    mask_f = (kv_pos <= q_pos) & kv_valid                   # [B, T]
    j = torch.arange(N, device=q.device)
    mask_i = j <= step                                      # [N]
    if sliding_window is not None:
        mask_f = mask_f & (kv_pos > q_pos - sliding_window)
        mask_i = mask_i & ((step - j) < sliding_window)
    sf = sf.masked_fill(~mask_f[:, None, None, :], NEG_INF)
    si = si.masked_fill(~mask_i, NEG_INF)
    probs = torch.softmax(torch.cat([sf, si], dim=-1), dim=-1)
    out = (torch.einsum("bkgt,bktd->bkgd", probs[..., :T], v_frozen.float())
           + torch.einsum("bkgj,bkjd->bkgd", probs[..., T:], v_infl.float()))
    return out.reshape(B, 1, Nq, D).to(q.dtype)


def decode_mask(
    kv_pos: torch.Tensor,    # [B, T] logical position of each cache slot
    kv_valid: torch.Tensor,  # [B, T] bool: slot holds a real token
    q_pos: torch.Tensor,     # [B, 1] logical position of the query
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """The slots a one-token query sees, [B, T] bool: valid, at or before
    its position and, with a window w, after position - w (the mask K13
    takes; sdpa_with_cache's at S == 1)."""
    mask = kv_valid & (kv_pos <= q_pos)
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    return mask


def attention_with_cache(
    q: torch.Tensor,         # [B, S, Nq, D]
    k_cache: torch.Tensor,   # [B, Nk, T, D]
    v_cache: torch.Tensor,   # [B, Nk, T, D]
    q_pos: torch.Tensor,     # [B, S]
    kv_pos: torch.Tensor,    # [B, T]
    kv_valid: torch.Tensor,  # [B, T]
    slot: int,               # slot of the first query row
    scale: Optional[float] = None,
    sliding_window: Optional[int] = None,
    kernel: str = "kernel",  # "kernel" | "plain"
) -> torch.Tensor:
    """Dispatch between the plain oracle and the kernels.

    "kernel" sends S == 1 to flash_decode (K13) under decode_mask, and
    S > 1 to flash_prefill (K1), which takes only a validity byte per slot
    and the slot of the first query row (slot causality equals position
    causality within a left-padded row). Each wrapper runs its kernel on a
    CUDA tensor and its plain version on a CPU tensor."""
    if kernel == "plain":
        return sdpa_with_cache(
            q, k_cache, v_cache, q_pos=q_pos, kv_pos=kv_pos,
            kv_valid=kv_valid, scale=scale, sliding_window=sliding_window,
        )
    if kernel != "kernel":
        raise ValueError(f"unknown attention route {kernel!r}")
    D = q.shape[-1]
    if scale is None:
        scale = D ** -0.5
    if q.shape[1] == 1:
        mask = decode_mask(kv_pos, kv_valid, q_pos, sliding_window)
        return flash_decode(q[:, 0].contiguous(), k_cache, v_cache, mask,
                            scale=scale)[:, None]
    out = flash_prefill(
        q.transpose(1, 2).contiguous(), k_cache, v_cache, kv_valid,
        scale=scale, q_slot=slot, sliding_window=sliding_window,
    )
    return out.transpose(1, 2)
