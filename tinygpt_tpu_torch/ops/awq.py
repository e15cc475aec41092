"""AWQ-style activation-aware weight scaling before int4/int8 quantization.

Counterpart of tinygpt_tpu/ops/awq.py (Lin et al., "AWQ: Activation-aware
Weight Quantization"): per-input-channel scales s, chosen from calibration
activation statistics, are folded INTO the weights before quantization
(w' = w * s) and exactly compensated upstream (x' = x / s), so salient
channels get finer quantization grids at no runtime cost: the folded
params quantize to the same layout and run the same kernels.

- Stats: one float prefill over the calibration batch, in fp32, collects
  the per-channel second moments E[x^2] at every quantized-matmul input.
  Its attention is plain softmax attention, as in the JAX package (no
  Pallas kernel is involved there either).
- Search: per layer, the alpha grid minimizing the diagonal proxy
  sum_i m_i * sum_o (dq(w*s)[i,o]/s_i - w[i,o])^2 (m = E[x_i^2]). The JAX
  package's lax.maps over layers and candidates are Python loops here, so
  the fp32 working set stays one (layer, candidate) large: a Mistral-7B
  gate_up layer is 470 MB in fp32.
- Folding is an exact model identity on the float params, up to dtype
  rounding; it writes new stacks and leaves the input params as they are.

Fold map (per layer):
  qkv_w rows    * s  <-> input_ln    / s
  gate_up_w rows* s  <-> post_ln     / s
  down_w rows   * s  <-> up columns  / s   (silu(g) * (u/s) scales the
                                            product linearly)
  o_w rows      * s  <-> v columns   / s   (attention output is linear in
                                            v; s shared across the q heads
                                            of each kv group for GQA)
  lm_head rows  * s  <-> final_ln    / s

MoE (mixtral) fold map: post_ln feeds the router as well as every expert,
so the expert-input scale is one vector shared by the experts of a layer
(search_scales_shared) and is counter-folded into the router too (the
router logits stay the same):
  moe_gate_up_w[e] rows * s  <-> post_ln / s, router_w rows * s
  moe_down_w[e] rows * s_e   <-> expert e's up columns / s_e
                                 (per expert: act_e feeds only expert e)
Expert e's down statistics are its activation's second moments weighted by
the routing mass each token gives it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tinygpt_tpu_torch.ops.moe_kernels import moe_route
from tinygpt_tpu_torch.ops.norms import rms_norm
from tinygpt_tpu_torch.ops.quant import group_quant, quantize_params
from tinygpt_tpu_torch.ops.rope import apply_rope_gathered, gather_rope

# The standard AWQ alpha grid. alpha=0 is the identity (plain RTN), so
# AWQ can never be worse than round-to-nearest under the search proxy.
ALPHA_GRID = (0.0, 0.25, 0.5, 0.75, 1.0)

_MOE_KEYS = ("router_w", "moe_gate_up_w", "moe_down_w")
_DENSE_MLP = ("gate_up_w", "down_w")


def _check_layout(layers) -> bool:
    """True for the MoE layout (router and both expert stacks, no dense
    MLP), False for the dense one; a mix of the two raises."""
    moe = [k in layers for k in _MOE_KEYS]
    dense = [k in layers for k in _DENSE_MLP]
    if all(moe) and not any(dense):
        return True
    if all(dense) and not any(moe):
        return False
    held = sorted(k for k in _MOE_KEYS + _DENSE_MLP if k in layers)
    raise ValueError(f"AWQ: the layers hold {held}: neither the dense MLP {_DENSE_MLP} "
                     f"nor the MoE layout {_MOE_KEYS}")


# -- calibration: per-channel activation second moments ------------------------


def _second_moment(h: torch.Tensor) -> torch.Tensor:
    """[..., C] -> [C]: the mean of h^2 over every leading dim, in fp32."""
    hf = h.float()
    return (hf * hf).reshape(-1, hf.shape[-1]).mean(dim=0)


@torch.inference_mode()
def collect_act_stats(params: Dict, cfg, input_ids) -> Dict[str, torch.Tensor]:
    """One fp32 prefill over the calibration batch [B, S] (numpy or
    tensor); returns the per-channel second moments E[x^2] at each
    quantized-matmul input, on the params' device:

      qkv_in     [L, H]      o_in    [L, Nq*D]
      gate_up_in [L, H]      down_in [L, I]   (MoE: [L, E, I])
      head_in    [H]

    Call it on FLOAT params (before quantize_params). The layer math
    mirrors causal_lm's decoder layer, one layer at a time. A MoE layer's
    gate_up_in is shared by its experts (the router and every expert read
    h); its down_in is per expert, the routing-mass-weighted second moment
    of the expert's activation over the tokens (every expert's SwiGLU runs
    on every token, one expert at a time, as the JAX package's dense
    formulation)."""
    layers = params["layers"]
    is_moe = _check_layout(layers)
    dev = params["embed"].device
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).long()
    B, S = ids.shape
    D = cfg.head_dim
    Nq, Nk = cfg.num_attention_heads, cfg.num_kv_heads
    q_dim = Nq * D
    eps = cfg.rms_norm_eps

    # causal (+ optional sliding window) mask, shared by all layers
    i = torch.arange(S, device=dev)
    mask = i[None, :] <= i[:, None]
    if cfg.sliding_window:
        mask = mask & (i[None, :] > i[:, None] - cfg.sliding_window)
    neg = torch.finfo(torch.float32).min
    rope_c, rope_s = gather_rope(params["rope_cos"], params["rope_sin"],
                                 i[None, :].expand(B, S))

    x = params["embed"][ids].float()
    stats = {k: [] for k in ("qkv_in", "o_in", "gate_up_in", "down_in")}
    for l in range(cfg.num_hidden_layers):
        lp = {k: v[l] for k, v in layers.items()}
        h = rms_norm(x, lp["input_ln"], eps)
        stats["qkv_in"].append(_second_moment(h))
        qkv = h @ lp["qkv_w"].float()
        if "qkv_b" in lp:
            qkv = qkv + lp["qkv_b"].float()
        q = qkv[..., :q_dim].reshape(B, S, Nq, D)
        k = qkv[..., q_dim : q_dim + Nk * D].reshape(B, S, Nk, D)
        v = qkv[..., q_dim + Nk * D :].reshape(B, S, Nk, D)
        if cfg.qk_norm:
            q = rms_norm(q, lp["q_norm"], eps)
            k = rms_norm(k, lp["k_norm"], eps)
        q, k = apply_rope_gathered(q, k, rope_c, rope_s)
        # GQA: kv head h // rep serves q head h
        rep = Nq // Nk
        kq = k.repeat_interleave(rep, dim=2)
        vq = v.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bsnd,btnd->bnst", q, kq) / (D ** 0.5)
        logits = torch.where(mask[None, None], logits, neg)
        attn = torch.einsum("bnst,btnd->bsnd", logits.softmax(dim=-1), vq)
        attn = attn.reshape(B, S, q_dim)
        stats["o_in"].append(_second_moment(attn))
        x = x + attn @ lp["o_w"].float()
        h = rms_norm(x, lp["post_ln"], eps)
        stats["gate_up_in"].append(_second_moment(h))
        if is_moe:
            st_down, out = _moe_stats(h.reshape(B * S, -1), lp, cfg)
            stats["down_in"].append(st_down)
            x = x + out.reshape(x.shape)
            continue
        gate, up = (h @ lp["gate_up_w"].float()).chunk(2, dim=-1)
        act = F.silu(gate) * up
        stats["down_in"].append(_second_moment(act))
        x = x + act @ lp["down_w"].float()
    out = {k: torch.stack(v) for k, v in stats.items()}
    out["head_in"] = _second_moment(rms_norm(x, params["final_ln"], eps))
    return out


def _moe_stats(h: torch.Tensor, lp: Dict, cfg):
    """One MoE layer over tokens h [T, H] in fp32: (down_in [E, I], the
    layer's MLP output [T, H])."""
    E = cfg.num_local_experts
    w_top, idx = moe_route(h, lp["router_w"], cfg.num_experts_per_tok)
    we = torch.zeros((h.shape[0], E), dtype=torch.float32, device=h.device).scatter_add_(
        1, idx, w_top)                                             # [T, E] routing mass
    out = torch.zeros_like(h)
    m_acc = []
    for e in range(E):
        gate, up = (h @ lp["moe_gate_up_w"][e].float()).chunk(2, dim=-1)
        act = F.silu(gate) * up                                    # [T, I]
        out += we[:, e : e + 1] * (act @ lp["moe_down_w"][e].float())
        m_acc.append(we[:, e] @ (act * act))
    st_down = torch.stack(m_acc) / we.sum(dim=0).clamp(min=1e-6)[:, None]
    return st_down, out


# -- alpha grid search ---------------------------------------------------------


def _qdq(w: torch.Tensor, bits: int, g: int) -> torch.Tensor:
    """Quantize-dequantize [in, out] in fp32 through the grid
    quant.quantize_weight uses, without packing."""
    q, scales = group_quant(w, bits, g)
    return (q * scales[:, None, :]).reshape(w.shape)


def _scales_from_alpha(m: torch.Tensor, alpha: float) -> torch.Tensor:
    """s = (a / gmean(a))^alpha with a = sqrt(E[x^2]); normalized so the
    geometric mean is 1 (keeps the folded weights in the same dynamic
    range) and clamped to [1/32, 32]. The mean is the sum times the fp32
    reciprocal of the count, as XLA computes the JAX package's."""
    log_a = torch.log(torch.sqrt(torch.clamp(m.float(), min=1e-12)))
    recip = torch.tensor(1.0 / log_a.shape[-1], dtype=torch.float32, device=m.device)
    s = torch.exp((log_a - log_a.sum() * recip) * alpha)
    return torch.clamp(s, 1.0 / 32.0, 32.0)


@torch.inference_mode()
def search_scales(
    w: torch.Tensor,       # [L, in, out] stacked float weight
    m: torch.Tensor,       # [L, in] activation second moments
    bits: int,
    group_size: int,
    kv_share: Optional[tuple] = None,  # (Nk, G, D): share s across the G
                                       # q heads of each kv group (o_w)
) -> torch.Tensor:
    """Per-layer alpha grid search minimizing the diagonal calibration-MSE
    proxy  sum_i m_i * sum_o (dq(w*s)[i,o]/s_i - w[i,o])^2.  Returns the
    winning s [L, in] in fp32 (alpha=0 -> all-ones, so never worse than
    RTN under the proxy; the first of equal errors wins, as jnp.argmin
    picks it)."""
    in_dim = w.shape[-2]
    g = min(group_size, in_dim)
    if bits == 4:
        g = min(g, in_dim // 2)
    out = torch.empty((w.shape[0], in_dim), dtype=torch.float32, device=w.device)
    for l in range(w.shape[0]):
        wf, m2 = w[l].float(), m[l].float()
        m_eff = m2
        if kv_share is not None:
            # rows are ordered (q_head, d), q head h -> kv head h // G;
            # averaging the stats over each kv group gives every member
            # row the SAME scale
            nk, grp, d = kv_share
            m_eff = m2.reshape(nk, grp, d).mean(dim=1, keepdim=True).expand(
                nk, grp, d).reshape(in_dim)
        best, best_err = None, None
        for alpha in ALPHA_GRID:
            s = _scales_from_alpha(m_eff, alpha)
            e = _qdq(wf * s[:, None], bits, g) / s[:, None] - wf
            err = torch.sum(m2 * torch.sum(e * e, dim=-1))
            if best_err is None or err < best_err:
                best, best_err = s, err
        out[l] = best
    return out


@torch.inference_mode()
def search_scales_shared(
    w: torch.Tensor,       # [L, E, in, out] stacked expert weights
    m: torch.Tensor,       # [L, in] shared activation second moments
    bits: int,
    group_size: int,
) -> torch.Tensor:
    """The alpha grid search for ONE scale vector shared by the E experts
    of a layer (the MoE gate_up fold: the scale is counter-folded into
    post_ln and the router, which every expert shares): the error is the
    sum over the experts of search_scales' proxy, one expert in fp32 at a
    time. Returns s [L, in] in fp32."""
    in_dim = w.shape[-2]
    g = min(group_size, in_dim)
    if bits == 4:
        g = min(g, in_dim // 2)
    out = torch.empty((w.shape[0], in_dim), dtype=torch.float32, device=w.device)
    for l in range(w.shape[0]):
        m2 = m[l].float()
        best, best_err = None, None
        for alpha in ALPHA_GRID:
            s = _scales_from_alpha(m2, alpha)
            errs = []
            for e in range(w.shape[1]):
                wf = w[l, e].float()
                d = _qdq(wf * s[:, None], bits, g) / s[:, None] - wf
                errs.append(torch.sum(m2 * torch.sum(d * d, dim=-1)))
            err = torch.stack(errs).sum()
            if best_err is None or err < best_err:
                best, best_err = s, err
        out[l] = best
    return out


# -- exact-identity folding ----------------------------------------------------


@torch.inference_mode()
def apply_awq(params: Dict, cfg, stats: Dict[str, torch.Tensor], bits: int = 4,
              group_size: int = 128) -> Dict:
    """Return NEW float params with the AWQ scales folded in: the same
    model up to dtype rounding (quantize the result with
    quant.quantize_params to get the benefit). The input params are left
    as they are. Tied-embedding models get an explicit scaled `lm_head`
    (= embed.T * s), so the embedding gather keeps the unscaled table."""
    layers = params["layers"]
    is_moe = _check_layout(layers)
    D = cfg.head_dim
    Nq, Nk = cfg.num_attention_heads, cfg.num_kv_heads
    q_dim, v0 = Nq * D, (Nq + Nk) * D   # v columns of qkv start at v0
    rep = Nq // Nk
    dt = layers["qkv_w"].dtype

    s_qkv = search_scales(layers["qkv_w"], stats["qkv_in"], bits, group_size)
    s_o = search_scales(layers["o_w"], stats["o_in"], bits, group_size,
                        kv_share=(Nk, rep, D))
    if is_moe:
        # one expert-input scale a layer, shared; per-expert down scales
        s_gu = search_scales_shared(layers["moe_gate_up_w"], stats["gate_up_in"], bits,
                                    group_size)                     # [L, H]
        L, E, I, Hd = layers["moe_down_w"].shape
        s_down = search_scales(layers["moe_down_w"].reshape(L * E, I, Hd),
                               stats["down_in"].reshape(L * E, I), bits,
                               group_size).reshape(L, E, I)
    else:
        s_gu = search_scales(layers["gate_up_w"], stats["gate_up_in"], bits, group_size)
        s_down = search_scales(layers["down_w"], stats["down_in"], bits, group_size)
    s_kv = s_o.reshape(-1, Nq, D)[:, ::rep].reshape(-1, Nk * D)   # [L, Nk*D]

    new = dict(layers)
    for k in ("qkv_w", "input_ln", "o_w", "post_ln", "qkv_b") + _DENSE_MLP + _MOE_KEYS:
        if k in layers:
            new[k] = torch.empty_like(layers[k])
    for l in range(cfg.num_hidden_layers):   # one layer in fp32 at a time
        sq, so, sg, sd, skv = s_qkv[l], s_o[l], s_gu[l], s_down[l], s_kv[l]
        # qkv fold: rows * s_qkv, input_ln / s_qkv; v COLUMNS / s_kv
        # (o_w input channel (h, d) is fed by v channel (h // rep, d))
        qkv = layers["qkv_w"][l].float() * sq[:, None]
        qkv[:, v0:] = qkv[:, v0:] / skv[None, :]
        new["qkv_w"][l] = qkv.to(dt)
        new["input_ln"][l] = (layers["input_ln"][l].float() / sq).to(dt)
        if "qkv_b" in layers:
            b = layers["qkv_b"][l].float()   # (the input itself when fp32)
            new["qkv_b"][l] = torch.cat([b[:v0], b[v0:] / skv]).to(dt)
        new["o_w"][l] = (layers["o_w"][l].float() * so[:, None]).to(dt)
        new["post_ln"][l] = (layers["post_ln"][l].float() / sg).to(dt)
        if is_moe:
            # post_ln / sg feeds the router too: its rows scale up by sg
            new["router_w"][l] = (layers["router_w"][l].float() * sg[:, None]).to(dt)
            for e in range(sd.shape[0]):   # one expert in fp32 at a time
                gu = layers["moe_gate_up_w"][l, e].float() * sg[:, None]
                half = gu.shape[-1] // 2
                gu[:, half:] = gu[:, half:] / sd[e][None, :]
                new["moe_gate_up_w"][l, e] = gu.to(dt)
                new["moe_down_w"][l, e] = (layers["moe_down_w"][l, e].float()
                                           * sd[e][:, None]).to(dt)
            continue
        # mlp folds: post_ln <-> gate_up rows; up columns <-> down rows
        gu = layers["gate_up_w"][l].float() * sg[:, None]
        half = gu.shape[-1] // 2
        gu[:, half:] = gu[:, half:] / sd[None, :]
        new["gate_up_w"][l] = gu.to(dt)
        new["down_w"][l] = (layers["down_w"][l].float() * sd[:, None]).to(dt)
    out = dict(params, layers=new)

    head = params.get("lm_head")
    if head is None:
        head = params["embed"].T
    s_head = search_scales(head[None], stats["head_in"][None], bits, group_size)[0]
    out["lm_head"] = (head.float() * s_head[:, None]).to(dt)
    out["final_ln"] = (params["final_ln"].float() / s_head).to(dt)
    return out


# Compact built-in calibration corpus: mixed register English + code +
# numerals, enough signal to expose salient channels when the caller has
# no corpus on hand. Real deployments should pass their own text.
DEFAULT_CALIB_TEXT = (
    "The transformer architecture processes sequences of tokens through "
    "stacked layers of self-attention and feed-forward networks. Each "
    "attention head computes a weighted average over earlier positions; "
    "the weights come from a softmax over scaled dot products.\n"
    "def attention(q, k, v, mask):\n"
    "    scores = q @ k.T / math.sqrt(d)\n"
    "    scores = scores.masked_fill(mask == 0, float('-inf'))\n"
    "    return softmax(scores, dim=-1) @ v\n"
    "In 1868, the first practical typewriter reached production; by 1910 "
    "over two million units had been sold at prices from $60 to $125.\n"
    "for i in range(len(xs)):\n"
    "    total += xs[i] * weights[i % len(weights)]\n"
    "The quick brown fox jumps over the lazy dog. Pack my box with five "
    "dozen liquor jugs. 0 1 2 3 4 5 6 7 8 9 10 42 1729 65536.\n"
    "Les mots français portent des accents: été, naïve, cœur, garçon.\n"
    "SELECT name, COUNT(*) FROM users WHERE active GROUP BY name;\n"
    "E = mc^2; F = ma; PV = nRT; entropy never decreases in a closed "
    "system, and information is physical.\n"
)


def default_calib_ids(tokenizer, n_tokens: int = 2048,
                      path: Optional[str] = None, seq_len: int = 512) -> np.ndarray:
    """Tokenize a calibration corpus into a [B, S] id batch. `path` reads
    a UTF-8 text file; otherwise the built-in sample corpus is repeated
    to length. Returns a numpy int32 array."""
    if path is not None:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    else:
        text = DEFAULT_CALIB_TEXT
    ids = tokenizer.encode(text)
    while len(ids) < n_tokens:
        ids = ids + ids
    ids = ids[:n_tokens]
    S = min(seq_len, len(ids))
    B = max(1, len(ids) // S)
    return np.asarray(ids[: B * S], dtype=np.int32).reshape(B, S)


def awq_policy(awq_flag, bits: int, layers) -> tuple:
    """The single decision point for 'does AWQ apply here': returns
    (awq_on, layout_ok). awq_flag None = auto (on for int4, the JAX
    engine's default); the layout needs the causal_lm keys, dense-MLP or
    MoE. Shared by the engine and the evaluator so the two never quantize
    differently."""
    on = awq_flag if awq_flag is not None else bits == 4
    dense = all(k in layers for k in ("qkv_w", "gate_up_w", "down_w"))
    moe = all(k in layers for k in ("qkv_w",) + _MOE_KEYS)
    return on, dense or moe


def awq_quantize_params(params: Dict, cfg, calib_ids, bits: int = 4,
                        group_size: int = 128,
                        quantize_lm_head: bool = True) -> Dict:
    """Calibrate → fold → quantize, in one call (the engine's and the
    evaluator's entry point)."""
    stats = collect_act_stats(params, cfg, calib_ids)
    folded = apply_awq(params, cfg, stats, bits=bits, group_size=group_size)
    del stats
    return quantize_params(folded, bits=bits, group_size=group_size,
                           quantize_lm_head=quantize_lm_head)
