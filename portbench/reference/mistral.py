"""Plain reference of the Mistral and Mixtral architectures, in float32.

HF semantics (MistralForCausalLM, MixtralForCausalLM): token embedding;
per layer a pre-RMSNorm, fused q/k/v projection, rotate-half RoPE at
theta `rope_theta`, causal GQA attention with softmax scale D^-0.5, the
output projection and the residual; then a post-RMSNorm and a SwiGLU MLP
(gate = the first half of the fused gate/up columns) or, for Mixtral, the
block-sparse MoE (full softmax over the fp32 router logits, top-k,
renormalised, the weighted sum of the chosen experts' SwiGLU) and the
residual; a final RMSNorm and the head. No sliding window (both configs
state none).

It reads the weights as the benchmark made them (weights/mistral.py:
int4 data and scales, bf16 embedding, norms and router) and works out
everything else itself: the int4 unpacking and dequantisation, the rope
tables, every activation, in fp32 with TF32 off. It imports torch alone,
and nothing of the program. Work goes layer by layer over all sequences,
each layer's weights dequantised once, attention a sequence and a block of
queries at a time, so that it fits beside what the run leaves on the card.

With `act_fp8` it is the control (control.py): the same math with every
input of a weight matmul (q/k/v, o, gate/up, down, each expert's, the
head) rounded to fp8 e4m3 at a per-row scale (absmax / 448), the nearest
precision below the bf16 activations the configurations state.
"""

from __future__ import annotations

import torch


def dequant_int4(data: torch.Tensor, scales: torch.Tensor, group: int) -> torch.Tensor:
    """[..., in/2, out] packed int4 and [..., in/group, out] scales -> the
    fp32 weight [..., in, out]: low nibbles are rows 0 .. in/2 - 1, high
    nibbles rows in/2 .. in - 1, each u - 8, times its group's scale."""
    u = data.view(torch.uint8)
    q = torch.cat([(u & 0x0F).float() - 8.0, (u >> 4).float() - 8.0], dim=-2)
    *lead, n_in, n_out = q.shape
    w = q.view(*lead, n_in // group, group, n_out) * scales.float()[..., :, None, :]
    return w.view(*lead, n_in, n_out)


def _fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 at a per-row scale, back in fp32."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope(cfg: dict, n: int, device):
    """cos, sin [n, D] of positions 0 .. n - 1 (rotate-half layout), from
    float64 angles."""
    D = _head_dim(cfg)
    inv = 1.0 / (cfg["rope_theta"] ** (torch.arange(0, D, 2, dtype=torch.float64) / D))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().float().to(device), ang.sin().float().to(device)


def _head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def _rotate(x, cos, sin):
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


def _attention(q, k, v, block: int = 1024):
    """Causal GQA attention of one sequence: q [N, Nq, D], k / v [N, Nk, D]
    -> [N, Nq * D], a block of queries at a time."""
    N, Nq, D = q.shape
    G = Nq // k.shape[1]
    kh = k.repeat_interleave(G, dim=1).transpose(0, 1)          # [Nq, N, D]
    vh = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty((N, Nq, D), dtype=torch.float32, device=q.device)
    pos = torch.arange(N, device=q.device)
    for s0 in range(0, N, block):
        qb = q[s0 : s0 + block].transpose(0, 1)                  # [Nq, b, D]
        s = (qb @ kh[:, : s0 + block].transpose(1, 2)) * D ** -0.5
        mask = pos[None, : s0 + block] > pos[s0 : s0 + block, None]
        s.masked_fill_(mask[None], float("-inf"))
        out[s0 : s0 + block] = (torch.softmax(s, dim=-1) @ vh[:, : s0 + block]).transpose(0, 1)
    return out.reshape(N, Nq * D)


def _swiglu(h, gate_up, down, rq=lambda x: x):
    I = down.shape[0]
    a = rq(h) @ gate_up
    return rq(torch.nn.functional.silu(a[:, :I]) * a[:, I:]) @ down


def _moe(h, router, gate_up_data, gate_up_scales, down_data, down_scales, k, group,
         rq=lambda x: x):
    """Mixtral's sparse MoE over the rows h [T, H], layer's stacks [E, ...]."""
    probs = torch.softmax(h @ router.float(), dim=-1)
    top, idx = torch.topk(probs, k, dim=-1)
    top = top / top.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in torch.unique(idx).tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        y = _swiglu(h[rows], dequant_int4(gate_up_data[e], gate_up_scales[e], group),
                    dequant_int4(down_data[e], down_scales[e], group), rq)
        out.index_add_(0, rows, y * top[rows, slot][:, None])
    return out


@torch.no_grad()
def logits_at(cfg: dict, w: dict, seqs, starts, act_fp8: bool = False):
    """fp32 logits [len(seq) - start, V] of each sequence in `seqs` (lists
    of token ids), at positions start .. len(seq) - 1 of it: what the model
    predicts after each of those tokens. `act_fp8`: the control (module
    docstring)."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _logits_at(cfg, w, seqs, starts, _fp8_rows if act_fp8 else (lambda x: x))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _logits_at(cfg, w, seqs, starts, rq):
    dev = w["embed"].device
    g = w["group"]
    L, V, eps = cfg["num_hidden_layers"], cfg["vocab_size"], cfg["rms_norm_eps"]
    Nq = cfg["num_attention_heads"]
    Nk = cfg.get("num_key_value_heads") or Nq
    D = _head_dim(cfg)
    moe = bool(cfg.get("num_local_experts"))
    ids = [torch.tensor(s, dtype=torch.long, device=dev) for s in seqs]
    lens = [len(s) for s in seqs]
    x = torch.cat([w["embed"][i].float() for i in ids])          # [sum N, H]
    cos, sin = _rope(cfg, max(lens), dev)
    cuts = torch.tensor([0] + lens).cumsum(0).tolist()
    for l in range(L):
        h = _rms_norm(x, w["input_ln"][l], eps)
        qkv = rq(h) @ dequant_int4(w["qkv"][0][l], w["qkv"][1][l], g)
        attn = torch.empty((x.shape[0], Nq * D), dtype=torch.float32, device=dev)
        for a, b in zip(cuts[:-1], cuts[1:]):
            n = b - a
            q = qkv[a:b, : Nq * D].view(n, Nq, D)
            k = qkv[a:b, Nq * D : (Nq + Nk) * D].view(n, Nk, D)
            v = qkv[a:b, (Nq + Nk) * D :].view(n, Nk, D)
            attn[a:b] = _attention(_rotate(q, cos[:n], sin[:n]), _rotate(k, cos[:n], sin[:n]),
                                   v)
        del qkv
        x = x + rq(attn) @ dequant_int4(w["o"][0][l], w["o"][1][l], g)
        h = _rms_norm(x, w["post_ln"][l], eps)
        if moe:
            x = x + _moe(h, w["router"][l], w["moe_gate_up"][0][l], w["moe_gate_up"][1][l],
                         w["moe_down"][0][l], w["moe_down"][1][l],
                         cfg["num_experts_per_tok"], g, rq)
        else:
            x = x + _swiglu(h, dequant_int4(w["gate_up"][0][l], w["gate_up"][1][l], g),
                            dequant_int4(w["down"][0][l], w["down"][1][l], g), rq)
    head = dequant_int4(w["head"][0], w["head"][1], g)[:, :V]
    out = []
    for a, n, s0 in zip(cuts[:-1], lens, starts):
        out.append(rq(_rms_norm(x[a + s0 : a + n], w["final_ln"], eps)) @ head)
    return out
