"""Generic CausalLM for the HF-Llama family (llama / qwen2 / qwen3 /
mistral / mixtral).

Counterpart of tinygpt_tpu/models/causal_lm.py: embed → N pre-norm decoder
layers (fused QKV matmul, RoPE, GQA attention over the KV cache, fused
gate-up SwiGLU, or mixtral's routed mixture of SwiGLU experts) → RMSNorm →
lm_head, with tied embeddings, qkv bias (qwen2), per-head q/k RMSNorm
(qwen3), explicit head_dim (qwen3), Llama-3 rope scaling and
sliding-window masking (mistral).

Params are a plain dict with the JAX package's layout, so the two can be
held against each other key by key: layers STACKED along a leading [L]
axis, weights as [in, out], q/k/v and gate/up fused at load:

    embed [V, H]; final_ln [H]; lm_head [H, V] or None (tied to embed);
    rope_cos / rope_sin [P, D] fp32;
    layers: input_ln [L, H], qkv_w [L, H, (Nq+2Nk)·D], qkv_b (qwen2),
            q_norm / k_norm [L, D] (qwen3), o_w [L, Nq·D, H], post_ln,
            gate_up_w [L, H, 2I], down_w [L, I, H]; mixtral instead
            router_w [L, H, E], moe_gate_up_w [L, E, H, 2I],
            moe_down_w [L, E, I, H].

PyTorch runs eagerly, so the JAX layer scan is a Python loop over layers
and the chunked decode a Python loop over steps. Attention goes through
the Hopper kernels (ops/attention_kernels.py) under attn_impl="kernel",
or through the plain position-masked oracles under "plain". The KV cache
is updated in place (engine/kv_cache.py).

Weight-only params (ops/quant.quantize_params) run the kernels of
ops/quant_kernels.py. int4: in `forward` every layer matmul goes through
K5b and the lm_head through K4; `decode_steps` takes the fused route (K6
for qkv with the norm prologue and the RoPE / qk-norm epilogue, for o
with the residual and for the head with the final norm; K7 for the MLP)
when all four layer matrices are int4, as the JAX package does. int8:
every layer matmul goes through K5a and the head through K3, in `forward`
and in decode alike (the unfused route). A float head beside quantized
layers (quantize_lm_head=False) stays a plain matmul. The layer is an
offset into the [L, ...] stacks. attn_impl="plain" runs the plain
version of every kernel instead.

`decode_paged_steps` is the continuous batcher's decode quantum over the
paged KV pool (engine/paged_kv.py): the same layer loop as decode_steps,
with attention through the block tables (K8, ops/paged_attention.py).
`forward_paged` is one whole decode step over the pool, each layer
writing its K/V into the pool before attention (K9): the batcher's
stepwise quantum. `decode_paged_spec_steps` is its speculative quantum:
rounds of n-gram drafting and an S-position verify forward (attention
through K10), with greedy prefix acceptance or exact rejection sampling.

`decode_step` is one decode step written straight into the dense cache,
attention through K13 (flash_decode) under one mask a step: the streaming
engine's per-token route.

The four one-token loops (decode_steps, decode_step, decode_paged_steps,
forward_paged) are shared with GPT-2 (models/gpt2.py): run_decode_steps,
run_decode_step, run_decode_paged_steps and run_forward_paged take the
family's token function, decode_token(params, cfg, tok, pos, put_kv,
attend, impl) -> logits [B, 1, V], which hands each layer's new K/V to
put_kv and attends through attend.

The KV cache and the pools may be fp8 (torch.float8_e4m3fn): K/V are cast
once as they are written (engine/kv_cache.kv_cast), the in-flight buffers
of the chunked loops stay bf16 until the merge or scatter, and attention
decodes the e4m3 slots (K1, K2, K8, K9, K10 and K13 each take them).

The MoE MLP (mixtral, HF semantics: full softmax over the router logits,
top-k, renormalized): `forward` and the verify forward of the speculative
quantum run `moe_mlp` on layer l's experts, dequantized to bf16 when
quantized, as the JAX package does (dense below 32 tokens, else routed:
tokens sorted by expert, one torch.matmul per expert's group). The
one-token step (decode_steps, decode_step, decode_paged_steps,
forward_paged) runs ops/moe_kernels.moe_mlp_gathered on the whole expert stacks at layer l:
K12 for bf16 stacks, K11a for int8, K11b for int4, on the card for all
three dtypes (the JAX package sends bf16 stacks to the dense formulation at
decode, after a TPU measurement that does not carry over). Quantized
mixtral params take the unfused route (no gate_up_w): K5b / K5a for qkv
and o, K4 / K3 for the head.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tinygpt_tpu_torch.engine.kv_cache import KVCache, kv_cast
from tinygpt_tpu_torch.engine.paged_kv import PagedKVState
from tinygpt_tpu_torch.hf.config import ModelConfig
from tinygpt_tpu_torch.ops.attention import (
    attention_with_cache,
    decode_mask,
    sdpa_decode_frozen,
    sdpa_with_cache,
)
from tinygpt_tpu_torch.ops.attention_kernels import flash_decode, flash_decode_frozen
from tinygpt_tpu_torch.ops.paged_attention import (
    paged_decode,
    paged_decode_frozen,
    paged_decode_frozen_plain,
    paged_decode_spec,
    paged_decode_spec_plain,
)
from tinygpt_tpu_torch.ops import quant_kernels as qk
from tinygpt_tpu_torch.ops.moe_kernels import moe_mlp_gathered, moe_route
from tinygpt_tpu_torch.ops.norms import rms_norm
from tinygpt_tpu_torch.ops.quant import (
    QuantizedTensor,
    dequantize,
    matmul_dequant,
    matmul_dequant_stacked,
)
from tinygpt_tpu_torch.ops.rope import (
    apply_rope_gathered,
    compute_rope_freqs,
    gather_rope,
)
from tinygpt_tpu_torch.ops.sampling import NEG_INF, masked_logits_batched
from tinygpt_tpu_torch.parallel.distributed import all_gather, all_reduce
from tinygpt_tpu_torch.utils.profiler import span


def _check_weights(params: Dict) -> None:
    """Every layer weight and the head: a tensor, or int8 / int4."""
    weights = dict(params["layers"], lm_head=params.get("lm_head"))
    for k, v in weights.items():
        if isinstance(v, QuantizedTensor) and v.bits not in (8, 4):
            raise ValueError(f"int{v.bits} weight {k!r}: int8 or int4 only")
        if not (v is None or isinstance(v, (torch.Tensor, QuantizedTensor))):
            raise TypeError(f"weight {k!r} of type {type(v).__name__}")


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    D = cfg.head_dim
    Nq, Nk = cfg.num_attention_heads, cfg.num_kv_heads
    H, I, E = cfg.hidden_size, cfg.intermediate_size, cfg.num_local_experts
    shapes = {
        "input_ln": (H,),
        "qkv_w": (H, (Nq + 2 * Nk) * D),
        "o_w": (Nq * D, H),
        "post_ln": (H,),
    }
    if E:  # mixtral: router and stacked experts
        shapes.update(router_w=(H, E), moe_gate_up_w=(E, H, 2 * I), moe_down_w=(E, I, H))
    else:
        shapes.update(gate_up_w=(H, 2 * I), down_w=(I, H))
    if cfg.qkv_bias or cfg.attention_bias:
        shapes["qkv_b"] = ((Nq + 2 * Nk) * D,)
    if cfg.qk_norm:
        shapes["q_norm"] = (D,)
        shapes["k_norm"] = (D,)
    return shapes


def _rope_tables(cfg: ModelConfig, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return compute_rope_freqs(cfg.head_dim, cfg.max_position_embeddings,
                              cfg.rope_theta, cfg.rope_scaling, device=device)


def load_params(
    cfg: ModelConfig,
    weights: Dict[str, torch.Tensor],
    dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
) -> Dict:
    """Map HF safetensors names into the stacked-layer params dict.

    HF names: model.embed_tokens, model.layers.{i}.self_attn.{q,k,v,o}_proj,
    .mlp.{gate,up,down}_proj (mixtral: .block_sparse_moe.gate and
    .block_sparse_moe.experts.{e}.w1 / w3 / w2, fused as gate || up per
    expert), .input_layernorm, .post_attention_layernorm, model.norm,
    lm_head. Each tensor is uploaded as its raw bytes and transposed, fused
    and cast on the device, one layer at a time."""
    L, E = cfg.num_hidden_layers, cfg.num_local_experts
    has_bias = bool(cfg.qkv_bias or cfg.attention_bias)

    def g(name: str) -> torch.Tensor:
        if name not in weights:
            raise KeyError(f"missing weight {name!r}")
        return weights[name].to(device)

    layers = {k: torch.empty((L, *s), dtype=dtype, device=device)
              for k, s in _layer_shapes(cfg).items()}
    for i in range(L):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        layers["input_ln"][i] = g(p + "input_layernorm.weight")
        layers["qkv_w"][i] = torch.cat(
            [g(a + f"{n}_proj.weight").T for n in "qkv"], dim=1)
        layers["o_w"][i] = g(a + "o_proj.weight").T
        layers["post_ln"][i] = g(p + "post_attention_layernorm.weight")
        if E:
            m = p + "block_sparse_moe."
            layers["router_w"][i] = g(m + "gate.weight").T
            for e in range(E):
                x = f"{m}experts.{e}."
                layers["moe_gate_up_w"][i, e] = torch.cat(
                    [g(x + "w1.weight").T, g(x + "w3.weight").T], dim=1)
                layers["moe_down_w"][i, e] = g(x + "w2.weight").T
        else:
            layers["gate_up_w"][i] = torch.cat(
                [g(p + "mlp.gate_proj.weight").T, g(p + "mlp.up_proj.weight").T],
                dim=1)
            layers["down_w"][i] = g(p + "mlp.down_proj.weight").T
        if has_bias:
            layers["qkv_b"][i] = torch.cat(
                [g(a + f"{n}_proj.bias") for n in "qkv"])
        if cfg.qk_norm:
            layers["q_norm"][i] = g(a + "q_norm.weight")
            layers["k_norm"][i] = g(a + "k_norm.weight")

    def own(name: str) -> torch.Tensor:
        # a copy, never a view of the (read-only) file mapping
        return g(name).to(dtype=dtype, copy=True)

    embed = own("model.embed_tokens.weight")
    if cfg.tie_word_embeddings or "lm_head.weight" not in weights:
        lm_head = None  # reuse embed
    else:
        lm_head = own("lm_head.weight").T.contiguous()
    cos, sin = _rope_tables(cfg, device)
    return {
        "embed": embed,
        "layers": layers,
        "final_ln": own("model.norm.weight"),
        "lm_head": lm_head,
        "rope_cos": cos,
        "rope_sin": sin,
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: Any = "cuda") -> Dict:
    """Random params in the final (fused, [in, out]) layout, drawn on the
    device from a torch.Generator seeded with `seed` (N(0, 0.02²) weights,
    unit norms). Each layer (and each expert of a layer) is drawn on its
    own, so a full-size model never holds more than one layer's matrix in
    fp32."""
    L, H, V = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape, scale=0.02):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    layers = {}
    for k, s in _layer_shapes(cfg).items():
        if k in ("input_ln", "post_ln", "q_norm", "k_norm"):
            layers[k] = torch.ones((L, *s), dtype=dtype, device=device)
        else:
            layers[k] = torch.empty((L, *s), dtype=dtype, device=device)
            for i in range(L):
                if k.startswith("moe_"):
                    for e in range(s[0]):
                        layers[k][i, e] = w(*s[1:])
                else:
                    layers[k][i] = w(*s)
    cos, sin = _rope_tables(cfg, device)
    return {
        "embed": w(V, H),
        "layers": layers,
        "final_ln": torch.ones((H,), dtype=dtype, device=device),
        "lm_head": None if cfg.tie_word_embeddings else w(H, V),
        "rope_cos": cos,
        "rope_sin": sin,
    }


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; bfloat16 arrays (ml_dtypes, as JAX hands them
    out) travel as their raw uint16 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_numpy(np_params: Dict, device: Any = "cuda",
                      dtype: Optional[torch.dtype] = None) -> Dict:
    """The JAX package's params as numpy arrays
    (`jax.tree.map(np.asarray, params)`) → this package's params, with the
    same keys and layouts. `dtype` casts the weights (not the fp32 rope
    tables, nor quantized bytes and scales); None keeps the arrays' own
    dtype. A quantized weight is any object with `data`, `scales`,
    `bits`, `group_size` and `in_dim` (what the tree map makes of the JAX
    QuantizedTensor); it becomes this package's QuantizedTensor on the
    same bytes."""

    def conv(key: str, a):
        if a is None:
            return None
        if not isinstance(a, np.ndarray) and all(
                hasattr(a, n) for n in ("data", "scales", "bits", "group_size", "in_dim")):
            return QuantizedTensor(
                _from_numpy(np.asarray(a.data)).to(device),
                _from_numpy(np.asarray(a.scales)).to(device),
                int(a.bits), int(a.group_size), int(a.in_dim))
        t = _from_numpy(np.asarray(a)).to(device)
        if dtype is not None and not key.startswith("rope_"):
            t = t.to(dtype)
        return t

    out = {k: conv(k, v) for k, v in np_params.items() if k != "layers"}
    out["layers"] = {k: conv(k, v) for k, v in np_params["layers"].items()}
    return out


# -- layers ---------------------------------------------------------------


def _impl(attn_impl: str) -> str:
    if attn_impl not in ("kernel", "plain"):
        raise ValueError(f"unknown attention route {attn_impl!r}")
    return attn_impl


def _shard(params: Dict):
    """The params' ShardContext (parallel/sharding.py), or None on a single
    device."""
    return params.get("shard")


def _tp_sum(y: torch.Tensor, sc, cut: bool) -> torch.Tensor:
    """The all-reduce over tp after a row-parallel matmul of a cut block."""
    return all_reduce(y, sc.tp_group) if sc is not None and cut else y


def embed_tokens(params: Dict, ids: torch.Tensor, table: str = "embed") -> torch.Tensor:
    """The token embedding of `ids`. With the table cut over the vocab,
    each rank gathers the rows it holds (zeros elsewhere) and the tp
    all-reduce assembles them."""
    emb, sc = params[table], _shard(params)
    if sc is None or not sc.vocab:
        return emb[ids.long()]
    local = ids.long() - sc.vocab_start
    hit = (local >= 0) & (local < emb.shape[0])
    x = emb[local.clamp(0, emb.shape[0] - 1)] * hit[..., None].to(emb.dtype)
    return all_reduce(x, sc.tp_group)


def gather_vocab(logits: torch.Tensor, params: Dict) -> torch.Tensor:
    """Logits of the whole vocab from each rank's vocab slice (the tp
    all-gather); unchanged where the head is not cut."""
    sc = _shard(params)
    if sc is None or not sc.vocab:
        return logits
    return all_gather(logits, sc.tp_group, dim=-1)


def _moe_experts(sc):
    """(first local expert, local experts) under expert parallelism."""
    return (sc.expert_start, sc.experts) if sc is not None and sc.ep else None


def _mm(lp: Dict, key: str, h: torch.Tensor, l: int, impl: str) -> torch.Tensor:
    """h @ layer weight `key`: a quantized stack goes through K5a (int8)
    or K5b (int4) at layer l."""
    w = lp[key]
    if isinstance(w, QuantizedTensor):
        return matmul_dequant_stacked(h, w, l, impl)
    return h @ w


def _qkv(lp: Dict, x: torch.Tensor, cfg: ModelConfig, rope_c, rope_s,
         l: int = 0, impl: str = "kernel"):
    """Pre-norm, fused QKV projection, qk-norm and RoPE of one layer.
    x [B, S, H] -> q [B, S, Nq, D], k / v [B, S, Nk, D]."""
    B, S = x.shape[0], x.shape[1]
    D = cfg.head_dim
    Nq, Nk = cfg.num_attention_heads, cfg.num_kv_heads
    q_dim = Nq * D
    h = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
    qkv = _mm(lp, "qkv_w", h, l, impl)
    if "qkv_b" in lp:
        qkv = qkv + lp["qkv_b"]
    q = qkv[..., :q_dim].reshape(B, S, Nq, D)
    k = qkv[..., q_dim : q_dim + Nk * D].reshape(B, S, Nk, D)
    v = qkv[..., q_dim + Nk * D :].reshape(B, S, Nk, D)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.rms_norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.rms_norm_eps)
    q, k = apply_rope_gathered(q, k, rope_c, rope_s)
    return q, k, v


# -- the MoE MLP (mixtral) ---------------------------------------------------------

_MOE_STACKS = ("moe_gate_up_w", "moe_down_w")


def _moe_layer_params(lp: Dict, l: int) -> Dict:
    """Layer l's MoE weights for moe_mlp: the expert stacks' [E, in, out]
    slices; a quantized stack dequantized to bf16, as the JAX package
    does, with its quantize-time pad rows sliced away (gate_up's rows are
    down's out, down's rows half gate_up's out)."""
    def layer(w):
        if isinstance(w, QuantizedTensor):
            return dequantize(QuantizedTensor(w.data[l], w.scales[l], w.bits,
                                              w.group_size, w.in_dim))
        return w[l]

    gu, dn = (layer(lp[k]) for k in _MOE_STACKS)
    return {"router_w": lp["router_w"], "moe_gate_up_w": gu[:, : dn.shape[-1]],
            "moe_down_w": dn[:, : gu.shape[-1] // 2]}


def moe_mlp(h: torch.Tensor, lp: Dict, cfg: ModelConfig,
            impl: str = "auto", experts: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Mixtral block-sparse MoE MLP, HF semantics (ops/moe_kernels.moe_route:
    full softmax over the fp32 router logits, top-k, renormalized), the
    JAX moe_mlp. h [B, S, H] post-norm; lp: router_w [H, E], moe_gate_up_w
    [E, H, 2I], moe_down_w [E, I, H] (weights of another dtype are cast to
    h's, as JAX promotes them). Two formulations of the same sum:

    * "dense": every expert's SwiGLU on every token, weighted by a mostly
      zero routing coefficient, in chunks of 256 tokens;
    * "routed": tokens sorted by expert, each expert's contiguous group
      through its own matmuls (_moe_ffn_routed);
    * "auto": routed at B * S >= 32 tokens, else dense.
    With `experts` = (e0, n) the stacks hold experts e0 .. e0 + n - 1 only
    (expert parallelism): routing runs over every expert, and the result
    is this rank's partial sum over its own. Returns [B, S, H] in h's
    dtype."""
    k, E = cfg.num_experts_per_tok, cfg.num_local_experts
    B, S, H = h.shape
    T = B * S
    if impl == "auto":
        impl = "routed" if T >= 32 else "dense"
    if impl not in ("dense", "routed"):
        raise ValueError(f"unknown MoE formulation {impl!r}")
    w_top, idx = moe_route(h.reshape(T, H), lp["router_w"], k)     # [T, k]
    gw, dw = (lp[n].to(h.dtype) for n in _MOE_STACKS)
    e0, n_loc = experts if experts is not None else (0, E)
    if impl == "routed":
        if experts is not None:
            # another rank's (token, choice) pairs go to bucket n_loc, skipped
            loc = idx - e0
            hit = (loc >= 0) & (loc < n_loc)
            w_top, idx = w_top * hit, torch.where(hit, loc, n_loc)
        return _moe_ffn_routed(h, w_top, idx, gw, dw)
    # the per-expert coefficient map [T, E], zero off the top k
    we = torch.zeros((T, E), dtype=torch.float32, device=h.device).scatter_add_(
        1, idx, w_top)[:, e0 : e0 + n_loc]
    hf = h.reshape(T, H)
    C = min(T, 256)   # bounds the [C, E, 2I] activation
    out = torch.empty_like(hf)
    for c0 in range(0, T, C):
        ht, wt = hf[c0 : c0 + C], we[c0 : c0 + C]
        gate, up = torch.einsum("ch,eho->ceo", ht, gw).chunk(2, dim=-1)
        act = F.silu(gate.float()).to(up.dtype) * up
        out[c0 : c0 + C] = torch.einsum("ce,cei,eih->ch", wt.to(ht.dtype), act, dw)
    return out.reshape(B, S, H)


def _moe_ffn_routed(h: torch.Tensor, w_top: torch.Tensor, idx: torch.Tensor,
                    gw: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """The routed expert FFN (the JAX _moe_ffn_routed): (token, choice)
    pairs stably sorted by expert id, each expert's SwiGLU over its
    contiguous group by torch.matmul (in place of lax.ragged_dot), and the
    weighted outputs summed back per token in slot order, which is
    deterministic. Reads the group sizes on the host. h [B, S, H]; w_top /
    idx [T, k]; gw [E, H, 2I]; dw [E, I, H]. An id of E or more names no
    expert here: its rows stay zero."""
    B, S, H = h.shape
    T, k = idx.shape
    eid = idx.reshape(T * k)
    order = torch.sort(eid, stable=True).indices
    x_s = h.reshape(T, H)[order // k]                              # [T*k, H]
    with span("tg.moe.group"):   # the host waits for the routing here
        counts = torch.bincount(eid, minlength=gw.shape[0]).tolist()
    o = torch.zeros((T * k, dw.shape[-1]), dtype=h.dtype, device=h.device)
    start = 0
    for e, n in enumerate(counts[: gw.shape[0]]):
        if n:
            xe = x_s[start : start + n]
            gate, up = (xe @ gw[e]).chunk(2, dim=-1)
            o[start : start + n] = (F.silu(gate.float()).to(up.dtype) * up) @ dw[e]
            start += n
    o_tok = torch.empty_like(o)
    o_tok[order] = o                                               # back to (token, slot)
    out = (o_tok.float() * w_top.reshape(T * k, 1)).reshape(T, k, H).sum(dim=1)
    return out.to(h.dtype).reshape(B, S, H)


def _out_and_mlp(lp: Dict, x: torch.Tensor, attn: torch.Tensor,
                 cfg: ModelConfig, l: int = 0, impl: str = "kernel",
                 gathered: bool = False, sc=None) -> torch.Tensor:
    """Output projection + residual, then the post-norm SwiGLU MLP +
    residual. attn [B, S, Nq, D]. A MoE layer runs moe_mlp on layer l's
    experts, or with `gathered` (the one-token step) moe_mlp_gathered on
    the whole stacks at layer l (K12 / K11a / K11b). Under a ShardContext
    `sc` the row-parallel o and down (and the MoE partial sums) are summed
    over their group before the residual is added, once."""
    B, S = x.shape[0], x.shape[1]
    x = x + _tp_sum(_mm(lp, "o_w", attn.reshape(B, S, -1), l, impl), sc,
                    sc is not None and sc.attn)
    h = rms_norm(x, lp["post_ln"], cfg.rms_norm_eps)
    if "router_w" in lp:
        if gathered:
            y = moe_mlp_gathered(h, lp["router_w"], lp["moe_gate_up_w"],
                                 lp["moe_down_w"], l, cfg, impl, _moe_experts(sc))
        else:
            y = moe_mlp(h, _moe_layer_params(lp, l), cfg, experts=_moe_experts(sc))
        return x + (all_reduce(y, sc.moe_group) if sc is not None else y)
    gate, up = _mm(lp, "gate_up_w", h, l, impl).chunk(2, dim=-1)
    act = F.silu(gate.float()).to(up.dtype) * up
    return x + _tp_sum(_mm(lp, "down_w", act, l, impl), sc, sc is not None and sc.mlp)


def _logits(params: Dict, x: torch.Tensor, cfg: ModelConfig,
            impl: str = "kernel") -> torch.Tensor:
    x = rms_norm(x, params["final_ln"], cfg.rms_norm_eps)
    head = params["lm_head"]
    if head is None:
        logits = x @ params["embed"].T
    elif isinstance(head, QuantizedTensor):
        # K3 or K4; the head's pad columns (quant.pad_head_out) are sliced away
        logits = matmul_dequant(x, head, impl)[..., : cfg.vocab_size]
    else:
        logits = x @ head
    return gather_vocab(logits.float(), params)


def decoder_layer_step(
    lp: Dict,
    x: torch.Tensor,          # [B, S, H]
    k_cache: torch.Tensor,    # [B, Nk, T, D] this layer's cache (updated in place)
    v_cache: torch.Tensor,    # [B, Nk, T, D]
    *,
    cfg: ModelConfig,
    positions: torch.Tensor,  # [B, S]
    kv_pos: torch.Tensor,     # [B, T] (already holding this step's positions)
    valid: torch.Tensor,      # [B, T]
    slot: int,
    rope_c: torch.Tensor,     # [B, S, 1, D] gathered rope rows
    rope_s: torch.Tensor,
    attn_impl: str = "kernel",
    l: int = 0,               # layer index into lp's quantized stacks
    sc=None,                  # ShardContext of sharded params
    seq_lo: Optional[int] = None,  # x is the sp slice from token seq_lo
) -> torch.Tensor:
    """One pre-norm decoder layer (attention + SwiGLU MLP) over the dense
    cache. Writes this step's K/V into the cache at `slot` and returns
    the new hidden states. Quantized weights in `lp` are the whole
    [L, ...] stacks, read at layer `l`. With `seq_lo` (sequence
    parallelism) x, positions and the rope rows are this rank's slice of
    the tokens: K/V are all-gathered over sp before they are written, and
    the local queries attend from slot `slot + seq_lo`."""
    impl = _impl(attn_impl)
    q, k, v = _qkv(lp, x, cfg, rope_c, rope_s, l, impl)
    if seq_lo is not None:
        k, v = all_gather(k, sc.sp_group, dim=1), all_gather(v, sc.sp_group, dim=1)
    S = k.shape[1]
    k_cache[:, :, slot : slot + S] = kv_cast(k.transpose(1, 2), k_cache.dtype)
    v_cache[:, :, slot : slot + S] = kv_cast(v.transpose(1, 2), v_cache.dtype)
    attn = attention_with_cache(
        q, k_cache, v_cache, q_pos=positions, kv_pos=kv_pos, kv_valid=valid,
        slot=slot + (seq_lo or 0), sliding_window=cfg.sliding_window, kernel=impl,
    )
    return _out_and_mlp(lp, x, attn, cfg, l, impl, sc=sc)


def seq_slice(sc, ids: torch.Tensor, positions: torch.Tensor):
    """This rank's slice of a prefill's tokens under sequence parallelism:
    (ids, positions, first token) of the slice, or the whole input and
    None where the sequence is not cut (no ShardContext, sp of 1, a MoE
    model, or fewer tokens than sp ranks). The caller pads S to a multiple
    of sp."""
    S = ids.shape[1]
    if sc is None or not sc.seq or S < sc.sp:
        return ids, positions, None
    if S % sc.sp:
        raise ValueError(f"{S} prefill tokens over sp={sc.sp}: pad to a multiple")
    n = S // sc.sp
    lo = sc.sp_rank * n
    return ids[:, lo : lo + n], positions[:, lo : lo + n], lo


def _layer(params: Dict, l: int) -> Dict:
    """Layer l's weights: float stacks sliced, quantized stacks and MoE
    expert stacks whole (the kernels take the layer as an offset)."""
    return {k: v if isinstance(v, QuantizedTensor) or k in _MOE_STACKS else v[l]
            for k, v in params["layers"].items()}


def forward(
    params: Dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,    # [B, S]
    cache: KVCache,
    positions: torch.Tensor,    # [B, S] logical positions (RoPE/causality)
    token_valid: torch.Tensor,  # [B, S] bool — real token vs pad
    last_only: bool = False,
    attn_impl: str = "kernel",  # "kernel" | "plain"
    last_pos: Optional[torch.Tensor] = None,  # [B] row of the last REAL
                                # token for trailing-padded prompts
                                # (default: S - 1)
) -> Tuple[torch.Tensor, KVCache]:
    """One forward step (prefill S>1 or decode S=1) at slot cache.length.

    Returns (fp32 logits [B, S, V], or [B, 1, V] if last_only, and the
    cache, which was updated in place)."""
    _check_weights(params)
    impl = _impl(attn_impl)
    S = input_ids.shape[1]
    slot = cache.length
    if slot + S > cache.max_len:
        raise ValueError(f"{S} tokens at slot {slot} overflow a cache of "
                         f"{cache.max_len} slots")
    cache.kv_pos[:, slot : slot + S] = positions
    cache.valid[:, slot : slot + S] = token_valid
    sc = _shard(params)
    ids, q_pos, seq_lo = seq_slice(sc, input_ids, positions)
    rope_c, rope_s = gather_rope(params["rope_cos"], params["rope_sin"], q_pos)
    x = embed_tokens(params, ids)
    for l in range(cfg.num_hidden_layers):
        x = decoder_layer_step(
            _layer(params, l), x, cache.k[l], cache.v[l], cfg=cfg,
            positions=q_pos, kv_pos=cache.kv_pos, valid=cache.valid,
            slot=slot, rope_c=rope_c, rope_s=rope_s, attn_impl=impl, l=l,
            sc=sc, seq_lo=seq_lo,
        )
    if seq_lo is not None:
        x = all_gather(x, sc.sp_group, dim=1)
    if last_only and last_pos is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_pos.long()][:, None]
    elif last_only:  # left padding puts every row's last token at S - 1
        x = x[:, -1:]
    cache.length = slot + S
    return _logits(params, x, cfg, impl), cache


# -- the fused int4 decode route -------------------------------------------------

_FUSED_KEYS = ("qkv_w", "o_w", "gate_up_w", "down_w")


def _int4_fused(params: Dict) -> bool:
    """The fused decode route runs when all four layer matrices are int4."""
    return all(isinstance(params["layers"].get(k), QuantizedTensor)
               and params["layers"][k].bits == 4 for k in _FUSED_KEYS)


def _invrms(x2: torch.Tensor, eps: float) -> torch.Tensor:
    """fp32 per-row 1/rms [M, 1], computed outside the kernels."""
    xf = x2.float()
    return torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)


def _fused_fns(impl: str):
    """(K6, K7) of a route: the kernel wrappers, or their plain versions."""
    if impl == "plain":
        return (qk.matmul_dequant_int4_stacked_fused_plain,
                qk.mlp_fused_int4_stacked_plain)
    return qk.matmul_dequant_int4_stacked_fused, qk.mlp_fused_int4_stacked


def _qkv_fused(params: Dict, x2: torch.Tensor, cfg: ModelConfig, c, s,
               l: int, impl: str):
    """K6 for qkv: input-norm prologue, then + qkv_b (qwen2), per-head
    qk-norm (qwen3) and RoPE on the q || k heads in the epilogue.
    x2 [B, H]; c / s [B, D] gathered rope rows."""
    B, D = x2.shape[0], cfg.head_dim
    Nq, Nk = cfg.num_attention_heads, cfg.num_kv_heads
    lay = params["layers"]
    qt = lay["qkv_w"]
    kw = dict(ln=lay["input_ln"], invrms=_invrms(x2, cfg.rms_norm_eps),
              bias=lay.get("qkv_b"), rope_cos=c, rope_sin=s,
              rope_heads=Nq + Nk, rope_dim=D)
    if cfg.qk_norm:
        kw.update(qk_norm_w=(lay["q_norm"], lay["k_norm"]), qk_heads=Nq,
                  eps=cfg.rms_norm_eps)
    qkv = _fused_fns(impl)[0](x2, qt.data, qt.scales, l, qt.group_size, **kw)
    q = qkv[:, : Nq * D].reshape(B, 1, Nq, D).contiguous()  # K2 reads q dense
    k = qkv[:, Nq * D : (Nq + Nk) * D].reshape(B, 1, Nk, D)
    v = qkv[:, (Nq + Nk) * D :].reshape(B, 1, Nk, D)
    return q, k, v


def _out_and_mlp_fused(params: Dict, x2: torch.Tensor, attn: torch.Tensor,
                       cfg: ModelConfig, l: int, impl: str) -> torch.Tensor:
    """K6 for o with the residual, then the MLP: K7 for at most 32 rows
    when gate_up and down share a group, else K6 twice (norm prologue;
    silu * up prologue with the residual). Under tp every rank takes the
    same kernels, and only tp rank 0 adds the residual. x2 [B, H] -> [B, H]."""
    B = x2.shape[0]
    mm_fused, mlp_fused = _fused_fns(impl)
    lay = params["layers"]
    sc = _shard(params)
    # a cut block's partial sums meet in the tp all-reduce: only tp rank 0
    # adds the residual in its epilogue, so that it is counted once
    attn_cut = sc is not None and sc.attn
    mlp_cut = sc is not None and sc.mlp
    qt = lay["o_w"]
    x2 = _tp_sum(mm_fused(attn.reshape(B, -1), qt.data, qt.scales, l, qt.group_size,
                          res=x2 if not attn_cut or sc.tp_rank == 0 else None),
                 sc, attn_cut)
    gu, dn = lay["gate_up_w"], lay["down_w"]
    inv = _invrms(x2, cfg.rms_norm_eps)
    lead = not mlp_cut or sc.tp_rank == 0
    if B <= qk.MAX_DECODE_ROWS and gu.group_size == dn.group_size:
        y = mlp_fused(x2, gu.data, gu.scales, dn.data, dn.scales,
                      lay["post_ln"], inv, l, gu.group_size, residual=lead)
    else:
        gate_up = mm_fused(x2, gu.data, gu.scales, l, gu.group_size,
                           ln=lay["post_ln"], invrms=inv)
        y = mm_fused(gate_up, dn.data, dn.scales, l, dn.group_size, silu=True,
                     res=x2 if lead else None)
    return _tp_sum(y, sc, mlp_cut)


def _logits_fused(params: Dict, x2: torch.Tensor, cfg: ModelConfig,
                  impl: str) -> torch.Tensor:
    """The head of the fused route: K6 with one layer and the final-norm
    prologue for an int4 head, else _logits. Returns [B, 1, V] fp32."""
    head = params["lm_head"]
    if not (isinstance(head, QuantizedTensor) and head.bits == 4):
        return _logits(params, x2[:, None], cfg, impl)
    logits = _fused_fns(impl)[0](
        x2, head.data[None], head.scales[None], 0, head.group_size,
        ln=params["final_ln"][None], invrms=_invrms(x2, cfg.rms_norm_eps))
    return gather_vocab(logits[:, None, : cfg.vocab_size].float(), params)


def _decode_token(params, cfg, tok, pos, put_kv, attend, impl: str):
    """Logits [B, 1, V] of one decode step of the llama family: every layer
    hands this step's K/V [B, Nk, D] to put_kv(l, k, v), then attends
    through attend(l, q [B, 1, Nq, D]) -> [B, 1, Nq, D]. int4 params take
    the fused route (K6, K7), int8 params the unfused one (K5a, K3); a MoE
    layer runs the gathered-expert kernels (K12, K11a, K11b)."""
    B = tok.shape[0]
    fused = _int4_fused(params)
    sc = _shard(params)
    rope_c, rope_s = gather_rope(params["rope_cos"], params["rope_sin"], pos)
    x = embed_tokens(params, tok)[:, None]  # [B, 1, H]
    for l in range(cfg.num_hidden_layers):
        lp = _layer(params, l)
        if fused:
            q, k, v = _qkv_fused(params, x[:, 0], cfg, rope_c[:, 0, 0],
                                 rope_s[:, 0, 0], l, impl)
        else:
            q, k, v = _qkv(lp, x, cfg, rope_c, rope_s, l, impl)
        put_kv(l, k[:, 0], v[:, 0])
        attn = attend(l, q)
        if fused:
            x = _out_and_mlp_fused(params, x[:, 0], attn, cfg, l, impl)[:, None]
        else:
            x = _out_and_mlp(lp, x, attn, cfg, l, impl, gathered=True, sc=sc)
    if fused:
        return _logits_fused(params, x[:, 0], cfg, impl)
    return _logits(params, x.reshape(B, 1, -1), cfg, impl)


def _put_inflight(infl_k: torch.Tensor, infl_v: torch.Tensor, step: int):
    """put_kv of the frozen loops: layer l's K/V [B, Nk, D] go to the
    in-flight buffers [L, B, Nk, N, D] at `step`."""
    def put(l, k, v):
        infl_k[l, :, :, step] = k
        infl_v[l, :, :, step] = v
    return put


def _decode_one(decode_token, params, cfg, tok, pos, cache, infl_k, infl_v, step,
                attn_impl):
    """Logits [B, 1, V] of one decode step over the frozen cache; writes
    this step's K/V into the in-flight buffers at `step`."""
    impl = _impl(attn_impl)
    D = cfg.head_dim
    window = cfg.sliding_window
    if impl == "kernel":
        # frozen-slot mask (causal & valid & window), shared by the layers
        mask_f = decode_mask(cache.kv_pos, cache.valid, pos, window)

    def attend(l, q):
        if impl == "kernel":
            return flash_decode_frozen(
                q[:, 0].contiguous(), cache.k, cache.v, mask_f, infl_k[l], infl_v[l], l,
                step, scale=D ** -0.5, window=window,
            )[:, None]
        return sdpa_decode_frozen(
            q, cache.k[l], cache.v[l], cache.kv_pos, cache.valid,
            infl_k[l], infl_v[l], step, pos, sliding_window=window,
        )

    return decode_token(params, cfg, tok, pos, _put_inflight(infl_k, infl_v, step),
                        attend, impl)


def decode_steps(
    params: Dict,
    cfg: ModelConfig,
    tok0: torch.Tensor,      # [B] first input token of the chunk
    cache: KVCache,
    pos0: torch.Tensor,      # [B, 1] logical position of tok0
    n_steps: int,
    sample_fn: Callable[[torch.Tensor], torch.Tensor],  # logits [B, V] -> tok [B]
    attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, KVCache]:
    """n_steps single-token decode steps with the big KV cache FROZEN.

    Each step's K/V land in a small in-flight buffer [L, B, Nk, n_steps, D]
    that attention merges with the frozen cache (flash_decode_frozen);
    the chunk is written into the cache once, at the end, in place. No
    step reads anything back to the host. int4 params take the fused
    route (K6 and K7), on the card and on the CPU alike.

    Returns (toks [n_steps, B] int32 — the tokens sampled AFTER each
    input — and the advanced cache)."""
    _check_weights(params)
    return run_decode_steps(_decode_token, params, cfg, tok0, cache, pos0, n_steps,
                            sample_fn, attn_impl)


def run_decode_steps(decode_token, params: Dict, cfg: ModelConfig, tok0: torch.Tensor,
                     cache: KVCache, pos0: torch.Tensor, n_steps: int,
                     sample_fn: Callable[[torch.Tensor], torch.Tensor],
                     attn_impl: str = "kernel") -> Tuple[torch.Tensor, KVCache]:
    """decode_steps of a family whose one-token step is `decode_token`."""
    B = tok0.shape[0]
    L, D, Nk = cfg.num_hidden_layers, cfg.head_dim, cfg.num_kv_heads
    slot0 = cache.length
    if slot0 + n_steps > cache.max_len:
        raise ValueError(f"{n_steps} steps at slot {slot0} overflow a cache "
                         f"of {cache.max_len} slots")
    dev = cache.k.device
    infl_k = torch.zeros((L, B, Nk, n_steps, D), dtype=_infl_dtype(cache.k.dtype),
                         device=dev)
    infl_v = torch.zeros_like(infl_k)
    toks = torch.empty((n_steps, B), dtype=torch.int32, device=dev)
    tok = tok0.to(torch.int32)
    pos = pos0.to(torch.int32)
    for step in range(n_steps):
        logits = _decode_one(decode_token, params, cfg, tok, pos, cache, infl_k,
                             infl_v, step, attn_impl)
        tok = sample_fn(logits[:, -1, :]).to(torch.int32)
        toks[step] = tok
        pos = pos + 1

    # merge the chunk into the cache once
    end = slot0 + n_steps
    cache.k[:, :, :, slot0:end] = kv_cast(infl_k, cache.k.dtype)
    cache.v[:, :, :, slot0:end] = kv_cast(infl_v, cache.v.dtype)
    cache.kv_pos[:, slot0:end] = pos0.to(torch.int32) + torch.arange(
        n_steps, dtype=torch.int32, device=dev)
    cache.valid[:, slot0:end] = True
    cache.length = end
    return toks, cache


def decode_step(
    params: Dict,
    cfg: ModelConfig,
    tok: torch.Tensor,       # [B] input token
    cache: KVCache,
    pos: torch.Tensor,       # [B, 1] logical position of tok
    attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step written straight into the dense cache: the
    streaming engine's per-token route (the JAX engine's per-token body,
    a one-token `forward`). Every layer writes the token's K/V at slot
    cache.length, then attends over its layer of the cache through K13
    (flash_decode) under one mask a step, shared by the layers. The decode
    matmuls are decode_steps': the fused int4 route (K6, K7), int8 (K5a,
    K3), the MoE gathered kernels (K12, K11a, K11b).

    Returns (fp32 logits [B, 1, V], and the cache, advanced by one slot in
    place)."""
    _check_weights(params)
    return run_decode_step(_decode_token, params, cfg, tok, cache, pos, attn_impl)


def run_decode_step(decode_token, params: Dict, cfg: ModelConfig, tok: torch.Tensor,
                    cache: KVCache, pos: torch.Tensor,
                    attn_impl: str = "kernel") -> Tuple[torch.Tensor, KVCache]:
    """decode_step of a family whose one-token step is `decode_token`."""
    impl = _impl(attn_impl)
    slot = cache.length
    if slot >= cache.max_len:
        raise ValueError(f"a decode step at slot {slot} overflows a cache of "
                         f"{cache.max_len} slots")
    D, window = cfg.head_dim, cfg.sliding_window
    pos = pos.to(torch.int32)
    cache.kv_pos[:, slot] = pos[:, 0]
    cache.valid[:, slot] = True
    mask = decode_mask(cache.kv_pos, cache.valid, pos, window)

    def put_kv(l, k, v):  # [B, Nk, D] into slot `slot` of layer l
        cache.k[l, :, :, slot] = kv_cast(k, cache.k.dtype)
        cache.v[l, :, :, slot] = kv_cast(v, cache.v.dtype)

    def attend(l, q):
        if impl == "kernel":
            return flash_decode(q[:, 0].contiguous(), cache.k[l], cache.v[l], mask,
                                scale=D ** -0.5)[:, None]
        return sdpa_with_cache(q, cache.k[l], cache.v[l], pos, cache.kv_pos,
                               cache.valid, sliding_window=window)

    logits = decode_token(params, cfg, tok.to(torch.int32), pos, put_kv, attend, impl)
    cache.length = slot + 1
    return logits, cache


def decode_paged_steps(
    params: Dict,
    cfg: ModelConfig,
    tok0: torch.Tensor,      # [B] int32 first input token of the quantum
    state: PagedKVState,
    n_steps: int,
    sample_fn: Callable[[torch.Tensor], torch.Tensor],  # logits [B, V] -> tok [B]
    attn_impl: str = "kernel",
) -> torch.Tensor:
    """n_steps paged decode steps with the block POOLS frozen (the paged
    analogue of decode_steps): each step's K/V land in an in-flight
    buffer [L, B, Nk, n_steps, D] that paged_decode_frozen (K8) merges
    with the pool, and ONE scatter at the end writes slot lengths0 + t of
    every active row into its (block, offset); inactive rows write to the
    null block 0. Sliding windows are handled inside the merge (the
    current token's slot is lengths0[b] + step, and slot deltas equal
    logical deltas within a row). int4 params take the fused route (K6,
    K7). No step reads anything back to the host.

    Updates `state` in place (pools, and lengths advanced by
    n_steps * active) and returns the tokens sampled after each input,
    [n_steps, B] int32."""
    _check_weights(params)
    return run_decode_paged_steps(_decode_token, params, cfg, tok0, state, n_steps,
                                  sample_fn, attn_impl)


def run_decode_paged_steps(decode_token, params: Dict, cfg: ModelConfig,
                           tok0: torch.Tensor, state: PagedKVState, n_steps: int,
                           sample_fn: Callable[[torch.Tensor], torch.Tensor],
                           attn_impl: str = "kernel") -> torch.Tensor:
    """decode_paged_steps of a family whose one-token step is
    `decode_token`."""
    impl = _impl(attn_impl)
    B = tok0.shape[0]
    L, D, Nk = cfg.num_hidden_layers, cfg.head_dim, cfg.num_kv_heads
    window = cfg.sliding_window
    bs, MB = state.block_size, state.max_blocks
    dev = state.k_pool.device
    tables, starts, active = state.block_tables, state.starts, state.active
    lengths0 = state.lengths
    act = active.to(torch.int32)
    attend_fn = paged_decode_frozen if impl == "kernel" else paged_decode_frozen_plain
    infl_k = torch.zeros((L, B, Nk, n_steps, D), dtype=_infl_dtype(state.k_pool.dtype),
                         device=dev)
    infl_v = torch.zeros_like(infl_k)
    toks = torch.empty((n_steps, B), dtype=torch.int32, device=dev)
    tok = tok0.to(torch.int32)
    for step in range(n_steps):
        # [B, 1] logical; may pass the context at the cap (gather_rope clamps)
        pos = (lengths0 + step * act - starts)[:, None]

        def attend(l, q, step=step):
            return attend_fn(q[:, 0].contiguous(), state.k_pool, state.v_pool, tables,
                             lengths0, starts, infl_k[l], infl_v[l], l, step,
                             scale=D ** -0.5, window=window)[:, None]

        logits = decode_token(params, cfg, tok, pos, _put_inflight(infl_k, infl_v, step),
                              attend, impl)
        tok = sample_fn(logits[:, -1, :]).to(torch.int32)
        toks[step] = tok

    # scatter the quantum's K/V into their (block, offset) slots: step t's
    # token occupies slot lengths0 + t of its row. A slot past the table
    # takes its last entry (the JAX gather clamps so); inactive rows write
    # to the null block.
    steps = torch.arange(n_steps, dtype=torch.int32, device=dev)
    slot_t = lengths0[None, :] + steps[:, None] * act[None, :]          # [N, B]
    keep = active[None, :].expand(n_steps, B)
    _scatter_slots(state, slot_t, keep, infl_k.permute(3, 1, 0, 2, 4),
                   infl_v.permute(3, 1, 0, 2, 4))
    state.lengths = lengths0 + n_steps * act
    return toks


def forward_paged(
    params: Dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B] int32 one decode token per row
    state: PagedKVState,
    attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, PagedKVState]:
    """One decode step over the paged pool (the JAX forward_paged): row b's
    token goes to slot lengths[b] of its block table, at logical position
    lengths[b] - starts[b]; every layer writes its K/V into the pool, then
    attends over the row's slots through K9 (paged_decode, with the
    model's sliding window). Inactive rows write into the null block 0 and
    keep their length; their outputs are discarded by the batcher. The
    batcher's stepwise quantum runs it for a model without
    decode_paged_steps. Returns (fp32 logits [B, V], and `state`, updated
    in place: pools, and lengths advanced for active rows)."""
    _check_weights(params)
    return run_forward_paged(_decode_token, params, cfg, input_ids, state, attn_impl)


def run_forward_paged(decode_token, params: Dict, cfg: ModelConfig,
                      input_ids: torch.Tensor, state: PagedKVState,
                      attn_impl: str = "kernel") -> Tuple[torch.Tensor, PagedKVState]:
    """forward_paged of a family whose one-token step is `decode_token`.
    The row's K/V are cast for the pool (kv_cast) and written on the same
    stream as the K9 launch that reads them."""
    impl = _impl(attn_impl)
    B = input_ids.shape[0]
    D = cfg.head_dim
    bs, MB = state.block_size, state.max_blocks
    lengths, starts, tables, active = (state.lengths, state.starts, state.block_tables,
                                       state.active)
    pos = (lengths - starts)[:, None]                                # [B, 1] logical
    rows = torch.arange(B, device=lengths.device)
    # a slot past the table takes its last entry (the JAX gather clamps so);
    # inactive rows write to the null block
    blk = tables[rows, (lengths // bs).clamp(0, MB - 1).long()]
    blk = torch.where(active, blk, 0).long()
    off = (lengths % bs).long()
    new_lengths = torch.where(active, lengths + 1, lengths)

    def put_kv(l, k, v):  # [B, Nk, D] into each row's (block, offset)
        state.k_pool[l, blk, :, off] = kv_cast(k, state.k_pool.dtype)
        state.v_pool[l, blk, :, off] = kv_cast(v, state.v_pool.dtype)

    def attend(l, q):
        return paged_decode(q[:, 0].contiguous(), state.k_pool[l], state.v_pool[l], tables,
                            new_lengths, starts, D ** -0.5, cfg.sliding_window,
                            kernel=impl)[:, None]

    logits = decode_token(params, cfg, input_ids.to(torch.int32), pos, put_kv, attend, impl)
    state.lengths = new_lengths
    return logits[:, 0], state


def _infl_dtype(kv_dtype: torch.dtype) -> torch.dtype:
    """The in-flight K/V buffers' dtype: the cache's, or bf16 beside an fp8
    cache (the JAX package's choice: the newest tokens keep bf16 until the
    merge or scatter)."""
    return torch.bfloat16 if kv_dtype == torch.float8_e4m3fn else kv_dtype


def _scatter_slots(state: PagedKVState, slot: torch.Tensor, keep: torch.Tensor,
                   infl_k: torch.Tensor, infl_v: torch.Tensor) -> None:
    """Writes in-flight K/V into their pool slots in place: entry i of the
    flattened `slot` [..., B] (row b's slot index) takes infl_k / infl_v
    [..., B, L, Nk, D] (the same leading dims); entries not kept write to
    the null block 0. A slot past the table takes its last entry (the JAX
    gather clamps so)."""
    bs, MB = state.block_size, state.max_blocks
    B = slot.shape[-1]
    rows = torch.arange(B, device=slot.device).expand(slot.shape)
    blk = state.block_tables[rows, (slot // bs).clamp(0, MB - 1).long()]
    blk = torch.where(keep, blk, 0).reshape(-1).long()
    off = (slot % bs).reshape(-1).long()
    L, Nk, D = infl_k.shape[-3:]
    # the indexed dims go to the front: pool[:, blk, :, off, :] is [n, L, Nk, D]
    for pool, vals in ((state.k_pool, infl_k), (state.v_pool, infl_v)):
        pool[:, blk, :, off, :] = kv_cast(vals.reshape(-1, L, Nk, D), pool.dtype)


# -- n-gram speculation ------------------------------------------------------------


def ngram_draft_batched(ctx: torch.Tensor, clen: torch.Tensor, cur: torch.Tensor,
                        ngram: int, gamma: int) -> torch.Tensor:
    """Prompt-lookup drafting on the device, per row: the most recent
    EARLIER window of ctx [B, C] equal to the row's last `ngram` tokens
    (of its clen [B] real ones) gives the next `gamma` tokens after it; a
    row without a match, or past its context's end, drafts `cur` [B].
    Returns [B, gamma] int32; nothing is read on the host."""
    B, C = ctx.shape
    W = C - ngram + 1
    dev = ctx.device
    idx = (clen[:, None] - ngram + torch.arange(ngram, device=dev)[None, :]).clamp(0, C - 1)
    tail = ctx.gather(1, idx.long())                                   # [B, ngram]
    match = torch.ones((B, W), dtype=torch.bool, device=dev)
    for j in range(ngram):
        match &= ctx[:, j : W + j] == tail[:, j : j + 1]
    iota = torch.arange(W, device=dev)[None, :]
    match &= iota <= (clen[:, None] - ngram - 1)
    i_star = torch.where(match, iota, -1).amax(dim=1)                  # [B]
    p = i_star[:, None] + ngram + torch.arange(gamma, device=dev)[None, :]
    avail = (i_star >= 0)[:, None] & (p < clen[:, None])
    vals = ctx.gather(1, p.clamp(0, C - 1).long())
    return torch.where(avail, vals, cur[:, None]).to(torch.int32)


def spec_accept(logits: torch.Tensor, draft: torch.Tensor, sampler=None,
                generator: Optional[torch.Generator] = None,
                greedy_rows: Optional[torch.Tensor] = None):
    """Acceptance of one verify round. logits [B, S, V] fp32 at the S =
    gamma + 1 verify positions, draft [B, gamma]. Returns (m [B] accepted
    drafts, nxt [B] the next input, emit [B, S] the round's tokens, of
    which the first m + 1 are emitted).

    sampler None: greedy prefix acceptance of the argmax predictions.
    Else (temps, topks, topps, minps) [B]: speculative rejection sampling
    against the point-mass draft. Draft d at a position whose processed
    distribution is p (ops/sampling.masked_logits_batched) is accepted with
    probability p(d); the first rejected position emits a sample of p with
    d's mass removed, so that every emitted token is an exact sample of p
    (Leviathan et al.); full acceptance emits a bonus sample of the last
    position's p. Rows in greedy_rows (default: temperature <= 0) accept by
    argmax prefix. The draws come from `generator` (torch.rand and
    torch.multinomial), not from the JAX package's bits."""
    B, S, V = logits.shape
    gamma = S - 1
    dev = logits.device
    preds = logits.argmax(dim=-1).to(torch.int32)                      # [B, S]
    greedy_ok = preds[:, :gamma] == draft
    if sampler is None:
        # int32 as in JAX (an integer sum promotes to int64): the kernels'
        # slot tensors are derived from it
        m = torch.cumprod(greedy_ok.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)
        nxt = preds.gather(1, m.clamp(0, gamma)[:, None].long())[:, 0]
        return m, nxt, preds
    temps, topks, topps, minps = sampler
    if greedy_rows is None:
        greedy_rows = temps <= 0
    ml = masked_logits_batched(
        logits.reshape(B * S, V), temps.repeat_interleave(S), topks.repeat_interleave(S),
        topps.repeat_interleave(S), minps.repeat_interleave(S)).reshape(B, S, V)
    p_draft = torch.softmax(ml[:, :gamma], dim=-1).gather(
        -1, draft[..., None].long())[..., 0]                         # [B, gamma]
    u = torch.rand((B, gamma), generator=generator, device=dev)
    ok = torch.where(greedy_rows[:, None], greedy_ok, u < p_draft)
    m = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1, dtype=torch.int32)
    mc = m.clamp(0, gamma)[:, None].long()
    ml_m = ml.gather(1, mc[..., None].expand(B, 1, V))[:, 0]           # [B, V]
    d_m = draft.gather(1, m.clamp(0, gamma - 1)[:, None].long())       # [B, 1]
    vocab = torch.arange(V, device=dev)[None, :]
    ml_res = torch.where((m < gamma)[:, None] & (vocab == d_m), NEG_INF, ml_m)
    nxt_s = torch.multinomial(torch.softmax(ml_res, dim=-1), 1,
                              generator=generator)[:, 0].to(torch.int32)
    nxt = torch.where(greedy_rows, preds.gather(1, mc)[:, 0], nxt_s)
    iota_s = torch.arange(S, device=dev)[None, :]
    pad_draft = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
    emit_s = torch.where(iota_s < m[:, None], pad_draft, nxt[:, None])
    emit = torch.where(greedy_rows[:, None], preds, emit_s)
    return m, nxt, emit.to(torch.int32)


def _verify_forward(params: Dict, cfg: ModelConfig, ids: torch.Tensor,
                    positions: torch.Tensor, infl_k: torch.Tensor, infl_v: torch.Tensor,
                    base: int, attend, impl: str) -> torch.Tensor:
    """Logits [B, S, V] of the S verify positions per row: every layer
    writes the round's K/V into the in-flight buffers at slots base ..
    base + S - 1, then attends through attend(l, q [B, S, Nq, D]). Layer
    matmuls run unfused at B * S rows (K5b / K5a for quantized stacks), as
    the JAX verify forward does."""
    S = ids.shape[1]
    sc = _shard(params)
    rope_c, rope_s = gather_rope(params["rope_cos"], params["rope_sin"], positions)
    x = embed_tokens(params, ids)                                      # [B, S, H]
    for l in range(cfg.num_hidden_layers):
        lp = _layer(params, l)
        q, k, v = _qkv(lp, x, cfg, rope_c, rope_s, l, impl)
        infl_k[l, :, :, base : base + S] = k.transpose(1, 2)
        infl_v[l, :, :, base : base + S] = v.transpose(1, 2)
        attn = attend(l, q.contiguous())
        x = _out_and_mlp(lp, x, attn, cfg, l, impl, sc=sc)
    return _logits(params, x, cfg, impl)


def decode_paged_spec_steps(
    params: Dict,
    cfg: ModelConfig,
    tok0: torch.Tensor,        # [B] int32 current input token per row
    state: PagedKVState,       # frozen pools, updated in place at the end
    ctx_tokens: torch.Tensor,  # [B, C] int32 prompt + generated, cur last
    ctx_lens: torch.Tensor,    # [B] int32
    n_rounds: int,
    gamma: int,                # draft length; S = gamma + 1 verify positions
    ngram: int,
    attn_impl: str = "kernel",
    sampler=None,              # None = greedy; else (temps, topks, topps, minps) [B]
    generator: Optional[torch.Generator] = None,  # with a sampler
):
    """n_rounds of n-gram speculative verification for the continuous
    batcher (the JAX decode_paged_spec_steps, as an eager loop over rounds
    and layers): per round each row drafts gamma tokens from its own
    context (ngram_draft_batched), one S-position verify forward runs
    against the FROZEN pools plus the accepted in-flight slots (K10,
    ops/paged_attention.paged_decode_spec), and spec_accept takes the
    matched prefix (greedy rows) or rejection-samples (sampled rows). One
    scatter at the end writes every ACCEPTED slot; rejected slots are never
    made valid and never written. A verify forward reads the weights once
    for S positions, so a row's throughput multiplies by (1 + its mean
    accepted drafts).

    Positions, q_slots, the acceptance counts and the validity stay device
    tensors: no round reads a device value on the host (only the round's
    base slot r * S and the layer are host ints). Sliding windows are
    exact: verify positions carry their prospective pool slots and accepted
    in-flight entries theirs, and the merge masks in slot space.

    Returns (toks [R, B, S], counts [R, B] emitted per round, cur [B] next
    input per row), all int32 on the device; `state` is advanced in place
    (pools and lengths)."""
    _check_weights(params)
    impl = _impl(attn_impl)
    if sampler is not None and generator is None:
        raise ValueError("rejection sampling needs a torch.Generator")
    B = tok0.shape[0]
    S = gamma + 1
    N = n_rounds * S
    L, D, Nk = cfg.num_hidden_layers, cfg.head_dim, cfg.num_kv_heads
    window = cfg.sliding_window
    dev = state.k_pool.device
    tables, starts, active = state.block_tables, state.starts, state.active
    lengths0 = state.lengths
    act = active.to(torch.int32)
    attend_fn = paged_decode_spec if impl == "kernel" else paged_decode_spec_plain
    infl_k = torch.zeros((L, B, Nk, N, D), dtype=_infl_dtype(state.k_pool.dtype),
                         device=dev)
    infl_v = torch.zeros_like(infl_k)
    valid = torch.zeros((B, N), dtype=torch.bool, device=dev)
    infl_slots = torch.zeros((B, N), dtype=torch.int32, device=dev)
    acc = torch.zeros((B,), dtype=torch.int32, device=dev)
    cur = tok0.to(torch.int32)
    ctx, clen = ctx_tokens.to(torch.int32), ctx_lens.to(torch.int32)
    C = ctx.shape[1]
    iota_s = torch.arange(S, dtype=torch.int32, device=dev)
    iota_n = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    iota_c = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    toks, counts = [], []
    for r in range(n_rounds):
        base = r * S
        draft = ngram_draft_batched(ctx, clen, cur, ngram, gamma)      # [B, gamma]
        ids = torch.cat([cur[:, None], draft], dim=1)                  # [B, S]
        positions = (lengths0 - starts + acc)[:, None] + iota_s[None, :]
        # the pool slot each verify position will occupy (window masks)
        q_slots = (lengths0 + acc)[:, None] + iota_s[None, :]

        def attend(l, q, base=base, q_slots=q_slots):
            return attend_fn(q, state.k_pool, state.v_pool, tables, lengths0, starts,
                             infl_k[l], infl_v[l], valid, l, base, D ** -0.5,
                             window, q_slots, infl_slots)

        logits = _verify_forward(params, cfg, ids, positions, infl_k, infl_v, base,
                                 attend, impl)
        m, cur, emit = spec_accept(logits, draft, sampler, generator)
        # this round's slots 0..m become valid, with their pool slots
        accepted = (iota_n >= base) & (iota_n - base <= m[:, None]) & (iota_n < base + S)
        valid = valid | accepted
        infl_slots = torch.where(accepted, (lengths0 + acc)[:, None] + iota_n - base,
                                 infl_slots)
        # append the emitted tokens emit[:, :m+1] to each row's context
        d = iota_c - clen[:, None]
        ctx = torch.where((d >= 0) & (d <= m[:, None]),
                          emit.gather(1, d.clamp(0, S - 1).long()), ctx)
        emitted = (m + 1) * act
        acc = acc + emitted
        clen = clen + emitted
        toks.append(emit)
        counts.append(m + 1)
    counts = torch.stack(counts) * act[None, :]                        # [R, B]
    # round r's slot i goes to pool slot lengths0 + A_r + i, A_r the tokens
    # emitted before round r; slots past the round's count are not kept
    A = torch.cumsum(counts, dim=0) - counts
    slot = lengths0[None, None, :] + A[:, None, :] + iota_s[None, :, None]   # [R, S, B]
    keep = (iota_s[None, :, None] < counts[:, None, :]) & active[None, None, :]

    def by_slot(x):  # [L, B, Nk, R*S, D] -> [R, S, B, L, Nk, D]
        return x.reshape(L, B, Nk, n_rounds, S, D).permute(3, 4, 1, 0, 2, 5)

    _scatter_slots(state, slot, keep, by_slot(infl_k), by_slot(infl_v))
    state.lengths = lengths0 + acc
    return torch.stack(toks), counts.to(torch.int32), cur
