"""GPT-2 model.

Counterpart of tinygpt_tpu/models/gpt2.py: learned positional embeddings
(wpe) indexed at each token's position, pre-norm LayerNorm blocks with
biases, a fused QKV projection (HF's Conv1D weights are [in, out] already:
no transpose), a tanh-GELU 4x MLP, and a head tied to the token embedding
(x @ wte.T); weights under the `transformer.` prefix, or none.

Params keep the JAX package's keys and layouts, so that
`params_from_numpy` carries JAX params across unchanged:

    wte [V, H]; wpe [P, H]; lnf_w / lnf_b [H];
    layers (STACKED along [L]): ln1_w, ln1_b, qkv_w [L, H, 3H], qkv_b,
            o_w [L, H, H], o_b, ln2_w, ln2_b, fc_w [L, H, I], fc_b,
            proj_w [L, I, H], proj_b.

Attention runs the same kernels as the llama family: `forward` (prefill)
through K1 (ops/attention.attention_with_cache), `decode_steps` through
K2 (flash_decode_frozen; the JAX package calls the XLA sdpa_decode_frozen
here, which computes the same function), `decode_paged_steps` through K8
and `forward_paged` through K9; attn_impl="plain" runs their plain
versions. The decode loops are causal_lm's (run_decode_steps,
run_decode_paged_steps, run_forward_paged), with this module's token step.
Weight-only params (ops/quant.quantize_params) run the four layer
matrices through K5a (int8) or K5b (int4) by layer index; the tied head
stays a float matmul, as in the JAX package. GPT-2 has no speculative
quantum (decode_paged_spec_steps): the batcher runs plain quanta for it.

A position past the last wpe row (n_positions - 1) reads that row, as the
JAX gather clamps: the batcher's pools may hold more slots per row than
the context.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from tinygpt_tpu_torch.engine.kv_cache import KVCache, kv_cast
from tinygpt_tpu_torch.engine.paged_kv import PagedKVState
from tinygpt_tpu_torch.hf.config import ModelConfig
from tinygpt_tpu_torch.models.causal_lm import (
    _check_supported,
    _impl,
    _layer,
    _mm,
    params_from_numpy,
    run_decode_paged_steps,
    run_decode_steps,
    run_forward_paged,
)
from tinygpt_tpu_torch.ops.attention import attention_with_cache
from tinygpt_tpu_torch.ops.norms import layer_norm

__all__ = ["load_params", "init_params", "params_from_numpy", "forward", "decode_steps",
           "decode_paged_steps", "forward_paged"]

# layer param -> HF name under h.{i}.
_HF_NAMES = {
    "ln1_w": "ln_1.weight", "ln1_b": "ln_1.bias",
    "qkv_w": "attn.c_attn.weight", "qkv_b": "attn.c_attn.bias",
    "o_w": "attn.c_proj.weight", "o_b": "attn.c_proj.bias",
    "ln2_w": "ln_2.weight", "ln2_b": "ln_2.bias",
    "fc_w": "mlp.c_fc.weight", "fc_b": "mlp.c_fc.bias",
    "proj_w": "mlp.c_proj.weight", "proj_b": "mlp.c_proj.bias",
}
_NORMS = ("ln1_w", "ln2_w")


def _layer_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    H, I = cfg.hidden_size, cfg.intermediate_size
    return {
        "ln1_w": (H,), "ln1_b": (H,),
        "qkv_w": (H, 3 * H), "qkv_b": (3 * H,),
        "o_w": (H, H), "o_b": (H,),
        "ln2_w": (H,), "ln2_b": (H,),
        "fc_w": (H, I), "fc_b": (I,),
        "proj_w": (I, H), "proj_b": (H,),
    }


def load_params(
    cfg: ModelConfig,
    weights: Dict[str, torch.Tensor],
    dtype: torch.dtype = torch.bfloat16,
    device: Any = "cuda",
) -> Dict:
    """HF safetensors names (with the `transformer.` prefix, or without)
    into the stacked-layer params dict, one layer at a time on the
    device."""
    L = cfg.num_hidden_layers

    def g(name: str) -> torch.Tensor:
        for prefix in ("transformer.", ""):
            if prefix + name in weights:
                return weights[prefix + name].to(device)
        raise KeyError(f"missing weight {name!r}")

    layers = {k: torch.empty((L, *s), dtype=dtype, device=device)
              for k, s in _layer_shapes(cfg).items()}
    for i in range(L):
        for key, name in _HF_NAMES.items():
            layers[key][i] = g(f"h.{i}.{name}")

    def own(name: str) -> torch.Tensor:
        # a copy, never a view of the (read-only) file mapping
        return g(name).to(dtype=dtype, copy=True)

    return {"wte": own("wte.weight"), "wpe": own("wpe.weight"), "layers": layers,
            "lnf_w": own("ln_f.weight"), "lnf_b": own("ln_f.bias")}


def init_params(cfg: ModelConfig, seed: int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: Any = "cuda") -> Dict:
    """Random params, drawn on the device from a torch.Generator seeded
    with `seed`: weights and biases N(0, 0.02²), LayerNorm weights 1 and
    biases 0 (the JAX init_params' distribution, not its numbers). Each
    layer is drawn on its own."""
    L, H, V = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size
    P = cfg.max_position_embeddings
    gen = torch.Generator(device=device).manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * 0.02).to(dtype)

    layers = {}
    for k, s in _layer_shapes(cfg).items():
        if k in _NORMS:
            layers[k] = torch.ones((L, *s), dtype=dtype, device=device)
        elif k in ("ln1_b", "ln2_b"):
            layers[k] = torch.zeros((L, *s), dtype=dtype, device=device)
        else:
            layers[k] = torch.empty((L, *s), dtype=dtype, device=device)
            for i in range(L):
                layers[k][i] = w(*s)
    return {"wte": w(V, H), "wpe": w(P, H), "layers": layers,
            "lnf_w": torch.ones((H,), dtype=dtype, device=device),
            "lnf_b": torch.zeros((H,), dtype=dtype, device=device)}


# -- layers ---------------------------------------------------------------


def _embed(params: Dict, ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """wte[ids] + wpe[positions], a position past the table reading its
    last row (the JAX gather clamps)."""
    pos = positions.long().clamp(0, params["wpe"].shape[0] - 1)
    return params["wte"][ids.long()] + params["wpe"][pos]


def _qkv(lp: Dict, x: torch.Tensor, cfg: ModelConfig, l: int, impl: str):
    """ln_1 and the fused QKV projection: x [B, S, H] -> q, k, v
    [B, S, N, D]."""
    B, S = x.shape[0], x.shape[1]
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.layer_norm_epsilon)
    qkv = _mm(lp, "qkv_w", h, l, impl) + lp["qkv_b"]
    q, k, v = qkv.reshape(B, S, 3, cfg.num_attention_heads, cfg.head_dim).unbind(2)
    return q, k, v


def _out_and_mlp(lp: Dict, x: torch.Tensor, attn: torch.Tensor, cfg: ModelConfig,
                 l: int, impl: str) -> torch.Tensor:
    """Output projection + residual, then ln_2, the tanh-GELU MLP (in the
    activation dtype, as the JAX package) + residual. attn [B, S, N, D]."""
    B, S = x.shape[0], x.shape[1]
    x = x + _mm(lp, "o_w", attn.reshape(B, S, -1), l, impl) + lp["o_b"]
    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.layer_norm_epsilon)
    h = F.gelu(_mm(lp, "fc_w", h, l, impl) + lp["fc_b"], approximate="tanh")
    return x + _mm(lp, "proj_w", h, l, impl) + lp["proj_b"]


def _logits(params: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final LayerNorm and the tied head, a float matmul: fp32 logits."""
    x = layer_norm(x, params["lnf_w"], params["lnf_b"], cfg.layer_norm_epsilon)
    return (x @ params["wte"].T).float()


def forward(
    params: Dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,    # [B, S]
    cache: KVCache,
    positions: torch.Tensor,    # [B, S] logical positions
    token_valid: torch.Tensor,  # [B, S] bool — real token vs pad
    last_only: bool = False,
    attn_impl: str = "kernel",  # "kernel" | "plain"
    last_pos=None,              # [B] row of the last REAL token (trailing pads)
) -> Tuple[torch.Tensor, KVCache]:
    """One forward step (prefill S > 1 or decode S = 1) at slot
    cache.length, attention through K1. Returns (fp32 logits [B, S, V],
    or [B, 1, V] if last_only, and the cache, updated in place)."""
    _check_supported(cfg, params)
    impl = _impl(attn_impl)
    S = input_ids.shape[1]
    slot = cache.length
    if slot + S > cache.max_len:
        raise ValueError(f"{S} tokens at slot {slot} overflow a cache of "
                         f"{cache.max_len} slots")
    cache.kv_pos[:, slot : slot + S] = positions
    cache.valid[:, slot : slot + S] = token_valid
    x = _embed(params, input_ids, positions)
    for l in range(cfg.num_hidden_layers):
        lp = _layer(params, l)
        q, k, v = _qkv(lp, x, cfg, l, impl)
        cache.k[l, :, :, slot : slot + S] = kv_cast(k.transpose(1, 2), cache.k.dtype)
        cache.v[l, :, :, slot : slot + S] = kv_cast(v.transpose(1, 2), cache.v.dtype)
        attn = attention_with_cache(
            q, cache.k[l], cache.v[l], q_pos=positions, kv_pos=cache.kv_pos,
            kv_valid=cache.valid, slot=slot, kernel=impl)
        x = _out_and_mlp(lp, x, attn, cfg, l, impl)
    if last_only and last_pos is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_pos.long()][:, None]
    elif last_only:  # left padding puts every row's last token at S - 1
        x = x[:, -1:]
    cache.length = slot + S
    return _logits(params, x, cfg), cache


def _decode_token(params, cfg, tok, pos, put_kv, attend, impl: str) -> torch.Tensor:
    """Logits [B, 1, V] of one decode step (the token step of causal_lm's
    shared loops): every layer hands its K/V [B, N, D] to put_kv(l, k, v),
    then attends through attend(l, q [B, 1, N, D])."""
    x = _embed(params, tok[:, None], pos)                             # [B, 1, H]
    for l in range(cfg.num_hidden_layers):
        lp = _layer(params, l)
        q, k, v = _qkv(lp, x, cfg, l, impl)
        put_kv(l, k[:, 0], v[:, 0])
        x = _out_and_mlp(lp, x, attend(l, q), cfg, l, impl)
    return _logits(params, x, cfg)


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
    """n_steps decode steps with the dense cache FROZEN (causal_lm's
    decode_steps, attention through K2). Returns (toks [n_steps, B] int32,
    the cache advanced in place)."""
    _check_supported(cfg, params)
    return run_decode_steps(_decode_token, params, cfg, tok0, cache, pos0, n_steps,
                            sample_fn, attn_impl)


def decode_paged_steps(
    params: Dict,
    cfg: ModelConfig,
    tok0: torch.Tensor,      # [B] int32 first input token of the quantum
    state: PagedKVState,
    n_steps: int,
    sample_fn: Callable[[torch.Tensor], torch.Tensor],
    attn_impl: str = "kernel",
) -> torch.Tensor:
    """The batcher's frozen decode quantum (causal_lm's decode_paged_steps,
    attention through K8). Returns the tokens [n_steps, B] int32; `state`
    is advanced in place."""
    _check_supported(cfg, params)
    return run_decode_paged_steps(_decode_token, params, cfg, tok0, state, n_steps,
                                  sample_fn, attn_impl)


def forward_paged(
    params: Dict,
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B] one decode token per row
    state: PagedKVState,
    attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, PagedKVState]:
    """One decode step over the paged pool (causal_lm's forward_paged,
    attention through K9). Returns (fp32 logits [B, V], `state` updated in
    place)."""
    _check_supported(cfg, params)
    return run_forward_paged(_decode_token, params, cfg, input_ids, state, attn_impl)
