"""Pipeline parallelism: microbatched stages over a "pp" mesh axis.

Counterpart of tinygpt_tpu/parallel/pipeline.py on torch.distributed.
The layers are stacked on a leading axis, so staging is a reshape
[L, ...] -> [PP, L/PP, ...]: stage s owns layers [s * L/PP, (s + 1) * L/PP),
with Megatron tp inside each stage as in the single-stage path.

`make_pipelined_forward` runs the JAX schedule: the batch is cut into
n_micro microbatches, and tick t runs microbatch t - stage on each stage
(n_micro + pp - 1 ticks, pp - 1 of them bubbles). Activations hop from
stage s to s + 1 by a point-to-point send. Each stage updates only its own
layers' KV cache; the last stage's logits are broadcast to every stage, so
that every rank samples the same tokens. Prefill (S = prompt length) and
decode (S = 1) take the same function; attention runs through K1 and,
at S = 1, K13 (ops/attention.attention_with_cache).

Pipeline stages cover the llama family in float weights, without sequence
parallelism or speculation, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from tinygpt_tpu_torch.engine.kv_cache import KVCache
from tinygpt_tpu_torch.hf.config import ModelConfig
from tinygpt_tpu_torch.models.causal_lm import (
    _layer,
    _logits,
    decoder_layer_step,
    embed_tokens,
)
from tinygpt_tpu_torch.ops.quant import QuantizedTensor
from tinygpt_tpu_torch.ops.rope import gather_rope
from tinygpt_tpu_torch.parallel.distributed import broadcast, recv, send, world
from tinygpt_tpu_torch.parallel.sharding import (
    Mesh,
    param_pspecs,
    shard_context,
    shard_params,
)


def _restack(x, fn):
    if isinstance(x, QuantizedTensor):
        return QuantizedTensor(fn(x.data), fn(x.scales), x.bits, x.group_size, x.in_dim)
    return fn(x)


def _layers_of(layers: Dict) -> int:
    x = next(iter(layers.values()))
    return (x.data if isinstance(x, QuantizedTensor) else x).shape[0]


def stage_layers(layers: Dict, pp: int) -> Dict:
    """[L, ...] stacked layer dict -> [PP, L/PP, ...]."""
    L = _layers_of(layers)
    if L % pp:
        raise ValueError(f"num layers {L} not divisible by pp={pp}")
    return {k: _restack(v, lambda x: x.reshape(pp, L // pp, *x.shape[1:]))
            for k, v in layers.items()}


def unstage_layers(layers: Dict) -> Dict:
    return {k: _restack(v, lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]))
            for k, v in layers.items()}


def stage_cache(cache: KVCache, pp: int) -> KVCache:
    """KVCache k / v [L, B, Nk, T, D] -> [PP, L/PP, B, Nk, T, D]."""
    L = cache.k.shape[0]
    if L % pp:
        raise ValueError(f"num layers {L} not divisible by pp={pp}")
    r = lambda x: x.reshape(pp, L // pp, *x.shape[1:])  # noqa: E731
    return dataclasses.replace(cache, k=r(cache.k), v=r(cache.v))


def unstage_cache(cache: KVCache) -> KVCache:
    r = lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])  # noqa: E731
    return dataclasses.replace(cache, k=r(cache.k), v=r(cache.v))


def staged_param_specs(cfg: ModelConfig, params_staged: Dict, tp: int) -> Dict:
    """The specs of the staged params (the JAX package's, as tuples):
    layers get a leading "pp" dim on top of the Megatron tp specs; the
    rest is replicated across pp (the embedding serves the first stage,
    the final norm and head the last)."""
    layer_specs = {
        "input_ln": ("pp",), "qkv_w": ("pp", None, None, "tp"),
        "qkv_b": ("pp", None, "tp"), "o_w": ("pp", None, "tp", None),
        "post_ln": ("pp",), "gate_up_w": ("pp", None, None, "tp"),
        "down_w": ("pp", None, "tp", None), "q_norm": ("pp",), "k_norm": ("pp",),
    }
    vocab_tp = "tp" if tp > 1 and cfg.vocab_size % tp == 0 else None
    return {
        "embed": (vocab_tp, None),
        "layers": {k: layer_specs[k] for k in params_staged["layers"]},
        "final_ln": (),
        "lm_head": None if params_staged.get("lm_head") is None else (None, vocab_tp),
        "rope_cos": (), "rope_sin": (),
    }


def staged_cache_specs(cfg: ModelConfig, tp: int) -> Dict:
    kv_tp = "tp" if tp > 1 and cfg.num_kv_heads % tp == 0 else None
    return {"k": ("pp", None, "dp", kv_tp, None, None),
            "v": ("pp", None, "dp", kv_tp, None, None),
            "kv_pos": ("dp", None), "valid": ("dp", None), "length": ()}


def make_pipeline_mesh(dp: int, pp: int, tp: int, devices=None) -> Mesh:
    """Mesh ("dp", "pp", "tp") over the first dp * pp * tp ranks."""
    devices = list(devices if devices is not None else range(world()[1]))
    n = dp * pp * tp
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(np.asarray(devices[:n]).reshape(dp, pp, tp), ("dp", "pp", "tp"))


def shard_staged(params_staged: Dict, mesh: Mesh, cfg: ModelConfig):
    """This rank's stage of the staged params, cut over tp within the
    stage: (params with layers [L/PP, ...] and their ShardContext under
    "shard", the stage's local model config). Build the stage's KV cache
    with that config (its layers, its KV heads)."""
    from tinygpt_tpu_torch.parallel.sharding import local_config

    s = mesh.index("pp")
    stage = dict(params_staged)
    stage["layers"] = {k: _restack(v, lambda x: x[s]) for k, v in params_staged["layers"].items()}
    specs = param_pspecs(cfg, stage, mesh)
    out = shard_params(stage, mesh, specs, cfg)
    sc = shard_context(cfg, specs, mesh)
    out["shard"] = sc
    return out, local_config(cfg, sc, layers=_layers_of(stage["layers"]))


def make_pipelined_forward(mesh: Mesh, cfg: ModelConfig, n_micro: int,
                           attn_impl: str = "kernel", stage_cfg: Optional[ModelConfig] = None):
    """fn(params, ids, cache, positions, token_valid) -> (last-position
    logits [B, V] fp32 on every stage, the cache). `params` and `cache` are
    this rank's stage (shard_staged; the cache of `stage_cfg`, its local
    config); ids, positions and validity [B, S] are the whole batch, on
    every stage. B must be divisible by n_micro. The cache is updated in
    place and advanced by S slots."""
    pp = mesh.shape["pp"]
    stage = mesh.index("pp")
    group = mesh.group("pp")
    prev = mesh.src(pp=stage - 1) if stage > 0 else None
    nxt = mesh.src(pp=stage + 1) if stage < pp - 1 else None
    last = mesh.src(pp=pp - 1)
    lcfg = stage_cfg or cfg

    def fwd(params, ids, cache, positions, token_valid):
        B, S = ids.shape
        if B % n_micro:
            raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
        mb = B // n_micro
        slot = cache.length
        if slot + S > cache.max_len:
            raise ValueError(f"{S} tokens at slot {slot} overflow a cache of "
                             f"{cache.max_len} slots")
        cache.kv_pos[:, slot : slot + S] = positions
        cache.valid[:, slot : slot + S] = token_valid
        sc = params.get("shard")
        rope_c, rope_s = gather_rope(params["rope_cos"], params["rope_sin"], positions)
        emb = params["embed"]
        dev = emb.device
        out = torch.zeros((B, cfg.vocab_size), dtype=torch.float32, device=dev)
        for t in range(n_micro + pp - 1):
            m = t - stage
            if not 0 <= m < n_micro:
                continue  # a bubble
            rows = slice(m * mb, (m + 1) * mb)
            if prev is None:
                x = embed_tokens(params, ids[rows])
            else:
                x = recv(torch.empty((mb, S, cfg.hidden_size), dtype=emb.dtype,
                                     device=dev), prev)
            # the microbatch's slot metadata, copied: a row slice of the
            # [B, T] tensors starts off the 16-byte alignment K1 reads at
            kv_pos, valid = cache.kv_pos[rows].clone(), cache.valid[rows].clone()
            for l in range(lcfg.num_hidden_layers):
                x = decoder_layer_step(
                    _layer(params, l), x, cache.k[l, rows], cache.v[l, rows], cfg=lcfg,
                    positions=positions[rows], kv_pos=kv_pos, valid=valid, slot=slot,
                    rope_c=rope_c[rows], rope_s=rope_s[rows], attn_impl=attn_impl, l=l,
                    sc=sc)
            if nxt is not None:
                send(x, nxt)
            else:  # the last stage's head, on the final position only
                out[rows] = _logits(params, x[:, -1:], lcfg, attn_impl)[:, 0]
        broadcast(out, last, group)
        cache.length = slot + S
        return out, cache

    return fwd
