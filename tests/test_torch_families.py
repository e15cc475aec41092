"""The port's decode routes against the JAX package at the features of the
bench shapes (benches/flagship_bench.py) that the other CPU tests do not
put together, on the same numpy-seeded params, in fp32 on the CPU:

  qwen2_g7  7 query heads over 1 KV head of 16 (Qwen2.5-0.5B's G = 7), qkv
            bias, tied head; hidden 112, so an int4 weight's 112 rows are
            padded to 256 (Qwen2.5-0.5B's 896 to 1,024);
  llama_g3  6 query heads over 2 of 16 (Llama-3.2-3B's G = 3), tied head;
  qwen3_g2  4 over 2 of 16 with qk-norm (Qwen3-1.7B's G = 2), tied head.

Every norm weight (input, post, final, q and k) is 1 + N(0, 0.1^2) and the
qkv bias N(0, 0.5^2), so a weight read at another head shows. Each runs
with float weights and with int4 weights (group 64) through the fused
decode route (K6 with the norm prologue and the bias / qk-norm / RoPE
epilogue, K7, K6 for the tied head with the final norm), here on the
kernels' plain versions, on both attention routes. For int4 the float
weights are first put on the int4 grid (as tests/test_torch_quant_model.py
does: the JAX package's CPU route rounds dequantized weights to bf16), with
groups that the row padding leaves partly zero. The prefill's logits, then
the logits of a decode chunk of 8 steps fed JAX's greedy tokens, within
1e-4."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache  # noqa: E402
from tinygpt_tpu.hf.config import parse_model_config as j_parse  # noqa: E402
from tinygpt_tpu.models import causal_lm as jlm  # noqa: E402
from tinygpt_tpu.ops.quant import quantize_params as j_quantize_params  # noqa: E402
from tinygpt_tpu.ops.rope import compute_rope_freqs  # noqa: E402
from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache  # noqa: E402
from tinygpt_tpu_torch.hf.config import parse_model_config  # noqa: E402
from tinygpt_tpu_torch.models import causal_lm  # noqa: E402
from tinygpt_tpu_torch.ops.quant import QuantizedTensor  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
GROUP = 64
_BASE = dict(vocab_size=101, intermediate_size=128, num_hidden_layers=2,
             max_position_embeddings=64, rms_norm_eps=1e-6, tie_word_embeddings=True)
CONFIGS = {
    "qwen2_g7": dict(_BASE, model_type="qwen2", hidden_size=112, num_attention_heads=7,
                     num_key_value_heads=1),
    "llama_g3": dict(_BASE, model_type="llama", hidden_size=64, num_attention_heads=6,
                     num_key_value_heads=2, head_dim=16),
    "qwen3_g2": dict(_BASE, model_type="qwen3", hidden_size=64, num_attention_heads=4,
                     num_key_value_heads=2, head_dim=16),
}
B, S, PADS, N = 2, 8, (0, 3), 8


def on_grid(w: np.ndarray, axis: int) -> np.ndarray:
    """w with each group of 64 along `axis` (the last one partial, as the
    int4 row padding completes it with zero rows) on the int4 grid of scale
    2^-7: integers in [-7, 7] times 2^-7, the group's first one 7."""
    w = np.moveaxis(np.asarray(w, np.float32), axis, -1)
    n = w.shape[-1]
    pad = -n % GROUP
    q = np.clip(np.round(np.pad(w, [(0, 0)] * (w.ndim - 1) + [(0, pad)]) * 128), -7, 7)
    q[..., ::GROUP] = 7
    return np.moveaxis(q[..., :n] / 128, -1, axis).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models(name, weights):
    """The JAX params (drawn with numpy: weights N(0, 0.02^2), norm weights
    1 + N(0, 0.1^2), the qkv bias N(0, 0.5^2); JAX's RoPE tables), int4
    ones quantized by the JAX package, and the port's on the same bytes."""
    jcfg = j_parse(CONFIGS[name])
    shapes = jax.eval_shape(lambda: jlm.init_params(jcfg, dtype=jnp.float32))
    rng = np.random.default_rng(7)

    def draw(key, shape):
        if key.endswith(("_ln", "_norm")):
            return 1 + 0.1 * rng.standard_normal(shape)
        return (0.5 if key == "qkv_b" else 0.02) * rng.standard_normal(shape)

    cos, sin = compute_rope_freqs(jcfg.head_dim, jcfg.max_position_embeddings,
                                  jcfg.rope_theta, jcfg.rope_scaling)
    layers = {k: draw(k, v.shape) for k, v in shapes["layers"].items()}
    jparams = dict(embed=draw("embed", shapes["embed"].shape), layers=layers,
                   final_ln=draw("final_ln", shapes["final_ln"].shape), lm_head=None,
                   rope_cos=np.asarray(cos), rope_sin=np.asarray(sin))
    assert shapes["lm_head"] is None  # tied: the head is embed.T
    if weights == "int4":
        for k in ("qkv_w", "o_w", "gate_up_w", "down_w"):
            layers[k] = on_grid(layers[k], axis=-2)
        jparams["embed"] = on_grid(jparams["embed"], axis=-1)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), jparams)
    if weights == "int4":
        jparams = j_quantize_params(jparams, bits=4, group_size=GROUP)
    tparams = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, parse_model_config(CONFIGS[name]), tparams


def _batch(vocab):
    rng = np.random.default_rng(0)
    ids = rng.integers(3, vocab, (B, S)).astype(np.int32)
    slots = np.arange(S)[None, :]
    pad = np.asarray(PADS)[:, None]
    valid = slots >= pad
    positions = np.where(valid, slots - pad, 0).astype(np.int32)
    ids = np.where(valid, ids, 0).astype(np.int32)
    return ids, positions, valid, valid.sum(1).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_run(name, weights):
    """JAX's prefill logits, then a greedy decode chunk of N steps: every
    step's logits (read out of the scan by a debug callback) and the tokens
    fed."""
    jcfg, jparams, _, _ = _models(name, weights)
    ids, positions, valid, lens = _batch(jcfg.vocab_size)
    cache = j_create_kv_cache(jcfg, B, S + N, dtype=jnp.float32)
    lg, cache = jlm.forward(jparams, jcfg, jnp.asarray(ids), cache,
                            jnp.asarray(positions), jnp.asarray(valid))
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
    seen, fed = [], [np.asarray(tok)]

    def greedy(x, key):
        jax.debug.callback(lambda v: seen.append(np.array(v)), x, ordered=True)
        return jnp.argmax(x, -1).astype(jnp.int32)

    toks, _ = jlm.decode_steps(jparams, jcfg, tok, cache, jnp.asarray(lens[:, None]),
                               jax.random.split(jax.random.PRNGKey(0), N), greedy,
                               attn_impl="xla")
    jax.effects_barrier()
    fed.extend(np.asarray(toks))
    return np.asarray(lg), np.stack(seen), np.stack(fed)


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("weights", ["float", "int4"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_route_matches_jax(name, weights, route):
    want_lg, want_steps, fed = _jax_run(name, weights)
    _, _, cfg, params = _models(name, weights)
    if weights == "float":
        assert params["lm_head"] is None
    else:
        assert isinstance(params["lm_head"], QuantizedTensor)  # the tied head's int4 copy
        assert causal_lm._int4_fused(params)                    # the fused decode route
    ids, positions, valid, lens = _batch(cfg.vocab_size)
    cache = create_kv_cache(cfg, B, S + N, dtype=torch.float32, device="cpu")
    lg, cache = causal_lm.forward(params, cfg, _t(ids), cache, _t(positions), _t(valid),
                                  attn_impl=route)
    for b, p in enumerate(PADS):  # real positions only
        np.testing.assert_allclose(lg[b, p:].numpy(), want_lg[b, p:], **LOGIT_TOL)
    seen = []

    def forced(x):
        seen.append(x.numpy().copy())
        return _t(fed[len(seen)])

    causal_lm.decode_steps(params, cfg, _t(fed[0]), cache, _t(lens[:, None]), N, forced,
                           attn_impl=route)
    assert len(seen) == len(want_steps) == N
    np.testing.assert_allclose(np.stack(seen), want_steps, **LOGIT_TOL)
