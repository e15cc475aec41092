"""The port's CausalLM (tinygpt_tpu_torch.models.causal_lm) against the
JAX package: the same params (JAX init_params → params_from_numpy), the
same numpy inputs, fp32 on the CPU.

Both attention routes of the port are checked: "kernel" (the kernels'
plain versions on the CPU) and "plain" (the position-masked oracles).
Logit tolerance 1e-4 (fp32, a few layers, another summation order), as
tests/test_models.py uses for the JAX decode path. Greedy tokens must be
equal up to the first step where they differ, and that step must be a
near-tie: its top-2 logit gap below 1e-3, ten times the logit tolerance.

mixtral (4 experts, top 2) runs moe_mlp in the forward and the gathered
MLP (K12's plain version on the CPU) in every decode step; the JAX
package's CPU decode runs its dense moe_mlp: the same fp32 function."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tests.fixtures import build_tiny_model_dir  # noqa: E402
from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache  # noqa: E402
from tinygpt_tpu.hf.config import load_model_config as j_load_model_config  # noqa: E402
from tinygpt_tpu.hf.config import parse_model_config as j_parse  # noqa: E402
from tinygpt_tpu.hf.safetensors_io import load_safetensors_dir as j_load_dir  # noqa: E402
from tinygpt_tpu.models import causal_lm as jlm  # noqa: E402
from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache  # noqa: E402
from tinygpt_tpu_torch.hf.config import load_model_config, parse_model_config  # noqa: E402
from tinygpt_tpu_torch.hf.safetensors_io import load_safetensors_dir  # noqa: E402
from tinygpt_tpu_torch.models import causal_lm, get_model  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NEAR_TIE = 1e-3

_BASE = dict(vocab_size=101, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=64, rms_norm_eps=1e-5)
CONFIGS = {
    "llama": dict(_BASE, model_type="llama", rope_scaling={
        "rope_type": "llama3", "factor": 4.0, "high_freq_factor": 4.0,
        "low_freq_factor": 1.0, "original_max_position_embeddings": 16}),
    "qwen2": dict(_BASE, model_type="qwen2"),               # qkv bias
    "qwen3": dict(_BASE, model_type="qwen3", head_dim=32),  # qk-norm, head_dim
    "mistral": dict(_BASE, model_type="mistral", sliding_window=4),
    "mixtral": dict(_BASE, model_type="mixtral", num_local_experts=4,   # MoE MLP
                    num_experts_per_tok=2),
}
FAMILIES = list(CONFIGS)
ROUTES = ["kernel", "plain"]
B, S, PADS, N = 2, 8, (0, 3), 4


@functools.lru_cache(maxsize=None)
def _models(fam):
    jcfg = j_parse(CONFIGS[fam])
    jparams = jlm.init_params(jcfg, seed=3, dtype=jnp.float32)
    tparams = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, jparams, parse_model_config(CONFIGS[fam]), tparams


def _batch(vocab):
    rng = np.random.default_rng(0)
    ids = rng.integers(3, vocab, (B, S)).astype(np.int32)
    slots = np.arange(S)[None, :]
    pad = np.asarray(PADS)[:, None]
    valid = slots >= pad
    positions = np.where(valid, slots - pad, 0).astype(np.int32)
    ids = np.where(valid, ids, 0).astype(np.int32)
    lens = valid.sum(1).astype(np.int32)
    return ids, positions, valid, lens


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_prefill_and_step(fam):
    """JAX logits of a left-padded prefill and of one 1-token decode."""
    jcfg, jparams, _, _ = _models(fam)
    ids, positions, valid, lens = _batch(jcfg.vocab_size)
    cache = j_create_kv_cache(jcfg, B, 32, dtype=jnp.float32)
    lg, cache = jlm.forward(jparams, jcfg, jnp.asarray(ids), cache,
                            jnp.asarray(positions), jnp.asarray(valid))
    nxt = np.asarray(jnp.argmax(lg[:, -1], -1)).astype(np.int32)[:, None]
    lg1, _ = jlm.forward(jparams, jcfg, jnp.asarray(nxt), cache,
                         jnp.asarray(lens[:, None]), jnp.ones((B, 1), jnp.bool_))
    return np.asarray(lg), nxt, np.asarray(lg1)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fam", FAMILIES)
def test_forward_prefill_and_decode_match_jax(fam, route):
    want, nxt, want1 = _jax_prefill_and_step(fam)
    _, _, cfg, params = _models(fam)
    ids, positions, valid, lens = _batch(cfg.vocab_size)
    cache = create_kv_cache(cfg, B, 32, dtype=torch.float32, device="cpu")
    lg, cache = causal_lm.forward(params, cfg, _t(ids), cache, _t(positions),
                                  _t(valid), attn_impl=route)
    assert cache.length == S
    for b, p in enumerate(PADS):  # real positions only
        np.testing.assert_allclose(lg[b, p:].numpy(), want[b, p:], **LOGIT_TOL)
    lg1, cache = causal_lm.forward(params, cfg, _t(nxt), cache, _t(lens[:, None]),
                                   torch.ones(B, 1, dtype=torch.bool),
                                   attn_impl=route)
    assert cache.length == S + 1
    np.testing.assert_allclose(lg1.numpy(), want1, **LOGIT_TOL)


def _assert_tokens_match(got, want, gaps):
    """Equal up to the first difference, which must be a near-tie."""
    for b in range(got.shape[1]):
        diff = np.flatnonzero(got[:, b] != want[:, b])
        if diff.size:
            assert gaps[diff[0], b] < NEAR_TIE, (b, diff[0], gaps[diff[0], b])


@functools.lru_cache(maxsize=None)
def _jax_two_chunks(fam):
    jcfg, jparams, _, _ = _models(fam)
    ids, positions, valid, lens = _batch(jcfg.vocab_size)
    cache = j_create_kv_cache(jcfg, B, S + 2 * N, dtype=jnp.float32)
    lg, cache = jlm.forward(jparams, jcfg, jnp.asarray(ids), cache,
                            jnp.asarray(positions), jnp.asarray(valid),
                            last_only=True)
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
    out = [np.asarray(tok)[None]]
    for c in range(2):
        keys = jax.random.split(jax.random.PRNGKey(c), N)
        toks, cache = jlm.decode_steps(
            jparams, jcfg, tok, cache, jnp.asarray(lens[:, None] + c * N), keys,
            lambda x, k: jnp.argmax(x, -1).astype(jnp.int32), attn_impl="xla")
        out.append(np.asarray(toks))
        tok = toks[-1]
    return np.concatenate(out), np.asarray(cache.k), np.asarray(cache.kv_pos)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fam", FAMILIES)
def test_decode_steps_two_chunks_match_jax(fam, route):
    want, want_k, want_kv_pos = _jax_two_chunks(fam)
    _, _, cfg, params = _models(fam)
    ids, positions, valid, lens = _batch(cfg.vocab_size)
    cache = create_kv_cache(cfg, B, S + 2 * N, dtype=torch.float32, device="cpu")
    lg, cache = causal_lm.forward(params, cfg, _t(ids), cache, _t(positions),
                                  _t(valid), last_only=True, attn_impl=route)
    gaps = []

    def greedy(x):
        top2 = x.topk(2, dim=-1).values
        gaps.append((top2[:, 0] - top2[:, 1]).numpy())
        return x.argmax(-1)

    tok = greedy(lg[:, -1])
    out = [tok[None].numpy()]
    for c in range(2):
        toks, cache = causal_lm.decode_steps(
            params, cfg, tok, cache, _t(lens[:, None] + c * N), N, greedy,
            attn_impl=route)
        out.append(toks.numpy())
        tok = toks[-1]
    got = np.concatenate(out)
    _assert_tokens_match(got, want, np.stack(gaps))
    assert cache.length == S + 2 * N
    if (got == want).all():  # same tokens: same cache where written
        np.testing.assert_array_equal(cache.kv_pos.numpy(), want_kv_pos)
        for b, p in enumerate(PADS):
            np.testing.assert_allclose(cache.k[:, b, :, p:].numpy(),
                                       want_k[:, b, :, p:], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    out = {}
    for fam in FAMILIES:
        d = tmp_path_factory.mktemp(f"torch_tiny_{fam}")
        build_tiny_model_dir(fam, str(d), seed=5)
        out[fam] = str(d)
    return out


@pytest.mark.parametrize("fam,dtype", [(f, "float32") for f in FAMILIES]
                         + [("llama", "bfloat16")])
def test_load_params_matches_jax(hf_dirs, fam, dtype):
    """HF safetensors → params: transposes, q/k/v and gate/up fusion,
    dtype cast — bit-identical to the JAX package's load_params."""
    jcfg = j_load_model_config(hf_dirs[fam])
    jparams = jlm.load_params(jcfg, j_load_dir(hf_dirs[fam]),
                              dtype=getattr(jnp, dtype))
    want = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       device="cpu")
    cfg = load_model_config(hf_dirs[fam])
    got = causal_lm.load_params(cfg, load_safetensors_dir(hf_dirs[fam]),
                                dtype=getattr(torch, dtype), device="cpu")
    assert got.keys() == want.keys()
    assert got["layers"].keys() == want["layers"].keys()
    pairs = [(k, got[k], want[k]) for k in got if k != "layers"]
    pairs += [(k, got["layers"][k], want["layers"][k]) for k in got["layers"]]
    for k, g, w in pairs:
        if w is None:
            assert g is None, k
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


@pytest.mark.parametrize("model_type", ["gpt2", "mixtral"])
def test_families_not_ported_raise(model_type):
    """No family of the JAX registry is left unported: gpt2 and mixtral
    (the MoE MLP) return every entry point of the JAX registry's namespace,
    mixtral the speculative quantum too (as the JAX package: not gpt2)."""
    ns = get_model(model_type)
    for name in ("load_params", "init_params", "forward", "decode_steps",
                 "decode_paged_steps", "forward_paged"):
        assert callable(getattr(ns, name)), name
    assert hasattr(ns, "decode_paged_spec_steps") == (model_type == "mixtral")
    if model_type == "mixtral":
        assert ns.forward is causal_lm.forward
