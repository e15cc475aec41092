"""The port's int4 model, engine and CLI against the JAX package's, on the
CPU, on the same quantized bytes.

The JAX package's CPU route rounds each dequantized weight to bf16 before
its matmul (quant._matmul_dequant_reference); the port's plain versions
dequantize exactly in fp32. So that the comparison stays sharp, the
float weights are put on the int4 grid first: every group (64 rows of a
column) holds integers in [-7, 7] times 2^-7 and one of them is 7, so
quantization gives scale 2^-7 and the dequantized weights are exact in
bf16. Both sides then compute the same function in fp32 in another
order: logits within 1e-4 (as tests/test_torch_causal_lm.py), greedy
tokens equal up to the first difference, which must be a near-tie (top-2
gap below 1e-3). On the port, the prefill runs K5b and K4, the decode
the fused route (K6, K7), here through their plain versions."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tinygpt_tpu.engine.engine import GPTConfig as JGPTConfig  # noqa: E402
from tinygpt_tpu.engine.engine import GPTEngine as JGPTEngine  # noqa: E402
from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache  # noqa: E402
from tinygpt_tpu.hf.config import parse_model_config as j_parse  # noqa: E402
from tinygpt_tpu.models import causal_lm as jlm  # noqa: E402
from tinygpt_tpu.ops.quant import quantize_params as j_quantize_params  # noqa: E402
from tinygpt_tpu_torch import cli  # noqa: E402
from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine  # noqa: E402
from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache  # noqa: E402
from tinygpt_tpu_torch.hf.config import parse_model_config  # noqa: E402
from tinygpt_tpu_torch.hf.safetensors_io import load_safetensors, save_safetensors  # noqa: E402
from tinygpt_tpu_torch.models import causal_lm  # noqa: E402
from tinygpt_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from tinygpt_tpu_torch.ops.quant import QuantizedTensor, quantize_params  # noqa: E402
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NEAR_TIE = 1e-3
GROUP = 64

_BASE = dict(vocab_size=101, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=64, rms_norm_eps=1e-5)
CONFIGS = {
    "llama": dict(_BASE, model_type="llama", tie_word_embeddings=True),
    "qwen2": dict(_BASE, model_type="qwen2"),               # qkv bias
    "qwen3": dict(_BASE, model_type="qwen3", head_dim=32),  # qk-norm
    "mistral": dict(_BASE, model_type="mistral", sliding_window=4),
}
FAMILIES = list(CONFIGS)
ROUTES = ["kernel", "plain"]
B, S, PADS, N = 2, 8, (0, 3), 4


def on_grid(w: np.ndarray, axis: int = -2) -> np.ndarray:
    """w with each group of 64 along `axis` on the int4 grid of scale 2^-7
    (see the module docstring); all-zero groups stay zero."""
    w = np.moveaxis(np.asarray(w, np.float32), axis, -1)
    q = np.clip(np.round(w * 128), -7, 7)
    live = np.abs(w).reshape(*w.shape[:-1], -1, GROUP).max(-1) > 0
    q[..., ::GROUP] = np.where(live, 7, 0)
    return np.moveaxis(q / 128, -1, axis).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models(fam):
    jcfg = j_parse(CONFIGS[fam])
    jparams = jlm.init_params(jcfg, seed=3, dtype=jnp.float32)
    layers = dict(jparams["layers"])
    for k in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        layers[k] = jnp.asarray(on_grid(layers[k]))
    jparams = dict(jparams, layers=layers)
    if jparams["lm_head"] is None:  # tied: the head is embed.T
        jparams["embed"] = jnp.asarray(on_grid(jparams["embed"], axis=-1))
    else:
        jparams["lm_head"] = jnp.asarray(on_grid(jparams["lm_head"]))
    jq = j_quantize_params(jparams, bits=4, group_size=GROUP)
    tparams = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    return jcfg, jq, parse_model_config(CONFIGS[fam]), tparams


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
def _jax_run(fam):
    """JAX prefill logits, then the greedy tokens of two decode chunks."""
    jcfg, jparams, _, _ = _models(fam)
    ids, positions, valid, lens = _batch(jcfg.vocab_size)
    cache = j_create_kv_cache(jcfg, B, S + 2 * N, dtype=jnp.float32)
    lg, cache = jlm.forward(jparams, jcfg, jnp.asarray(ids), cache,
                            jnp.asarray(positions), jnp.asarray(valid))
    tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)
    out = [np.asarray(tok)[None]]
    for c in range(2):
        keys = jax.random.split(jax.random.PRNGKey(c), N)
        toks, cache = jlm.decode_steps(
            jparams, jcfg, tok, cache, jnp.asarray(lens[:, None] + c * N), keys,
            lambda x, k: jnp.argmax(x, -1).astype(jnp.int32), attn_impl="xla")
        out.append(np.asarray(toks))
        tok = toks[-1]
    return np.asarray(lg), np.concatenate(out)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fam", FAMILIES)
def test_int4_forward_and_decode_match_jax(fam, route):
    want_lg, want_toks = _jax_run(fam)
    _, _, cfg, params = _models(fam)
    assert isinstance(params["lm_head"], QuantizedTensor)
    ids, positions, valid, lens = _batch(cfg.vocab_size)
    cache = create_kv_cache(cfg, B, S + 2 * N, dtype=torch.float32, device="cpu")
    lg, cache = causal_lm.forward(params, cfg, _t(ids), cache, _t(positions),
                                  _t(valid), attn_impl=route)
    assert lg.shape == (B, S, cfg.vocab_size)  # the head's pad columns are gone
    for b, p in enumerate(PADS):  # real positions only
        np.testing.assert_allclose(lg[b, p:].numpy(), want_lg[b, p:], **LOGIT_TOL)
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
    got, gaps = np.concatenate(out), np.stack(gaps)
    assert cache.length == S + 2 * N
    for b in range(B):
        diff = np.flatnonzero(got[:, b] != want_toks[:, b])
        if diff.size:
            assert gaps[diff[0], b] < NEAR_TIE, (b, diff[0], gaps[diff[0], b])


@pytest.mark.parametrize("fam", ["qwen2", "qwen3"])
def test_fused_decode_step_logits_match_unfused(fam):
    """One decode step through the fused route (K6 / K7 plain versions)
    against the same step through forward (K5b and K4): logits within
    1e-4 (fp32; the fused route keeps the gate_up activation and the qk
    norm in fp32, which in fp32 changes nothing)."""
    _, _, cfg, params = _models(fam)
    ids, positions, valid, lens = _batch(cfg.vocab_size)

    def prefilled():
        cache = create_kv_cache(cfg, B, S + 1, dtype=torch.float32, device="cpu")
        causal_lm.forward(params, cfg, _t(ids), cache, _t(positions), _t(valid))
        return cache

    tok = torch.tensor([5, 17], dtype=torch.int32)
    want, _ = causal_lm.forward(params, cfg, tok[:, None], prefilled(),
                                _t(lens[:, None]), torch.ones(B, 1, dtype=torch.bool))
    seen = []
    causal_lm.decode_steps(params, cfg, tok, prefilled(), _t(lens[:, None]), 1,
                           lambda x: seen.append(x) or x.argmax(-1))
    np.testing.assert_allclose(seen[0].numpy(), want[:, 0].numpy(), **LOGIT_TOL)


def test_int8_weights_over_an_fp8_cache():
    """int8 weights over an fp8 KV cache run (tests/test_torch_int8.py holds
    int8 to JAX): the logits stay close to the same params' over an fp32
    cache (top-1 agreement above 0.85, the JAX package's fp8 contract)."""
    cfg = parse_model_config(CONFIGS["llama"])
    p8 = quantize_params(causal_lm.init_params(cfg, seed=0, dtype=torch.float32,
                                               device="cpu"), bits=8, group_size=64)
    ids, positions, valid, _ = _batch(cfg.vocab_size)
    outs = {}
    for dt in (torch.float32, torch.float8_e4m3fn):
        cache = create_kv_cache(cfg, B, S, dtype=dt, device="cpu")
        outs[dt] = causal_lm.forward(p8, cfg, _t(ids), cache, _t(positions),
                                     _t(valid))[0].numpy()
        assert cache.k.dtype == dt
    top = [o.argmax(-1)[:, max(PADS):] for o in outs.values()]
    assert (top[0] == top[1]).mean() > 0.85


# -- engine and CLI ---------------------------------------------------------------

TINY = dict(model_type="llama", vocab_size=503, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256, rms_norm_eps=1e-5)
PROMPTS = ["Hello world", "the quick brown fox jumps over the lazy dog", "a"]
ENGINE_KW = dict(dtype="float32", max_tokens=10, prefill_bucket=16, decode_chunk=4,
                 quantization="int4", awq=False)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A random llama dir whose projection and head weights are on the
    int4 grid (HF layout [out, in]: groups along the last axis)."""
    d = str(tmp_path_factory.mktemp("torch_quant_llama"))
    write_random_model_dir(d, TINY, seed=11, dtype=torch.float32)
    path = f"{d}/model.safetensors"
    weights = {k: torch.from_numpy(np.array(v)) for k, v in load_safetensors(path).items()}
    for k, v in weights.items():
        if k.endswith("proj.weight") or k == "lm_head.weight":
            weights[k] = torch.from_numpy(on_grid(v.numpy(), axis=-1))
    save_safetensors(path, weights)
    return d


def test_int4_generate_sync_matches_jax(model_dir):
    jeng = JGPTEngine(JGPTConfig(model_dir=model_dir, **ENGINE_KW))
    jeng.prepare()
    teng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", **ENGINE_KW))
    teng.prepare()
    assert isinstance(teng.ctx.params["layers"]["qkv_w"], QuantizedTensor)
    assert teng.ctx.params["layers"]["qkv_w"].group_size == GROUP
    ak.reset_launches()
    got = teng.generate_sync(PROMPTS)
    want = jeng.generate_sync(PROMPTS)
    assert not ak.LAUNCHES  # CPU: plain versions only
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert g.text == w.text
        assert g.finish_reason.value == w.finish_reason.value


@pytest.mark.parametrize("kw", [dict(quantization="int8"),
                                dict(quantization="int4", awq=None),
                                dict(quantization="int4", awq=True)])
def test_engine_quantization_matches_jax(model_dir, kw):
    """int8 and int4 with AWQ (the default, and asked for): the port's
    engine gives the JAX engine's quantized bytes (AWQ: up to one step in
    a few places, see tests/test_torch_awq.py) and greedy tokens."""
    kw = dict(ENGINE_KW, **kw)
    jeng = JGPTEngine(JGPTConfig(model_dir=model_dir, **kw))
    jeng.prepare()
    teng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", **kw))
    teng.prepare()
    for k in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        got, want = teng.ctx.params["layers"][k], jeng.ctx.params["layers"][k]
        assert got.bits == want.bits and got.group_size == want.group_size
        steps = np.abs(got.data.numpy().astype(int) - np.asarray(want.data).astype(int))
        assert (steps > 0).mean() < 1e-3, (k, (steps > 0).mean())
    got = teng.generate_sync(PROMPTS)
    want = jeng.generate_sync(PROMPTS)
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids


def test_cli_int4(model_dir, capsys):
    rc = cli.main(["--model", model_dir, "--device", "cpu", "--dtype", "float32",
                   "--max-tokens", "4", "--quantization", "int4", "--no-awq",
                   "--prompt", "Hello"])
    assert rc == 0
    assert ">>> Hello" in capsys.readouterr().out
    # without --no-awq the CLI runs AWQ, as the JAX CLI does
    rc = cli.main(["--model", model_dir, "--device", "cpu", "--dtype", "float32",
                   "--max-tokens", "4", "--quantization", "int4", "--prompt", "Hello"])
    assert rc == 0
    assert ">>> Hello" in capsys.readouterr().out
