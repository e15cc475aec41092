"""The port's GPT-2 (models/gpt2.py) against the JAX package's and HF's, on
the CPU: layer_norm, load_params, the prefill forward (against HF's
GPT2LMHeadModel too, as tests/test_models.py), decode_steps,
decode_paged_steps and forward_paged (a row whose position passes
n_positions included), int8 and int4 weights; then the continuous batcher
(frozen and stepwise quanta against the JAX batcher), the engine, the CLI
and the server on a GPT-2 dir with the port's generated tokenizer, and the
engine's use_generation_defaults against the JAX engine's.

Both packages compute the same fp32 functions in another order: logits
within 1e-4 of JAX's (HF's: 2e-4, as tests/test_models.py), greedy streams
equal up to a first difference that must be a near-tie (top-2 gap of the
JAX dense logits below 1e-3). Quantized weights are put on the int grid
first (tests/test_torch_quant_model.py), so that the JAX package's bf16
rounding of dequantized weights is exact."""

import http.server
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.fixtures import build_tiny_model_dir, hf_reference_logits
from tests.test_torch_forward_paged import (
    assert_paged_steps_agree,
    paged_state,
    run_forward_paged,
    stepwise,
)
from tinygpt_tpu.engine.engine import GPTConfig as JGPTConfig
from tinygpt_tpu.engine.engine import GPTEngine as JGPTEngine
from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache
from tinygpt_tpu.engine.paged_kv import PagedKVState as JPagedKVState
from tinygpt_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from tinygpt_tpu.engine.scheduler import Request as JRequest
from tinygpt_tpu.engine.scheduler import SchedulerConfig as JSchedulerConfig
from tinygpt_tpu.hf.config import load_model_config as j_load_config
from tinygpt_tpu.hf.safetensors_io import load_safetensors_dir as j_load_weights
from tinygpt_tpu.models import get_model as j_get_model
from tinygpt_tpu.models import gpt2 as jgpt2
from tinygpt_tpu.ops.norms import layer_norm as j_layer_norm
from tinygpt_tpu.ops.quant import quantize_params as j_quantize_params
from tinygpt_tpu.ops.sampling import SamplerConfig as JSamplerConfig
from tinygpt_tpu_torch import cli
from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
from tinygpt_tpu_torch.engine.paged_kv import PagedKVState
from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, Request, SchedulerConfig
from tinygpt_tpu_torch.hf.config import load_model_config
from tinygpt_tpu_torch.hf.safetensors_io import load_safetensors_dir
from tinygpt_tpu_torch.models import get_model, gpt2, params_device, params_dtype
from tinygpt_tpu_torch.ops.norms import layer_norm
from tinygpt_tpu_torch.ops.quant import QuantizedTensor, quantize_params
from tinygpt_tpu_torch.ops.sampling import SamplerConfig
from tinygpt_tpu_torch.server.http import ServerConfig, TinyGPTServer, _make_handler
from tinygpt_tpu_torch.tokenizer.chat_template import CHATML_TEMPLATE
from tinygpt_tpu_torch.utils.fixtures import EOS_ID, write_random_model_dir

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
HF_TOL = dict(rtol=2e-4, atol=2e-4)
NEAR_TIE = 1e-3
ROUTES = ["kernel", "plain"]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """HF's tiny GPT-2 (tests/fixtures: 3 layers, 4 heads of 16, vocab 503,
    n_positions 128) and the JAX package's params on it, carried across."""
    d = str(tmp_path_factory.mktemp("torch_gpt2_hf"))
    build_tiny_model_dir("gpt2", d, seed=29)
    jcfg = j_load_config(d)
    jparams = jgpt2.load_params(jcfg, j_load_weights(d), dtype=jnp.float32)
    tparams = gpt2.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return d, jcfg, jparams, load_model_config(d), tparams


def _t(a):
    return torch.from_numpy(np.array(a))


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 64)) * 2 + 0.5).astype(np.float32)
    w, b = rng.standard_normal(64).astype(np.float32), rng.standard_normal(64).astype(np.float32)
    for eps in (1e-5, 1e-2):
        got = layer_norm(_t(x), _t(w), _t(b), eps).numpy()
        want = np.asarray(j_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), eps))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_load_params_matches_jax(tiny):
    d, _, _, cfg, want = tiny
    got = gpt2.load_params(cfg, load_safetensors_dir(d), dtype=torch.float32, device="cpu")
    assert got.keys() == want.keys() and got["layers"].keys() == want["layers"].keys()
    pairs = [(k, got[k], want[k]) for k in got if k != "layers"]
    pairs += [(k, got["layers"][k], want["layers"][k]) for k in got["layers"]]
    for k, g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g, w), k


def _prefill(model, params, cfg, ids, pads, T, impl=None, jax_side=False):
    """Left-padded prefill of ids [B, S] (row b: pads[b] pad slots)."""
    B, S = ids.shape
    pos = np.maximum(np.arange(S)[None, :] - np.asarray(pads)[:, None], 0).astype(np.int32)
    valid = np.arange(S)[None, :] >= np.asarray(pads)[:, None]
    if jax_side:
        cache = j_create_kv_cache(cfg, B, T, dtype=jnp.float32)
        return model.forward(params, cfg, jnp.asarray(ids), cache, jnp.asarray(pos),
                             jnp.asarray(valid))
    cache = create_kv_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    return model.forward(params, cfg, _t(ids), cache, _t(pos), _t(valid), attn_impl=impl)


@pytest.mark.parametrize("impl", ROUTES)
def test_forward_matches_jax_and_hf(tiny, impl):
    d, jcfg, jparams, cfg, tparams = tiny
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    got, _ = _prefill(gpt2, tparams, cfg, ids, (0, 0), 32, impl)
    want, _ = _prefill(jgpt2, jparams, jcfg, ids, (0, 0), 32, jax_side=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), hf_reference_logits(d, ids), **HF_TOL)


@pytest.mark.parametrize("impl", ROUTES)
def test_left_padded_forward_matches_jax(tiny, impl):
    _, jcfg, jparams, cfg, tparams = tiny
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 10)).astype(np.int32)
    pads = (0, 4, 9)
    got, cache = _prefill(gpt2, tparams, cfg, ids, pads, 16, impl)
    want, _ = _prefill(jgpt2, jparams, jcfg, ids, pads, 16, jax_side=True)
    assert cache.length == 10
    for b, p in enumerate(pads):  # real tokens only: a pad query sees no slot
        np.testing.assert_allclose(got[b, p:].numpy(), np.asarray(want)[b, p:], **LOGIT_TOL)


def _capture_jax(seen):
    """A JAX sample_fn that records each step's logits and returns the
    step's "key": the forced tokens of that step."""
    def sample(lg, key):
        jax.debug.callback(lambda x: seen.append(np.asarray(x)), lg, ordered=True)
        return key
    return sample


def _forcing(forced, seen):
    def sample(lg):
        seen.append(lg.numpy().copy())
        return torch.from_numpy(forced[len(seen) - 1])
    return sample


@pytest.mark.parametrize("impl", ROUTES)
def test_decode_steps_matches_jax(tiny, impl):
    """A left-padded prefill, then 5 frozen-cache steps on forced tokens:
    every step's logits, and the cache after the merge."""
    _, jcfg, jparams, cfg, tparams = tiny
    ids = np.random.default_rng(2).integers(3, cfg.vocab_size, (2, 8)).astype(np.int32)
    pads, n = (0, 3), 5
    forced = np.random.default_rng(3).integers(3, cfg.vocab_size, (n, 2)).astype(np.int32)
    tok0 = np.array([7, 11], np.int32)
    pos0 = (8 - np.asarray(pads, np.int32))[:, None]

    _, jcache = _prefill(jgpt2, jparams, jcfg, ids, pads, 16, jax_side=True)
    seen_j = []
    jtoks, jcache = jgpt2.decode_steps(jparams, jcfg, jnp.asarray(tok0), jcache,
                                       jnp.asarray(pos0), jnp.asarray(forced),
                                       _capture_jax(seen_j))
    jax.effects_barrier()
    _, cache = _prefill(gpt2, tparams, cfg, ids, pads, 16, impl)
    seen_t = []
    toks, cache = gpt2.decode_steps(tparams, cfg, _t(tok0), cache, _t(pos0), n,
                                    _forcing(forced, seen_t), attn_impl=impl)
    for i in range(n):
        np.testing.assert_allclose(seen_t[i][:, -1], seen_j[i][:, -1], **LOGIT_TOL,
                                   err_msg=f"step {i}")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert cache.length == 8 + n
    for name in ("k", "v"):  # real slots: a pad slot's K/V past layer 0 differ
        for b, p in enumerate(pads):
            np.testing.assert_allclose(getattr(cache, name).numpy()[:, b, :, p : 8 + n],
                                       np.asarray(getattr(jcache, name))[:, b, :, p : 8 + n],
                                       **LOGIT_TOL)


@pytest.mark.parametrize("impl", ROUTES)
def test_decode_paged_steps_matches_jax(tiny, impl):
    """One frozen quantum of 4 steps (K8's route), ragged rows, a start
    inside a block and an inactive row: logits, tokens, lengths, pools."""
    _, jcfg, jparams, cfg, tparams = tiny
    active = np.array([True, True, True, False])
    st = paged_state(cfg, 4, [20, 33, 7, 45], [0, 2, 0, 0], active)
    forced = np.random.default_rng(5).integers(3, cfg.vocab_size, (4, 4)).astype(np.int32)
    tok0 = np.array([5, 9, 11, 13], np.int32)
    seen_j = []
    jtoks, jst = jgpt2.decode_paged_steps(
        jparams, jcfg, jnp.asarray(tok0),
        JPagedKVState(**{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(forced),
        _capture_jax(seen_j))
    jax.effects_barrier()
    tst = PagedKVState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    seen_t = []
    toks = gpt2.decode_paged_steps(tparams, cfg, _t(tok0), tst, 4, _forcing(forced, seen_t),
                                   attn_impl=impl)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert_paged_steps_agree(list(zip(seen_t, seen_j)), tst, jst, active)


@pytest.mark.parametrize("impl", ROUTES)
def test_forward_paged_matches_jax(tiny, impl):
    """Three forward_paged steps (K9's route). Row 0 starts at slot 126 of
    a table of 160 slots: its positions reach 128 = n_positions, where
    both packages read the last wpe row (the JAX gather clamps)."""
    _, jcfg, jparams, cfg, tparams = tiny
    assert cfg.max_position_embeddings == 128
    active = np.array([True, True, True, False])
    st = paged_state(cfg, 6, [126, 31, 7, 45], [0, 3, 0, 0], active, MB=10, n_blocks=24)
    forced = np.random.default_rng(7).integers(3, cfg.vocab_size, (3, 4)).astype(np.int32)
    seen, tst, jst = run_forward_paged(jgpt2, jparams, jcfg, gpt2, tparams, cfg, st,
                                       forced, impl)
    assert_paged_steps_agree(seen, tst, jst, active)
    assert int(tst.lengths[0]) == 129


def _on_grid(w, bits, group):
    """w with each group of `group` rows of a column on the int grid of
    scale 2^-7 (int4) or 2^-11 (int8), one value of each group at the
    largest integer, so quantization gives that scale exactly."""
    qmax, inv = (7, 128) if bits == 4 else (127, 2048)
    w = np.moveaxis(np.asarray(w, np.float32), -2, -1)
    q = np.clip(np.round(w * inv), -qmax, qmax)
    q[..., ::group] = qmax
    return np.moveaxis(q / inv, -1, -2).astype(np.float32)


@pytest.mark.parametrize("bits,group", [(8, 16), (4, 16), (4, 8)])
@pytest.mark.parametrize("impl", ROUTES)
def test_quantized_forward_matches_jax(tiny, bits, group, impl):
    """int8 and int4 layer weights (K5a / K5b's route by layer index); the
    tied head stays float in both packages."""
    _, jcfg, jparams, cfg, _ = tiny
    layers = dict(jparams["layers"])
    for k in ("qkv_w", "o_w", "fc_w", "proj_w"):
        layers[k] = jnp.asarray(_on_grid(layers[k], bits, group))
    jq = j_quantize_params(dict(jparams, layers=layers), bits=bits, group_size=group)
    assert "lm_head" not in jq
    tq = gpt2.params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    assert all(isinstance(tq["layers"][k], QuantizedTensor) and tq["layers"][k].bits == bits
               for k in ("qkv_w", "o_w", "fc_w", "proj_w"))
    ids = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    got, _ = _prefill(gpt2, tq, cfg, ids, (0, 2), 16, impl)
    want, _ = _prefill(jgpt2, jq, jcfg, ids, (0, 2), 16, jax_side=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], **LOGIT_TOL)
    np.testing.assert_allclose(got[1, 2:].numpy(), np.asarray(want)[1, 2:], **LOGIT_TOL)


@pytest.mark.parametrize("window,stride", [(64, 32), (100, 100)])
def test_window_nll_matches_jax(tiny, window, stride):
    """The perplexity evaluator on GPT-2: the summed NLL of 200 tokens
    against the JAX evaluator's, 1e-5 relative (tests/test_torch_evaluate.py)."""
    from tinygpt_tpu import evaluate as jeval
    from tinygpt_tpu_torch import evaluate

    _, jcfg, jparams, cfg, tparams = tiny
    ids = [int(x) for x in np.random.default_rng(9).integers(2, cfg.vocab_size, 200)]
    want = jeval.window_nll(j_get_model("gpt2"), jcfg, jparams, ids, window=window,
                            stride=stride)
    got = evaluate.window_nll(get_model("gpt2"), cfg, tparams, ids, window=window,
                              stride=stride)
    assert got[1] == want[1] == len(ids) - 1
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])


def test_quantize_params_keeps_the_gpt2_head_float(tiny):
    """quantize_params quantizes GPT-2's four layer matrices and adds no
    head (its tied head stays x @ wte.T, as the JAX package leaves it); a
    tied llama still gets a quantized transposed copy of its embedding."""
    _, _, _, cfg, tparams = tiny
    q = quantize_params(tparams, bits=8, group_size=16)
    assert "lm_head" not in q and torch.equal(q["wte"], tparams["wte"])
    assert {k for k, v in q["layers"].items() if isinstance(v, QuantizedTensor)} == {
        "qkv_w", "o_w", "fc_w", "proj_w"}
    llama = {"embed": torch.randn(100, 64), "lm_head": None,
             "layers": {"qkv_w": torch.randn(2, 64, 128)}}
    assert isinstance(quantize_params(llama, bits=8, group_size=64)["lm_head"],
                      QuantizedTensor)


@pytest.mark.parametrize("bits", [None, 8, 4])
def test_params_device_and_dtype_of_either_family(tiny, bits):
    """models.params_device and params_dtype read the token embedding of
    either family (GPT-2's wte, llama's embed), which quantize_params
    leaves in float."""
    _, _, _, _, tparams = tiny
    llama = {"embed": torch.randn(100, 64, dtype=torch.bfloat16), "lm_head": None,
             "layers": {"qkv_w": torch.randn(2, 64, 128, dtype=torch.bfloat16)}}
    for params, dtype in ((tparams, torch.float32), (llama, torch.bfloat16)):
        if bits:
            params = quantize_params(params, bits=bits, group_size=16)
        assert params_device(params) == torch.device("cpu")
        assert params_dtype(params) == dtype


# -- the continuous batcher ----------------------------------------------------

SC = dict(block_size=16, prefill_bucket=16, dtype="float32")


def _run(b, prompts, max_new, arrivals):
    got, step = {}, 0
    pending = sorted(zip(arrivals, range(len(prompts)), prompts))
    req_t = JRequest if isinstance(b, JBatcher) else Request
    while (b.has_work or pending) and step < 500:
        while pending and pending[0][0] <= step:
            _, i, p = pending.pop(0)
            b.add_request(req_t(request_id=i, prompt_ids=p, max_new_tokens=max_new))
        for ev in b.step():
            if ev.token_id is not None:
                got.setdefault(ev.request_id, []).append(ev.token_id)
        step += 1
    assert not b.has_work
    return got


def _assert_streams_agree(jcfg, jparams, prompts, a, b):
    """Equal streams, or equal up to a first difference where both tokens
    are within NEAR_TIE of the JAX dense argmax."""
    assert a.keys() == b.keys()
    for rid in a:
        x, y = a[rid], b[rid]
        if x == y:
            continue
        i = next(j for j in range(min(len(x), len(y))) if x[j] != y[j])
        ctx = prompts[rid] + x[:i]
        lg, _ = _prefill(jgpt2, jparams, jcfg, np.asarray([ctx], np.int32), (0,), len(ctx),
                         jax_side=True)
        lg = np.asarray(lg)[0, -1]
        assert lg.max() - lg[x[i]] < NEAR_TIE and lg.max() - lg[y[i]] < NEAR_TIE, (
            f"request {rid} diverges at {i} without a near-tie")


def _batchers(tiny, kw, quantum):
    _, jcfg, jparams, cfg, tparams = tiny
    ns = {"frozen": get_model("gpt2"), "stepwise": stepwise(get_model("gpt2"))}[quantum]
    jns = {"frozen": j_get_model("gpt2"), "stepwise": stepwise(j_get_model("gpt2"))}[quantum]
    return (JBatcher(jns, jcfg, jparams, eos_ids=set(), config=JSchedulerConfig(**SC, **kw)),
            ContinuousBatcher(ns, cfg, tparams, eos_ids=set(),
                              config=SchedulerConfig(**SC, **kw)))


@pytest.mark.parametrize("quantum", ["frozen", "stepwise"])
def test_batcher_streams_match_jax(tiny, quantum):
    """Staggered requests, more than the 3 rows, one sharing a prefix block
    with another: the port's greedy streams (K8's frozen quantum, or K9's
    stepwise one) against the JAX batcher's on the same namespace; the
    stepwise streams against the frozen ones."""
    _, jcfg, jparams, cfg, _ = tiny
    rng = np.random.default_rng(11)
    prompts = [[int(x) for x in rng.integers(3, cfg.vocab_size, n)] for n in (5, 20, 37, 3, 2)]
    prompts[3] = prompts[2][:16] + prompts[3]
    arrivals = [0, 0, 1, 3, 6]
    kw = dict(batch_capacity=3, n_blocks=40, max_blocks_per_seq=6, decode_quantum=4)
    jb, b = _batchers(tiny, kw, quantum)
    want = _run(jb, prompts, 9, arrivals)
    got = _run(b, prompts, 9, arrivals)
    assert all(len(v) == 9 for v in got.values())
    _assert_streams_agree(jcfg, jparams, prompts, got, want)
    if quantum == "stepwise":
        frozen = _run(_batchers(tiny, kw, "frozen")[1], prompts, 9, arrivals)
        _assert_streams_agree(jcfg, jparams, prompts, got, frozen)


@pytest.mark.parametrize("quantum", ["frozen", "stepwise"])
def test_batcher_row_past_n_positions_matches_jax(tiny, quantum):
    """A row's pool range (10 blocks of 16 = 160 slots) exceeds n_positions
    (128): a prompt of 120 tokens decodes to position 135, reading the last
    wpe row from 128 on, beside a short row. The streams equal the JAX
    batcher's, whose gather clamps."""
    _, jcfg, jparams, cfg, _ = tiny
    rng = np.random.default_rng(12)
    prompts = [[int(x) for x in rng.integers(3, cfg.vocab_size, n)] for n in (120, 4)]
    kw = dict(batch_capacity=2, n_blocks=24, max_blocks_per_seq=10, decode_quantum=4)
    jb, b = _batchers(tiny, kw, quantum)
    want = _run(jb, prompts, 16, [0, 0])
    got = _run(b, prompts, 16, [0, 0])
    assert [len(got[i]) for i in (0, 1)] == [16, 16]
    _assert_streams_agree(jcfg, jparams, prompts, got, want)


# -- the engine, the CLI and the server on a GPT-2 dir ---------------------------

TINY_GPT2 = dict(model_type="gpt2", vocab_size=503, n_embd=64, n_layer=2, n_head=4,
                 n_positions=256)
PROMPTS = ["Hello world", "the quick brown fox jumps over the lazy dog", "a"]
ENGINE_KW = dict(dtype="float32", max_tokens=10, prefill_bucket=16, decode_chunk=4)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_gpt2_dir")
    return write_random_model_dir(str(d), TINY_GPT2, seed=13, dtype=torch.float32)


@pytest.fixture(scope="module")
def engines(model_dir):
    jeng = JGPTEngine(JGPTConfig(model_dir=model_dir, **ENGINE_KW))
    jeng.prepare()
    teng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", **ENGINE_KW))
    teng.prepare()
    return jeng, teng


def test_fixture_writes_gpt2_hf_names(model_dir):
    w = load_safetensors_dir(model_dir)
    assert w["transformer.h.1.attn.c_attn.weight"].shape == (64, 192)  # Conv1D [in, out]
    assert w["transformer.h.0.mlp.c_fc.weight"].shape == (64, 256)
    assert not w["transformer.wte.weight"][EOS_ID].any()
    assert not any(k.startswith("model.") or k == "lm_head.weight" for k in w)


def test_engine_generate_sync_matches_jax(engines):
    jeng, teng = engines
    want = jeng.generate_sync(PROMPTS)
    got = teng.generate_sync(PROMPTS)
    assert [g.token_ids for g in got] == [w.token_ids for w in want]
    assert [g.text for g in got] == [w.text for w in want]
    assert all(len(g.token_ids) == ENGINE_KW["max_tokens"] for g in got)


def test_engine_greedy_determinism(engines):
    _, teng = engines
    a = teng.generate_sync(["Deterministic prompt"])[0]
    b = teng.generate_sync(["Deterministic prompt"])[0]
    assert a.token_ids == b.token_ids and a.text == b.text


def test_engine_batch_matches_single(engines):
    _, teng = engines
    solo = teng.generate_sync(["One fish two fish"])[0]
    batch = teng.generate_sync(["One fish two fish",
                                "A much much much longer prompt than that one"])[0]
    assert solo.token_ids == batch.token_ids


def test_engine_speculation_matches_greedy(model_dir):
    """n-gram speculation of one prompt (verify forwards through K1's
    route) gives the greedy tokens, in the port and in the JAX engine."""
    prompt = "the cat sat on the mat. the cat sat on the"
    kw = dict(dtype="float32", max_tokens=24, spec_draft_len=4, spec_ngram=2)
    outs = {}
    for spec in (None, "ngram"):
        eng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", speculative=spec, **kw))
        eng.prepare()
        outs[spec] = eng.generate_sync([prompt])[0].token_ids
    jeng = JGPTEngine(JGPTConfig(model_dir=model_dir, speculative="ngram", **kw))
    jeng.prepare()
    assert outs[None] == outs["ngram"] == jeng.generate_sync([prompt])[0].token_ids
    assert len(outs[None]) == 24


@pytest.mark.parametrize("case", ["adopted", "explicit_wins", "off"])
def test_generation_config_sampling_defaults(tmp_path, case):
    """The contract of tests/test_engine.py's generation-config test, in
    both engines on one dir: do_sample defaults are adopted when no sampler
    knob is set, an explicit knob wins, use_generation_defaults=False keeps
    the sampler at its defaults."""
    d = write_random_model_dir(str(tmp_path / "m"), TINY_GPT2, seed=7, dtype=torch.float32)
    with open(os.path.join(d, "generation_config.json"), "w") as f:
        json.dump({"eos_token_id": EOS_ID, "do_sample": True, "temperature": 0.7,
                   "top_p": 0.9}, f)
    kw = {"adopted": {}, "explicit_wins": {"temperature": 0.1},
          "off": {"use_generation_defaults": False}}[case]
    base = dict(model_dir=d, dtype="float32", max_tokens=2)
    if "temperature" in kw:
        jeng = JGPTEngine(JGPTConfig(**base, sampler=JSamplerConfig(**kw)))
        teng = GPTEngine(GPTConfig(**base, device="cpu", sampler=SamplerConfig(**kw)))
    else:
        jeng = JGPTEngine(JGPTConfig(**base, **kw))
        teng = GPTEngine(GPTConfig(**base, device="cpu", **kw))
    jeng.prepare()
    teng.prepare()
    want = jeng.config.sampler
    got = teng.config.sampler
    assert (got.temperature, got.top_k, got.top_p, got.min_p) == (
        want.temperature, want.top_k, want.top_p, want.min_p)
    expect = {"adopted": (0.7, 0.9), "explicit_wins": (0.1, None), "off": (None, None)}[case]
    assert (got.temperature, got.top_p) == expect
    if case == "off":
        assert got == SamplerConfig()


def test_cli_gpt2(model_dir, capsys):
    rc = cli.main(["--model", model_dir, "--device", "cpu", "--dtype", "float32",
                   "--max-tokens", "4", "--prompt", "Hello", "--prompt", "world"])
    assert rc == 0
    out = capsys.readouterr().out
    assert ">>> Hello" in out and ">>> world" in out


def test_server_serves_gpt2(model_dir, engines):
    """One chat completion and one plain completion through the HTTP server
    (the continuous batcher's frozen quantum); the plain completion's text
    is the engine's greedy text for the same prompt."""
    srv = TinyGPTServer(ServerConfig(
        model_dir=model_dir, host="127.0.0.1", port=0, dtype="float32", max_tokens=6,
        device="cpu", chat_template=CHATML_TEMPLATE, batch_capacity=2, kv_n_blocks=32))
    srv.prepare()
    srv._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(srv))
    url = f"http://127.0.0.1:{srv._httpd.server_address[1]}"
    t = threading.Thread(target=srv._httpd.serve_forever, daemon=True)
    t.start()

    def post(path, body):
        req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"},
                                     method="POST")
        return json.loads(urllib.request.urlopen(req, timeout=120).read())

    try:
        chat = post("/v1/chat/completions",
                    {"messages": [{"role": "user", "content": "hi there"}], "max_tokens": 5})
        comp = post("/v1/completions", {"prompt": PROMPTS[1], "max_tokens": 6})
    finally:
        srv._httpd.shutdown()
        srv.worker.stop()
        t.join(timeout=30)
    assert chat["choices"][0]["message"]["role"] == "assistant"
    assert chat["usage"]["completion_tokens"] == 5
    _, teng = engines
    teng.reconfigure(max_tokens=6)
    try:
        want = teng.generate_sync([PROMPTS[1]])[0].text
    finally:
        teng.reconfigure(max_tokens=ENGINE_KW["max_tokens"])
    assert comp["choices"][0]["text"] == want
