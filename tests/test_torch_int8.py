"""The port's int8 weight-only path against the JAX package's, on the CPU:
the plain versions of K3 and K5a against the TPU kernels in interpret
mode, then forward, decode_steps and decode_paged_steps on int8 params
(and on int4 layers beside a float head), the engine, the CLI and one
server request.

Kernel tolerances, relative to the largest output: fp32, 2e-6 (both sum
exact q * s * x products in fp32 in another order); bf16, one bf16 ulp
(2^-7) where both round one fp32 sum, 2^-6 for the stacked kernel at
M > 32, whose TPU branch rounds each dequantized weight to bf16 before
its matmul (measured: 5.3e-3).

The model-level checks put the float weights on the int8 grid first:
every group of 64 rows of a column holds integers in [-127, 127] times
2^-11, one of them 127, so quantization gives scale 2^-11 exactly and the
dequantized weights are exact in bf16, which the JAX package's CPU route
rounds them to (quant._matmul_dequant_reference). Both sides then compute
the same function in fp32 in another order: logits within 1e-4, greedy
tokens equal up to the first difference, which must be a near-tie (top-2
gap below 1e-3)."""

import functools
import http.server
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tinygpt_tpu.engine.engine import GPTConfig as JGPTConfig  # noqa: E402
from tinygpt_tpu.engine.engine import GPTEngine as JGPTEngine  # noqa: E402
from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache  # noqa: E402
from tinygpt_tpu.engine.paged_kv import PagedKVState as JPagedKVState  # noqa: E402
from tinygpt_tpu.hf.config import parse_model_config as j_parse  # noqa: E402
from tinygpt_tpu.models import causal_lm as jlm  # noqa: E402
from tinygpt_tpu.ops import quant_kernels as jqk  # noqa: E402
from tinygpt_tpu.ops.quant import quantize_params as j_quantize_params  # noqa: E402
from tinygpt_tpu_torch import cli  # noqa: E402
from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine  # noqa: E402
from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache  # noqa: E402
from tinygpt_tpu_torch.engine.paged_kv import PagedKVState  # noqa: E402
from tinygpt_tpu_torch.hf.config import parse_model_config  # noqa: E402
from tinygpt_tpu_torch.hf.safetensors_io import load_safetensors, save_safetensors  # noqa: E402
from tinygpt_tpu_torch.models import causal_lm  # noqa: E402
from tinygpt_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from tinygpt_tpu_torch.ops import quant_kernels as qk  # noqa: E402
from tinygpt_tpu_torch.ops.quant import QuantizedTensor, quantize_params, quantize_weight  # noqa: E402
from tinygpt_tpu_torch.server.http import ServerConfig, TinyGPTServer, _make_handler  # noqa: E402
from tinygpt_tpu_torch.tokenizer.chat_template import CHATML_TEMPLATE  # noqa: E402
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir  # noqa: E402
from tests.test_torch_quant_model import on_grid as on_grid4  # noqa: E402
from tests.test_torch_scheduler import _paged_state  # noqa: E402

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NEAR_TIE = 1e-3
GROUP = 64

# -- K3 / K5a ---------------------------------------------------------------------


def _kernel_tol(dtype: str, stacked: bool, M: int) -> float:
    if dtype == "float32":
        return 2e-6
    return 2.0 ** -6 if stacked and M > 32 else 2.0 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 33, 64])
@pytest.mark.parametrize("IN,group", [(64, 64), (896, 128)])
def test_int8_kernels_plain_match_jax_interpret(IN, group, M, dtype):
    """K3 and K5a (layer 1 of 2) plain versions against the TPU kernels in
    interpret mode, on the bytes quantize_weight(bits=8) makes (int8 rows
    are never padded: 896 has 7 groups of 128)."""
    rng = np.random.default_rng(IN + M)
    w = (rng.standard_normal((2, IN, 256)) * 0.05).astype(np.float32)
    qt = quantize_weight(torch.from_numpy(w), bits=8, group_size=group)
    assert qt.in_dim == IN and qt.group_size == group
    x = rng.standard_normal((M, IN)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jd, js = jnp.asarray(qt.data.numpy()), jnp.asarray(qt.scales.numpy())
    cases = [
        (False, qk.matmul_dequant_int8(tx, qt.data[1], qt.scales[1], group),
         jqk.matmul_dequant_int8(jx, jd[1], js[1], group=group, interpret=True)),
        (True, qk.matmul_dequant_int8_stacked(tx, qt.data, qt.scales, 1, group),
         jqk.matmul_dequant_int8_stacked(jx, jd, js, 1, group=group, interpret=True)),
    ]
    for stacked, got, want in cases:
        assert got.dtype == tx.dtype and got.shape == (M, 256)
        want = np.asarray(want).astype(np.float32)
        err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
        assert err <= _kernel_tol(dtype, stacked, M), (stacked, err)


def test_int8_plain_is_exact_dequant_matmul():
    """The plain versions: the weight dequantized exactly in fp32 (q *
    scale, rounded once), one fp32 product, one rounding to x's dtype."""
    rng = np.random.default_rng(3)
    qt = quantize_weight(torch.from_numpy(rng.standard_normal((3, 128, 64))
                                          .astype(np.float32)), bits=8, group_size=32)
    x = torch.from_numpy(rng.standard_normal((5, 128)).astype(np.float32))
    w = qt.data[2].float().reshape(4, 32, 64) * qt.scales[2][:, None, :]
    want = x @ w.reshape(128, 64)
    assert torch.equal(qk.matmul_dequant_int8_stacked_plain(x, qt.data, qt.scales, 2, 32),
                       want)
    got = qk.matmul_dequant_int8_plain(x.bfloat16(), qt.data[2], qt.scales[2], 32)
    assert torch.equal(got, (x.bfloat16().float() @ w.reshape(128, 64)).bfloat16())


# -- the model on int8 params ---------------------------------------------------------

_BASE = dict(vocab_size=101, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=64, rms_norm_eps=1e-5)
CONFIGS = {
    "llama": dict(_BASE, model_type="llama", tie_word_embeddings=True),
    "qwen2": dict(_BASE, model_type="qwen2"),               # qkv bias
    "qwen3": dict(_BASE, model_type="qwen3", head_dim=32),  # qk-norm
    "mistral": dict(_BASE, model_type="mistral", sliding_window=4),
}
B, S, PADS, N = 2, 8, (0, 3), 4


def on_grid8(w: np.ndarray, axis: int = -2) -> np.ndarray:
    """w with each group of 64 along `axis` on the int8 grid of scale 2^-11
    (see the module docstring); all-zero groups stay zero."""
    w = np.moveaxis(np.asarray(w, np.float32), axis, -1)
    q = np.clip(np.round(w * 2048), -127, 127)
    live = np.abs(w).reshape(*w.shape[:-1], -1, GROUP).max(-1) > 0
    q[..., ::GROUP] = np.where(live, 127, 0)
    return np.moveaxis(q / 2048, -1, axis).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models(fam: str, variant: str = "int8"):
    """(JAX cfg, JAX params, port cfg, port params) on the same bytes.
    variant "int8": every layer matrix and the head in int8; "int4_fhead":
    int4 layers beside a float head (quantize_lm_head=False)."""
    jcfg = j_parse(CONFIGS[fam])
    jparams = jlm.init_params(jcfg, seed=3, dtype=jnp.float32)
    grid = on_grid8 if variant == "int8" else on_grid4
    layers = dict(jparams["layers"])
    for k in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        layers[k] = jnp.asarray(grid(layers[k]))
    jparams = dict(jparams, layers=layers)
    if jparams["lm_head"] is None:  # tied: the head is embed.T
        jparams["embed"] = jnp.asarray(grid(jparams["embed"], axis=-1))
    else:
        jparams["lm_head"] = jnp.asarray(grid(jparams["lm_head"]))
    bits, head = (8, True) if variant == "int8" else (4, False)
    jq = j_quantize_params(jparams, bits=bits, group_size=GROUP, quantize_lm_head=head)
    tfloat = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tparams = quantize_params(tfloat, bits=bits, group_size=GROUP, quantize_lm_head=head)
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
def _jax_run(fam, variant):
    """JAX prefill logits, then the greedy tokens of two decode chunks."""
    jcfg, jparams, _, _ = _models(fam, variant)
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


def _check_forward_and_decode(fam, variant, route):
    want_lg, want_toks = _jax_run(fam, variant)
    _, _, cfg, params = _models(fam, variant)
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


@pytest.mark.parametrize("route", ["kernel", "plain"])
@pytest.mark.parametrize("fam", list(CONFIGS))
def test_int8_forward_and_decode_match_jax(fam, route):
    """int8 stacks and an int8 head: the prefill through K5a and K3, the
    decode through the unfused route (K5a, K3), here their plain versions."""
    _, jq, _, params = _models(fam, "int8")
    for k in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        qt = params["layers"][k]
        assert qt.bits == 8 and qt.group_size == GROUP
        np.testing.assert_array_equal(qt.data.numpy(), np.asarray(jq["layers"][k].data))
    assert params["lm_head"].bits == 8
    assert not causal_lm._int4_fused(params)
    _check_forward_and_decode(fam, "int8", route)


@pytest.mark.parametrize("fam", ["llama", "qwen2"])
def test_int4_layers_with_float_head_match_jax(fam):
    """quantize_lm_head=False: int4 layers on the fused decode route beside
    the float head (tied: embed.T), as JAX's quantize_params leaves it."""
    _, jq, _, params = _models(fam, "int4_fhead")
    assert causal_lm._int4_fused(params)
    assert not isinstance(params["lm_head"], QuantizedTensor)
    assert (params["lm_head"] is None) == (jq["lm_head"] is None)
    _check_forward_and_decode(fam, "int4_fhead", "kernel")


@pytest.mark.parametrize("fam", ["llama", "mistral"])
def test_int8_decode_paged_steps_match_jax(fam):
    """The batcher's decode quantum on int8 params (the unfused route with
    K5a and K3 between the K8 calls): 5 steps on forced tokens, ragged rows
    and an inactive one; every step's logits, the pools and the lengths."""
    jcfg, jparams, cfg, tparams = _models(fam, "int8")
    n_steps = 5
    st = _paged_state(cfg, 5, [20, 33, 7, 45], [True, True, True, False])
    forced = np.random.default_rng(6).integers(3, 101, (n_steps, 4)).astype(np.int32)
    tok0 = np.array([5, 9, 11, 13], np.int32)
    seen_j = []
    jstate = JPagedKVState(**{k: jnp.asarray(v) for k, v in st.items()})

    def j_sample(lg, key):  # the "key" of each step is its forced token row
        jax.debug.callback(lambda x: seen_j.append(np.asarray(x)), lg, ordered=True)
        return key

    jtoks, jst = jlm.decode_paged_steps(jparams, jcfg, jnp.asarray(tok0), jstate,
                                        jnp.asarray(forced), j_sample)
    jax.effects_barrier()
    seen_t = []

    def t_sample(lg):
        seen_t.append(lg.numpy().copy())
        return torch.from_numpy(forced[len(seen_t) - 1])

    tstate = PagedKVState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    toks = causal_lm.decode_paged_steps(tparams, cfg, torch.from_numpy(tok0), tstate,
                                        n_steps, t_sample)
    assert len(seen_t) == len(seen_j) == n_steps
    for i in range(n_steps):
        np.testing.assert_allclose(seen_t[i], seen_j[i], **LOGIT_TOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(jst.lengths))
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(getattr(tstate, name).numpy()[:, 1:],
                                   np.asarray(getattr(jst, name))[:, 1:], **LOGIT_TOL)


# -- engine, CLI and server -------------------------------------------------------

TINY = dict(model_type="llama", vocab_size=503, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256, rms_norm_eps=1e-5)
PROMPTS = ["Hello world", "the quick brown fox jumps over the lazy dog", "a"]
ENGINE_KW = dict(dtype="float32", max_tokens=10, prefill_bucket=16, decode_chunk=4,
                 quantization="int8")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A random llama dir whose projection and head weights are on the
    int8 grid (HF layout [out, in]: groups along the last axis)."""
    d = str(tmp_path_factory.mktemp("torch_int8_llama"))
    write_random_model_dir(d, TINY, seed=13, dtype=torch.float32)
    path = f"{d}/model.safetensors"
    weights = {k: torch.from_numpy(np.array(v)) for k, v in load_safetensors(path).items()}
    for k, v in weights.items():
        if k.endswith("proj.weight") or k == "lm_head.weight":
            weights[k] = torch.from_numpy(on_grid8(v.numpy(), axis=-1))
    save_safetensors(path, weights)
    return d


@pytest.fixture(scope="module")
def jax_outputs(model_dir):
    jeng = JGPTEngine(JGPTConfig(model_dir=model_dir, **ENGINE_KW))
    jeng.prepare()
    return jeng.generate_sync(PROMPTS)


def test_int8_generate_sync_matches_jax(model_dir, jax_outputs):
    """quantization="int8": group 128 by default (clipped to 64 where a
    matrix has 64 rows), no AWQ; the same greedy tokens and texts as the
    JAX engine."""
    teng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", **ENGINE_KW))
    teng.prepare()
    layers = teng.ctx.params["layers"]
    assert layers["qkv_w"].bits == 8 and layers["down_w"].group_size == 128
    ak.reset_launches()
    got = teng.generate_sync(PROMPTS)
    assert not ak.LAUNCHES  # CPU: plain versions only
    for g, w in zip(got, jax_outputs):
        assert g.token_ids == w.token_ids
        assert g.text == w.text
        assert g.finish_reason.value == w.finish_reason.value


def test_cli_int8(model_dir, capsys):
    rc = cli.main(["--model", model_dir, "--device", "cpu", "--dtype", "float32",
                   "--max-tokens", "4", "--quantization", "int8", "--prompt", "Hello"])
    assert rc == 0
    assert ">>> Hello" in capsys.readouterr().out


def test_server_int8_request_matches_jax(model_dir, jax_outputs):
    """One completion from TinyGPTServer(quantization="int8") through the
    continuous batcher: the JAX engine's greedy tokens, streamed."""
    srv = TinyGPTServer(ServerConfig(
        model_dir=model_dir, host="127.0.0.1", port=0, dtype="float32",
        max_tokens=10, device="cpu", chat_template=CHATML_TEMPLATE,
        batch_capacity=2, kv_n_blocks=32, quantization="int8"))
    srv.prepare()
    srv._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(srv))
    t = threading.Thread(target=srv._httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv._httpd.server_address[1]}/v1/completions"
        req = urllib.request.Request(
            url, data=json.dumps({"prompt": PROMPTS[1], "max_tokens": 10}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        body = json.loads(urllib.request.urlopen(req, timeout=120).read())
    finally:
        srv._httpd.shutdown()
        srv.worker.stop()
        t.join(timeout=30)
    assert srv.engine.ctx.params["layers"]["o_w"].bits == 8
    stream = srv.engine.ctx.tokenizer.decode_stream(skip_special_tokens=True)
    want = jax_outputs[1].token_ids
    assert body["usage"]["completion_tokens"] == len(want)
    assert body["choices"][0]["text"] == "".join(stream.step(x) for x in want) + stream.flush()
