"""The port's AWQ (tinygpt_tpu_torch.ops.awq) against the JAX package's
(tinygpt_tpu.ops.awq), on the CPU, in fp32, on the same numpy-seeded
params: tiny llama (tied head), qwen2 (qkv bias), qwen3 (qk-norm, head
dim 32), mistral (sliding window) and mixtral (the MoE folds; its alpha
search and quantized bytes at int4 are in tests/test_torch_moe_model.py),
each with salient channels in its norms so that the search moves away
from plain round-to-nearest.

Tolerances, measured on these models: the calibration statistics agree
to 1e-6 relative (the same fp32 prefill in another summation order), the
scales and folded weights to 1e-6 relative (log and exp differ by ulps
between XLA and torch); every layer picks the same alpha, and the
quantized bytes and scales of awq_quantize_params are identical (a ulp
in a folded weight could move one value by one step; none does here)."""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache  # noqa: E402
from tinygpt_tpu.hf.config import parse_model_config as j_parse  # noqa: E402
from tinygpt_tpu.models import causal_lm as jlm  # noqa: E402
from tinygpt_tpu.ops import awq as jawq  # noqa: E402
from tinygpt_tpu.tokenizer import Tokenizer as JTokenizer  # noqa: E402
from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache  # noqa: E402
from tinygpt_tpu_torch.hf.config import parse_model_config  # noqa: E402
from tinygpt_tpu_torch.models import causal_lm  # noqa: E402
from tinygpt_tpu_torch.ops import awq  # noqa: E402
from tinygpt_tpu_torch.ops.quant import QuantizedTensor, quantize_params  # noqa: E402
from tinygpt_tpu_torch.tokenizer import Tokenizer  # noqa: E402
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir  # noqa: E402

REL = 1e-6
_BASE = dict(vocab_size=101, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=64, rms_norm_eps=1e-5)
CONFIGS = {
    "llama": dict(_BASE, model_type="llama", tie_word_embeddings=True),
    "qwen2": dict(_BASE, model_type="qwen2"),
    "qwen3": dict(_BASE, model_type="qwen3", head_dim=32),
    "mistral": dict(_BASE, model_type="mistral", sliding_window=4),
    "mixtral": dict(_BASE, model_type="mixtral", num_local_experts=4,   # MoE folds
                    num_experts_per_tok=2),
}
FAMILIES = list(CONFIGS)
DENSE = [f for f in FAMILIES if f != "mixtral"]   # the tests of the dense MLP's keys
STACKS = (("qkv_w", "qkv_in"), ("o_w", "o_in"), ("gate_up_w", "gate_up_in"),
          ("down_w", "down_in"))


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(a).max())


@functools.lru_cache(maxsize=None)
def _models(fam):
    """(JAX cfg, JAX fp32 params, port cfg, port params, calibration ids).
    The norms get random gains and 8x on four channels (salient
    activations), qwen2 a random qkv bias."""
    jcfg = j_parse(CONFIGS[fam])
    jp = jlm.init_params(jcfg, seed=3, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    layers = dict(jp["layers"])
    for k in ("input_ln", "post_ln"):
        v = np.asarray(layers[k]) * rng.uniform(0.5, 1.5, layers[k].shape)
        v[:, :4] *= 8
        layers[k] = jnp.asarray(v.astype(np.float32))
    if "qkv_b" in layers:
        layers["qkv_b"] = jnp.asarray(
            rng.normal(0, 0.1, layers["qkv_b"].shape).astype(np.float32))
    final = np.asarray(jp["final_ln"]).copy()
    final[:4] *= 8
    jp = dict(jp, layers=layers, final_ln=jnp.asarray(final))
    tp = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    calib = rng.integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    return jcfg, jp, parse_model_config(CONFIGS[fam]), tp, calib


@functools.lru_cache(maxsize=None)
def _jax_stats(fam):
    jcfg, jp, _, _, calib = _models(fam)
    return {k: np.array(v) for k, v in
            jawq.collect_act_stats(jp, jcfg, jnp.asarray(calib)).items()}


@pytest.mark.parametrize("fam", FAMILIES)
def test_collect_act_stats_matches_jax(fam):
    _, _, cfg, tp, calib = _models(fam)
    want = _jax_stats(fam)
    got = awq.collect_act_stats(tp, cfg, calib)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == torch.float32
        assert _rel(v, got[k].numpy()) < REL, k


def _alpha_index(m, s, kv_share=None):
    """Which ALPHA_GRID entry produced the scales s [in] from stats m."""
    m_eff = m
    if kv_share is not None:
        m_eff = np.broadcast_to(m.reshape(kv_share).mean(1, keepdims=True),
                                kv_share).reshape(-1)
    cands = [np.asarray(jawq._scales_from_alpha(jnp.asarray(m_eff), a))
             for a in awq.ALPHA_GRID]
    return int(np.argmin([np.abs(c - s).max() for c in cands]))


@pytest.mark.parametrize("bits,group", [(4, 16), (8, 32)])
@pytest.mark.parametrize("fam", DENSE)
def test_search_picks_the_same_alpha_as_jax(fam, bits, group):
    jcfg, jp, cfg, tp, _ = _models(fam)
    stats = _jax_stats(fam)
    kv = (cfg.num_kv_heads, cfg.num_attention_heads // cfg.num_kv_heads, cfg.head_dim)
    alphas = []
    for key, sk in STACKS:
        share = kv if key == "o_w" else None
        want = np.asarray(jawq.search_scales(jp["layers"][key], jnp.asarray(stats[sk]),
                                             bits, group, kv_share=share))
        got = awq.search_scales(tp["layers"][key], torch.from_numpy(stats[sk]), bits,
                                group, kv_share=share).numpy()
        assert _rel(want, got) < REL, key
        for l in range(cfg.num_hidden_layers):
            a = _alpha_index(stats[sk][l], want[l], share)
            assert a == _alpha_index(stats[sk][l], got[l], share), (key, l)
            alphas.append(a)
    assert any(alphas), "the search never left alpha = 0 on these models"


@pytest.mark.parametrize("fam", FAMILIES)
def test_folded_params_match_jax(fam):
    jcfg, jp, cfg, tp, _ = _models(fam)
    stats = _jax_stats(fam)
    before = {k: v.clone() for k, v in tp["layers"].items()}
    want = jawq.apply_awq(jp, jcfg, {k: jnp.asarray(v) for k, v in stats.items()},
                          bits=4, group_size=16)
    got = awq.apply_awq(tp, cfg, {k: torch.from_numpy(v) for k, v in stats.items()},
                        bits=4, group_size=16)
    for k, v in want["layers"].items():
        assert _rel(v, got["layers"][k].numpy()) < REL, k
    for k in ("lm_head", "final_ln"):
        assert _rel(want[k], got[k].numpy()) < REL, k
    assert torch.equal(got["embed"], tp["embed"])  # the gather keeps the unscaled table
    for k, v in before.items():  # the input params are left as they were
        assert torch.equal(tp["layers"][k], v), k


def _logits(params, cfg, ids):
    B, S = ids.shape
    cache = create_kv_cache(cfg, B, S + 4, dtype=torch.float32, device="cpu")
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
    lg, _ = causal_lm.forward(params, cfg, torch.from_numpy(ids), cache, pos,
                              torch.ones(B, S, dtype=torch.bool))
    return lg.numpy()


@pytest.mark.parametrize("fam", FAMILIES)
def test_fold_is_exact_identity(fam):
    """As the JAX package's test of the same name: the folded float params
    are the same model (fp32 folds, reassociation noise only)."""
    _, _, cfg, tp, calib = _models(fam)
    stats = awq.collect_act_stats(tp, cfg, calib)
    for v in stats.values():
        assert torch.isfinite(v).all()
    folded = awq.apply_awq(tp, cfg, stats, bits=4, group_size=16)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    np.testing.assert_allclose(_logits(folded, cfg, ids), _logits(tp, cfg, ids),
                               atol=2e-3, rtol=1e-3)


def test_scales_never_lose_to_rtn():
    """The alpha grid includes 0 (identity), so the winning scales are at
    most RTN's error under the search's own objective (JAX's test)."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(2, 64, 32)).astype(np.float32)
    m = rng.uniform(0.01, 1.0, size=(2, 64)).astype(np.float32)
    m[:, :4] = 100.0  # salient channels
    s = awq.search_scales(torch.from_numpy(w), torch.from_numpy(m), bits=4, group_size=16)
    assert s.shape == (2, 64)
    np.testing.assert_allclose(
        s.numpy(), np.asarray(jawq.search_scales(jnp.asarray(w), jnp.asarray(m), 4, 16)),
        rtol=REL)

    def weighted_err(w2, m2, s2):
        dq = awq._qdq(torch.from_numpy(w2 * s2[:, None]), 4, 16).numpy() / s2[:, None]
        return float(np.sum(m2 * np.sum((dq - w2) ** 2, axis=-1)))

    for l in range(2):
        err_awq = weighted_err(w[l], m[l], s[l].numpy())
        err_rtn = weighted_err(w[l], m[l], np.ones(64, np.float32))
        assert err_awq <= err_rtn * (1 + 1e-6), (err_awq, err_rtn)
    assert float((s - 1.0).abs().max()) > 1e-3  # not the identity


def test_kv_share_grouping():
    """o_w scales are constant across the q heads of one kv group, and
    equal JAX's."""
    rng = np.random.default_rng(2)
    nk, g, d = 2, 2, 8  # Nq = 4 heads, in_dim = 32
    w = rng.normal(size=(1, nk * g * d, 16)).astype(np.float32)
    m = rng.uniform(0.01, 10.0, size=(1, nk * g * d)).astype(np.float32)
    s = awq.search_scales(torch.from_numpy(w), torch.from_numpy(m), bits=4,
                          group_size=16, kv_share=(nk, g, d)).numpy()
    want = np.asarray(jawq.search_scales(jnp.asarray(w), jnp.asarray(m), bits=4,
                                         group_size=16, kv_share=(nk, g, d)))
    np.testing.assert_allclose(s, want, rtol=REL)
    s = s[0].reshape(nk, g, d)
    np.testing.assert_array_equal(s[:, 0], s[:, 1])


@pytest.mark.parametrize("bits,group", [(4, 16), (8, 32)])
@pytest.mark.parametrize("fam", DENSE)
def test_awq_quantize_params_matches_jax(fam, bits, group):
    """Calibrate → fold → quantize end to end: the same bytes and scales."""
    jcfg, jp, cfg, tp, calib = _models(fam)
    want = jawq.awq_quantize_params(jp, jcfg, calib, bits=bits, group_size=group)
    got = awq.awq_quantize_params(tp, cfg, calib, bits=bits, group_size=group)
    for k in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        g, w = got["layers"][k], want["layers"][k]
        assert isinstance(g, QuantizedTensor) and (g.bits, g.group_size) == (w.bits, w.group_size)
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data), err_msg=k)
        np.testing.assert_allclose(g.scales.numpy(), np.asarray(w.scales), rtol=REL)
    np.testing.assert_array_equal(got["lm_head"].data.numpy(), np.asarray(want["lm_head"].data))
    for k in ("input_ln", "post_ln"):
        assert _rel(want["layers"][k], got["layers"][k].numpy()) < REL


def test_awq_beats_rtn_on_logits():
    """As JAX's end-to-end test: int4 AWQ tracks the float logits at least
    as well as plain RTN (mean squared logit error, 25 % slack)."""
    _, _, cfg, tp, calib = _models("llama")
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    ref = _logits(tp, cfg, ids)
    mse_awq = np.mean((_logits(awq.awq_quantize_params(tp, cfg, calib, bits=4,
                                                       group_size=16), cfg, ids) - ref) ** 2)
    mse_rtn = np.mean((_logits(quantize_params(tp, bits=4, group_size=16), cfg, ids)
                       - ref) ** 2)
    assert np.isfinite(mse_awq) and mse_awq <= mse_rtn * 1.25, (mse_awq, mse_rtn)


def test_default_calib_ids_match_jax(tmp_path):
    d = write_random_model_dir(str(tmp_path / "m"), dict(_BASE, model_type="llama",
                                                         vocab_size=503), seed=0)
    assert awq.DEFAULT_CALIB_TEXT == jawq.DEFAULT_CALIB_TEXT
    text = tmp_path / "calib.txt"
    text.write_text("Calibration text, ünïcode and 12345.\n" * 40, encoding="utf-8")
    jt, tt = JTokenizer.from_dir(d), Tokenizer.from_dir(d)
    for kw in (dict(), dict(n_tokens=100, seq_len=32), dict(path=str(text), n_tokens=300)):
        got = awq.default_calib_ids(tt, **kw)
        want = jawq.default_calib_ids(jt, **kw)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_awq_policy_matches_jax():
    dense = {"qkv_w": 0, "gate_up_w": 0, "down_w": 0}
    moe = {"qkv_w": 0, "router_w": 0, "moe_gate_up_w": 0, "moe_down_w": 0}
    gpt2 = {"fc_w": 0, "proj_w": 0}
    for flag in (None, True, False):
        for bits in (4, 8):
            for layers in (dense, moe, gpt2):
                assert (awq.awq_policy(flag, bits, layers)
                        == jawq.awq_policy(flag, bits, layers))
    assert awq.awq_policy(None, 4, dense) == (True, True)
    assert awq.awq_policy(None, 8, dense) == (False, True)


def test_moe_layout_raises():
    """The MoE layout is folded (mixtral runs every test above); a layout
    that mixes a router into the dense MLP's keys, neither the one nor the
    other, raises."""
    _, _, cfg, tp, calib = _models("llama")
    moe = dict(tp, layers=dict(tp["layers"], router_w=torch.zeros(2, 64, 4)))
    with pytest.raises(ValueError, match="neither the dense MLP"):
        awq.awq_quantize_params(moe, cfg, calib)


def test_jax_forward_on_port_folded_params():
    """The port's folded params carried back into the JAX forward give the
    JAX logits of the unfolded model (the fold identity across packages)."""
    jcfg, jp, cfg, tp, calib = _models("qwen2")
    folded = awq.apply_awq(tp, cfg, awq.collect_act_stats(tp, cfg, calib), bits=4,
                           group_size=16)
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 9)).astype(np.int32)

    def jax_logits(p):
        cache = j_create_kv_cache(jcfg, 1, 12, dtype=jnp.float32)
        lg, _ = jlm.forward(p, jcfg, jnp.asarray(ids), cache, jnp.arange(9)[None],
                            jnp.ones((1, 9), jnp.bool_))
        return np.asarray(lg)

    back = jax.tree.map(jnp.asarray, dict(folded, layers={k: v.numpy() for k, v in
                                                          folded["layers"].items()},
                                          **{k: folded[k].numpy() for k in
                                             ("embed", "final_ln", "lm_head",
                                              "rope_cos", "rope_sin")}))
    np.testing.assert_allclose(jax_logits(back), jax_logits(jp), atol=2e-3, rtol=1e-3)
