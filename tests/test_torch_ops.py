"""The port's small ops (rms_norm, RoPE, sampling) against the JAX
package on the same numpy inputs, fp32. Tolerances: 1e-6 for the
elementwise ops (same fp32 arithmetic), exact for the rope tables (both
computed in float64 numpy) and for the sampling masks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.hf.config import RopeScaling as JRopeScaling
from tinygpt_tpu.ops import norms as jnorms
from tinygpt_tpu.ops import rope as jrope
from tinygpt_tpu.ops import sampling as jsampling
from tinygpt_tpu_torch.hf.config import RopeScaling
from tinygpt_tpu_torch.ops import norms, rope, sampling


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 4, 32)])
def test_rms_norm(shape):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = norms.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


SCALING = dict(rope_type="llama3", factor=8.0, high_freq_factor=4.0,
               low_freq_factor=1.0, original_max_position_embeddings=64)


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("head_dim", [32, 128])
def test_compute_rope_freqs(scaled, head_dim):
    jsc = JRopeScaling(**SCALING) if scaled else None
    tsc = RopeScaling(**SCALING) if scaled else None
    jc, js = jrope.compute_rope_freqs(head_dim, 300, 500000.0, jsc)
    tc, ts = rope.compute_rope_freqs(head_dim, 300, 500000.0, tsc)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_apply_rope_gathered():
    rng = np.random.default_rng(1)
    B, S, Nq, Nk, D = 2, 5, 4, 2, 32
    q = rng.standard_normal((B, S, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Nk, D)).astype(np.float32)
    pos = rng.integers(0, 100, (B, S)).astype(np.int32)
    jc, js = jrope.compute_rope_freqs(D, 128, 10000.0,
                                      JRopeScaling(**SCALING))
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(jc),
                              jnp.asarray(js), jnp.asarray(pos))
    tc, ts = rope.compute_rope_freqs(D, 128, 10000.0, RopeScaling(**SCALING))
    c, s = rope.gather_rope(tc, ts, _t(pos))
    tq, tk = rope.apply_rope_gathered(_t(q), _t(k), c, s)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-6, atol=1e-6)


def test_gather_rope_clamps_past_the_table_like_jax():
    """Positions past the table take its last row, as JAX's gather clamps."""
    D, P = 32, 128
    pos = np.array([[0, 5, 127, 128, 200, 10 ** 6]], np.int32)
    jc, js = jrope.compute_rope_freqs(D, P, 10000.0)
    tc, ts = rope.compute_rope_freqs(D, P, 10000.0)
    c, s = rope.gather_rope(tc, ts, _t(pos))
    np.testing.assert_array_equal(c[:, :, 0].numpy(), np.asarray(jnp.asarray(jc)[pos]))
    np.testing.assert_array_equal(s[:, :, 0].numpy(), np.asarray(jnp.asarray(js)[pos]))
    np.testing.assert_array_equal(c[0, 3:, 0].numpy(), np.broadcast_to(jc[-1], (3, D)))


def _logits(seed=2, B=3, V=40):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 2


def test_greedy_equal():
    lg = _logits()
    want = jsampling.sample(jnp.asarray(lg), jsampling.SamplerConfig())
    got = sampling.sample(_t(lg), sampling.SamplerConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("name,arg", [("apply_top_k", 5), ("apply_top_k", 1),
                                      ("apply_top_p", 0.7), ("apply_top_p", 0.2),
                                      ("apply_min_p", 0.1), ("apply_min_p", 0.5)])
def test_masks_equal(name, arg):
    lg = _logits(3)
    want = np.asarray(getattr(jsampling, name)(jnp.asarray(lg), arg))
    got = getattr(sampling, name)(_t(lg), arg).numpy()
    np.testing.assert_array_equal(got == sampling.NEG_INF, want == jsampling.NEG_INF)
    np.testing.assert_array_equal(got, want)


def _jax_masked(lg, cfg):
    x = jnp.asarray(lg)
    if cfg.temperature:
        x = x / cfg.temperature
    if cfg.top_k:
        x = jsampling.apply_top_k(x, cfg.top_k)
    if cfg.top_p:
        x = jsampling.apply_top_p(x, cfg.top_p)
    if cfg.min_p:
        x = jsampling.apply_min_p(x, cfg.min_p)
    return np.asarray(x)


@pytest.mark.parametrize("knobs", [dict(temperature=0.7, top_k=4),
                                   dict(temperature=1.3, top_p=0.8),
                                   dict(temperature=1.0, min_p=0.2)])
def test_sample_distribution(knobs):
    """Draws follow softmax of the JAX-processed logits: never outside the
    kept set, and empirical frequencies within 0.02 of the probabilities
    (20000 draws: the standard error of a frequency is at most 0.0036)."""
    lg = _logits(4, B=1, V=12)
    cfg = sampling.SamplerConfig(**knobs)
    jcfg = jsampling.SamplerConfig(**knobs)
    p = torch.softmax(_t(_jax_masked(lg, jcfg)), dim=-1)[0].numpy()
    np.testing.assert_allclose(
        torch.softmax(sampling.masked_logits(_t(lg), cfg), -1)[0].numpy(), p,
        rtol=1e-6, atol=1e-7)
    g = torch.Generator().manual_seed(0)
    draws = torch.cat([sampling.sample(_t(lg).expand(1000, -1), cfg, g)
                       for _ in range(20)]).numpy()
    freq = np.bincount(draws, minlength=p.size) / draws.size
    assert set(np.flatnonzero(freq)) <= set(np.flatnonzero(p > 0))
    np.testing.assert_allclose(freq, p, atol=0.02)


def test_sample_seeded_generator_reproducible():
    lg = _logits(5)
    cfg = sampling.SamplerConfig(temperature=1.0)
    a = sampling.sample(_t(lg), cfg, torch.Generator().manual_seed(7))
    b = sampling.sample(_t(lg), cfg, torch.Generator().manual_seed(7))
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        sampling.sample(_t(lg), cfg)
