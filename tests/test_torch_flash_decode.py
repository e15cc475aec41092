"""K13 (attention_kernels.flash_decode), attention_with_cache at S == 1 and
the per-token decode step (decode_step) of the port against the JAX
package, on the same numpy inputs, on the CPU.

On the CPU the K13 wrapper runs its plain PyTorch version, which is held
against the JAX Pallas kernel in interpret mode (bt = 8, as
tests/test_attention_kernels.py runs it): 1 to 16 query heads per KV head,
head dims 64 and 128, ragged validity, a window folded into the mask, an
e4m3 cache (both sides decode the same e4m3 values exactly). fp32
throughout, tolerance 2e-5 as in the JAX package's kernel tests (same
math, another summation order). A query row that sees no slot gives 0 in
the port and the uniform mean of V in the JAX kernel: the tests compare
around it, and check that the port's row is 0.

decode_step runs one token through every layer straight into the dense
cache. It is held against the JAX per-token body (a one-token `forward`)
and against the port's decode_steps(n_steps=1), on model dirs of the
llama, GPT-2 and Mixtral families written by
tinygpt_tpu_torch.utils.fixtures, both attention routes: logits within
1e-4 (fp32, two layers, another summation order), as
tests/test_torch_causal_lm.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache
from tinygpt_tpu.hf.loader import load_model_dir as j_load_model_dir
from tinygpt_tpu.ops import attention as jattn
from tinygpt_tpu.ops import attention_kernels as jak
from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache, kv_cast
from tinygpt_tpu_torch.hf.loader import load_model_dir
from tinygpt_tpu_torch.ops import attention as tattn
from tinygpt_tpu_torch.ops import attention_kernels as tak
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(B, Nq, Nk, T, D, pads, length, window, seed):
    """Row b holds pads[b] pad slots, then real tokens up to slot
    `length`; the query is the token at slot length - 1 (its own K/V
    written, as decode_step writes it before attending)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Nq, D)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, Nk, T, D)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, Nk, T, D)).astype(np.float32) * 0.3
    slots = np.arange(T)[None, :]
    pad = np.asarray(pads)[:, None]
    valid = (slots >= pad) & (slots < length)
    kv_pos = np.where(valid, slots - pad, 0).astype(np.int32)
    q_pos = np.maximum(length - 1 - pad, 0).astype(np.int32)      # [B, 1]
    mask = valid & (kv_pos <= q_pos)
    if window is not None:
        mask &= kv_pos > q_pos - window
    return q, k, v, valid, kv_pos, q_pos, mask


CASES = [
    # (Nq, Nk, D, T, pads, length, window)
    (4, 4, 64, 24, (0, 5), 17, None),         # G = 1, ragged rows
    (8, 2, 128, 32, (0, 13, 3), 30, None),    # G = 4
    (8, 2, 64, 32, (2, 0), 32, 6),            # a window folded into the mask
    (32, 2, 64, 16, (0, 4), 11, None),        # G = 16 (Llama-3.1-405B's)
    (16, 1, 128, 24, (7, 1), 24, 9),          # G = 16, window
]


@pytest.mark.parametrize("case", CASES)
def test_flash_decode_matches_jax_kernel(case):
    Nq, Nk, D, T, pads, length, window = case
    q, k, v, _, _, _, mask = _inputs(len(pads), Nq, Nk, T, D, pads, length, window, 0)
    want = jak.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(mask), scale=D ** -0.5, bt=8, interpret=True)
    got = tak.flash_decode(_t(q), _t(k), _t(v), _t(mask), D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    plain = tak.flash_decode_plain(_t(q), _t(k), _t(v), _t(mask).to(torch.uint8),
                                   D ** -0.5)
    assert torch.equal(plain, got)


@pytest.mark.parametrize("case", CASES[:3])
def test_flash_decode_e4m3_cache_matches_jax_kernel(case):
    """An e4m3 cache beside fp32 queries: both sides decode the same e4m3
    values (jnp's float8_e4m3fn and torch's agree bit for bit below 448)."""
    Nq, Nk, D, T, pads, length, window = case
    q, k, v, _, _, _, mask = _inputs(len(pads), Nq, Nk, T, D, pads, length, window, 1)
    k8, v8 = (jnp.asarray(x * 8).astype(jnp.float8_e4m3fn) for x in (k, v))
    want = jak.flash_decode(jnp.asarray(q), k8, v8, jnp.asarray(mask),
                            scale=D ** -0.5, bt=8, interpret=True)
    tk, tv = (kv_cast(_t(np.asarray(x.astype(jnp.float32))), torch.float8_e4m3fn)
              for x in (k8, v8))
    assert np.array_equal(tk.float().numpy(), np.asarray(k8.astype(jnp.float32)))
    got = tak.flash_decode(_t(q), tk, tv, _t(mask), D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flash_decode_all_masked_row_is_zero():
    """Row 1 sees no slot: the port gives 0 there (the JAX kernel the
    uniform mean of V, by design); row 0 agrees with JAX."""
    q, k, v, _, _, _, mask = _inputs(2, 8, 2, 16, 64, (0, 0), 9, None, 2)
    mask[1] = False
    want = np.asarray(jak.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(mask), scale=0.125, bt=8,
                                       interpret=True))
    got = tak.flash_decode(_t(q), _t(k), _t(v), _t(mask), 0.125)
    np.testing.assert_allclose(got[0].numpy(), want[0], **TOL)
    assert not got[1].any()
    np.testing.assert_allclose(want[1], np.broadcast_to(
        v[1].mean(axis=1).repeat(4, axis=0), want[1].shape), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_attention_with_cache_one_row_matches_jax(case):
    """S == 1 through the kernel route (K13's plain version on the CPU)
    and the oracle, against JAX's attention_with_cache (which sends S == 1
    to its oracle)."""
    Nq, Nk, D, T, pads, length, window = case
    q, k, v, valid, kv_pos, q_pos, _ = _inputs(len(pads), Nq, Nk, T, D, pads, length,
                                               window, 3)
    qs = q[:, None]                                              # [B, 1, Nq, D]
    want = np.asarray(jattn.attention_with_cache(
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), q_pos=jnp.asarray(q_pos),
        kv_pos=jnp.asarray(kv_pos), kv_valid=jnp.asarray(valid), slot=length - 1,
        sliding_window=window, kernel="pallas"))
    tak.reset_launches()
    for route in ("kernel", "plain"):
        got = tattn.attention_with_cache(
            _t(qs), _t(k), _t(v), q_pos=_t(q_pos), kv_pos=_t(kv_pos),
            kv_valid=_t(valid), slot=length - 1, sliding_window=window, kernel=route)
        assert got.shape == qs.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=route)
    assert sum(tak.LAUNCHES.values()) == 0  # the CPU runs the plain versions


def test_attention_with_cache_sends_one_row_to_k13(monkeypatch):
    """The kernel route takes K13 at S == 1, under decode_mask, and K1
    above (the card then launches the kernel the wrapper is given)."""
    calls = []
    for name in ("flash_decode", "flash_prefill"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    q, k, v, valid, kv_pos, q_pos, mask = _inputs(2, 8, 2, 16, 64, (0, 3), 12, 4, 5)
    for S in (1, 2):
        qs = np.repeat(q[:, None], S, axis=1)
        tattn.attention_with_cache(_t(qs), _t(k), _t(v), q_pos=_t(np.repeat(q_pos, S, 1)),
                                   kv_pos=_t(kv_pos), kv_valid=_t(valid), slot=11,
                                   sliding_window=4)
    assert calls == ["flash_decode", "flash_prefill"]


def test_decode_mask_is_the_oracles_mask():
    _, _, _, valid, kv_pos, q_pos, mask = _inputs(3, 4, 2, 20, 64, (0, 4, 9), 18, 5, 4)
    got = tattn.decode_mask(_t(kv_pos), _t(valid), _t(q_pos), 5)
    assert np.array_equal(got.numpy(), mask)


def test_flash_decode_raises_off_cpu():
    q = torch.empty(1, 2, 64, device="meta")
    k = torch.empty(1, 1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tak.flash_decode(q, k, k, torch.empty(1, 8, dtype=torch.bool, device="meta"),
                         0.125)


# -- decode_step -----------------------------------------------------------------

_DIRS = {
    "llama": dict(model_type="llama", vocab_size=307, hidden_size=64,
                  intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128,
                  rms_norm_eps=1e-5),
    "gpt2": dict(model_type="gpt2", vocab_size=307, n_embd=64, n_layer=2, n_head=4,
                 n_positions=128),
    "mixtral": dict(model_type="mixtral", vocab_size=307, hidden_size=64,
                    intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, max_position_embeddings=128,
                    num_local_experts=4, num_experts_per_tok=2, rms_norm_eps=1e-5,
                    sliding_window=5),
}
B, S, PADS, STEPS = 2, 8, (0, 3), 4


@pytest.fixture(scope="module", params=list(_DIRS))
def models(request, tmp_path_factory):
    d = write_random_model_dir(str(tmp_path_factory.mktemp(f"k13_{request.param}")),
                               _DIRS[request.param], seed=4, dtype=torch.float32)
    return j_load_model_dir(d, dtype=jnp.float32), load_model_dir(d, "float32", "cpu")


def _prefill_batch(vocab):
    rng = np.random.default_rng(0)
    slots = np.arange(S)[None, :]
    pad = np.asarray(PADS)[:, None]
    valid = slots >= pad
    ids = np.where(valid, rng.integers(3, vocab, (B, S)), 0).astype(np.int32)
    positions = np.where(valid, slots - pad, 0).astype(np.int32)
    return ids, positions, valid, valid.sum(1).astype(np.int32)


def _port_prefill(ctx, route):
    ids, positions, valid, lens = _prefill_batch(ctx.model_config.vocab_size)
    cache = create_kv_cache(ctx.model_config, B, S + STEPS, dtype=torch.float32,
                            device="cpu")
    lg, cache = ctx.model.forward(ctx.params, ctx.model_config, _t(ids), cache,
                                  _t(positions), _t(valid), last_only=True,
                                  attn_impl=route)
    return lg, cache, lens


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_decode_step_matches_jax_forward_of_one_token(models, route):
    """STEPS greedy steps: the JAX per-token body (forward of one token)
    and decode_step, fed the same tokens (JAX's argmax)."""
    jctx, ctx = models
    cfg = jctx.model_config
    ids, positions, valid, lens = _prefill_batch(cfg.vocab_size)
    jcache = j_create_kv_cache(cfg, B, S + STEPS, dtype=jnp.float32)
    jlg, jcache = jctx.model.forward(jctx.params, cfg, jnp.asarray(ids), jcache,
                                     jnp.asarray(positions), jnp.asarray(valid),
                                     last_only=True)
    lg, cache, _ = _port_prefill(ctx, route)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)
    for i in range(STEPS):
        pos = (lens + i)[:, None]
        jlg, jcache = jctx.model.forward(jctx.params, cfg, jnp.asarray(tok[:, None]),
                                         jcache, jnp.asarray(pos),
                                         jnp.ones((B, 1), jnp.bool_), last_only=True)
        lg, cache = ctx.model.decode_step(ctx.params, ctx.model_config, _t(tok), cache,
                                          _t(pos), attn_impl=route)
        assert lg.shape == (B, 1, cfg.vocab_size) and cache.length == S + i + 1
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL,
                                   err_msg=f"step {i}")
        tok = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)
    # the real slots' K/V (a pad row sees no slot in the first layer, so
    # the later layers' pad K/V differ by design)
    real = np.asarray(jcache.valid)[None, :, None, :]
    for got, want in ((cache.k, jcache.k), (cache.v, jcache.v)):
        np.testing.assert_allclose(np.where(real[..., None], got.numpy(), 0),
                                   np.where(real[..., None], np.asarray(want), 0),
                                   **LOGIT_TOL)
    assert np.array_equal(cache.kv_pos.numpy(), np.asarray(jcache.kv_pos))
    assert np.array_equal(cache.valid.numpy(), np.asarray(jcache.valid))


@pytest.mark.parametrize("route", ["kernel", "plain"])
def test_decode_step_matches_decode_steps_of_one(models, route):
    """decode_step and decode_steps(n_steps=1) from the same cache: the
    same logits and the same cache after the step."""
    _, ctx = models
    mc = ctx.model_config
    lg, cache_a, lens = _port_prefill(ctx, route)
    _, cache_b, _ = _port_prefill(ctx, route)
    tok = lg[:, -1].argmax(-1).to(torch.int32)
    pos = _t(lens[:, None])
    seen = []

    def sample_fn(x):
        seen.append(x)
        return x.argmax(-1)

    toks, cache_b = ctx.model.decode_steps(ctx.params, mc, tok, cache_b, pos, 1,
                                           sample_fn, attn_impl=route)
    lg_a, cache_a = ctx.model.decode_step(ctx.params, mc, tok, cache_a, pos,
                                          attn_impl=route)
    np.testing.assert_allclose(lg_a[:, -1].numpy(), seen[0].numpy(), **LOGIT_TOL)
    assert torch.equal(lg_a[:, -1].argmax(-1).to(torch.int32), toks[0])
    assert cache_a.length == cache_b.length == S + 1
    torch.testing.assert_close(cache_a.k, cache_b.k, **LOGIT_TOL)
    torch.testing.assert_close(cache_a.v, cache_b.v, **LOGIT_TOL)
    assert torch.equal(cache_a.kv_pos, cache_b.kv_pos)
    assert torch.equal(cache_a.valid, cache_b.valid)


def test_decode_step_overflow_raises(models):
    _, ctx = models
    cache = create_kv_cache(ctx.model_config, 1, 1, dtype=torch.float32, device="cpu")
    cache.length = 1
    with pytest.raises(ValueError, match="overflows"):
        ctx.model.decode_step(ctx.params, ctx.model_config, torch.zeros(1, dtype=torch.int32),
                              cache, torch.zeros(1, 1, dtype=torch.int32))
