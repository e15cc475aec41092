"""The port's fp8 (e4m3) KV cache against the JAX package's, on the CPU.

Both packages store K/V in float8_e4m3fn with the same layouts, decode
it exactly to fp32 for attention, and keep the in-flight K/V of the
chunked loops in bf16 until the merge or scatter. The cast differs on
overflow, by design: the port saturates at +-448 (engine/kv_cache.kv_cast),
where JAX's cast gives NaN; below that the bytes are equal. So:

  * kv_cast's bytes against JAX's astype for |x| <= 448 (normals,
    subnormals, ties, bf16 sources), and the pinned saturating case;
  * the plain versions of K1, K2 and K8 on e4m3 caches against the JAX
    oracles and TPU kernels (interpret mode);
  * forward, decode_steps, decode_paged_steps and decode_paged_spec_steps
    on fp8 caches and pools against JAX's: logits within 1e-4 (fp32, a
    few layers, another summation order) and the cache bytes;
  * the engine, the batcher and the evaluator on fp8 against JAX's
    (tests/test_evaluate.py:60, :81, :94)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_causal_lm import B, N, PADS, S, _batch
from tests.test_torch_causal_lm import _models as _lm_models
from tests.test_torch_scheduler import _models as _sched_models
from tests.test_torch_scheduler import _paged_state, _port_batcher, _prompts, _run
from tinygpt_tpu import evaluate as jeval
from tinygpt_tpu.engine.engine import GPTConfig as JGPTConfig
from tinygpt_tpu.engine.engine import GPTEngine as JGPTEngine
from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache
from tinygpt_tpu.engine.paged_kv import PagedKVState as JPagedKVState
from tinygpt_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from tinygpt_tpu.engine.scheduler import SchedulerConfig as JSchedulerConfig
from tinygpt_tpu.models import causal_lm as jlm
from tinygpt_tpu.models import get_model as j_get_model
from tinygpt_tpu.ops.attention import sdpa_decode_frozen as j_sdpa_decode_frozen
from tinygpt_tpu.ops.attention import sdpa_with_cache as j_sdpa_with_cache
from tinygpt_tpu.ops.attention_kernels import flash_decode_frozen as j_flash_decode_frozen
from tinygpt_tpu.ops.paged_attention import (
    paged_decode_frozen_tpu,
    paged_decode_frozen_xla,
)
from tinygpt_tpu_torch import evaluate
from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache, kv_cast
from tinygpt_tpu_torch.engine.paged_kv import PagedKVState
from tinygpt_tpu_torch.models import causal_lm, get_model
from tinygpt_tpu_torch.ops import attention_kernels as ak
from tinygpt_tpu_torch.ops import paged_attention as pa
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

E4M3 = torch.float8_e4m3fn
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ROUTES = ["kernel", "plain"]
FAMS = ["llama", "mistral"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _bytes(x) -> np.ndarray:
    """The raw bytes of an fp8 tensor or array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _to_port_fp8(a) -> torch.Tensor:
    """A JAX float8_e4m3fn array as a torch tensor on the same bytes."""
    return torch.from_numpy(np.array(a).view(np.uint8)).view(E4M3)


# -- the cast --------------------------------------------------------------------------


def test_kv_cast_bytes_match_jax_below_448():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4000) * 2.0,                # normals
        rng.standard_normal(1000) * 1e-3,               # subnormals (below 2^-6)
        rng.uniform(-448, 448, 1000),                   # the whole range
        np.array([0.0, -0.0, 448.0, -448.0, 2 ** -9, 2 ** -10, 0.0137,
                  1.0625, 1.1875, 17.0, 19.0]),         # the edges and ties
    ]).astype(np.float32)
    want = _bytes(jnp.asarray(x).astype(jnp.float8_e4m3fn))
    np.testing.assert_array_equal(_bytes(kv_cast(_t(x), E4M3)), want)
    # a bf16 source (the in-flight buffers beside an fp8 cache)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    tb = torch.from_numpy(np.array(xb).view(np.uint16)).view(torch.bfloat16)
    np.testing.assert_array_equal(_bytes(kv_cast(tb, E4M3)),
                                  _bytes(xb.astype(jnp.float8_e4m3fn)))


def test_kv_cast_saturates_where_jax_gives_nan():
    """Pinned: past 448 the port writes +-448 (0x7E / 0xFE), JAX NaN (0x7F
    / 0xFF); NaN stays NaN in both."""
    x = np.array([500.0, -500.0, 470.0, 1000.0, np.inf, 448.0, 1e-3, 0.0137],
                 np.float32)
    got = _bytes(kv_cast(_t(x), E4M3))
    np.testing.assert_array_equal(got, [0x7E, 0xFE, 0x7E, 0x7E, 0x7E, 0x7E, 0x01, 0x07])
    jx = _bytes(jnp.asarray(x[:4]).astype(jnp.float8_e4m3fn))
    np.testing.assert_array_equal(jx, [0x7F, 0xFF, 0x7F, 0x7F])
    assert torch.isnan(kv_cast(torch.tensor([float("nan")]), E4M3).float()).all()
    # every other dtype is a plain cast
    assert kv_cast(_t(x), torch.bfloat16).dtype == torch.bfloat16


# -- attention on e4m3 caches -------------------------------------------------------------


def _fp8_case(seed, shape):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    x[..., :8] *= 0.01
    j8 = jnp.asarray(x).astype(jnp.float8_e4m3fn)
    return j8, _to_port_fp8(j8)


def test_flash_prefill_plain_e4m3_matches_jax():
    """K1's plain version over an e4m3 cache (q fp32) against the JAX
    oracle reading the same bytes (its fp8 route upcasts them)."""
    Bq, Nq, Nk, T, Dh, Sq, q_slot = 2, 4, 2, 24, 64, 6, 10
    rng = np.random.default_rng(1)
    q = (rng.standard_normal((Bq, Sq, Nq, Dh)) * 0.3).astype(np.float32)
    jk, tk = _fp8_case(2, (Bq, Nk, T, Dh))
    jv, tv = _fp8_case(3, (Bq, Nk, T, Dh))
    slots = np.arange(T)[None, :]
    pad = np.array([[0], [4]])
    valid = (slots >= pad) & (slots < q_slot + Sq)
    kv_pos = np.maximum(slots - pad, 0).astype(np.int32)
    q_pos = (q_slot + np.arange(Sq))[None, :] - pad
    for window in (None, 5):
        want = j_sdpa_with_cache(jnp.asarray(q), jk, jv, jnp.asarray(q_pos),
                                 jnp.asarray(kv_pos), jnp.asarray(valid),
                                 sliding_window=window)
        got = ak.flash_prefill(_t(q).transpose(1, 2).contiguous(), tk, tv, _t(valid),
                               Dh ** -0.5, q_slot, window).transpose(1, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_flash_decode_frozen_plain_e4m3_matches_jax_kernel():
    """K2's plain version over an e4m3 frozen stack with bf16 in-flight
    K/V against the JAX kernel's e4m3 branch (kv_e4m3, interpret mode)
    and the XLA oracle."""
    L, Bq, Nq, Nk, T, Dh, Nn, step = 2, 2, 4, 2, 128, 128, 16, 5
    rng = np.random.default_rng(4)
    q = (rng.standard_normal((Bq, Nq, Dh)) * 0.3).astype(np.float32)
    jk, tk = _fp8_case(5, (L, Bq, Nk, T, Dh))
    jv, tv = _fp8_case(6, (L, Bq, Nk, T, Dh))
    infl = lambda s: jnp.asarray((np.random.default_rng(s).standard_normal(  # noqa: E731
        (Bq, Nk, Nn, Dh)) * 0.3).astype(np.float32)).astype(jnp.bfloat16)
    jki, jvi = infl(7), infl(8)
    tki = torch.from_numpy(np.asarray(jki).view(np.uint16)).view(torch.bfloat16)
    tvi = torch.from_numpy(np.asarray(jvi).view(np.uint16)).view(torch.bfloat16)
    mask = np.zeros((Bq, T), bool)
    mask[0, :70] = True
    mask[1, 9:100] = True
    for l in range(L):
        got = ak.flash_decode_frozen(_t(q), tk, tv, _t(mask), tki, tvi, l, step,
                                     Dh ** -0.5).numpy()
        kern = j_flash_decode_frozen(jnp.asarray(q), jk, jv, jnp.asarray(mask), jki, jvi,
                                     jnp.asarray(l, jnp.int32), jnp.asarray(step, jnp.int32),
                                     scale=Dh ** -0.5, interpret=True)
        np.testing.assert_allclose(got, np.asarray(kern).astype(np.float32), rtol=2e-5,
                                   atol=2e-5, err_msg=f"layer {l}")
        kv_pos = np.arange(T)[None].repeat(Bq, 0).astype(np.int32)
        oracle = j_sdpa_decode_frozen(
            jnp.asarray(q)[:, None], jk[l], jv[l], jnp.asarray(kv_pos), jnp.asarray(mask),
            jki, jvi, jnp.asarray(step, jnp.int32), jnp.full((Bq, 1), T, jnp.int32))
        np.testing.assert_allclose(got, np.asarray(oracle)[:, 0], rtol=2e-5, atol=2e-5)


def test_paged_decode_frozen_plain_e4m3_matches_jax():
    """K8's plain version over e4m3 pools: the case of
    tests/test_paged.py:100 against the JAX kernel's e4m3 branch
    (interpret mode) and the XLA oracle."""
    rng = np.random.default_rng(5)
    L, n_blocks, Nk, bs, Dh, Bq, G, Nn = 2, 16, 2, 16, 64, 3, 2, 8
    kp = (rng.standard_normal((L, n_blocks, Nk, bs, Dh)) * 0.3).astype(np.float32)
    vp = (rng.standard_normal((L, n_blocks, Nk, bs, Dh)) * 0.3).astype(np.float32)
    kp[..., :8] *= 0.01
    kp[:, 0] = 0.0
    vp[:, 0] = 0.0
    kp8 = jnp.asarray(kp).astype(jnp.float8_e4m3fn)
    vp8 = jnp.asarray(vp).astype(jnp.float8_e4m3fn)
    ki = (rng.standard_normal((Bq, Nk, Nn, Dh)) * 0.3).astype(np.float32)
    vi = (rng.standard_normal((Bq, Nk, Nn, Dh)) * 0.3).astype(np.float32)
    q = (rng.standard_normal((Bq, Nk * G, Dh)) * 0.3).astype(np.float32)
    tables = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0]], np.int32)
    lengths0 = np.array([41, 20, 9], np.int32)
    starts = np.array([0, 3, 1], np.int32)
    step = 2
    for l in range(L):
        args = (jnp.asarray(q), kp8, vp8, jnp.asarray(tables), jnp.asarray(lengths0),
                jnp.asarray(starts), jnp.asarray(ki), jnp.asarray(vi))
        ref = paged_decode_frozen_xla(args[0], kp8[l], vp8[l], *args[3:8],
                                      jnp.asarray(step, jnp.int32), scale=Dh ** -0.5)
        kern = paged_decode_frozen_tpu(*args, jnp.asarray(l, jnp.int32),
                                       jnp.asarray(step, jnp.int32), scale=Dh ** -0.5,
                                       interpret=True)
        got = pa.paged_decode_frozen(_t(q), _to_port_fp8(kp8), _to_port_fp8(vp8),
                                     _t(tables), _t(lengths0), _t(starts), _t(ki), _t(vi),
                                     l, step, Dh ** -0.5).numpy()
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(kern), rtol=2e-5, atol=2e-5)


# -- the model on fp8 caches -------------------------------------------------------------


def _jax_cache(jcfg, T):
    return j_create_kv_cache(jcfg, B, T, dtype=jnp.float8_e4m3fn)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fam", FAMS)
def test_forward_fp8_matches_jax(fam, route):
    """A left-padded prefill and one decode step through forward on an fp8
    cache: logits within 1e-4 of JAX's and the same cache bytes."""
    jcfg, jparams, cfg, params = _lm_models(fam)
    ids, positions, valid, lens = _batch(cfg.vocab_size)
    jc = _jax_cache(jcfg, 32)
    want, jc = jlm.forward(jparams, jcfg, jnp.asarray(ids), jc, jnp.asarray(positions),
                           jnp.asarray(valid))
    nxt = np.asarray(jnp.argmax(want[:, -1], -1)).astype(np.int32)[:, None]
    want1, jc = jlm.forward(jparams, jcfg, jnp.asarray(nxt), jc, jnp.asarray(lens[:, None]),
                            jnp.ones((B, 1), jnp.bool_))
    cache = create_kv_cache(cfg, B, 32, dtype=E4M3, device="cpu")
    assert cache.k.dtype == E4M3
    lg, cache = causal_lm.forward(params, cfg, _t(ids), cache, _t(positions), _t(valid),
                                  attn_impl=route)
    for b, p in enumerate(PADS):
        np.testing.assert_allclose(lg[b, p:].numpy(), np.asarray(want)[b, p:], **LOGIT_TOL)
    lg1, cache = causal_lm.forward(params, cfg, _t(nxt), cache, _t(lens[:, None]),
                                   torch.ones(B, 1, dtype=torch.bool), attn_impl=route)
    np.testing.assert_allclose(lg1.numpy(), np.asarray(want1), **LOGIT_TOL)
    for name in ("k", "v"):
        got_b, want_b = _bytes(getattr(cache, name)), _bytes(getattr(jc, name))
        for b, p in enumerate(PADS):
            np.testing.assert_array_equal(got_b[:, b, :, p : S + 1], want_b[:, b, :, p : S + 1])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("fam", FAMS)
def test_decode_steps_fp8_matches_jax(fam, route):
    """Two chunks of decode_steps on an fp8 cache, forced tokens: every
    step's logits within 1e-4 of JAX's (in-flight K/V in bf16 in both),
    and the merged cache bytes equal."""
    jcfg, jparams, cfg, params = _lm_models(fam)
    ids, positions, valid, lens = _batch(cfg.vocab_size)
    forced = np.random.default_rng(2).integers(3, cfg.vocab_size, (2, N, B)).astype(np.int32)
    tok0 = np.array([5, 9], np.int32)
    seen_j = []
    jc = _jax_cache(jcfg, S + 2 * N)
    _, jc = jlm.forward(jparams, jcfg, jnp.asarray(ids), jc, jnp.asarray(positions),
                        jnp.asarray(valid), last_only=True)

    def j_sample(lg, key):  # each step's "key" is its forced token row
        jax.debug.callback(lambda x: seen_j.append(np.asarray(x)), lg, ordered=True)
        return key

    tok = jnp.asarray(tok0)
    for c in range(2):
        _, jc = jlm.decode_steps(jparams, jcfg, tok, jc, jnp.asarray(lens[:, None] + c * N),
                                 jnp.asarray(forced[c]), j_sample, attn_impl="xla")
        tok = jnp.asarray(forced[c, -1])
    jax.effects_barrier()

    cache = create_kv_cache(cfg, B, S + 2 * N, dtype=E4M3, device="cpu")
    _, cache = causal_lm.forward(params, cfg, _t(ids), cache, _t(positions), _t(valid),
                                 last_only=True, attn_impl=route)
    seen_t = []

    def t_sample(lg):
        seen_t.append(lg.numpy().copy())
        return torch.from_numpy(forced.reshape(-1, B)[len(seen_t) - 1])

    tok = _t(tok0)
    for c in range(2):
        _, cache = causal_lm.decode_steps(params, cfg, tok, cache, _t(lens[:, None] + c * N),
                                          N, t_sample, attn_impl=route)
        tok = _t(forced[c, -1])
    assert len(seen_t) == len(seen_j) == 2 * N
    for i in range(2 * N):
        np.testing.assert_allclose(seen_t[i], seen_j[i], **LOGIT_TOL, err_msg=f"step {i}")
    for name in ("k", "v"):
        got_b, want_b = _bytes(getattr(cache, name)), _bytes(getattr(jc, name))
        for b, p in enumerate(PADS):
            np.testing.assert_array_equal(got_b[:, b, :, p:], want_b[:, b, :, p:])


def _fp8_state(cfg, seed):
    """_paged_state's pools cast to e4m3 (the same bytes in both packages)."""
    st = _paged_state(cfg, seed, [20, 33, 7, 45], [True, True, True, False])
    for k in ("k_pool", "v_pool"):
        st[k] = np.asarray(jnp.asarray(st[k]).astype(jnp.float8_e4m3fn))
    return st


def _states(st):
    jstate = JPagedKVState(**{k: jnp.asarray(v) for k, v in st.items()})
    conv = lambda v: _to_port_fp8(v) if v.dtype.itemsize == 1 and v.dtype != bool \
        else torch.from_numpy(v.copy())  # noqa: E731
    return jstate, PagedKVState(**{k: conv(v) for k, v in st.items()})


def _assert_pools_equal(tstate, jst):
    for name in ("k_pool", "v_pool"):
        np.testing.assert_array_equal(_bytes(getattr(tstate, name))[:, 1:],
                                      _bytes(getattr(jst, name))[:, 1:])
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(jst.lengths))


@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("impl", ROUTES)
def test_decode_paged_steps_fp8_matches_jax(fam, impl):
    """One 5-step quantum on fp8 pools, forced tokens: logits within 1e-4
    of JAX's every step, the same pool bytes after the scatter (outside
    the null block) and lengths."""
    jcfg, jparams, cfg, tparams = _sched_models(fam)
    st = _fp8_state(cfg, 5)
    forced = np.random.default_rng(6).integers(3, 101, (5, 4)).astype(np.int32)
    tok0 = np.array([5, 9, 11, 13], np.int32)
    jstate, tstate = _states(st)
    assert tstate.k_pool.dtype == E4M3
    seen_j = []

    def j_sample(lg, key):
        jax.debug.callback(lambda x: seen_j.append(np.asarray(x)), lg, ordered=True)
        return key

    _, jst = jlm.decode_paged_steps(jparams, jcfg, jnp.asarray(tok0), jstate,
                                    jnp.asarray(forced), j_sample)
    jax.effects_barrier()
    seen_t = []

    def t_sample(lg):
        seen_t.append(lg.numpy().copy())
        return torch.from_numpy(forced[len(seen_t) - 1])

    causal_lm.decode_paged_steps(tparams, cfg, _t(tok0), tstate, 5, t_sample, attn_impl=impl)
    for i in range(5):
        np.testing.assert_allclose(seen_t[i][:3], seen_j[i][:3], **LOGIT_TOL)
    _assert_pools_equal(tstate, jst)


@pytest.mark.parametrize("fam", FAMS)
def test_decode_paged_spec_steps_fp8_matches_jax(fam):
    """Two greedy speculative rounds on fp8 pools: the same counts, tokens,
    pool bytes and lengths as JAX's."""
    jcfg, jparams, cfg, tparams = _sched_models(fam)
    st = _fp8_state(cfg, 7)
    rng = np.random.default_rng(8)
    ctx = np.zeros((4, 48), np.int32)
    clen = np.array([14, 17, 20, 9], np.int32)
    for b in range(4):
        ctx[b, : clen[b]] = (list(rng.integers(3, 101, 4 + b)) * 8)[: clen[b]]
    tok0 = ctx[np.arange(4), clen - 1]
    jstate, tstate = _states(st)
    jtoks, jcounts, _, jst = jlm.decode_paged_spec_steps(
        jparams, jcfg, jnp.asarray(tok0), jstate, jnp.asarray(ctx), jnp.asarray(clen),
        2, 3, 2)
    toks, counts, _ = causal_lm.decode_paged_spec_steps(
        tparams, cfg, _t(tok0), tstate, _t(ctx), _t(clen), 2, 3, 2, attn_impl="plain")
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    for r in range(2):
        for b in range(3):
            n = int(counts[r, b])
            np.testing.assert_array_equal(toks.numpy()[r, b, :n], np.asarray(jtoks)[r, b, :n])
    _assert_pools_equal(tstate, jst)


def test_fp8_close_to_fp32_cache():
    """tests/test_evaluate.py:60 on the port: logits on an fp8 cache stay
    close to the fp32 cache's (top-1 agreement above 0.85)."""
    _, _, cfg, params = _lm_models("llama")
    ids, positions, valid, _ = _batch(cfg.vocab_size)
    outs = {}
    for dt in (torch.float32, E4M3):
        cache = create_kv_cache(cfg, B, 16, dtype=dt, device="cpu")
        outs[dt] = causal_lm.forward(params, cfg, _t(ids), cache, _t(positions),
                                     _t(valid))[0].numpy()
    agree = (outs[torch.float32].argmax(-1) == outs[E4M3].argmax(-1))[:, 3:].mean()
    assert agree > 0.85, agree


# -- engine, batcher, evaluator ----------------------------------------------------------


TINY = dict(model_type="llama", vocab_size=503, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5)
PROMPTS = ["Hello world", "the quick brown fox jumps over the lazy dog", "a"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fp8_llama")
    return write_random_model_dir(str(d), TINY, seed=17, dtype=torch.float32)


@pytest.mark.parametrize("kd", ["fp8", "e4m3", "float8_e4m3"])
def test_engine_fp8_matches_jax(model_dir, kd):
    """tests/test_evaluate.py:81: the engine on an fp8 cache (each of its
    names), against the JAX engine's greedy tokens."""
    kw = dict(dtype="float32", max_tokens=8, prefill_bucket=16, decode_chunk=4,
              kv_cache_dtype=kd)
    jeng = JGPTEngine(JGPTConfig(model_dir=model_dir, **kw))
    jeng.prepare()
    teng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", **kw))
    teng.prepare()
    assert teng._kv_dtype() == E4M3
    got = [o.token_ids for o in teng.generate_sync(PROMPTS)]
    assert got == [o.token_ids for o in jeng.generate_sync(PROMPTS)]
    assert all(len(t) == 8 for t in got)


def test_scheduler_fp8_matches_jax():
    """tests/test_evaluate.py:94: the batcher on fp8 pools, against the JAX
    batcher's greedy streams; with speculation on too."""
    jcfg, jparams, _, _ = _sched_models("llama")
    prompts = _prompts(7, (5, 20, 11))
    kw = dict(batch_capacity=2, n_blocks=32, max_blocks_per_seq=4, block_size=16,
              prefill_bucket=16, dtype="float32", kv_cache_dtype="fp8")
    jb = JBatcher(j_get_model("llama"), jcfg, jparams, eos_ids=set(),
                  config=JSchedulerConfig(**kw))
    want, _ = _run(jb, prompts, 6)
    b = _port_batcher("llama", **{k: v for k, v in kw.items()
                                  if k not in ("block_size", "prefill_bucket", "dtype")})
    assert b.state.k_pool.dtype == E4M3
    got, _ = _run(b, prompts, 6)
    assert got == want
    spec = _port_batcher("llama", speculative="ngram", **{
        k: v for k, v in kw.items() if k not in ("block_size", "prefill_bucket", "dtype")})
    assert _run(spec, prompts, 6)[0] == want


@pytest.mark.parametrize("window,stride", [(64, 32), (100, 100)])
def test_evaluate_fp8_matches_jax(window, stride):
    """The evaluator's kv_dtype: the NLL over an fp8 cache within 1e-5
    relative of JAX's, and apart from the fp32 cache's."""
    from tinygpt_tpu.hf.config import parse_model_config as j_parse
    from tinygpt_tpu_torch.hf.config import parse_model_config

    jcfg = j_parse(TINY)
    jp = j_get_model("llama").init_params(jcfg, seed=33, dtype=jnp.float32)
    tp = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg, model = parse_model_config(TINY), get_model("llama")
    ids = [int(x) for x in np.random.default_rng(0).integers(2, TINY["vocab_size"], 300)]
    want = jeval.window_nll(j_get_model("llama"), jcfg, jp, ids, window=window,
                            stride=stride, kv_dtype=jnp.float8_e4m3fn)
    got = evaluate.window_nll(model, cfg, tp, ids, window=window, stride=stride,
                              attn_impl="plain", kv_dtype=E4M3)
    assert got[1] == want[1]
    assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
    full = evaluate.window_nll(model, cfg, tp, ids, window=window, stride=stride)
    assert got[0] != full[0]


def test_evaluate_main_fp8(model_dir, tmp_path, capsys):
    text = tmp_path / "eval.txt"
    text.write_text("The quick brown fox jumps over the lazy dog. " * 12, encoding="utf-8")
    args = ["--model", model_dir, "--text", str(text), "--window", "64", "--stride", "32",
            "--device", "cpu"]
    assert evaluate.main(args + ["--kv-cache-dtype", "fp8"]) == 0
    assert "perplexity:" in capsys.readouterr().out
