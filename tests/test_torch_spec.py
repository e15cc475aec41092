"""The port's n-gram speculation against the JAX package's, on the CPU.

  * K10's plain version (paged_decode_spec_plain, and its wrapper on CPU
    tensors) against the JAX oracle paged_decode_spec_xla and the Pallas
    kernel paged_decode_spec_tpu in interpret mode: prior-accepted and
    own-round in-flight masks, first and later rounds, 1 to 4 query heads
    per KV head, binding windows (oracle only: the TPU kernel takes none),
    e4m3 pools. All compute in fp32 in another order: tolerance 2e-5.
  * the device prompt-lookup draft against the JAX engine's host
    ngram_draft;
  * causal_lm.decode_paged_spec_steps against the JAX one (greedy toks,
    counts, next inputs, pools and lengths), on the kernel and the plain
    route (both the plain versions on the CPU);
  * the ContinuousBatcher with speculation against the JAX batcher's
    streams and its own plain quanta (tests/test_paged.py:383, :445,
    :1267), rejection sampling as a distribution (:1186), the auto-off
    policy (:1384);
  * the engine's batch-1 speculation against plain greedy and the JAX
    engine (tests/test_engine.py:120, :261, :290), the CLI and the server.

Greedy streams of two programs may part at a near-tie of the dense
logits (top-2 gap below 1e-3), after which they may differ."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_torch_scheduler import (
    NEAR_TIE,
    SC,
    _assert_streams_agree,
    _dense_logits,
    _models,
    _paged_state,
    _port_batcher,
    _run,
)
from tinygpt_tpu.engine.engine import GPTConfig as JGPTConfig
from tinygpt_tpu.engine.engine import GPTEngine as JGPTEngine
from tinygpt_tpu.engine.engine import ngram_draft as j_ngram_draft
from tinygpt_tpu.engine.paged_kv import PagedKVState as JPagedKVState
from tinygpt_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from tinygpt_tpu.engine.scheduler import SchedulerConfig as JSchedulerConfig
from tinygpt_tpu.models import causal_lm as jlm
from tinygpt_tpu.models import get_model as j_get_model
from tinygpt_tpu.ops.paged_attention import (
    paged_decode_spec_tpu,
    paged_decode_spec_xla,
)
from tinygpt_tpu_torch import cli
from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine, ngram_draft
from tinygpt_tpu_torch.engine.paged_kv import PagedKVState
from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, Request, SchedulerConfig
from tinygpt_tpu_torch.models import causal_lm
from tinygpt_tpu_torch.ops import attention_kernels as ak
from tinygpt_tpu_torch.ops import paged_attention as pa
from tinygpt_tpu_torch.ops.sampling import SamplerConfig, masked_logits_batched
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

TOL = dict(rtol=2e-5, atol=2e-5)
E4M3 = torch.float8_e4m3fn


def _t(a):
    return torch.from_numpy(np.array(a))


# -- K10's plain version ------------------------------------------------------------

L_, NB, NK, BS, D = 2, 16, 2, 16, 64
TABLES = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 0, 0, 0]], np.int32)
LENGTHS0 = np.array([41, 20, 9], np.int32)
STARTS = np.array([0, 3, 1], np.int32)


def _spec_inputs(G, S, N, seed, fp8=False):
    """The inputs of tests/test_paged.py:141 (G query heads per KV head, S
    positions, N in-flight slots); e4m3 pools as the JAX package casts them."""
    rng = np.random.default_rng(seed)
    B = TABLES.shape[0]
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    kp, vp = f(L_, NB, NK, BS, D), f(L_, NB, NK, BS, D)
    kp[:, 0] = 0.0
    vp[:, 0] = 0.0
    x = dict(q=f(B, S, NK * G, D), kp=kp, vp=vp, ki=f(B, NK, N, D), vi=f(B, NK, N, D))
    if fp8:
        kp[..., :8] *= 0.01  # the e4m3 subnormal range
        x["kp8"] = jnp.asarray(kp).astype(jnp.float8_e4m3fn)
        x["vp8"] = jnp.asarray(vp).astype(jnp.float8_e4m3fn)
        # in-flight K/V beside an fp8 pool are bf16
        x["ki"] = np.asarray(jnp.asarray(x["ki"]).astype(jnp.bfloat16).astype(jnp.float32))
        x["vi"] = np.asarray(jnp.asarray(x["vi"]).astype(jnp.bfloat16).astype(jnp.float32))
    return x


def _port_pools(x, fp8):
    if not fp8:
        return _t(x["kp"]), _t(x["vp"])
    as_t = lambda a: torch.from_numpy(np.array(a).view(np.uint8)).view(E4M3)  # noqa: E731
    return as_t(x["kp8"]), as_t(x["vp8"])


# (G, S, N, base, prior accepted slots per row, window, fp8)
SPEC_CASES = [
    (2, 3, 9, 3, (2, 3, 0), None, False),      # tests/test_paged.py:141
    (2, 3, 9, 0, (0, 0, 0), None, False),      # the first round
    (4, 5, 10, 5, (5, 1, 3), None, False),     # the serving shape's G and S
    (1, 2, 6, 4, (4, 2, 1), None, False),
    (2, 3, 9, 3, (2, 3, 0), 12, False),        # a binding window
    (4, 5, 10, 5, (5, 1, 3), 7, False),
    (2, 3, 9, 3, (2, 3, 0), None, True),       # e4m3 pools
    (4, 5, 10, 5, (5, 1, 3), 9, True),
]


@pytest.mark.parametrize("case", SPEC_CASES)
def test_paged_decode_spec_plain_matches_jax(case):
    G, S, N, base, prior, window, fp8 = case
    x = _spec_inputs(G, S, N, seed=7 + G + S, fp8=fp8)
    B = TABLES.shape[0]
    valid = np.zeros((B, N), bool)
    for b, n in enumerate(prior):
        valid[b, :n] = True
    # verify position s of row b sits at pool slot lengths0 + accepted + s;
    # accepted in-flight slot j at lengths0 + j
    q_slots = (LENGTHS0[:, None] + np.array(prior)[:, None] + np.arange(S)[None]).astype(
        np.int32)
    infl_slots = np.where(valid, LENGTHS0[:, None] + np.arange(N)[None], 0).astype(np.int32)
    kp_t, vp_t = _port_pools(x, fp8)
    kp_j = x["kp8"] if fp8 else jnp.asarray(x["kp"])
    vp_j = x["vp8"] if fp8 else jnp.asarray(x["vp"])
    common = (jnp.asarray(TABLES), jnp.asarray(LENGTHS0), jnp.asarray(STARTS),
              jnp.asarray(x["ki"]), jnp.asarray(x["vi"]), jnp.asarray(valid))
    for l in range(L_):
        got = pa.paged_decode_spec_plain(
            _t(x["q"]), kp_t, vp_t, _t(TABLES), _t(LENGTHS0), _t(STARTS), _t(x["ki"]),
            _t(x["vi"]), _t(valid), l, base, D ** -0.5, window, _t(q_slots),
            _t(infl_slots)).numpy()
        oracle = paged_decode_spec_xla(
            jnp.asarray(x["q"]), kp_j[l], vp_j[l], *common, jnp.asarray(base, jnp.int32),
            scale=D ** -0.5, sliding_window=window, q_slots=jnp.asarray(q_slots),
            infl_slots=jnp.asarray(infl_slots))
        np.testing.assert_allclose(got, np.asarray(oracle), **TOL, err_msg=f"layer {l}")
        if window is None:
            kernel = paged_decode_spec_tpu(
                jnp.asarray(x["q"]), kp_j, vp_j, *common, jnp.asarray(l, jnp.int32),
                jnp.asarray(base, jnp.int32), scale=D ** -0.5, interpret=True)
            np.testing.assert_allclose(got, np.asarray(kernel), **TOL, err_msg=f"layer {l}")


def test_paged_decode_spec_wrapper_on_cpu_is_plain():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; a window of at least MB * bs slots is dropped (it masks
    nothing), as the JAX dispatch drops it."""
    G, S, N, base = 2, 3, 9, 3
    x = _spec_inputs(G, S, N, seed=3)
    valid = np.zeros((3, N), bool)
    valid[:, :2] = True
    args = (_t(x["q"]), _t(x["kp"]), _t(x["vp"]), _t(TABLES), _t(LENGTHS0), _t(STARTS),
            _t(x["ki"]), _t(x["vi"]), _t(valid), 1, base, D ** -0.5)
    ak.reset_launches()
    got = pa.paged_decode_spec(*args)
    np.testing.assert_array_equal(got.numpy(), pa.paged_decode_spec_plain(*args).numpy())
    wide = pa.paged_decode_spec(*args, TABLES.shape[1] * BS)  # no q_slots needed
    np.testing.assert_array_equal(wide.numpy(), got.numpy())
    assert not ak.LAUNCHES
    with pytest.raises(ValueError, match="q_slots"):
        pa.paged_decode_spec(*args, 5)


def test_rejected_slots_never_reach_the_output():
    """An in-flight slot neither accepted earlier nor in the own round (a
    rejected slot of an earlier round) is never seen: NaN there changes
    nothing."""
    G, S, N, base = 2, 3, 9, 3
    x = _spec_inputs(G, S, N, seed=5)
    valid = np.zeros((3, N), bool)
    valid[:, :1] = True  # slot 0 accepted; slots 1, 2 were rejected
    run = lambda: pa.paged_decode_spec_plain(  # noqa: E731
        _t(x["q"]), _t(x["kp"]), _t(x["vp"]), _t(TABLES), _t(LENGTHS0), _t(STARTS),
        _t(x["ki"]), _t(x["vi"]), _t(valid), 0, base, D ** -0.5).numpy()
    clean = run()
    x["ki"][:, :, 1:3] = np.nan
    x["vi"][:, :, 1:3] = np.nan
    np.testing.assert_array_equal(run(), clean)


# -- drafting ---------------------------------------------------------------------


@pytest.mark.parametrize("ngram,gamma", [(2, 3), (3, 4), (1, 2)])
def test_ngram_draft_batched_matches_host_draft(ngram, gamma):
    """The device prompt-lookup gives the host ngram_draft (the JAX
    engine's and the port's) padded with the current token."""
    rng = np.random.default_rng(ngram * 10 + gamma)
    contexts = [list(rng.integers(0, 5, n)) for n in (1, 2, 4, 9, 17, 30)]
    contexts.append([7, 8, 9] * 5)
    C = 40
    ctx = np.zeros((len(contexts), C), np.int32)
    for b, c in enumerate(contexts):
        ctx[b, : len(c)] = c
    clen = np.array([len(c) for c in contexts], np.int32)
    cur = ctx[np.arange(len(contexts)), clen - 1]
    got = causal_lm.ngram_draft_batched(_t(ctx), _t(clen), _t(cur), ngram, gamma).numpy()
    for b, c in enumerate(contexts):
        want = j_ngram_draft(c, ngram, gamma)
        assert ngram_draft(c, ngram, gamma) == want
        assert list(got[b]) == want + [int(cur[b])] * (gamma - len(want)), (b, c)


# -- the speculative quantum ------------------------------------------------------------


def _spec_ctx(st, seed, C=64):
    """A context per row that repeats a phrase, so drafts get accepted."""
    rng = np.random.default_rng(seed)
    B = len(st["lengths"])
    ctx = np.zeros((B, C), np.int32)
    clen = np.zeros(B, np.int32)
    for b in range(B):
        phrase = list(rng.integers(3, 101, 4 + b))
        toks = (phrase * 8)[: 10 + 3 * b]
        ctx[b, : len(toks)] = toks
        clen[b] = len(toks)
    return ctx, clen


@pytest.mark.parametrize("fam,int4", [("llama", False), ("mistral", False),
                                      ("llama", True)])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_decode_paged_spec_steps_matches_jax(fam, int4, impl):
    """Two greedy rounds (gamma 3, n-gram 2) on rows of ragged lengths and
    one inactive row: the emitted tokens, the counts, the next inputs, the
    pools after the final scatter (outside the null block) and the
    advanced lengths equal the JAX package's."""
    jcfg, jparams, cfg, tparams = _models(fam, int4)
    st = _paged_state(cfg, 5, [20, 33, 7, 45], [True, True, True, False])
    ctx, clen = _spec_ctx(st, 8)
    tok0 = ctx[np.arange(4), clen - 1]
    jstate = JPagedKVState(**{k: jnp.asarray(v) for k, v in st.items()})
    jtoks, jcounts, jcur, jst = jlm.decode_paged_spec_steps(
        jparams, jcfg, jnp.asarray(tok0), jstate, jnp.asarray(ctx), jnp.asarray(clen),
        2, 3, 2)
    tstate = PagedKVState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    seen = []

    def typed(*a):  # the kernel takes int32 tables, lengths and slots every round
        seen.append(a[9])
        assert all(t.dtype == torch.int32 for t in (a[3], a[4], a[5], a[13], a[14]))
        assert a[8].dtype == torch.bool
        return pa.paged_decode_spec(*a)

    real = causal_lm.paged_decode_spec
    causal_lm.paged_decode_spec = typed
    try:
        toks, counts, cur = causal_lm.decode_paged_spec_steps(
            tparams, cfg, _t(tok0), tstate, _t(ctx), _t(clen), 2, 3, 2, attn_impl=impl)
    finally:
        causal_lm.paged_decode_spec = real
    assert len(seen) == (2 * cfg.num_hidden_layers if impl == "kernel" else 0)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.numpy()[:, :3].sum() > 6, "no draft was accepted"
    live = np.asarray(jcounts) > 0
    for r in range(2):
        for b in range(4):
            n = int(np.asarray(jcounts)[r, b])
            np.testing.assert_array_equal(toks.numpy()[r, b, :n], np.asarray(jtoks)[r, b, :n])
    np.testing.assert_array_equal(cur.numpy()[live.any(0)], np.asarray(jcur)[live.any(0)])
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(jst.lengths))
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(getattr(tstate, name).numpy()[:, 1:],
                                   np.asarray(getattr(jst, name))[:, 1:], rtol=1e-4,
                                   atol=1e-4)


def test_decode_paged_spec_steps_writes_only_accepted_slots():
    """A rejected draft's slot is never scattered: the pool past each row's
    accepted tokens keeps what it held before the quantum."""
    _, _, cfg, tparams = _models("llama")
    st = _paged_state(cfg, 9, [20, 33, 7], [True, True, True])
    ctx, clen = _spec_ctx(st, 3)
    ctx[:, :] = np.random.default_rng(4).integers(3, 101, ctx.shape)  # drafts fail
    tok0 = ctx[np.arange(3), clen - 1]
    tstate = PagedKVState(**{k: torch.from_numpy(v.copy()) for k, v in st.items()})
    _, counts, _ = causal_lm.decode_paged_spec_steps(
        tparams, cfg, _t(tok0), tstate, _t(ctx), _t(clen), 2, 3, 2, attn_impl="plain")
    acc = counts.numpy().sum(0)
    bs = st["k_pool"].shape[3]
    for b, n0 in enumerate(st["lengths"]):
        for slot in range(n0 + acc[b], n0 + 8):
            blk, off = st["block_tables"][b, slot // bs], slot % bs
            np.testing.assert_array_equal(tstate.k_pool.numpy()[:, blk, :, off],
                                          st["k_pool"][:, blk, :, off])
    assert (tstate.lengths.numpy() == st["lengths"] + acc).all()


# -- the batcher --------------------------------------------------------------------------


SPEC_KW = dict(batch_capacity=2, n_blocks=64, max_blocks_per_seq=8, decode_quantum=8,
               speculative="ngram", spec_draft_len=3, spec_ngram=2)


def _repetitive_prompts(seed, vocab=101):
    rng = np.random.default_rng(seed)
    phrase = [int(x) for x in rng.integers(3, vocab, 6)]
    return [phrase * 3 + [int(x) for x in rng.integers(3, vocab, 2)],
            [int(x) for x in rng.integers(3, vocab, 9)], phrase * 2]


@pytest.mark.parametrize("fam", ["llama", "mistral", "mixtral"])
def test_spec_batcher_matches_jax_and_plain(fam):
    """tests/test_paged.py:383 on the port: the speculative batcher's greedy
    streams equal the JAX speculative batcher's and the port's own plain
    quanta (up to near-ties), with drafts accepted."""
    jcfg, jparams, _, _ = _models(fam)
    prompts = _repetitive_prompts(41)
    jb = JBatcher(j_get_model(jcfg.model_type), jcfg, jparams, eos_ids=set(),
                  config=JSchedulerConfig(**SC, **SPEC_KW))
    want, _ = _run(jb, prompts, 10)
    b = _port_batcher(fam, **SPEC_KW)
    got, reasons = _run(b, prompts, 10)
    plain, _ = _run(_port_batcher(fam, **dict(SPEC_KW, speculative=None)), prompts, 10)
    assert all(len(v) == 10 for v in got.values()) and set(reasons.values()) == {"length"}
    assert b.spec_verifies > 0 and b.spec_acceptance > 0
    _assert_streams_agree(fam, prompts, got, want)
    _assert_streams_agree(fam, prompts, got, plain)


def test_spec_batcher_sliding_window():
    """tests/test_paged.py:445: a window of 8 binds well inside prompt and
    generation, and repeated phrases make drafts accept: frozen, accepted
    in-flight and own-round slots are all masked in slot space. The streams
    equal the plain quanta's and dense greedy decoding's."""
    rng = np.random.default_rng(53)
    phrase = [int(x) for x in rng.integers(3, 101, 5)]
    prompts = [phrase * 4, [int(x) for x in rng.integers(3, 101, 13)]]
    got, _ = _run(_port_batcher("mistral", **SPEC_KW), prompts, 8)
    plain, _ = _run(_port_batcher("mistral", **dict(SPEC_KW, speculative=None)),
                    prompts, 8)
    _assert_streams_agree("mistral", prompts, got, plain)
    for i, p in enumerate(prompts):
        context = list(p)
        for tok in got[i]:
            lg = _dense_logits("mistral", context)
            assert lg.max() - lg[tok] < NEAR_TIE
            context.append(tok)


def test_spec_batcher_mixed_greedy_and_sampled():
    """tests/test_paged.py:1267: greedy and sampled rows in one speculative
    quantum. The greedy row emits the dense argmax chain, the sampled row
    only tokens of its top-k support (widened by one rank for threshold
    flips), both finish; and a speculating batcher stays seeded."""
    rng = np.random.default_rng(97)
    phrase = [int(x) for x in rng.integers(3, 101, 4)]
    prompts = [phrase * 3, phrase * 2]
    runs = []
    for _ in range(2):
        b = _port_batcher("llama", **dict(SPEC_KW, decode_quantum=6, spec_draft_len=2),
                          seed=5)
        b.add_request(Request(request_id=0, prompt_ids=prompts[0], max_new_tokens=6))
        b.add_request(Request(request_id=1, prompt_ids=prompts[1], max_new_tokens=6,
                              sampler=SamplerConfig(temperature=1.0, top_k=3)))
        runs.append(_run(b, [], 0)[0])
        assert b.spec_verifies > 0
    got = runs[0]
    assert runs[0] == runs[1]
    assert len(got[0]) == 6 and len(got[1]) == 6
    context = list(prompts[0])
    for tok in got[0]:
        lg = _dense_logits("llama", context)
        assert lg.max() - lg[tok] < NEAR_TIE
        context.append(tok)
    context = list(prompts[1])
    for tok in got[1]:
        lg = _dense_logits("llama", context)
        assert tok in set(int(t) for t in np.argsort(lg)[::-1][:4])
        context.append(tok)


def test_spec_rejection_sampling_preserves_distribution():
    """tests/test_paged.py:1186: with a deterministic n-gram draft,
    accepting draft d with probability p(d) and emitting from the residual
    on a reject makes the first emitted token an exact sample of the row's
    processed distribution p (top_k 4, temperature 1). 2048 copies of one
    row verify in a single quantum; the first tokens' frequencies are held
    to p by total-variation distance (sampling noise about 0.02)."""
    _, _, cfg, tparams = _models("llama")
    rng = np.random.default_rng(91)
    phrase = [int(x) for x in rng.integers(3, 101, 3)]
    context = phrase * 4
    K = 2048
    kw = dict(batch_capacity=1, n_blocks=8, max_blocks_per_seq=4)
    b = _port_batcher("llama", **kw)
    req = Request(request_id=0, prompt_ids=context, max_new_tokens=8)
    b.add_request(req)
    b.step()
    tok0 = req.generated[0]
    ctx_list = context + [tok0]
    # K rows over the one row's blocks (only read before the final scatter)
    state = PagedKVState(
        k_pool=b.state.k_pool, v_pool=b.state.v_pool,
        block_tables=b.state.block_tables[:1].repeat(K, 1),
        lengths=torch.full((K,), len(context), dtype=torch.int32),
        starts=torch.zeros(K, dtype=torch.int32), active=torch.ones(K, dtype=torch.bool))
    ctx = torch.zeros((K, 32), dtype=torch.int32)
    ctx[:, : len(ctx_list)] = torch.tensor(ctx_list)
    knobs = (torch.ones(K), torch.full((K,), 4, dtype=torch.int32), torch.ones(K),
             torch.zeros(K))
    toks, counts, _ = causal_lm.decode_paged_spec_steps(
        tparams, cfg, torch.full((K,), tok0, dtype=torch.int32), state, ctx,
        torch.full((K,), len(ctx_list), dtype=torch.int32), 1, 2, 2,
        attn_impl="plain", sampler=knobs, generator=torch.Generator().manual_seed(5))
    first = toks[0, :, 0].numpy()
    assert (counts.numpy() > 1).any(), "no draft was accepted"
    lg = torch.from_numpy(_dense_logits("llama", ctx_list))[None]
    p = torch.softmax(masked_logits_batched(lg, *(k[:1] for k in knobs)), -1)[0].numpy()
    support = np.flatnonzero(p > 1e-9)
    assert len(support) <= 4 and np.isin(first, support).all()
    emp = np.bincount(first, minlength=p.size) / K
    assert 0.5 * np.abs(emp - p).sum() < 0.08


def _policy(batcher_cls, sc):
    b = batcher_cls.__new__(batcher_cls)
    b.sc = sc
    b.running = {0: object()}
    b._spec_fn = object()  # the JAX batcher's switch
    b._spec = True         # the port's
    for k in ("_spec_disabled", "_spec_probing"):
        setattr(b, k, False)
    for k in ("_spec_win_emitted", "_spec_win_verifies", "_spec_low_windows",
              "_plain_since_probe"):
        setattr(b, k, 0)
    return b


def test_spec_auto_off_policy_matches_jax():
    """tests/test_paged.py:1384 on both packages: the same telemetry
    sequence (cold start, a low window, a second low window, plain quanta
    until the probe, healthy windows, a failed re-probe) gives the same
    decisions at every step."""
    jb = _policy(JBatcher, JSchedulerConfig(spec_window=8, spec_probe_every=3,
                                            spec_min_acceptance=0.5))
    tb = _policy(ContinuousBatcher, SchedulerConfig(spec_window=8, spec_probe_every=3,
                                                    spec_min_acceptance=0.5))
    seq = ([(1, 1)] * 16 + [None] * 3 + [(2, 1)] * 8 + [(1, 1)] * 8 + [(2, 1)] * 8
           + [(1, 1)] * 16 + [None] * 3 + [(1, 1)] * 8 + [None] * 2)
    decisions = []
    for item in seq:
        for b in (jb, tb):
            if item is None:
                decisions.append((b is tb, b._spec_eligible()))
            else:
                b._spec_policy_update(*item)
                decisions.append((b is tb, b._spec_disabled))
    j = [d for who, d in decisions if not who]
    t = [d for who, d in decisions if who]
    assert t == j
    assert True in t and False in t


# -- the engine, the CLI and the server ---------------------------------------------


TINY = dict(model_type="llama", vocab_size=503, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5)
PROMPT = "the cat sat on the mat. the cat sat on the"


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    out = {}
    for fam, extra in (("llama", {}), ("mistral", dict(model_type="mistral",
                                                       sliding_window=8))):
        d = tmp_path_factory.mktemp(f"torch_spec_{fam}")
        out[fam] = write_random_model_dir(str(d), dict(TINY, **extra), seed=11,
                                          dtype=torch.float32)
    return out


def _engine(d, **kw):
    kw = dict(dict(dtype="float32", max_tokens=24, prefill_bucket=16, decode_chunk=4,
                   spec_ngram=2), **kw)
    e = GPTEngine(GPTConfig(model_dir=d, device="cpu", **kw))
    e.prepare()
    return e


@pytest.mark.parametrize("fam", ["llama", "mistral"])
def test_engine_spec_matches_plain_and_jax(model_dirs, fam):
    """tests/test_engine.py:120: batch-1 speculation is exact for greedy
    decoding: the same tokens as the chunked loop and as the JAX engine's
    speculation, on a prompt repetitive enough for drafts to accept."""
    d = model_dirs[fam]
    got = _engine(d, speculative="ngram").generate_sync([PROMPT])[0]
    plain = _engine(d).generate_sync([PROMPT])[0]
    jeng = JGPTEngine(JGPTConfig(model_dir=d, dtype="float32", max_tokens=24,
                                 prefill_bucket=16, decode_chunk=4, speculative="ngram",
                                 spec_ngram=2))
    jeng.prepare()
    want = jeng.generate_sync([PROMPT])[0]
    assert got.token_ids == plain.token_ids == want.token_ids
    assert got.text == want.text and len(got.token_ids) == 24


def test_engine_spec_counts_rounds_and_stops(model_dirs, monkeypatch):
    """Drafts are accepted (fewer verify rounds than tokens), and a stop id
    ends the speculative stream where it ends the plain one."""
    d = model_dirs["llama"]
    rounds = []
    real = causal_lm.spec_accept

    def counting(*a, **kw):
        rounds.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(causal_lm, "spec_accept", counting)
    eng = _engine(d, speculative="ngram")
    out = eng.generate_sync([PROMPT])[0]
    assert len(rounds) < len(out.token_ids)
    stop = out.token_ids[5]
    eng.reconfigure(extra_stop_token_ids=[stop])
    plain = _engine(d, extra_stop_token_ids=(stop,))
    assert eng.generate_sync([PROMPT])[0].token_ids == plain.generate_sync([PROMPT])[0].token_ids


def test_engine_spec_sampled_batch1(model_dirs):
    """tests/test_engine.py:261: sampled decoding rides the speculative
    path (exact rejection sampling): every token lies in the top-k support
    of the dense logits (one rank of margin), the stream completes, and
    the same seed gives the same stream."""
    d = model_dirs["llama"]
    outs = []
    for _ in range(2):
        eng = _engine(d, speculative="ngram", spec_draft_len=3, max_tokens=8, seed=5,
                      sampler=SamplerConfig(temperature=1.0, top_k=4))
        outs.append(eng.generate_sync([PROMPT])[0].token_ids)
    assert outs[0] == outs[1] and len(outs[0]) == 8
    mc, params = eng.ctx.model_config, eng.ctx.params
    context = eng.ctx.tokenizer.encode(PROMPT)
    for tok in outs[0]:
        from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache

        S = len(context)
        cache = create_kv_cache(mc, 1, S, dtype=torch.float32, device="cpu")
        lg, _ = causal_lm.forward(params, mc, torch.tensor([context], dtype=torch.int32),
                                  cache, torch.arange(S)[None], torch.ones(1, S, dtype=torch.bool),
                                  last_only=True)
        assert tok in set(int(t) for t in lg[0, -1].argsort(descending=True)[:5])
        context.append(tok)


def test_engine_spec_batch_falls_back(model_dirs):
    """tests/test_engine.py:290: a batch takes the chunked loop: the same
    tokens with speculation asked for as without."""
    d = model_dirs["llama"]
    prompts = ["One fish", "Two fish"]
    got = [o.token_ids for o in _engine(d, speculative="ngram").generate_sync(prompts)]
    want = [o.token_ids for o in _engine(d).generate_sync(prompts)]
    assert got == want


def test_cli_speculative(model_dirs, capsys):
    d = model_dirs["llama"]
    base = ["--model", d, "--device", "cpu", "--dtype", "float32", "--max-tokens", "12",
            "--prompt", PROMPT]
    assert cli.main(base + ["--speculative", "ngram"]) == 0
    spec = capsys.readouterr().out
    assert cli.main(base) == 0
    assert capsys.readouterr().out == spec and f">>> {PROMPT}" in spec


def test_server_speculative(model_dirs):
    """ServerConfig(speculative=True) (the server's --speculative) serves
    greedy completions through speculative quanta: the same text as the
    plain server, with verify rounds counted."""
    import http.server
    import json
    import threading
    import urllib.request

    from tinygpt_tpu_torch.server.http import ServerConfig, TinyGPTServer, _make_handler

    texts = {}
    for spec in (False, True):
        srv = TinyGPTServer(ServerConfig(model_dir=model_dirs["llama"], dtype="float32",
                                         max_tokens=12, device="cpu", batch_capacity=2,
                                         kv_n_blocks=64, speculative=spec))
        srv.prepare()
        srv._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(srv))
        t = threading.Thread(target=srv._httpd.serve_forever, daemon=True)
        t.start()
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv._httpd.server_address[1]}/v1/completions",
                data=json.dumps({"prompt": PROMPT, "max_tokens": 12}).encode(),
                headers={"Content-Type": "application/json"})
            body = json.loads(urllib.request.urlopen(req, timeout=120).read())
        finally:
            srv._httpd.shutdown()
            srv.worker.stop()
            t.join(timeout=30)
        texts[spec] = body["choices"][0]["text"]
        assert body["usage"]["completion_tokens"] == 12
        assert (srv.worker.batcher.spec_verifies > 0) == spec
    assert texts[True] == texts[False]
