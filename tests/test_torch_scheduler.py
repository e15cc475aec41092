"""The port's continuous-batching path against the JAX package's, on the
CPU: per-row sampling masks, the paged decode quantum
(causal_lm.decode_paged_steps) on the same params and pools, and the
ContinuousBatcher's greedy streams, on a tiny llama and a windowed
mistral (2 layers, fp32). Then the scheduler contracts of
tests/test_paged.py on the port alone: prefix caching (reuse, eviction,
no aliasing under pool pressure), chunked against whole admission,
quantum invariance, pipelining, EOS / stop ids / max tokens and pool
exhaustion.

Both packages compute the same fp32 functions in another order, so
logits agree within 1e-4 and greedy streams up to the first difference,
which must be a near-tie of the JAX dense logits (top-2 gap below 1e-3).
int4 weights are put on the int4 grid first (see
tests/test_torch_quant_model.py), so that the JAX package's bf16
rounding of dequantized weights is exact."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache
from tinygpt_tpu.engine.paged_kv import PagedKVState as JPagedKVState
from tinygpt_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from tinygpt_tpu.engine.scheduler import Request as JRequest
from tinygpt_tpu.engine.scheduler import SchedulerConfig as JSchedulerConfig
from tinygpt_tpu.hf.config import parse_model_config as j_parse
from tinygpt_tpu.models import causal_lm as jlm
from tinygpt_tpu.models import get_model as j_get_model
from tinygpt_tpu.ops.quant import quantize_params as j_quantize_params
from tinygpt_tpu.ops.sampling import masked_logits_batched as j_masked
from tinygpt_tpu_torch.engine.paged_kv import PagedKVState
from tinygpt_tpu_torch.engine.scheduler import (
    ContinuousBatcher,
    Request,
    SchedulerConfig,
)
from tinygpt_tpu_torch.hf.config import parse_model_config
from tinygpt_tpu_torch.models import causal_lm, get_model
from tinygpt_tpu_torch.ops.sampling import (
    NEG_INF,
    SamplerConfig,
    masked_logits_batched,
    sample_batched,
)

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NEAR_TIE = 1e-3
GROUP = 64
_BASE = dict(vocab_size=101, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=256, rms_norm_eps=1e-5)
CONFIGS = {
    "llama": dict(_BASE, model_type="llama", tie_word_embeddings=True),
    "mistral": dict(_BASE, model_type="mistral", sliding_window=8),
    "mixtral": dict(_BASE, model_type="mixtral", num_local_experts=4,   # MoE MLP
                    num_experts_per_tok=2),
}
SC = dict(block_size=16, prefill_bucket=16, dtype="float32")


def on_grid(w, axis: int = -2) -> np.ndarray:
    """w with each group of 64 along `axis` on the int4 grid of scale 2^-7."""
    w = np.moveaxis(np.asarray(w, np.float32), axis, -1)
    q = np.clip(np.round(w * 128), -7, 7)
    live = np.abs(w).reshape(*w.shape[:-1], -1, GROUP).max(-1) > 0
    q[..., ::GROUP] = np.where(live, 7, 0)
    return np.moveaxis(q / 128, -1, axis).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models(fam: str, int4: bool = False):
    """(JAX cfg, JAX params, port cfg, port params) on the same weights."""
    jcfg = j_parse(CONFIGS[fam])
    jparams = jlm.init_params(jcfg, seed=3, dtype=jnp.float32)
    if int4:
        layers = {k: jnp.asarray(on_grid(v)) if k in ("qkv_w", "o_w", "gate_up_w",
                                                      "down_w") else v
                  for k, v in jparams["layers"].items()}
        jparams = dict(jparams, layers=layers,
                       embed=jnp.asarray(on_grid(jparams["embed"], axis=-1)))
        jparams = j_quantize_params(jparams, bits=4, group_size=GROUP)
    tparams = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                          device="cpu")
    return jcfg, jparams, parse_model_config(CONFIGS[fam]), tparams


def _prompts(seed, lens, vocab=101):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(3, vocab, n)] for n in lens]


def _port_batcher(fam, eos_ids=(), int4=False, **kw):
    _, _, cfg, params = _models(fam, int4)
    return ContinuousBatcher(get_model(cfg.model_type), cfg, params,
                             eos_ids=set(eos_ids),
                             config=SchedulerConfig(**dict(SC, **kw)))


def _run(batcher, prompts, max_new, arrivals=None, ids=None):
    """Streams {request id: tokens}. arrivals[i] is the scheduler step at
    which request i joins (default: all at once)."""
    arrivals = arrivals or [0] * len(prompts)
    ids = ids or list(range(len(prompts)))
    got, reasons, step = {}, {}, 0
    pending = sorted(zip(arrivals, ids, prompts))
    while (batcher.has_work or pending) and step < 500:
        while pending and pending[0][0] <= step:
            _, i, p = pending.pop(0)
            req_t = JRequest if isinstance(batcher, JBatcher) else Request
            batcher.add_request(req_t(request_id=i, prompt_ids=p, max_new_tokens=max_new))
        for ev in batcher.step():
            if ev.token_id is not None:
                got.setdefault(ev.request_id, []).append(ev.token_id)
            if ev.finished:
                reasons[ev.request_id] = ev.finish_reason
        step += 1
    assert not batcher.has_work
    return got, reasons


def _dense_logits(fam, context):
    """JAX teacher-forced dense logits for the token after `context`."""
    jcfg, jparams, _, _ = _models(fam)
    S = len(context)
    cache = j_create_kv_cache(jcfg, 1, S, dtype=jnp.float32)
    lg, _ = jlm.forward(jparams, jcfg, jnp.asarray([context], jnp.int32), cache,
                        jnp.arange(S)[None, :], jnp.ones((1, S), jnp.bool_),
                        last_only=True)
    return np.asarray(lg[0, -1])


def _assert_streams_agree(fam, prompts, a, b):
    """Equal streams, or equal up to a first difference where both tokens
    are within NEAR_TIE of the dense argmax (after which they may part)."""
    assert a.keys() == b.keys()
    for rid in a:
        x, y = a[rid], b[rid]
        if x == y:
            continue
        i = next((j for j in range(min(len(x), len(y))) if x[j] != y[j]), None)
        assert i is not None, f"request {rid}: {x} vs {y}"
        lg = _dense_logits(fam, prompts[rid] + x[:i])
        top = float(lg.max())
        assert top - lg[x[i]] < NEAR_TIE and top - lg[y[i]] < NEAR_TIE, (
            f"request {rid} diverges at {i} without a near-tie: {x[i]} vs {y[i]}")


# -- sampling ---------------------------------------------------------------


def _knobs():
    temp = np.array([0.0, 1.0, 0.7, 1.3, 1.0, 0.5], np.float32)
    top_k = np.array([0, 5, 0, 20, 1, 0], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.5, 1.0, 0.3], np.float32)
    min_p = np.array([0.0, 0.0, 0.05, 0.0, 0.0, 0.2], np.float32)
    return temp, top_k, top_p, min_p


def test_masked_logits_batched_matches_jax():
    logits = np.random.default_rng(0).standard_normal((6, 97)).astype(np.float32) * 3
    knobs = _knobs()
    got = masked_logits_batched(torch.from_numpy(logits),
                                *(torch.from_numpy(k) for k in knobs)).numpy()
    want = np.asarray(j_masked(jnp.asarray(logits), *(jnp.asarray(k) for k in knobs)))
    np.testing.assert_array_equal(got == NEG_INF, want == NEG_INF)
    keep = want != NEG_INF
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6)
    assert keep.sum(1).min() >= 1


def test_sample_batched_greedy_rows_and_masks():
    """Rows at temperature 0 take the argmax; the others draw only kept
    tokens, and the same seed gives the same draws."""
    logits = torch.from_numpy(
        np.random.default_rng(1).standard_normal((6, 97)).astype(np.float32) * 3)
    knobs = [torch.from_numpy(k) for k in _knobs()]
    keep = masked_logits_batched(logits, *knobs) != NEG_INF
    draws = []
    for seed in (7, 7):
        gen = torch.Generator().manual_seed(seed)
        draws.append(torch.stack([sample_batched(logits, *knobs, gen)
                                  for _ in range(50)]))
    assert torch.equal(draws[0], draws[1])
    d = draws[0]
    assert d.dtype == torch.int32
    assert bool((d[:, 0] == logits[0].argmax()).all())
    assert bool((d[:, 4] == logits[4].argmax()).all())  # top_k = 1
    assert bool(keep.gather(1, d.T.long()).all())
    assert len(set(d[:, 1].tolist())) > 1


# -- the paged decode quantum --------------------------------------------------


def _paged_state(cfg, seed, lengths, active, MB=4, n_blocks=24, bs=16, B=None):
    rng = np.random.default_rng(seed)
    B = len(lengths)
    shape = (cfg.num_hidden_layers, n_blocks, cfg.num_kv_heads, bs, cfg.head_dim)
    kp = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    vp = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    tables = np.zeros((B, MB), np.int32)
    free = list(range(1, n_blocks))
    for b in range(B):
        if active[b]:
            nb = -(-(lengths[b] + 8) // bs)
            tables[b, :nb] = free[:nb]
            free = free[nb:]
    return dict(k_pool=kp, v_pool=vp, block_tables=tables,
                lengths=np.asarray(lengths, np.int32),
                starts=np.zeros(B, np.int32), active=np.asarray(active, bool))


@pytest.mark.parametrize("fam,int4", [("llama", False), ("mistral", False),
                                      ("llama", True), ("mixtral", False)])
@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_decode_paged_steps_matches_jax(fam, int4, impl):
    """One quantum of 5 steps on forced tokens, rows of ragged lengths and
    one inactive row with a stale length: every step's logits (1e-4), the
    pools after the final scatter and the advanced lengths."""
    jcfg, jparams, cfg, tparams = _models(fam, int4)
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
                                        n_steps, t_sample, attn_impl=impl)
    assert len(seen_t) == len(seen_j) == n_steps
    for i in range(n_steps):
        np.testing.assert_allclose(seen_t[i], seen_j[i], **LOGIT_TOL, err_msg=f"step {i}")
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tstate.lengths.numpy(), np.asarray(jst.lengths))
    # pools equal outside the null block (inactive rows' writes land there,
    # in an order neither package fixes)
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(getattr(tstate, name).numpy()[:, 1:],
                                   np.asarray(getattr(jst, name))[:, 1:], **LOGIT_TOL)


# -- the batcher against the JAX batcher ----------------------------------------


@pytest.mark.parametrize("fam", ["llama", "mistral", "mixtral"])
def test_batcher_streams_match_jax(fam):
    """Staggered requests, more than the 3 rows, one sharing a prefix
    block with another: the port's greedy streams against the JAX
    ContinuousBatcher's, then against dense greedy decoding."""
    jcfg, jparams, cfg, tparams = _models(fam)
    prompts = _prompts(11, (5, 20, 37, 3, 2))
    prompts[3] = prompts[2][:16] + prompts[3]
    arrivals = [0, 0, 1, 3, 6]
    kw = dict(batch_capacity=3, n_blocks=40, max_blocks_per_seq=6, decode_quantum=4)
    jb = JBatcher(j_get_model(jcfg.model_type), jcfg, jparams, eos_ids=set(),
                  config=JSchedulerConfig(**SC, **kw))
    want, _ = _run(jb, prompts, 9, arrivals)
    got, reasons = _run(_port_batcher(fam, **kw), prompts, 9, arrivals)
    assert all(len(v) == 9 for v in got.values()) and set(reasons.values()) == {"length"}
    _assert_streams_agree(fam, prompts, got, want)


def test_request_at_the_context_cap_beside_a_live_row():
    """Pool slots per row (max_blocks_per_seq * block_size = 256) equal the
    context (max_position_embeddings = 256). A request filling it has its
    pipelined quanta run past position 255, and after its release its row
    is inactive while another row still decodes: the streams equal the JAX
    batcher's (whose RoPE gather clamps) and a released row's length is 0."""
    jcfg, jparams, cfg, _ = _models("llama")
    assert cfg.max_position_embeddings == 256
    prompts = _prompts(53, (250, 5))
    max_new = [6, 24]
    kw = dict(batch_capacity=2, n_blocks=40, max_blocks_per_seq=16, decode_quantum=4)

    def run(b):
        req_t = JRequest if isinstance(b, JBatcher) else Request
        for i, p in enumerate(prompts):
            b.add_request(req_t(request_id=i, prompt_ids=p, max_new_tokens=max_new[i]))
        return _run(b, [], 0)

    jb = JBatcher(j_get_model(jcfg.model_type), jcfg, jparams, eos_ids=set(),
                  config=JSchedulerConfig(**SC, **kw))
    want, _ = run(jb)
    b = _port_batcher("llama", **kw)
    got, reasons = run(b)
    assert [len(got[i]) for i in (0, 1)] == max_new
    assert reasons == {0: "length", 1: "length"}
    _assert_streams_agree("llama", prompts, got, want)
    assert not b._lengths.any()


# -- scheduler contracts on the port ----------------------------------------------


def test_prefix_cache_reuse_and_correctness():
    prompts = _prompts(13, (40, 5, 9))
    system = prompts[0]
    prompts = [system + prompts[1], system + prompts[2]]
    runs = {}
    for enable in (False, True):
        b = _port_batcher("llama", batch_capacity=2, n_blocks=64,
                          max_blocks_per_seq=8, enable_prefix_cache=enable)
        runs[enable] = _run(b, prompts, 5)[0]
        if enable:
            # 40-token system prefix = 2 whole blocks of 16 shared; idle-cached
            # blocks survive release and the pool accounting balances
            assert b.allocator.n_idle_cached > 0
            assert b.allocator.n_free == 63
    assert runs[True] == runs[False]


def test_prefix_cache_persists_and_evicts_under_pressure():
    """A prefix stays reusable after its request finished; on a tiny pool
    idle-cached blocks are reclaimed instead of failing admission."""
    system = _prompts(17, (32,))[0]
    b = _port_batcher("llama", batch_capacity=1, n_blocks=32, max_blocks_per_seq=8)
    _run(b, [system + [7, 8]], 3)
    n_cached = b.allocator.n_idle_cached
    assert n_cached > 0
    got, _ = _run(b, [system + [9]], 3, ids=[1])
    assert len(got[1]) == 3 and b.allocator.n_idle_cached >= n_cached

    b = _port_batcher("llama", batch_capacity=1, n_blocks=8, max_blocks_per_seq=6)
    for i, p in enumerate(_prompts(19, (40, 40, 40))):
        got, _ = _run(b, [p], 2, ids=[i])
        assert len(got[i]) == 2, f"request {i} starved"
    assert b.allocator.n_free == 7


def test_prefix_reuse_under_pool_pressure_no_aliasing():
    """Admission pins looked-up prefix blocks before alloc(): LRU reclaim
    must not hand one back as the same request's private block."""
    prefix_a, prefix_b, tail, long_suffix = _prompts(23, (32, 32, 8, 62))

    def run(enable):
        b = _port_batcher("llama", batch_capacity=1, n_blocks=8,
                          max_blocks_per_seq=8, enable_prefix_cache=enable)
        got = {}
        for i, p in enumerate([prefix_a + tail, prefix_b + tail]):
            got.update(_run(b, [p], 2, ids=[i])[0])
        b.add_request(Request(request_id=2, prompt_ids=prefix_a + long_suffix,
                              max_new_tokens=2))
        for ev in b.step():  # the admission step
            if ev.token_id is not None:
                got.setdefault(2, []).append(ev.token_id)
        for req in b.running.values():
            assert len(set(req.blocks)) == len(req.blocks), req.blocks
        more, _ = _run(b, [], 2)
        got.setdefault(2, []).extend(more.get(2, []))
        return got

    assert run(True) == run(False)


@pytest.mark.parametrize("enable_prefix", [False, True])
def test_chunked_admission_matches_whole(enable_prefix):
    """Chunked admission gives whole admission's tokens, and a running
    request keeps decoding between the chunks of a long prompt."""
    short, long_ = _prompts(29, (5, 70))
    if enable_prefix:
        long_ = short * 4 + long_  # a second request reuses whole blocks
    orders = {}
    runs = {}
    for chunk in (0, 16):
        b = _port_batcher("llama", batch_capacity=2, n_blocks=64, max_blocks_per_seq=8,
                          decode_quantum=1, prefill_chunk_tokens=chunk,
                          enable_prefix_cache=enable_prefix)
        order = []
        b.add_request(Request(request_id=0, prompt_ids=short, max_new_tokens=8))
        b.add_request(Request(request_id=1, prompt_ids=long_, max_new_tokens=4))
        got = {}
        while b.has_work:
            for ev in b.step():
                if ev.token_id is not None:
                    got.setdefault(ev.request_id, []).append(ev.token_id)
                    order.append(ev.request_id)
        runs[chunk], orders[chunk] = got, order
    assert runs[16] == runs[0]
    assert 0 in orders[16][: orders[16].index(1)], "short request starved"


def test_quantum_invariance():
    """decode_quantum changes dispatch granularity only: quanta of 1, 4
    and 8 give the same streams, up to a near-tie."""
    prompts = _prompts(11, (4, 7, 30))
    runs = {q: _run(_port_batcher("mistral", batch_capacity=2, n_blocks=64,
                                  max_blocks_per_seq=8, decode_quantum=q),
                    prompts, 10)[0] for q in (1, 4, 8)}
    _assert_streams_agree("mistral", prompts, runs[4], runs[1])
    _assert_streams_agree("mistral", prompts, runs[8], runs[1])


def test_pipelined_matches_unpipelined():
    """Pipelining quanta changes latency only, EOS finishes included."""
    prompts = _prompts(47, (5, 12, 3))
    free = _run(_port_batcher("llama", batch_capacity=2, n_blocks=64,
                              max_blocks_per_seq=8, decode_quantum=3), prompts, 7)[0]
    eos = free[1][2]
    runs = [_run(_port_batcher("llama", eos_ids={eos}, batch_capacity=2, n_blocks=64,
                               max_blocks_per_seq=8, decode_quantum=3,
                               pipeline_quanta=pipe), prompts, 7)
            for pipe in (True, False)]
    assert runs[0] == runs[1]
    assert runs[0][1][1] == "stop"


def test_eos_capacity_and_max_tokens():
    """More requests than rows queue and all finish by max_tokens; every
    block returns to the pool."""
    b = _port_batcher("llama", batch_capacity=2, n_blocks=32, max_blocks_per_seq=4)
    got, reasons = _run(b, _prompts(4, (4, 4, 4, 4)), 3)
    assert reasons == {i: "length" for i in range(4)}
    assert all(len(got[i]) == 3 for i in range(4))
    assert b.allocator.n_free == 31


def test_stop_token():
    """A stop id ends the stream before it (the stop token is not emitted)."""
    prompt = _prompts(5, (5,))
    free, reasons = _run(_port_batcher("llama", batch_capacity=2, n_blocks=32,
                                       max_blocks_per_seq=4), prompt, 6)
    assert reasons[0] == "length" and len(free[0]) == 6
    stop_tok = free[0][2]
    b = _port_batcher("llama", batch_capacity=2, n_blocks=32, max_blocks_per_seq=4)
    b.add_request(Request(request_id=0, prompt_ids=prompt[0], max_new_tokens=6,
                          stop_token_ids={stop_tok}))
    got, reasons = _run(b, [], 6)
    assert reasons[0] == "stop"
    assert got.get(0, []) == free[0][: free[0].index(stop_tok)]


def test_pool_exhaustion_finishes_with_length():
    """When the pool runs dry, rows that cannot get a block finish with
    "length" before max_tokens; a prompt that can never fit is refused
    with "length" at once; the pool recovers fully."""
    b = _port_batcher("llama", batch_capacity=2, n_blocks=4, max_blocks_per_seq=8)
    got, reasons = _run(b, _prompts(31, (16, 16, 200)), 40)
    assert reasons[2] == "length" and 2 not in got  # 200 + 40 tokens > 8 blocks
    assert set(reasons.values()) == {"length"}
    assert any(len(got[i]) < 40 for i in (0, 1))
    assert b.allocator.n_free == 3


def test_mesh_of_one_rank_matches_jax():
    """SchedulerConfig.mesh_shape=(1, 1, 1) and (1, 1): the sharded path's
    one-rank case streams what the JAX batcher does; a mesh of several
    ranks without a process group raises."""
    jcfg, jparams, _, _ = _models("llama")
    prompts = _prompts(61, (5, 18))
    kw = dict(batch_capacity=2, n_blocks=32)
    jb = JBatcher(j_get_model(jcfg.model_type), jcfg, jparams, eos_ids=set(),
                  config=JSchedulerConfig(**SC, **kw))
    want, _ = _run(jb, prompts, 6)
    for mesh in ((1, 1, 1), (1, 1)):
        got, _ = _run(_port_batcher("llama", mesh_shape=mesh, **kw), prompts, 6)
        _assert_streams_agree("llama", prompts, got, want)
    with pytest.raises(ValueError, match="ranks"):
        _port_batcher("llama", mesh_shape=(2, 1, 1), **kw)


@pytest.mark.parametrize("kw", [dict(speculative="ngram", spec_draft_len=3, spec_ngram=2),
                                dict(kv_cache_dtype="fp8")])
def test_speculation_and_fp8_pools_match_jax(kw):
    """Speculative quanta and fp8 pools run in the batcher and give the
    JAX batcher's greedy streams on the same configuration."""
    jcfg, jparams, _, _ = _models("llama")
    prompts = _prompts(61, (12, 5, 30))
    prompts[0] = prompts[0][:4] * 3
    kw = dict(kw, batch_capacity=2, n_blocks=40, max_blocks_per_seq=6, decode_quantum=8)
    jb = JBatcher(j_get_model(jcfg.model_type), jcfg, jparams, eos_ids=set(),
                  config=JSchedulerConfig(**SC, **kw))
    want, _ = _run(jb, prompts, 9)
    b = _port_batcher("llama", **kw)
    got, _ = _run(b, prompts, 9)
    assert all(len(v) == 9 for v in got.values())
    _assert_streams_agree("llama", prompts, got, want)
    if "speculative" in kw:
        assert b.spec_verifies > 0 and b.spec_acceptance == jb.spec_acceptance
    else:
        assert b.state.k_pool.dtype == torch.float8_e4m3fn


def test_model_without_paged_quantum_raises():
    """A model with neither decode quantum (decode_paged_steps for the
    frozen one, forward_paged for the stepwise one) is refused at start."""
    _, _, cfg, params = _models("llama")
    model = dataclasses.make_dataclass("M", [("forward", object)])(forward=None)
    with pytest.raises(ValueError, match="forward_paged"):
        ContinuousBatcher(model, cfg, params, eos_ids=set(),
                          config=SchedulerConfig(**SC))


def test_sampled_requests_are_seeded():
    """Rows with sampling knobs draw from the batcher's seeded generator:
    the same seed gives the same streams; greedy rows beside them keep
    their greedy tokens."""
    prompts = _prompts(3, (6, 9))
    runs = []
    for _ in range(2):
        b = _port_batcher("llama", batch_capacity=2, n_blocks=32, max_blocks_per_seq=4,
                          seed=5)
        b.add_request(Request(request_id=0, prompt_ids=prompts[0], max_new_tokens=6,
                              sampler=SamplerConfig(temperature=1.0, top_k=20)))
        b.add_request(Request(request_id=1, prompt_ids=prompts[1], max_new_tokens=6))
        runs.append(_run(b, [], 6)[0])
    assert runs[0] == runs[1]
    greedy = _run(_port_batcher("llama", batch_capacity=2, n_blocks=32,
                                max_blocks_per_seq=4), prompts[1:], 6, ids=[1])[0]
    assert runs[0][1] == greedy[1]
