"""The port's multi-device layouts against the JAX package, on the CPU.

Each module-scoped world (2, 4 and 8 ranks) is a set of spawned gloo ranks (tests/torch_worlds.py),
one process a rank as the port runs on cards, started once and given one
job a test. The ranks hold their shards and run the port's code on them
(the kernels' plain versions: CPU tensors); this process holds the JAX
package and compares, on the same numpy params:

  * fp32 logits of one forward on a (dp, sp, tp) mesh against the JAX
    forward on the same mesh of its 8 virtual CPU devices (GSPMD), within
    LOGIT_TOL: tp, sp x tp, tp = 4 over 2 KV heads (each rank keeps the KV
    head its queries read), and Mixtral's experts over sp;
  * greedy tokens of the engine at (2, 1, 2), (1, 2, 2), (1, 1, 4) and
    quantized (int8, int4) at (1, 1, 4), and of the pipeline stages, against
    the JAX single-device engine and forward, which tests/test_engine.py and
    tests/test_pipeline.py hold equal to their sharded programs;
  * the continuous batcher's streams at tp, sp x tp, dp x tp and
    dp x sp x tp (and Mixtral at sp x tp) against the JAX single-device
    batcher's: equal, or equal up to a first difference that is a near-tie
    of the JAX dense logits (top-2 gap below NEAR_TIE), the rule of
    tests/test_paged.py; dp speculation (greedy: the dense argmax chain;
    sampled: within the top-k support), the dp prefix cache (on == off);
  * the two-process engine and serving of tests/test_distributed.py,
    and the HTTP server with rank 0 serving and rank 1 following.

Every rank of a world must return the same tokens (lockstep sampling).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_worlds import World
from tinygpt_tpu.engine.engine import GPTConfig as JGPTConfig
from tinygpt_tpu.engine.engine import GPTEngine as JGPTEngine
from tinygpt_tpu.engine.kv_cache import create_kv_cache as j_create_kv_cache
from tinygpt_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from tinygpt_tpu.engine.scheduler import Request as JRequest
from tinygpt_tpu.engine.scheduler import SchedulerConfig as JSchedulerConfig
from tinygpt_tpu.hf.config import parse_model_config as j_parse
from tinygpt_tpu.models import causal_lm as jlm
from tinygpt_tpu.models import get_model as j_get_model
from tinygpt_tpu.parallel.sharding import make_mesh as j_make_mesh
from tinygpt_tpu.parallel.sharding import param_pspecs as j_param_pspecs
from tinygpt_tpu.parallel.sharding import shard_params as j_shard_params
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
NEAR_TIE = 1e-3
_BASE = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=256, rms_norm_eps=1e-5)
CONFIGS = {
    "llama": dict(_BASE, model_type="llama"),
    "mixtral": dict(_BASE, model_type="mixtral", num_local_experts=4,
                    num_experts_per_tok=2),
    "qwen2": dict(_BASE, model_type="qwen2", qkv_bias=True),
    "qwen3": dict(_BASE, model_type="qwen3", qk_norm=True, head_dim=16),
    "pp": dict(_BASE, model_type="llama", vocab_size=503, num_hidden_layers=4,
               intermediate_size=128, max_position_embeddings=128,
               tie_word_embeddings=True),
}
PROMPTS = ["Hello world", "the quick brown fox jumps over the lazy dog"]
ENGINE_KW = dict(max_tokens=6, prefill_bucket=16, decode_chunk=3)
SC = dict(block_size=16, n_blocks=64, max_blocks_per_seq=8, prefill_bucket=16,
          dtype="float32")


@pytest.fixture(scope="module")
def world4():
    w = World(4)
    yield w
    w.close()


@pytest.fixture(scope="module")
def world2():
    w = World(2)
    yield w
    w.close()


@pytest.fixture(scope="module")
def world8():
    w = World(8)
    yield w
    w.close()


@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_llama")
    return write_random_model_dir(str(d), dict(CONFIGS["llama"]), seed=11,
                                  dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _models(fam: str):
    """(JAX cfg, JAX params, the params as numpy) of family `fam`."""
    jcfg = j_parse(CONFIGS[fam])
    jparams = jlm.init_params(jcfg, seed=3, dtype=jnp.float32)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


@functools.lru_cache(maxsize=None)
def _jax_engine_tokens(model_dir: str, quant=None):
    kw = {} if quant is None else dict(quantization=quant, quant_group_size=16, awq=False)
    eng = JGPTEngine(JGPTConfig(model_dir=model_dir, dtype="float32", **ENGINE_KW, **kw))
    eng.prepare()
    return [o.token_ids for o in eng.generate_sync(PROMPTS)]


def _same_on_every_rank(results):
    for r in results[1:]:
        assert r == results[0], "ranks parted ways"
    return results[0]


def _prompts(seed, lens, vocab=512):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(3, vocab, n)] for n in lens]


DENSE_LEN = 64  # contexts are left-padded to one length: one shape for JAX


def _dense_logits(fam, context):
    """JAX teacher-forced dense logits for the token after `context`."""
    jcfg, jparams, _ = _models(fam)
    n = len(context)
    assert n <= DENSE_LEN
    ids = np.zeros((1, DENSE_LEN), np.int32)
    ids[0, DENSE_LEN - n:] = context
    pos = np.zeros((1, DENSE_LEN), np.int32)
    pos[0, DENSE_LEN - n:] = np.arange(n)
    valid = (np.arange(DENSE_LEN) >= DENSE_LEN - n)[None]
    cache = j_create_kv_cache(jcfg, 1, DENSE_LEN, dtype=jnp.float32)
    lg, _ = _j_forward(jparams, jcfg, jnp.asarray(ids), cache, jnp.asarray(pos),
                       jnp.asarray(valid), last_only=True)
    return np.asarray(lg[0, -1])


_j_forward = jax.jit(jlm.forward, static_argnames=("cfg", "last_only"))


@functools.lru_cache(maxsize=None)
def _jax_streams(fam, prompts, max_new, kw):
    jcfg, jparams, _ = _models(fam)
    b = JBatcher(j_get_model(jcfg.model_type), jcfg, jparams, eos_ids=set(),
                 config=JSchedulerConfig(**SC, **dict(kw)))
    for i, p in enumerate(prompts):
        b.add_request(JRequest(request_id=i, prompt_ids=list(p), max_new_tokens=max_new))
    got = {i: [] for i in range(len(prompts))}
    steps = 0
    while b.has_work and steps < 400:
        for ev in b.step():
            if ev.token_id is not None:
                got[ev.request_id].append(ev.token_id)
        steps += 1
    return [got[i] for i in range(len(prompts))]


def _assert_streams_agree(fam, prompts, got, want):
    """Equal streams, or equal up to a first difference where both tokens
    are within NEAR_TIE of the JAX dense argmax."""
    for p, x, y in zip(prompts, got, want):
        assert len(x) == len(y)
        if x == y:
            continue
        i = next(j for j in range(len(x)) if x[j] != y[j])
        lg = _dense_logits(fam, list(p) + x[:i])
        top = float(lg.max())
        assert top - lg[x[i]] < NEAR_TIE and top - lg[y[i]] < NEAR_TIE, (
            f"diverges at {i} without a near-tie: {x[i]} vs {y[i]}")


# -- the forward's logits on the same mesh ------------------------------------------------


@pytest.mark.parametrize("fam,mesh", [("llama", (1, 1, 2)), ("llama", (1, 2, 2)),
                                      ("llama", (1, 1, 4)), ("qwen2", (1, 1, 4)),
                                      ("qwen3", (1, 2, 2)), ("mixtral", (1, 2, 2))])
def test_forward_logits_match_jax_mesh(world4, fam, mesh):
    """One prefill on this mesh against the JAX forward on the same mesh:
    fp32 logits within LOGIT_TOL on every rank (tp = 4 over 2 KV heads keeps
    one KV head a rank; Mixtral's 4 experts split over sp)."""
    jcfg, jparams, np_params = _models(fam)
    rng = np.random.default_rng(5)
    B, S, T = 2, 12, 16
    ids = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    valid = np.ones((B, S), bool)
    valid[1, :3] = False  # a left-padded row
    pos[1] = np.maximum(np.arange(S) - 3, 0)
    jmesh = j_make_mesh(n_devices=int(np.prod(mesh)), dp=mesh[0], sp=mesh[1], tp=mesh[2])
    sharded = j_shard_params(jparams, jmesh, j_param_pspecs(jcfg, jparams))
    with jmesh:
        want, _ = jlm.forward(sharded, jcfg, jnp.asarray(ids),
                              j_create_kv_cache(jcfg, B, T, dtype=jnp.float32),
                              jnp.asarray(pos), jnp.asarray(valid))
    want = np.asarray(want)
    got = world4.run("forward_logits", np_params, CONFIGS[fam], list(mesh), ids, pos,
                     valid, T)
    for r, res in enumerate(got):
        if res is None:  # a rank outside a smaller mesh
            continue
        np.testing.assert_allclose(res, want, **LOGIT_TOL, err_msg=f"rank {r}")


# -- the engine ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", [(2, 1, 2), (1, 2, 2), (1, 1, 4)])
def test_engine_sharded_matches_jax(world4, llama_dir, mesh):
    got = _same_on_every_rank(world4.run("engine_tokens", llama_dir, list(mesh), PROMPTS,
                                         ENGINE_KW))
    assert got == _jax_engine_tokens(llama_dir)
    assert all(len(t) == ENGINE_KW["max_tokens"] for t in got)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_engine_sharded_quantized_matches_jax(world4, llama_dir, quant):
    """Mesh + weight-only quantization (the JAX test_engine_sharded_quantized):
    the quantized head is cut over the vocab; at this width the int4 o and
    down keep their rows whole (a shard below 256 rows), the int8 ones cut."""
    kw = dict(ENGINE_KW, quantization=quant, quant_group_size=16, awq=False)
    got = _same_on_every_rank(world4.run("engine_tokens", llama_dir, [1, 1, 4], PROMPTS, kw))
    assert got == _jax_engine_tokens(llama_dir, quant)


def _on_grid(w, axis: int = -2, group: int = 64) -> np.ndarray:
    """w with each group along `axis` on the int4 grid of scale 2^-7."""
    w = np.moveaxis(np.asarray(w, np.float32), axis, -1)
    q = np.clip(np.round(w * 128), -7, 7)
    live = np.abs(w).reshape(*w.shape[:-1], -1, group).max(-1) > 0
    q[..., ::group] = np.where(live, 7, 0)
    return np.moveaxis(q / 128, -1, axis).astype(np.float32)


def test_int4_fused_decode_cut_matches_jax(world2):
    """The fused int4 decode route (K6 for o and K7 on every rank, the
    residual added on tp rank 0 only) with the attention and MLP
    blocks cut at tp = 2 on a model wide enough for int4 row shards: the
    prefill logits against the JAX forward on the same quantized bytes, the
    greedy tokens of 4 decode steps against the JAX engine's frozen chunk."""
    from tinygpt_tpu.ops.quant import quantize_params as j_quantize

    cfg = dict(_BASE, model_type="llama", hidden_size=512, intermediate_size=1024,
               num_attention_heads=8, num_key_value_heads=2)
    jcfg = j_parse(cfg)
    jparams = jlm.init_params(jcfg, seed=4, dtype=jnp.float32)
    # weights on the int4 grid: the JAX package's bf16 rounding of the
    # dequantized weights is then exact (tests/test_torch_quant_model.py)
    jparams = dict(jparams, embed=jnp.asarray(_on_grid(jparams["embed"], axis=-1)),
                   lm_head=jnp.asarray(_on_grid(jparams["lm_head"])),
                   layers={k: jnp.asarray(_on_grid(v)) if k.endswith("_w") else v
                           for k, v in jparams["layers"].items()})
    np_params = jax.tree.map(np.asarray, jparams)
    jq = j_quantize(jparams, bits=4, group_size=64)
    ids = np.random.default_rng(2).integers(0, 512, (2, 8)).astype(np.int32)
    B, S, steps = 2, 8, 4
    want, cache = jlm.forward(jq, jcfg, jnp.asarray(ids),
                              j_create_kv_cache(jcfg, B, S + steps + 1, dtype=jnp.float32),
                              jnp.broadcast_to(jnp.arange(S), (B, S)),
                              jnp.ones((B, S), jnp.bool_), last_only=True)
    tok = jnp.argmax(want[:, -1], -1).astype(jnp.int32)
    toks, _ = jlm.decode_steps(jq, jcfg, tok, cache, jnp.full((B, 1), S, jnp.int32),
                               jax.random.split(jax.random.PRNGKey(0), steps),
                               lambda lg, k: jnp.argmax(lg, -1).astype(jnp.int32))
    res = world2.run("decode_logits", np_params, cfg, [1, 1, 2], (4, 64), ids, steps)
    for logits, got_toks in res:
        np.testing.assert_allclose(logits[0], np.asarray(want[:, -1]), **LOGIT_TOL)
        assert got_toks[0].tolist() == np.asarray(tok).tolist()
        assert got_toks[1:].tolist() == np.asarray(toks).tolist()


# -- pipeline stages ----------------------------------------------------------------------


def _pp_inputs(jcfg, B, S, padded=False):
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (B, S), 2, jcfg.vocab_size),
                     np.int32)
    positions = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    valid = np.ones((B, S), bool)
    if padded:
        for b, n in enumerate((8, 5, 3, 7)[:B]):
            valid[b, : S - n] = False
            positions[b, : S - n] = 0
            positions[b, S - n:] = np.arange(n)
    return ids, positions, valid


@pytest.mark.parametrize("dp,pp,tp,n_micro,fam,padded",
                         [(1, 2, 2, 4, "pp", False), (1, 4, 1, 2, "pp", False),
                          (2, 2, 1, 2, "pp", False), (1, 2, 1, 8, "pp", False),
                          (1, 2, 2, 2, "qwen2", False), (1, 2, 2, 2, "qwen3", False),
                          (1, 2, 1, 4, "pp", True)])
def test_pipeline_matches_jax(world4, dp, pp, tp, n_micro, fam, padded):
    """test_pipeline_matches_dense's cases that fit 4 ranks, its family
    deltas and its left-padded batch: the stages' prefill logits and one
    decode step's against the JAX dense forward."""
    jcfg, jparams, np_params = _models(fam)
    B, S, T = (4, 8, 32) if padded or fam != "pp" else (8, 16, 64)
    ids, positions, valid = _pp_inputs(jcfg, B, S, padded)
    ref, cache = jlm.forward(jparams, jcfg, jnp.asarray(ids),
                             j_create_kv_cache(jcfg, B, T, dtype=jnp.float32),
                             jnp.asarray(positions), jnp.asarray(valid), last_only=True)
    tok = jnp.argmax(ref[:, -1], -1).astype(jnp.int32)[:, None]
    ref2, _ = jlm.forward(jparams, jcfg, tok, cache, jnp.full((B, 1), S, jnp.int32),
                          jnp.ones((B, 1), jnp.bool_), last_only=True)
    res = world4.run("pipeline_logits", np_params, CONFIGS[fam], [dp, pp, tp], n_micro,
                     ids, positions, valid, T)
    for r in res:
        if r is None:
            continue
        out, out2, d = r
        rows = slice(d * B // dp, (d + 1) * B // dp)
        np.testing.assert_allclose(out, np.asarray(ref[rows, -1]), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(out2, np.asarray(ref2[rows, -1]), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("mesh,kw,match", [
    ((1, 1, 2, 2), dict(quantization="int8"), "quantization"),
    ((1, 1, 2, 2), dict(speculative="ngram"), "speculative"),
    ((1, 2, 2, 1), {}, "sp"),
])
def test_pipeline_rejects_unsupported(world4, llama_dir, mesh, kw, match):
    msgs = world4.run("engine_refuses", llama_dir, list(mesh), kw)
    assert all(match in m for m in msgs), msgs


def test_engine_pipeline_matches_jax(world4, llama_dir):
    """mesh_shape=(dp, sp, pp, tp) through the engine: microbatched stages
    for the prefill and each decode step (attention through K13's plain
    version), the JAX engine's greedy tokens."""
    got = _same_on_every_rank(world4.run("engine_tokens", llama_dir, [1, 1, 2, 2], PROMPTS,
                                         ENGINE_KW))
    assert got == _jax_engine_tokens(llama_dir)


def test_mesh_without_process_group_raises(llama_dir):
    """A mesh of several ranks in a process with no process group raises."""
    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
    from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, SchedulerConfig
    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm, get_model

    with pytest.raises(ValueError, match="ranks"):
        GPTEngine(GPTConfig(model_dir=llama_dir, device="cpu",
                            mesh_shape=(1, 1, 2))).prepare()
    cfg = parse_model_config(CONFIGS["llama"])
    params = causal_lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="ranks"):
        ContinuousBatcher(get_model("llama"), cfg, params, set(),
                          SchedulerConfig(mesh_shape=(1, 1, 2), dtype="float32"))


# -- the continuous batcher ---------------------------------------------------------------


@pytest.mark.parametrize("mesh,chunk", [((1, 1, 4), 0), ((1, 2, 2), 0), ((1, 2, 2), 16),
                                        ((2, 1, 2), 0), ((2, 1, 2), 16)])
def test_batcher_sharded_matches_jax(world4, mesh, chunk):
    """tp, sp x tp (the admission's sequence cut over sp, whole and in
    chunks) and dp x tp (rows, pools and allocators partitioned; more
    requests than rows, so rows recycle across shards)."""
    prompts = tuple(tuple(p) for p in _prompts(37, (4, 9, 35, 6, 21, 3)))
    kw = (("batch_capacity", 4), ("prefill_chunk_tokens", chunk))
    got, _ = _same_on_every_rank(world4.run("batcher_streams", _models("llama")[2],
                                            CONFIGS["llama"], list(mesh), prompts, 6,
                                            dict(kw)))
    _assert_streams_agree("llama", prompts, got, _jax_streams("llama", prompts, 6, kw))


@pytest.mark.parametrize("chunk", [0, 16])
def test_batcher_dp_sp_tp_matches_jax(world8, chunk):
    """The full three-axis serving mesh, dp2 x sp2 x tp2 (the JAX
    test_scheduler_dp_sp_tp_sharded_matches_single): rows and pools over
    dp, the admission's sequence over sp (whole and in chunks), the
    params over tp."""
    prompts = tuple(tuple(p) for p in _prompts(73, (35, 9, 50, 18)))
    kw = (("batch_capacity", 4), ("prefill_chunk_tokens", chunk))
    got, _ = _same_on_every_rank(world8.run("batcher_streams", _models("llama")[2],
                                            CONFIGS["llama"], [2, 2, 2], prompts, 5,
                                            dict(kw)))
    _assert_streams_agree("llama", prompts, got, _jax_streams("llama", prompts, 5, kw))


def test_batcher_moe_expert_parallel_matches_jax(world4):
    """Mixtral serving with its experts over sp and tp inside each expert."""
    prompts = tuple(tuple(p) for p in _prompts(83, (34, 9, 21)))
    kw = (("batch_capacity", 3),)
    got, _ = _same_on_every_rank(world4.run("batcher_streams", _models("mixtral")[2],
                                            CONFIGS["mixtral"], [1, 2, 2], prompts, 5,
                                            dict(kw)))
    _assert_streams_agree("mixtral", prompts, got, _jax_streams("mixtral", prompts, 5, kw))


def test_batcher_dp_speculation(world4):
    """Speculative quanta under dp x tp: greedy rows emit the dense argmax
    chain (near-ties aside), sampled rows stay in their top-k support
    (random bits differ between the packages: masks, not draws)."""
    rng = np.random.default_rng(101)
    phrase = [int(x) for x in rng.integers(3, 512, 4)]
    prompts = [phrase * 3, phrase * 2 + phrase[:3], phrase * 4, phrase + phrase[:3]]
    samplers = [None, dict(temperature=1.0, top_k=3), None, dict(temperature=1.0, top_k=3)]
    kw = dict(batch_capacity=4, decode_quantum=6, speculative="ngram", spec_draft_len=2,
              spec_ngram=2)
    got, verifies = _same_on_every_rank(world4.run(
        "batcher_streams", _models("llama")[2], CONFIGS["llama"], [2, 1, 2], prompts, 5,
        kw, samplers))
    assert verifies > 0
    for p, toks, s in zip(prompts, got, samplers):
        assert len(toks) == 5
        ctx = list(p)
        for tok in toks:
            lg = _dense_logits("llama", ctx)
            if s is None:
                assert lg.max() - lg[tok] < NEAR_TIE
            else:
                assert tok in set(np.argsort(lg)[::-1][:4].tolist())
            ctx.append(tok)


def test_batcher_dp_prefix_cache_is_shard_local(world2):
    """Prefix caching under dp: shared prefixes reuse blocks within a
    shard; the streams equal those of the run without the cache."""
    system = _prompts(41, (32,))[0]
    prompts = [system + p for p in _prompts(42, (5, 9, 7, 11))]
    runs = [_same_on_every_rank(world2.run(
        "batcher_streams", _models("llama")[2], CONFIGS["llama"], [2, 1, 1], prompts, 5,
        dict(batch_capacity=4, enable_prefix_cache=on)))[0] for on in (True, False)]
    assert runs[0] == runs[1]


# -- two processes, as tests/test_distributed.py --------------------------------------


def test_two_process_engine_and_serving(world2, llama_dir):
    """dp across the two processes: the engine's greedy streams; the
    batcher with speculative quanta and chunked admission, row-parallel."""
    got = _same_on_every_rank(world2.run("engine_tokens", llama_dir, [2, 1, 1], PROMPTS,
                                         ENGINE_KW))
    assert got == _jax_engine_tokens(llama_dir)
    rng = np.random.default_rng(5)
    phrase = [int(x) for x in rng.integers(3, 512, 5)]
    prompts = (tuple(phrase * 4), tuple(phrase * 2), tuple(_prompts(6, (11,))[0]))
    kw = (("batch_capacity", 2), ("decode_quantum", 8), ("speculative", "ngram"),
          ("spec_draft_len", 3), ("spec_ngram", 2), ("prefill_chunk_tokens", 16))
    got, verifies = _same_on_every_rank(world2.run(
        "batcher_streams", _models("llama")[2], CONFIGS["llama"], [2, 1, 1], prompts, 5,
        dict(kw)))
    assert verifies > 0
    _assert_streams_agree("llama", prompts, got, _jax_streams("llama", prompts, 5, kw))


def test_http_server_on_two_ranks(world2, llama_dir):
    """The server with the batcher at tp = 2: rank 0 serves HTTP, rank 1
    follows its plans; the completion's text is the JAX engine's."""
    texts = world2.run("served_text", llama_dir, [1, 1, 2], PROMPTS[0], 6)
    eng = JGPTEngine(JGPTConfig(model_dir=llama_dir, dtype="float32", **ENGINE_KW))
    eng.prepare()
    assert texts[0] == eng.generate_sync(PROMPTS[:1])[0].text
