"""The port's GPTEngine and CLI against the JAX package's, end to end on
the CPU: one model dir (a tiny random llama in fp32 with the generated
Metaspace-BPE tokenizer of tinygpt_tpu_torch.utils.fixtures), greedy
decoding, the same token ids and texts expected from both engines."""

import numpy as np
import pytest
import torch

from tinygpt_tpu.engine.engine import GPTConfig as JGPTConfig
from tinygpt_tpu.engine.engine import GPTEngine as JGPTEngine
from tinygpt_tpu.tokenizer import Tokenizer as JTokenizer
from tinygpt_tpu_torch import cli
from tinygpt_tpu_torch.engine.engine import FinishReason, GPTConfig, GPTEngine
from tinygpt_tpu_torch.tokenizer import Tokenizer
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

TINY_LLAMA = dict(model_type="llama", vocab_size=503, hidden_size=64,
                  intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=256, rms_norm_eps=1e-5)
PROMPTS = ["Hello world", "the quick brown fox jumps over the lazy dog", "a"]
ENGINE_KW = dict(dtype="float32", max_tokens=10, prefill_bucket=16, decode_chunk=4)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_engine_llama")
    return write_random_model_dir(str(d), TINY_LLAMA, seed=11, dtype=torch.float32)


@pytest.fixture(scope="module")
def engines(model_dir):
    jeng = JGPTEngine(JGPTConfig(model_dir=model_dir, **ENGINE_KW))
    jeng.prepare()
    teng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", **ENGINE_KW))
    teng.prepare()
    return jeng, teng


def test_tokenizer_matches_jax(model_dir):
    j, t = JTokenizer.from_dir(model_dir), Tokenizer.from_dir(model_dir)
    for text in PROMPTS + ["héllo wörld ☃ 42!", "  two  spaces"]:
        ids = t.encode(text)
        assert ids == j.encode(text)
        assert t.decode(ids, skip_special_tokens=True) == j.decode(
            ids, skip_special_tokens=True)


def test_generate_sync_matches_jax(engines):
    jeng, teng = engines
    want = jeng.generate_sync(PROMPTS)
    got = teng.generate_sync(PROMPTS)
    for g, w in zip(got, want):
        assert g.token_ids == w.token_ids
        assert g.text == w.text
        assert g.finish_reason.value == w.finish_reason.value
    assert all(len(g.token_ids) == ENGINE_KW["max_tokens"] for g in got)


def test_stop_token_matches_jax(engines):
    """A stop id that row 0 generates ends that row early in both."""
    jeng, teng = engines
    first = teng.generate_sync(PROMPTS[:2])
    stop = first[0].token_ids[3]
    for eng in engines:
        eng.reconfigure(extra_stop_token_ids=[stop])
    try:
        want = jeng.generate_sync(PROMPTS[:2])
        got = teng.generate_sync(PROMPTS[:2])
    finally:
        for eng in engines:
            eng.reconfigure(extra_stop_token_ids=[])
    assert got[0].finish_reason is FinishReason.STOP
    assert [g.token_ids for g in got] == [w.token_ids for w in want]


def test_batch_row_matches_single(engines):
    _, teng = engines
    solo = teng.generate_sync([PROMPTS[1]])[0]
    batch = teng.generate_sync(PROMPTS)[1]
    assert solo.token_ids == batch.token_ids


@pytest.mark.parametrize("mesh", [(1, 1, 2), (2, 1, 1, 1)])
def test_mesh_needs_a_process_group(model_dir, mesh):
    """A mesh of several ranks in a process without a process group
    raises: it never runs quietly on one rank."""
    with pytest.raises(ValueError, match="ranks"):
        GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", mesh_shape=mesh)).prepare()


def test_mesh_of_one_rank_matches_jax(model_dir, engines):
    """mesh_shape=(1, 1, 1): the sharded path's one-rank case gives the JAX
    engine's tokens."""
    jeng, _ = engines
    eng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", mesh_shape=(1, 1, 1),
                              **ENGINE_KW))
    eng.prepare()
    want = jeng.generate_sync(PROMPTS)
    assert [g.token_ids for g in eng.generate_sync(PROMPTS)] == [w.token_ids for w in want]


@pytest.mark.parametrize("kw", [dict(quantization="int4", awq=False, kv_cache_dtype="e4m3"),
                                dict(kv_cache_dtype="fp8"),
                                dict(speculative="ngram")])
def test_fp8_cache_and_speculation_match_jax(model_dir, kw):
    """The fp8 KV cache (with int4 weights too) and n-gram speculation run
    through the engine and give the JAX engine's greedy tokens (one prompt
    with speculation: a batch takes the chunked loop)."""
    prompts = PROMPTS[1:2] if kw.get("speculative") else PROMPTS
    jeng = JGPTEngine(JGPTConfig(model_dir=model_dir, **ENGINE_KW, **kw))
    jeng.prepare()
    teng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", **ENGINE_KW, **kw))
    teng.prepare()
    got = teng.generate_sync(prompts)
    assert [g.token_ids for g in got] == [w.token_ids for w in jeng.generate_sync(prompts)]
    assert all(len(g.token_ids) == ENGINE_KW["max_tokens"] for g in got)


def test_generate_async_matches_jax(engines):
    """The JAX engine's streaming test (tests/test_engine.py): the greedy
    stream's tokens and text equal generate_sync's, and JAX's."""
    jeng, teng = engines
    got, want = [], []
    out = teng.generate_async(PROMPTS[0], lambda c, d: (got.append(c), True)[1])
    jout = jeng.generate_async(PROMPTS[0], lambda c, d: (want.append(c), True)[1])
    sync = teng.generate_sync([PROMPTS[0]])[0]
    assert out.token_ids == jout.token_ids == sync.token_ids
    assert "".join(got) == "".join(want) == sync.text == out.text
    assert out.finish_reason.value == jout.finish_reason.value


def test_cli_batch(model_dir, capsys):
    rc = cli.main(["--model", model_dir, "--device", "cpu", "--dtype", "float32",
                   "--max-tokens", "4", "--prompt", "Hello", "--prompt", "world"])
    assert rc == 0
    out = capsys.readouterr().out
    assert ">>> Hello" in out and ">>> world" in out


def test_cli_mesh_needs_a_process_group(model_dir, monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="ranks"):
        cli.main(["--model", model_dir, "--device", "cpu", "--mesh", "1,1,2"])
    with pytest.raises(ValueError, match="DP,SP,TP"):
        cli.main(["--model", model_dir, "--device", "cpu", "--mesh", "2,2"])


def test_engine_sampling_is_seeded(model_dir):
    """Stochastic sampling draws from the engine's seeded generator: the
    same seed gives the same tokens."""
    outs = []
    for _ in range(2):
        eng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", seed=5,
                                  **dict(ENGINE_KW, max_tokens=6)))
        eng.prepare()
        eng.reconfigure(sampler=type(eng.config.sampler)(temperature=1.0, top_k=20))
        outs.append([o.token_ids for o in eng.generate_sync(PROMPTS[:2])])
    assert outs[0] == outs[1]
    assert np.all([len(t) == 6 for t in outs[0]])
