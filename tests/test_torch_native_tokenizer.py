"""The port's native tokenizer core (tokenizer/native.py over
tinygpt_tpu_torch/csrc/tokenizer.cpp) against the JAX package's native
core, both packages' pure-Python pipelines and HF `tokenizers`: the
byte-level BPE fixtures of tests/test_native_tokenizer.py (trained with
HF on the GPT-2, Llama-3 and Qwen2 split patterns, one with
`ignore_merges`) over its CASES, the port's Metaspace fixture at a vocab
with merges, batched and threaded encodes, two instances used in turn, a
long whitespace run, and TINYGPT_NO_NATIVE. Ids must be equal, exactly.
The native cases need a C++ compiler and skip without one."""

import logging
import random

import pytest

from tests.test_native_tokenizer import CASES, LLAMA3_PAT, QWEN2_PAT, _trained_dir
from tinygpt_tpu.tokenizer import Tokenizer as JTokenizer
from tinygpt_tpu_torch.ops import host_build
from tinygpt_tpu_torch.tokenizer import Tokenizer
from tinygpt_tpu_torch.tokenizer import native
from tinygpt_tpu_torch.utils.fixtures import write_metaspace_tokenizer

hf_tokenizers = pytest.importorskip("tokenizers")

logging.disable(logging.INFO)

FAMILIES = {"gpt2": (None, False), "llama3": (LLAMA3_PAT, True),
            "qwen2": (QWEN2_PAT, False)}
KINDS = {"gpt2": native.KIND_GPT2, "llama3": native.KIND_LLAMA3,
         "qwen2": native.KIND_QWEN2}


@pytest.fixture(autouse=True)
def _compiler():
    if host_build.compiler() is None:
        pytest.skip("no C++ compiler")


@pytest.fixture(scope="module", autouse=True)
def _jax_library_apart(tmp_path_factory):
    """The JAX package's tokenizer core, when this process has not loaded
    it yet, is built into this module's own directory: the JAX build
    writes its library in place, where other test processes may be
    building it at the same moment."""
    from tinygpt_tpu.tokenizer import native as j_native

    if j_native._LIB is None and not j_native._LIB_TRIED:
        so = tmp_path_factory.mktemp("jax_native") / "libtgtok.so"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_native, "_so_path", lambda: str(so))
            j_native._load_library()


def _python_only(tok):
    tok._native_tried, tok._native = True, None
    return tok


def _all_four(d):
    """(port native, port Python, JAX native, JAX Python) tokenizers."""
    port, jax_ = Tokenizer.from_dir(d), JTokenizer.from_dir(d)
    assert port.native_encoder is not None, "the port's fast path is not active"
    if jax_.native_encoder is None:
        pytest.skip("the JAX package's native tokenizer is unavailable")
    return port, _python_only(Tokenizer.from_dir(d)), jax_, \
        _python_only(JTokenizer.from_dir(d))


def _check(toks, want, texts, add_special_tokens=False):
    for t, w in zip(texts, want):
        for tok in toks:
            assert tok.encode(t, add_special_tokens=add_special_tokens) == w, \
                (type(tok).__module__, repr(t))
    for tok in toks[:1] + toks[2:3]:
        got = tok.encode_batch(texts, add_special_tokens=add_special_tokens,
                               num_threads=4)
        assert got == want


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_byte_level_bpe_matches_jax_and_hf(tmp_path, fam):
    d, hf = _trained_dir(tmp_path, *FAMILIES[fam])
    toks = _all_four(d)
    assert toks[0].native_encoder.kind == KINDS[fam]
    _check(toks, [hf.encode(t).ids for t in CASES], CASES)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_byte_level_bpe_random_text(tmp_path, fam):
    """Random mixes of letters, digits, scripts, punctuation, contractions
    and whitespace runs."""
    d, hf = _trained_dir(tmp_path, *FAMILIES[fam])
    toks = _all_four(d)
    rng = random.Random(11)
    atoms = ["a", "Zq", "é", "北", "🙂", "7", "123", "'s", "'LL", " ", "  ", "\n",
             "\r\n", "\t", "!", "?.", "—", "x" * 9]
    texts = ["".join(rng.choice(atoms) for _ in range(rng.randint(0, 40)))
             for _ in range(60)]
    _check(toks, [hf.encode(t).ids for t in texts], texts)


def test_metaspace_with_merges_matches_jax_and_hf(tmp_path):
    """The port's Metaspace fixture (byte fallback, fuse_unk, prepend
    scheme "first") at a vocab of 2,048, which leaves room for merges."""
    write_metaspace_tokenizer(str(tmp_path), 2048)
    toks = _all_four(str(tmp_path))
    assert toks[0].native_encoder.kind == native.KIND_METASPACE
    hf = hf_tokenizers.Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    texts = CASES + ["hello world, the quick brown fox", "ab<s>cd</s> ef",
                     " leading space", "<s>", "zzz yyy xxx ww"]
    want = [hf.encode(t, add_special_tokens=False).ids for t in texts]
    assert sum(len(w) for w in want) < sum(len(t.encode()) for t in texts), \
        "no merge applied"
    _check(toks, want, texts)
    # with the bos token of tokenizer_config.json
    hi = hf.encode("hi there", add_special_tokens=False).ids
    for tok in toks:
        assert tok.encode("hi there") == [1] + hi


def test_encode_batch_threads_match_sequential(tmp_path):
    d, hf = _trained_dir(tmp_path, LLAMA3_PAT, True)
    tok = Tokenizer.from_dir(d)
    texts = [CASES[i % len(CASES)] * (1 + i % 5) for i in range(200)]
    want = [hf.encode(t).ids for t in texts]
    for threads in (1, 3, 8, 0):
        assert tok.encode_batch(texts, add_special_tokens=False,
                                num_threads=threads) == want


def test_interleaved_instances(tmp_path):
    """Two vocabularies used in turn from one thread do not share the
    core's per-thread piece cache."""
    d1, hf1 = _trained_dir(tmp_path / "a")
    d2, hf2 = _trained_dir(tmp_path / "b", LLAMA3_PAT, True)
    t1, t2 = Tokenizer.from_dir(d1), Tokenizer.from_dir(d2)
    for t in CASES[:8]:
        assert t1.encode(t, add_special_tokens=False) == hf1.encode(t).ids
        assert t2.encode(t, add_special_tokens=False) == hf2.encode(t).ids
        assert t1.encode(t, add_special_tokens=False) == hf1.encode(t).ids


def test_long_whitespace_run(tmp_path):
    """A huge single piece takes the core's heap BPE path."""
    d, hf = _trained_dir(tmp_path)
    text = " " * 20000 + "\n" * 5000
    tok = Tokenizer.from_dir(d)
    assert tok.native_encoder is not None
    assert tok.encode(text, add_special_tokens=False) == hf.encode(text).ids


def test_no_native_keeps_the_python_pipeline(tmp_path, monkeypatch):
    d, hf = _trained_dir(tmp_path)
    monkeypatch.setenv("TINYGPT_NO_NATIVE", "1")
    tok = Tokenizer.from_dir(d)
    assert tok.native_encoder is None
    assert tok.encode(CASES[0], add_special_tokens=False) == hf.encode(CASES[0]).ids


def test_outside_the_fast_path_stays_python(tmp_path):
    """A pre-tokenizer pattern the core does not know keeps the Python
    pipeline, with the same ids as HF."""
    pat = r"\s+|\w+|[^\w\s]+"
    d, hf = _trained_dir(tmp_path, pat)
    tok = Tokenizer.from_dir(d)
    assert tok.native_encoder is None
    assert tok.encode(CASES[0], add_special_tokens=False) == hf.encode(CASES[0]).ids


def test_python_threads_share_one_encoder(tmp_path):
    """More Python threads than cores encode through one native encoder at
    once (each call fans out over the core's own threads too): every id
    list equals HF's."""
    import os
    import sys
    import threading

    d, hf = _trained_dir(tmp_path, QWEN2_PAT)
    tok = Tokenizer.from_dir(d)
    assert tok.native_encoder is not None
    texts = [CASES[i % len(CASES)] * (1 + i % 3) for i in range(40)]
    want = [hf.encode(t).ids for t in texts]
    n = 2 * (os.cpu_count() or 2)
    bad = []

    def work(k):
        for rep in range(5):
            if k % 2:
                got = tok.encode_batch(texts, add_special_tokens=False, num_threads=2)
            else:
                got = [tok.encode(t, add_special_tokens=False) for t in texts]
            if got != want:
                bad.append((k, rep))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not bad
