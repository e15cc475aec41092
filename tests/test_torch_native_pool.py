"""The port's KV-pool index in its C++ core (engine/native_pool.py over
tinygpt_tpu_torch/csrc/kvpool.cpp) against its Python index and the JAX
package's two: the same blocks, free counts and idle-cached counts at
every step of a randomized alloc / share / register / release workload on
a small pool (so that allocation reclaims idle-cached blocks); the index
`create_pool_index` picks; and the continuous batcher's greedy streams
and block tables on either index, with prefix-cache hits. The native
cases need a C++ compiler and skip without one."""

import numpy as np
import pytest
import torch

from tinygpt_tpu.engine import native_pool as j_pool
from tinygpt_tpu_torch.engine import native_pool
from tinygpt_tpu_torch.engine.scheduler import (
    ContinuousBatcher,
    Request,
    SchedulerConfig,
)
from tinygpt_tpu_torch.hf.config import parse_model_config
from tinygpt_tpu_torch.models import causal_lm, get_model
from tinygpt_tpu_torch.ops import host_build


@pytest.fixture
def lib():
    if host_build.compiler() is None:
        pytest.skip("no C++ compiler")
    lib = native_pool._load()
    assert lib is not None, "the kvpool core did not build"
    return lib


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's kvpool core, built (when this process has not
    loaded it yet) into this module's own directory: the JAX build writes
    its library in place, where other test processes may be building it
    at the same moment."""
    if j_pool._LIB is None and not j_pool._TRIED:
        so = tmp_path_factory.mktemp("jax_native") / "libtgpool.so"
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_pool, "_so_path", lambda: str(so))
            j_pool._load()
    if j_pool._LIB is None:
        pytest.skip("the JAX package's native pool is unavailable")
    return j_pool._LIB


@pytest.fixture
def no_native(monkeypatch):
    monkeypatch.setenv("TINYGPT_NO_NATIVE", "1")


def _digest(rng) -> int:
    """A 128-bit chain digest, as scheduler._block_hashes makes."""
    return (int(rng.integers(0, 2 ** 63)) << 65) | int(rng.integers(0, 2 ** 63))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_index_matches_python_and_jax(lib, jax_lib, seed):
    """tests/test_paged.py's randomized parity workload (seed 0 is its
    own), through four indexes at once, with 128-bit digests."""
    jlib = jax_lib
    idx = [native_pool.NativePoolIndex(32, lib), native_pool.PythonPoolIndex(32),
           j_pool.NativePoolIndex(32, jlib), j_pool.PythonPoolIndex(32)]
    assert [i.n_free for i in idx] == [31] * 4
    rng = np.random.default_rng(seed)
    live = []
    for step in range(300):
        op = rng.integers(0, 4)
        if op == 0:
            n = int(rng.integers(1, 5))
            got = [i.alloc(n) for i in idx]
            assert all(g == got[1] for g in got), f"step {step}: {got}"
            if got[0] is not None:
                live.append(list(got[0]))
        elif op == 1 and live:
            blocks = live[int(rng.integers(0, len(live)))]
            for blk in blocks[: int(rng.integers(1, len(blocks) + 1))]:
                h = _digest(rng)
                for i in idx:
                    i.register_prefix(h, blk)
                assert len({i.lookup_prefix(h) for i in idx}) == 1
        elif op == 2 and live:
            blocks = live[int(rng.integers(0, len(live)))]
            for i in idx:
                i.share(blocks)
            live.append(list(blocks))
        elif op == 3 and live:
            blocks = live.pop(int(rng.integers(0, len(live))))
            keeps = [[b for b in blocks if i.is_registered(b)] for i in idx]
            assert all(k == keeps[1] for k in keeps), f"step {step}"
            for i in idx:
                i.release(blocks, keep_cached=keeps[1])
        assert len({i.n_free for i in idx}) == 1, f"step {step}"
        assert len({i.n_idle_cached for i in idx}) == 1, f"step {step}"
    while live:
        blocks = live.pop()
        keep = [b for b in blocks if idx[1].is_registered(b)]
        for i in idx:
            i.release(blocks, keep_cached=keep)
    assert [i.n_free for i in idx] == [31] * 4


def test_native_index_splits_the_digest(lib):
    """Digests that differ only in their high or low 64 bits are
    different keys; an unknown digest finds nothing."""
    i = native_pool.NativePoolIndex(8, lib)
    a, b = i.alloc(2)
    lo, hi = 12345, 1 << 100
    i.register_prefix(hi | lo, a)
    i.register_prefix(lo, b)
    assert i.lookup_prefix(hi | lo) == a and i.lookup_prefix(lo) == b
    assert i.lookup_prefix(hi) is None
    assert i.is_registered(a) and i.is_registered(b)


def test_create_pool_index_is_native(lib):
    idx = native_pool.create_pool_index(12)
    assert isinstance(idx, native_pool.NativePoolIndex) and idx.kind == "native"
    assert idx.n_free == 11 and idx.n_idle_cached == 0


def test_no_native_selects_the_python_index(no_native):
    idx = native_pool.create_pool_index(12)
    assert isinstance(idx, native_pool.PythonPoolIndex) and idx.kind == "python"


def test_no_compiler_falls_back_to_python(monkeypatch, tmp_path):
    """Without a compiler (and no library built) the loader gives None
    with a warning and create_pool_index the Python index."""
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(host_build, "_libs", {})
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native_pool, "_LIB", None)
    monkeypatch.setattr(native_pool, "_TRIED", False)
    idx = native_pool.create_pool_index(12)
    assert idx.kind == "python" and idx.n_free == 11


_CFG = dict(model_type="llama", vocab_size=101, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rms_norm_eps=1e-5, tie_word_embeddings=True)


def _serve(monkeypatch, native: bool):
    """Greedy streams, block tables after every step, and prefix hits of a
    2-row batcher on a 24-block pool: five requests over two shared system
    prompts, arriving one a step, the later ones after the first finished
    (their prefixes idle-cached), the pool small enough to reclaim."""
    if native:
        monkeypatch.delenv("TINYGPT_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("TINYGPT_NO_NATIVE", "1")
    cfg = parse_model_config(_CFG)
    params = causal_lm.init_params(cfg, seed=3, dtype=torch.float32, device="cpu")
    b = ContinuousBatcher(get_model("llama"), cfg, params, eos_ids=set(),
                          config=SchedulerConfig(batch_capacity=2, n_blocks=24,
                                                 max_blocks_per_seq=6, block_size=16,
                                                 prefill_bucket=16, dtype="float32",
                                                 decode_quantum=4))
    assert b.allocator.kind == ("native" if native else "python")
    hits = []
    lookup = b.allocator.lookup_prefix

    def counted(h):
        got = lookup(h)
        hits.append(got is not None)
        return got

    b.allocator.lookup_prefix = counted
    rng = np.random.default_rng(5)
    sys_a, sys_b = ([int(x) for x in rng.integers(3, 101, n)] for n in (40, 33))
    prompts = [sys_a + [int(x) for x in rng.integers(3, 101, n)] for n in (3, 20)]
    prompts += [sys_b + [7], sys_a + [9, 9], sys_b + [int(x) for x in rng.integers(3, 101, 30)]]
    got, tables, pending = {}, [], list(enumerate(prompts))
    while b.has_work or pending:
        if pending:
            i, p = pending.pop(0)
            b.add_request(Request(request_id=i, prompt_ids=p, max_new_tokens=6 + i))
        for ev in b.step():
            if ev.token_id is not None:
                got.setdefault(ev.request_id, []).append(ev.token_id)
        tables.append(b.state.block_tables.tolist())
    return got, tables, sum(hits), (b.allocator.n_free, b.allocator.n_idle_cached)


def test_batcher_on_either_index(lib, monkeypatch):
    got_n, tables_n, hits_n, counts_n = _serve(monkeypatch, native=True)
    got_p, tables_p, hits_p, counts_p = _serve(monkeypatch, native=False)
    assert hits_n > 0 and hits_n == hits_p
    assert got_n == got_p and [len(got_n[i]) for i in range(5)] == [6, 7, 8, 9, 10]
    assert tables_n == tables_p
    assert counts_n == counts_p and counts_n[0] == 23


def test_host_build_names_and_concurrent_builds(monkeypatch, tmp_path):
    """Library names carry a hash of the sources and flags; four threads
    building one library into an empty directory at once all succeed and
    leave one library and no temporary file."""
    if host_build.compiler() is None:
        pytest.skip("no C++ compiler")
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path)
    p = host_build.library_path("kvpool.cpp")
    assert p.parent == tmp_path and p.name.startswith("libkvpool-") and p.suffix == ".so"
    assert host_build.library_path("tokenizer.cpp") != p
    monkeypatch.setattr(host_build, "CXX_FLAGS", host_build.CXX_FLAGS + ("-g",))
    assert host_build.library_path("kvpool.cpp") != p
    monkeypatch.setattr(host_build, "CXX_FLAGS", host_build.CXX_FLAGS[:-1])
    import threading

    errors = []

    def build():
        try:
            host_build.build("kvpool.cpp")
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert sorted(f.name for f in tmp_path.iterdir()) == [p.name]
    assert host_build.build("kvpool.cpp") == 0.0
