"""The port's paged KV bookkeeping against the JAX package's: the block
allocator, the pool index (the same op sequence gives the same block ids,
free counts and prefix lookups), the prefix chain hashes, and the layout
of the paged state."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.engine import native_pool as j_pool
from tinygpt_tpu.engine.paged_kv import BlockAllocator as JBlockAllocator
from tinygpt_tpu.engine.paged_kv import blocks_needed as j_blocks_needed
from tinygpt_tpu.engine.paged_kv import create_paged_state as j_create_paged_state
from tinygpt_tpu.engine.scheduler import ContinuousBatcher as JBatcher
from tinygpt_tpu.hf.config import parse_model_config as j_parse
from tinygpt_tpu_torch.engine import native_pool
from tinygpt_tpu_torch.engine.paged_kv import (
    BlockAllocator,
    blocks_needed,
    create_paged_state,
)
from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher
from tinygpt_tpu_torch.hf.config import parse_model_config

CFG = dict(model_type="mistral", vocab_size=101, hidden_size=64,
           intermediate_size=128, num_hidden_layers=3, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=64)


def test_block_allocator():
    a = BlockAllocator(8)  # block 0 reserved
    assert a.n_free == 7
    got = a.alloc(3)
    assert len(got) == 3 and 0 not in got
    assert got == JBlockAllocator(8).alloc(3)
    assert a.alloc(5) is None  # only 4 left
    a.release(got)
    assert a.n_free == 7


@pytest.mark.parametrize("n,bs", [(0, 16), (1, 16), (16, 16), (17, 16), (130, 64)])
def test_blocks_needed(n, bs):
    assert blocks_needed(n, bs) == j_blocks_needed(n, bs)


def test_create_pool_index_is_python(monkeypatch):
    """With TINYGPT_NO_NATIVE set, the index is the Python one (the native
    index, taken otherwise, is held against it in
    tests/test_torch_native_pool.py)."""
    monkeypatch.setenv("TINYGPT_NO_NATIVE", "1")
    idx = native_pool.create_pool_index(12)
    assert isinstance(idx, native_pool.PythonPoolIndex) and idx.kind == "python"
    assert idx.n_free == 11 and idx.n_idle_cached == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_index_matches_jax(seed):
    """A randomized alloc / register / share / release workload on a small
    pool (so that allocation reclaims idle-cached blocks): identical
    block ids, counts and prefix lookups at every step, and full recovery."""
    port, ref = native_pool.PythonPoolIndex(16), j_pool.PythonPoolIndex(16)
    rng = np.random.default_rng(seed)
    live = []
    for step in range(400):
        op = rng.integers(0, 5)
        if op == 0:
            n = int(rng.integers(1, 6))
            a, b = port.alloc(n), ref.alloc(n)
            assert a == b, f"step {step}: alloc {a} != {b}"
            if a is not None:
                live.append(list(a))
        elif op == 1 and live:
            blocks = live[int(rng.integers(0, len(live)))]
            for blk in blocks[: int(rng.integers(1, len(blocks) + 1))]:
                h = int(rng.integers(0, 2 ** 63))
                port.register_prefix(h, blk)
                ref.register_prefix(h, blk)
                assert port.lookup_prefix(h) == ref.lookup_prefix(h)
        elif op == 2 and live:
            blocks = live[int(rng.integers(0, len(live)))]
            port.share(blocks)
            ref.share(blocks)
            live.append(list(blocks))
        elif op in (3, 4) and live:
            blocks = live.pop(int(rng.integers(0, len(live))))
            keep = [b for b in blocks if ref.is_registered(b)]
            assert keep == [b for b in blocks if port.is_registered(b)]
            port.release(blocks, keep_cached=keep)
            ref.release(blocks, keep_cached=keep)
        assert port.n_free == ref.n_free, f"step {step}"
        assert port.n_idle_cached == ref.n_idle_cached, f"step {step}"
    while live:
        blocks = live.pop()
        keep = [b for b in blocks if ref.is_registered(b)]
        port.release(blocks, keep_cached=keep)
        ref.release(blocks, keep_cached=keep)
    assert port.n_free == ref.n_free == 15


@pytest.mark.parametrize("n_tok,bs", [(5, 16), (16, 16), (70, 16), (300, 64)])
def test_block_hashes_match_jax(n_tok, bs):
    ids = [int(x) for x in np.random.default_rng(n_tok).integers(0, 50000, n_tok)]
    me = SimpleNamespace(sc=SimpleNamespace(block_size=bs))
    got = ContinuousBatcher._block_hashes(me, ids)
    assert got == JBatcher._block_hashes(me, ids)
    assert len(got) == n_tok // bs


def test_paged_state_layout_matches_jax():
    st = create_paged_state(parse_model_config(CFG), 9, 16, 4, 5,
                            dtype=torch.float32, device="cpu")
    js = j_create_paged_state(j_parse(CFG), 9, 16, 4, 5, dtype=jnp.float32)
    for name in ("k_pool", "v_pool", "block_tables", "lengths", "starts", "active"):
        a, b = getattr(st, name), np.asarray(getattr(js, name))
        assert tuple(a.shape) == b.shape, name
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), name
        assert not a.any(), name
    assert st.block_size == js.block_size == 16
    assert st.max_blocks == js.max_blocks == 5
