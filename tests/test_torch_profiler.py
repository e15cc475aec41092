"""The port's utils/profiler.py, hf/safetensors_io.match_state,
ops/rope.apply_rope and the ops package's exports against their JAX
counterparts, on the CPU. match_state: the same missing and unexpected
lists, errors and consumed names. apply_rope on a Llama-3-scaled table:
fp32 within 1e-6 (the same fp32 arithmetic), bf16 within one bf16 ulp of
each output (2^-7 of it; both round one fp32 result). The profiler: a
trace file holding the annotation spans and the block's operators, and
fenced values equal to JAX's."""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.hf.config import RopeScaling as JRopeScaling
from tinygpt_tpu.hf.safetensors_io import SafeTensorsError as JSafeTensorsError
from tinygpt_tpu.hf.safetensors_io import match_state as j_match_state
from tinygpt_tpu.ops import apply_rope as j_apply_rope
from tinygpt_tpu.ops import compute_rope_freqs as j_compute_rope_freqs
from tinygpt_tpu.ops import layer_norm as j_layer_norm
from tinygpt_tpu.utils import profiler as j_profiler
from tinygpt_tpu_torch import ops
from tinygpt_tpu_torch.hf.config import RopeScaling
from tinygpt_tpu_torch.hf.safetensors_io import SafeTensorsError, match_state
from tinygpt_tpu_torch.utils import profiler

# -- match_state ------------------------------------------------------------------

_LOADED = {"a": (2, 2), "b": (3,), "extra": (1,)}
MATCH_CASES = [
    # (expected {name: shape}, strict)
    ({"a": (2, 2), "b": (3,), "c": (4,)}, False),   # missing and unexpected, logged
    ({"a": (2, 2), "b": (3,), "extra": (1,)}, True),  # all there
    ({"a": (9, 9)}, False),                          # shape mismatch
    ({"a": (2, 2), "b": (3,)}, True),                # unexpected, strict
    ({"a": (2, 2), "b": (3,), "extra": (1,), "z": (5,)}, True),  # missing, strict
    ({}, False),
]


def _run_match(fn, err, loaded, expected, strict):
    seen = []
    try:
        out = fn(loaded, {k: (s, None) for k, s in expected.items()}, strict=strict,
                 consume=lambda k, t: seen.append((k, tuple(t.shape))))
    except err as e:
        return "raised", str(e), seen
    return out, None, seen


@pytest.mark.parametrize("expected,strict", MATCH_CASES)
def test_match_state_matches_jax(expected, strict):
    rng = np.random.default_rng(0)
    arrays = {k: rng.standard_normal(s).astype(np.float32) for k, s in _LOADED.items()}
    want = _run_match(j_match_state, JSafeTensorsError, arrays, expected, strict)
    got = _run_match(match_state, SafeTensorsError, {k: torch.from_numpy(a) for k, a in
                                                     arrays.items()}, expected, strict)
    assert got == want


# -- apply_rope and the exports ------------------------------------------------------

SCALING = dict(rope_type="llama3", factor=8.0, high_freq_factor=4.0,
               low_freq_factor=1.0, original_max_position_embeddings=8192)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_jax(dtype):
    rng = np.random.default_rng(3)
    B, S, Nq, Nk, D, P = 2, 7, 8, 2, 128, 4096
    q = rng.standard_normal((B, S, Nq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Nk, D)).astype(np.float32)
    pos = rng.integers(0, P, (B, S)).astype(np.int32)
    jc, js = j_compute_rope_freqs(D, P, 500000.0, JRopeScaling(**SCALING))
    jq, jk = j_apply_rope(jnp.asarray(q, dtype), jnp.asarray(k, dtype), jnp.asarray(jc),
                          jnp.asarray(js), jnp.asarray(pos))
    tc, ts = ops.compute_rope_freqs(D, P, 500000.0, RopeScaling(**SCALING))
    tdt = getattr(torch, dtype)
    tq, tk = ops.apply_rope(torch.from_numpy(q).to(tdt), torch.from_numpy(k).to(tdt), tc,
                            ts, torch.from_numpy(pos))
    assert tq.dtype == tdt and tk.dtype == tdt
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=2 ** -7, atol=0)
    for got, want in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_layer_norm_is_exported_and_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2 + 1
    w, b = (rng.standard_normal(64).astype(np.float32) for _ in range(2))
    want = j_layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    got = ops.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert {"rms_norm", "layer_norm", "apply_rope", "compute_rope_freqs",
            "sdpa_with_cache"} <= set(ops.__all__)


# -- profiler ---------------------------------------------------------------------


def test_trace_writes_the_spans_and_the_operators(tmp_path):
    with profiler.trace(str(tmp_path), annotate="whole") as t:
        with profiler.span("inner"):
            y = torch.randn(16, 16) @ torch.randn(16, 16)
    assert y.shape == (16, 16)
    assert os.path.dirname(t["path"]) == str(tmp_path)
    with open(t["path"]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"whole", "inner"} <= names
    assert any(n and n.startswith("aten::") for n in names)
    with profiler.trace(str(tmp_path)) as t2:
        pass
    assert t2["path"] != t["path"] and os.path.exists(t2["path"])


def test_device_fence_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    i = rng.integers(0, 9, (5,)).astype(np.int32)
    want = j_profiler.device_fence({"a": jnp.asarray(a), "rest": [jnp.asarray(i),
                                                                  (jnp.asarray(a[0]),)]})
    got = profiler.device_fence({"a": torch.from_numpy(a), "rest": [torch.from_numpy(i),
                                                                    (torch.from_numpy(a[0]),)]})
    assert got.keys() == want.keys() and isinstance(got["rest"][1], tuple)
    for g, w in ((got["a"], want["a"]), (got["rest"][0], want["rest"][0]),
                 (got["rest"][1][0], want["rest"][1][0])):
        assert isinstance(g, np.ndarray) and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_device_fence_widens_bf16_exactly():
    x = torch.randn(64).bfloat16()
    got = profiler.device_fence(x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.float().numpy())
    assert profiler.device_fence(None) is None


def test_timed_fenced():
    holder = {}
    with profiler.timed_fenced(holder, key="t") as h:
        h["value"] = torch.arange(6).reshape(2, 3) * 2
    assert holder["t"] >= 0 and isinstance(holder["value"], np.ndarray)
    np.testing.assert_array_equal(holder["value"], np.arange(6).reshape(2, 3) * 2)
    empty = {}
    with profiler.timed_fenced(empty):
        pass
    assert set(empty) == {"seconds"}
