"""The port's paged decode attention against the JAX package's XLA
oracles and its Pallas kernels in interpret mode, on the same seeded
numpy inputs: K8's plain version and wrapper on CPU tensors against
paged_decode_frozen_xla / paged_decode_frozen_tpu, and K9's against
paged_decode_xla / paged_decode_tpu. The cases: ragged lengths, a start
inside a block, dead table entries over a non-zero block 0, an inactive row
with a stale length over a zero table, 1, 2 and 4 query heads per KV head,
windows, the first and last in-flight step, and e4m3 pools (the same bytes
in both packages). All compute in fp32 in another order: tolerance 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops.paged_attention import (
    paged_decode_frozen_tpu,
    paged_decode_frozen_xla,
    paged_decode_tpu,
    paged_decode_xla,
)
from tinygpt_tpu.ops.paged_attention import paged_gather_dense as j_gather
from tinygpt_tpu_torch.ops import attention_kernels as ak
from tinygpt_tpu_torch.ops import paged_attention as pa

TOL = dict(rtol=1e-5, atol=1e-5)
L, N_BLOCKS, NK, BS, D, N = 2, 16, 2, 16, 64, 6
# row 3 is inactive: zero table, stale length past the table (4 * 16)
TABLES = np.array([[1, 2, 3, 0],
                   [4, 5, 0, 0],
                   [6, 0, 0, 0],
                   [0, 0, 0, 0]], np.int32)
LENGTHS0 = np.array([41, 20, 9, 70], np.int32)
STARTS = np.array([0, 3, 1, 0], np.int32)


def _inputs(G, seed=0):
    rng = np.random.default_rng(seed)
    B = TABLES.shape[0]
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa: E731
    kp, vp = f(L, N_BLOCKS, NK, BS, D), f(L, N_BLOCKS, NK, BS, D)
    return dict(q=f(B, NK * G, D), kp=kp, vp=vp, ki=f(B, NK, N, D), vi=f(B, NK, N, D))


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(x, l, step, window):
    return pa.paged_decode_frozen_plain(
        _t(x["q"]), _t(x["kp"]), _t(x["vp"]), _t(TABLES), _t(LENGTHS0), _t(STARTS),
        _t(x["ki"]), _t(x["vi"]), l, step, D ** -0.5, window).numpy()


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [None, 10])
@pytest.mark.parametrize("step", [0, N - 1])
def test_plain_matches_jax_oracle_and_kernel(G, window, step):
    x = _inputs(G)
    for l in range(L):
        got = _port(x, l, step, window)
        common = (jnp.asarray(TABLES), jnp.asarray(LENGTHS0), jnp.asarray(STARTS),
                  jnp.asarray(x["ki"]), jnp.asarray(x["vi"]))
        oracle = paged_decode_frozen_xla(
            jnp.asarray(x["q"]), jnp.asarray(x["kp"][l]), jnp.asarray(x["vp"][l]),
            *common, jnp.asarray(step, jnp.int32), scale=D ** -0.5,
            sliding_window=window)
        kernel = paged_decode_frozen_tpu(
            jnp.asarray(x["q"]), jnp.asarray(x["kp"]), jnp.asarray(x["vp"]), *common,
            jnp.asarray(l, jnp.int32), jnp.asarray(step, jnp.int32), scale=D ** -0.5,
            sliding_window=window, interpret=True)
        np.testing.assert_allclose(got, np.asarray(oracle), **TOL, err_msg=f"layer {l}")
        np.testing.assert_allclose(got, np.asarray(kernel), **TOL, err_msg=f"layer {l}")


def test_gather_dense_matches_jax():
    x = _inputs(2)
    got = pa.paged_gather_dense(_t(x["kp"][1]), _t(TABLES)).numpy()
    want = np.asarray(j_gather(jnp.asarray(x["kp"][1]), jnp.asarray(TABLES)))
    np.testing.assert_array_equal(got, want)


def test_dead_entries_never_reach_the_output():
    """A NaN null block (what an inactive row's final scatter may leave
    there) does not reach the output of an active row: dead table entries
    and masked slots enter by select, never as 0 * value."""
    x = _inputs(4, seed=1)
    clean = _port(x, 0, 2, None)
    x["kp"][:, 0] = np.nan
    x["vp"][:, 0] = np.nan
    poisoned = _port(x, 0, 2, None)
    np.testing.assert_array_equal(poisoned[:3], clean[:3])  # rows 0-2 are active


def test_wrapper_on_cpu_is_the_plain_version():
    x = _inputs(4)
    ak.reset_launches()
    got = pa.paged_decode_frozen(
        _t(x["q"]), _t(x["kp"]), _t(x["vp"]), _t(TABLES), _t(LENGTHS0), _t(STARTS),
        _t(x["ki"]), _t(x["vi"]), 1, 3, D ** -0.5, 10)
    np.testing.assert_array_equal(got.numpy(), _port(x, 1, 3, 10))
    assert not ak.LAUNCHES  # nothing launched on the CPU


def test_fp8_pools_match_jax():
    """e4m3 pools (the same bytes in both packages) beside bf16 in-flight
    K/V: the wrapper on CPU tensors against the JAX oracle and the JAX
    kernel's e4m3 branch (interpret mode)."""
    x = _inputs(1)
    kp8 = jnp.asarray(x["kp"]).astype(jnp.float8_e4m3fn)
    vp8 = jnp.asarray(x["vp"]).astype(jnp.float8_e4m3fn)
    ki = jnp.asarray(x["ki"]).astype(jnp.bfloat16)
    vi = jnp.asarray(x["vi"]).astype(jnp.bfloat16)
    f8 = lambda a: torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn)  # noqa: E731
    bf = lambda a: torch.from_numpy(np.array(a).view(np.uint16)).view(torch.bfloat16)  # noqa: E731
    common = (jnp.asarray(TABLES), jnp.asarray(LENGTHS0), jnp.asarray(STARTS), ki, vi)
    for l in range(L):
        got = pa.paged_decode_frozen(_t(x["q"]), f8(kp8), f8(vp8), _t(TABLES),
                                     _t(LENGTHS0), _t(STARTS), bf(ki), bf(vi), l, 3,
                                     D ** -0.5).numpy()
        oracle = paged_decode_frozen_xla(jnp.asarray(x["q"]), kp8[l], vp8[l], *common,
                                         jnp.asarray(3, jnp.int32), scale=D ** -0.5)
        kernel = paged_decode_frozen_tpu(jnp.asarray(x["q"]), kp8, vp8, *common,
                                         jnp.asarray(l, jnp.int32), jnp.asarray(3, jnp.int32),
                                         scale=D ** -0.5, interpret=True)
        np.testing.assert_allclose(got, np.asarray(oracle), **TOL, err_msg=f"layer {l}")
        np.testing.assert_allclose(got, np.asarray(kernel), **TOL, err_msg=f"layer {l}")


# -- K9: one layer's pool, the row's own K/V already in it ---------------------

# forward_paged's lengths count the current token; row 3 stays inactive
LENGTHS = np.array([41, 20, 9, 70], np.int32)


def _f8(a):
    return torch.from_numpy(np.array(a).view(np.uint8)).view(torch.float8_e4m3fn)


def _k9_jax(q, kp, vp, window):
    args = (jnp.asarray(q), kp, vp, jnp.asarray(TABLES), jnp.asarray(LENGTHS),
            jnp.asarray(STARTS))
    return (np.asarray(paged_decode_xla(*args, scale=D ** -0.5, sliding_window=window)),
            np.asarray(paged_decode_tpu(*args, scale=D ** -0.5, sliding_window=window,
                                        interpret=True)))


def _k9_port(x, l, window, fn=pa.paged_decode_plain):
    return fn(_t(x["q"]), _t(x["kp"][l]), _t(x["vp"][l]), _t(TABLES), _t(LENGTHS),
              _t(STARTS), D ** -0.5, window).numpy()


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window", [None, 8, 24])
def test_paged_decode_plain_matches_jax_oracle_and_kernel(G, window):
    """Every pool block, block 0 included, holds random values: what the
    dead entries of rows 1 and 2 point at must stay out of the output."""
    x = _inputs(G, seed=7)
    for l in range(L):
        got = _k9_port(x, l, window)
        oracle, kernel = _k9_jax(x["q"], jnp.asarray(x["kp"][l]), jnp.asarray(x["vp"][l]),
                                 window)
        np.testing.assert_allclose(got, oracle, **TOL, err_msg=f"layer {l}")
        np.testing.assert_allclose(got, kernel, **TOL, err_msg=f"layer {l}")


def test_paged_decode_dead_entries_never_reach_the_output():
    x = _inputs(2, seed=8)
    clean = _k9_port(x, 1, None)
    x["kp"][:, 0] = np.nan
    x["vp"][:, 0] = np.nan
    np.testing.assert_array_equal(_k9_port(x, 1, None)[:3], clean[:3])


def test_paged_decode_row_that_sees_nothing_is_zeros():
    """A row of length 0 (a released row) gives zeros, where the JAX
    oracle's softmax gives the uniform mean; the batcher discards it."""
    x = _inputs(1, seed=9)
    out = pa.paged_decode_plain(_t(x["q"]), _t(x["kp"][0]), _t(x["vp"][0]), _t(TABLES),
                                _t(np.array([41, 0, 9, 0], np.int32)), _t(STARTS),
                                D ** -0.5)
    assert not out[1].any() and not out[3].any() and out[0].abs().sum() > 0


@pytest.mark.parametrize("kernel", ["kernel", "plain"])
def test_paged_decode_dispatch_on_cpu_is_the_plain_version(kernel):
    x = _inputs(4, seed=10)
    ak.reset_launches()
    got = pa.paged_decode(_t(x["q"]), _t(x["kp"][1]), _t(x["vp"][1]), _t(TABLES),
                          _t(LENGTHS), _t(STARTS), D ** -0.5, 8, kernel=kernel)
    np.testing.assert_array_equal(got.numpy(), _k9_port(x, 1, 8))
    assert not ak.LAUNCHES  # nothing launched on the CPU
    with pytest.raises(ValueError, match="route"):
        pa.paged_decode(_t(x["q"]), _t(x["kp"][1]), _t(x["vp"][1]), _t(TABLES),
                        _t(LENGTHS), _t(STARTS), D ** -0.5, kernel="pallas")


@pytest.mark.parametrize("window", [None, 8])
def test_paged_decode_fp8_pools_match_jax(window):
    """e4m3 pools, the same bytes in both packages, beside fp32 queries:
    the wrapper on CPU tensors against the JAX oracle and the JAX kernel's
    e4m3 branch (interpret mode)."""
    x = _inputs(2, seed=11)
    for l in range(L):
        kp8 = jnp.asarray(x["kp"][l]).astype(jnp.float8_e4m3fn)
        vp8 = jnp.asarray(x["vp"][l]).astype(jnp.float8_e4m3fn)
        got = pa.paged_decode_cuda(_t(x["q"]), _f8(kp8), _f8(vp8), _t(TABLES),
                                   _t(LENGTHS), _t(STARTS), D ** -0.5, window).numpy()
        oracle, kernel = _k9_jax(x["q"], kp8, vp8, window)
        np.testing.assert_allclose(got, oracle, **TOL, err_msg=f"layer {l}")
        np.testing.assert_allclose(got, kernel, **TOL, err_msg=f"layer {l}")
