"""The port's paged frozen-pool decode attention (K8's plain version and
its wrapper on CPU tensors) against the JAX package's XLA oracle
(paged_decode_frozen_xla) and its Pallas kernel in interpret mode
(paged_decode_frozen_tpu), on the same seeded numpy inputs: ragged
lengths, a start inside a block, dead table entries, an inactive row with
a stale length over a zero table, 1 and 4 query heads per KV head, windows,
and the first and last in-flight step. All three compute in fp32 in
another order: tolerance 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops.paged_attention import (
    paged_decode_frozen_tpu,
    paged_decode_frozen_xla,
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
