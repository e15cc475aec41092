"""The plain versions of the port's int4 kernels (K4, K5b, K6, K7 in
tinygpt_tpu_torch.ops.quant_kernels; the wrappers run them on CPU
tensors) against the JAX package's Pallas kernels in interpret mode, on
the same quantized bytes and numpy inputs.

Tolerances: fp32 rtol = atol = 2e-3, as tests/test_quant.py holds the
JAX kernels to their reference (both sides sum in fp32 in another order;
the JAX int4 path folds the -8 bias into a per-group correction). bf16:
one bf16 ulp of the largest output (2^-7 of its magnitude, at most):
both round once to bf16, and where the JAX kernel rounds its dequantized
weights to bf16 first (K5b at M > 32), that rounding stays well inside
the ulp."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tinygpt_tpu.ops import quant as jq  # noqa: E402
from tinygpt_tpu.ops import quant_kernels as jk  # noqa: E402
from tinygpt_tpu.ops.rope import compute_rope_freqs  # noqa: E402
from tinygpt_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from tinygpt_tpu_torch.ops import quant_kernels as qk  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a, dtype=None):
    """numpy / JAX array -> CPU tensor (bf16 through fp32, exact)."""
    t = torch.from_numpy(np.array(np.asarray(a).astype(np.float32)
                                  if dtype is not None else np.asarray(a)))
    return t.to(dtype) if dtype is not None else t


def _close(got: torch.Tensor, want, dtype: str, what: str = "") -> None:
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3, err_msg=what)
    else:
        tol = 2.0 ** -7 * np.abs(want).max()
        assert np.abs(got - want).max() <= tol, (what, np.abs(got - want).max(), tol)


def _quant(rng, shape, group=64):
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    j = jq.quantize_weight(w, bits=4, group_size=group)
    return j, _t(j.data), _t(j.scales)


@pytest.mark.parametrize("M,dtype", [(4, "float32"), (4, "bfloat16"),
                                     (40, "float32"), (40, "bfloat16")])
def test_matmul_int4_plain_matches_jax(M, dtype):
    """K4 and K5b (M = 4: the TPU's per-group dots; M = 40: its
    dequantize-the-block branch)."""
    rng = np.random.default_rng(2)
    jdt, tdt = DT[dtype]
    L, IN, OUT, G = 2, 256, 384, 64
    j, data, scales = _quant(rng, (L, IN, OUT), G)
    x = rng.standard_normal((M, IN)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), _t(x, tdt)
    ak.reset_launches()
    for l in range(L):
        want = jk.matmul_dequant_int4_stacked(jx, j.data, j.scales,
                                              jnp.asarray(l, jnp.int32),
                                              group=G, interpret=True)
        got = qk.matmul_dequant_int4_stacked(tx, data, scales, l, G)
        assert got.dtype == tdt
        _close(got, want, dtype, f"K5b layer {l}")
    want = jk.matmul_dequant_int4(jx, j.data[1], j.scales[1], group=G,
                                  interpret=True)
    _close(qk.matmul_dequant_int4(tx, data[1], scales[1], G), want, dtype, "K4")
    assert not ak.LAUNCHES  # CPU tensors launch nothing


def _silu(v):
    return v / (1 + np.exp(-v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["ln", "silu_res", "ln_bias", "silu_res_padded",
                                     "ln_padded"])
def test_fused_int4_plain_matches_jax(variant, dtype):
    """K6's prologues and epilogues: the norm prologue (with a bias), and
    silu(gate) * up with the residual; "padded": IN = 192, whose weight
    rows are padded to 256 (x and ln per segment)."""
    rng = np.random.default_rng(13)
    jdt, tdt = DT[dtype]
    L, OUT, M, G = 2, 384, 4, 64
    IN = 192 if variant.endswith("padded") else 256
    j, data, scales = _quant(rng, (L, IN, OUT), G)
    silu = variant.startswith("silu")
    x = (rng.standard_normal((M, 2 * IN if silu else IN)) * (0.5 if silu else 1)
         ).astype(np.float32)
    jkw, tkw = {}, {}
    if not silu:
        ln = rng.standard_normal((L, 1, IN)).astype(np.float32)
        inv = (1.0 / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6)).astype(np.float32)
        jkw.update(ln=jnp.asarray(ln).astype(jdt), invrms=jnp.asarray(inv))
        tkw.update(ln=_t(ln, tdt), invrms=_t(inv))
    if "bias" in variant:
        bias = rng.standard_normal((L, 1, OUT)).astype(np.float32)
        jkw["bias"], tkw["bias"] = jnp.asarray(bias).astype(jdt), _t(bias, tdt)
    if silu:
        res = rng.standard_normal((M, OUT)).astype(np.float32)
        jkw.update(silu=True, res=jnp.asarray(res).astype(jdt))
        tkw.update(silu=True, res=_t(res, tdt))
    for l in range(L):
        want = jk.matmul_dequant_int4_stacked_fused(
            jnp.asarray(x).astype(jdt), j.data, j.scales, jnp.asarray(l, jnp.int32),
            group=G, interpret=True, **jkw)
        got = qk.matmul_dequant_int4_stacked_fused(_t(x, tdt), data, scales, l, G,
                                                   **tkw)
        assert got.dtype == tdt
        _close(got, want, dtype, f"{variant} layer {l}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_fused_int4_rope_plain_matches_jax(qk_norm, dtype):
    """K6 as the decode qkv: norm prologue, bias, per-head qk-norm and RoPE
    on the q || k heads. Nq = 6, Nk = 1, D = 128: the q || k / v boundary
    (column 896) falls inside the TPU kernel's 256-column output tile."""
    rng = np.random.default_rng(17)
    jdt, tdt = DT[dtype]
    L, IN, Nq, Nk, D, M, G, EPS = 2, 256, 6, 1, 128, 4, 64, 1e-6
    OUT = (Nq + 2 * Nk) * D
    j, data, scales = _quant(rng, (L, IN, OUT), G)
    x = rng.standard_normal((M, IN)).astype(np.float32)
    ln = rng.standard_normal((L, 1, IN)).astype(np.float32)
    bias = rng.standard_normal((L, 1, OUT)).astype(np.float32)
    inv = (1.0 / np.sqrt((x ** 2).mean(-1, keepdims=True) + EPS)).astype(np.float32)
    cos, sin = compute_rope_freqs(D, 64)
    positions = np.array([3, 11, 0, 42])
    c, s = np.asarray(cos)[positions], np.asarray(sin)[positions]
    jkw = dict(ln=jnp.asarray(ln).astype(jdt), invrms=jnp.asarray(inv),
               bias=jnp.asarray(bias).astype(jdt), rope_cos=jnp.asarray(c),
               rope_sin=jnp.asarray(s), rope_heads=Nq + Nk, rope_dim=D)
    tkw = dict(ln=_t(ln, tdt), invrms=_t(inv), bias=_t(bias, tdt), rope_cos=_t(c),
               rope_sin=_t(s), rope_heads=Nq + Nk, rope_dim=D)
    if qk_norm:
        qn = (1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32)
        kn = (1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32)
        jkw.update(qk_norm_w=(jnp.asarray(qn).astype(jdt), jnp.asarray(kn).astype(jdt)),
                   qk_heads=Nq, eps=EPS)
        tkw.update(qk_norm_w=(_t(qn, tdt), _t(kn, tdt)), qk_heads=Nq, eps=EPS)
    for l in range(L):
        want = jk.matmul_dequant_int4_stacked_fused(
            jnp.asarray(x).astype(jdt), j.data, j.scales, jnp.asarray(l, jnp.int32),
            group=G, interpret=True, **jkw)
        got = qk.matmul_dequant_int4_stacked_fused(_t(x, tdt), data, scales, l, G,
                                                   **tkw)
        _close(got, want, dtype, f"layer {l}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_int4_plain_matches_jax(dtype):
    """K7: x + down(silu(g) * u) with the gate_up activation in fp32."""
    rng = np.random.default_rng(7)
    jdt, tdt = DT[dtype]
    L, H, I, M, G, BK = 2, 1024, 3072, 4, 64, 512
    gj, gd, gs = _quant(rng, (L, H, 2 * I), G)
    dj, dd, ds = _quant(rng, (L, I, H), G)
    x = rng.standard_normal((M, H)).astype(np.float32)
    ln = rng.standard_normal((L, 1, H)).astype(np.float32)
    inv = (1.0 / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6)).astype(np.float32)
    for l in range(L):
        want = jk.mlp_fused_int4_stacked(
            jnp.asarray(x).astype(jdt), gj.data, gj.scales, dj.data, dj.scales,
            jnp.asarray(ln).astype(jdt), jnp.asarray(inv), jnp.asarray(l, jnp.int32),
            group=G, bk=BK, interpret=True)
        got = qk.mlp_fused_int4_stacked(_t(x, tdt), gd, gs, dd, ds, _t(ln, tdt),
                                        _t(inv), l, G)
        assert got.dtype == tdt
        _close(got, want, dtype, f"layer {l}")


def test_mlp_plain_is_the_two_call_composition_in_fp32():
    """In fp32 the one-call MLP equals the two-call route (K6 with the
    norm prologue, then K6 with silu * up and the residual)."""
    rng = np.random.default_rng(8)
    L, H, I, M, G = 2, 256, 320, 3, 64  # I = 320: down's rows pad to 512
    _, gd, gs = _quant(rng, (L, H, 2 * I), G)
    _, dd, ds = _quant(rng, (L, I, H), G)
    x = _t(rng.standard_normal((M, H)).astype(np.float32))
    ln = _t(rng.standard_normal((L, H)).astype(np.float32))
    inv = torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5)
    for l in range(L):
        one = qk.mlp_fused_int4_stacked(x, gd, gs, dd, ds, ln, inv, l, G)
        gu = qk.matmul_dequant_int4_stacked_fused(x, gd, gs, l, G, ln=ln, invrms=inv)
        two = qk.matmul_dequant_int4_stacked_fused(gu, dd, ds, l, G, silu=True, res=x)
        torch.testing.assert_close(one, two, rtol=1e-5, atol=1e-5)


def test_mlp_without_the_residual_is_a_tp_ranks_partial_sum():
    """residual=False (a tp rank other than 0) drops the "x +" and nothing
    else: the result is the two-call route without res, and adding x gives
    the residual-on result."""
    rng = np.random.default_rng(9)
    L, H, I, M, G = 2, 256, 320, 3, 64
    _, gd, gs = _quant(rng, (L, H, 2 * I), G)
    _, dd, ds = _quant(rng, (L, I, H), G)
    x = _t(rng.standard_normal((M, H)).astype(np.float32))
    ln = _t(rng.standard_normal((L, H)).astype(np.float32))
    inv = torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-5)
    for l in range(L):
        part = qk.mlp_fused_int4_stacked(x, gd, gs, dd, ds, ln, inv, l, G, residual=False)
        gu = qk.matmul_dequant_int4_stacked_fused(x, gd, gs, l, G, ln=ln, invrms=inv)
        two = qk.matmul_dequant_int4_stacked_fused(gu, dd, ds, l, G, silu=True)
        torch.testing.assert_close(part, two, rtol=1e-5, atol=1e-5)
        whole = qk.mlp_fused_int4_stacked(x, gd, gs, dd, ds, ln, inv, l, G)
        torch.testing.assert_close(part + x, whole, rtol=1e-5, atol=1e-5)
