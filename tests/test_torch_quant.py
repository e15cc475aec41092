"""The port's weight-only quantization (tinygpt_tpu_torch.ops.quant)
against the JAX package's on the same numpy inputs: packing, per-group
quantization (int4 and int8, 2-D and stacked, row-padded dims) and
quantize_params (tied and untied heads, the head padded to a multiple of
2048) must give IDENTICAL bytes, group size and in_dim."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tinygpt_tpu.hf.config import parse_model_config as j_parse  # noqa: E402
from tinygpt_tpu.models import causal_lm as jlm  # noqa: E402
from tinygpt_tpu.ops import quant as jq  # noqa: E402
from tinygpt_tpu_torch.models import causal_lm  # noqa: E402
from tinygpt_tpu_torch.ops import quant as tq  # noqa: E402


def _same_qt(got: tq.QuantizedTensor, want) -> None:
    assert got.bits == want.bits
    assert got.group_size == want.group_size
    assert got.in_dim == want.in_dim
    assert got.data.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(want.scales))


def test_pack_int4_matches_jax_and_roundtrips():
    rng = np.random.default_rng(0)
    q = rng.integers(-8, 8, (64, 48)).astype(np.int8)
    packed = tq.pack_int4(q)
    np.testing.assert_array_equal(packed, jq.pack_int4(q))
    back = tq.unpack_int4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(back, q)
    np.testing.assert_array_equal(back, np.asarray(jq.unpack_int4(jnp.asarray(packed))))


QUANT_CASES = [
    # (shape, bits, group, dtype); in=896 and 192 are row-padded for int4
    ((256, 384), 4, 64, "float32"),
    ((256, 384), 4, 32, "bfloat16"),
    ((2, 896, 128), 4, 64, "float32"),
    ((3, 192, 64), 4, 64, "bfloat16"),
    ((128, 2048), 4, None, "float32"),
    ((256, 384), 8, 64, "float32"),
    ((3, 512, 64), 8, None, "bfloat16"),
    ((2, 896, 128), 8, 128, "float32"),
]


@pytest.mark.parametrize("shape,bits,group,dtype", QUANT_CASES)
def test_quantize_weight_bytes_match_jax(shape, bits, group, dtype):
    rng = np.random.default_rng(1)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., :5, 3] = 0.0  # an all-zero group column takes the 1e-8 scale
    jw = jnp.asarray(w).astype(getattr(jnp, dtype))
    tw = torch.from_numpy(w).to(getattr(torch, dtype))
    want = jq.quantize_weight(jw, bits=bits, group_size=group)
    got = tq.quantize_weight(tw, bits=bits, group_size=group)
    _same_qt(got, want)
    # dequantize in fp32: exactly q * scale
    np.testing.assert_array_equal(
        tq.dequantize(got, torch.float32).numpy(),
        np.asarray(jq.dequantize(want, jnp.float32)))


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_params_bytes_match_jax(tied):
    """Every layer matrix and the head (tied: a quantized transposed copy
    of the embedding; vocab 503 padded to 2048) identical to JAX's."""
    cfg = dict(model_type="llama", vocab_size=503, hidden_size=64,
               intermediate_size=192, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=64, tie_word_embeddings=tied)
    jparams = jlm.init_params(j_parse(cfg), seed=4, dtype=jnp.float32)
    want = jq.quantize_params(jparams, bits=4, group_size=64)
    got = tq.quantize_params(causal_lm.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu"), bits=4, group_size=64)
    for k in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        _same_qt(got["layers"][k], want["layers"][k])
    assert got["lm_head"].data.shape[-1] == 2048
    _same_qt(got["lm_head"], want["lm_head"])
    # the head's pad columns dequantize to exact zeros
    assert not tq.dequantize(got["lm_head"], torch.float32)[:, 503:].any()
    # the float tensors are untouched
    assert torch.equal(got["embed"], torch.from_numpy(np.array(jparams["embed"])))


def test_quantized_params_carry_across_from_jax():
    """params_from_numpy builds the port's QuantizedTensor from the numpy
    tree of JAX's, on the same bytes."""
    cfg = dict(model_type="qwen2", vocab_size=101, hidden_size=64,
               intermediate_size=128, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=64)
    jparams = jq.quantize_params(
        jlm.init_params(j_parse(cfg), seed=5, dtype=jnp.float32), bits=4,
        group_size=64)
    got = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
    for k in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        _same_qt(got["layers"][k], jparams["layers"][k])
    _same_qt(got["lm_head"], jparams["lm_head"])
    assert got["layers"]["qkv_b"].dtype == torch.float32


@pytest.mark.parametrize("bits", [8, 4])
def test_matmul_any_matches_jax_reference(bits):
    """matmul_any on a quantized weight (int8 through K3's plain version,
    int4 through K4's) against JAX's matmul_any, whose CPU reference
    rounds the dequantized weight to bf16, so the check is against the
    fp32 product with that rounding's tolerance."""
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((192, 64)) * 0.05).astype(np.float32)
    x = rng.standard_normal((2, 5, 192)).astype(np.float32)
    qt = tq.quantize_weight(torch.from_numpy(w), bits=bits, group_size=64)
    got = tq.matmul_any(torch.from_numpy(x), qt)
    want = np.asarray(jq.matmul_any(
        jnp.asarray(x), jq.quantize_weight(w, bits=bits, group_size=64)))
    assert got.shape == (2, 5, 64)
    # bf16 rounding of the weights on the JAX side: 2^-9 relative per weight
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-2)
    exact = (torch.from_numpy(x).reshape(10, 192) @ tq.dequantize(qt, torch.float32)[:192])
    np.testing.assert_allclose(got.reshape(10, 64).numpy(), exact.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_pad_x_to_and_head_pad():
    x = torch.ones(3, 5)
    assert tq.pad_x_to(x, 5) is x
    p = tq.pad_x_to(x, 8)
    assert p.shape == (3, 8) and not p[:, 5:].any()
    w = torch.ones(4, 503)
    assert tq.pad_head_out(w).shape == (4, 2048)
    assert tq.pad_head_out(torch.ones(4, 4096)).shape == (4, 4096)
