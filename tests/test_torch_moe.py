"""The port's MoE operations (tinygpt_tpu_torch.ops.moe_kernels, the MoE
parts of ops/quant.py and models/causal_lm.py) against the JAX package's,
on the CPU, on the same numpy-seeded inputs.

- The plain versions of K12, K11a and K11b against the JAX Pallas kernels
  run in interpret mode: 1e-4 in fp32 (the same exact dequantization,
  summed in another order); in bf16 one bf16 ulp of the largest output
  (2^-7 of it), as both round one fp32 sum once.
- moe_mlp_gathered (plain) against the JAX moe_mlp_gathered (interpret
  mode) and against the JAX dense moe_mlp: 1e-4 in fp32.
- moe_mlp, dense and routed, below and above 32 tokens: 1e-4 in fp32.
- quantize_params: the same bytes, scales and metadata as the JAX
  package's, the int8 fallback of int4 expert stacks included.
- Routing: the same experts per token (compared as sets) and, on exact
  ties, the same order as lax.top_k (the lower expert id first).

On the CPU every wrapper runs its plain version: no kernel launch is
counted."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tinygpt_tpu.hf.config import parse_model_config as j_parse  # noqa: E402
from tinygpt_tpu.models import causal_lm as jlm  # noqa: E402
from tinygpt_tpu.ops import moe_kernels as jmk  # noqa: E402
from tinygpt_tpu.ops.quant import QuantizedTensor as JQuantizedTensor  # noqa: E402
from tinygpt_tpu.ops.quant import _quantize_moe_stacked as j_quantize_moe  # noqa: E402
from tinygpt_tpu.ops.quant import quantize_params as j_quantize_params  # noqa: E402
from tinygpt_tpu_torch.hf.config import parse_model_config  # noqa: E402
from tinygpt_tpu_torch.models import causal_lm  # noqa: E402
from tinygpt_tpu_torch.ops import attention_kernels as ak  # noqa: E402
from tinygpt_tpu_torch.ops import moe_kernels as mk  # noqa: E402
from tinygpt_tpu_torch.ops.quant import (  # noqa: E402
    QuantizedTensor,
    _quantize_moe_stacked,
    quantize_params,
)

FP32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_ULP = 2.0 ** -7   # one bf16 ulp, relative to the largest output


def _cfg(H=128, I=256, E=4, k=2):
    return dict(model_type="mixtral", vocab_size=101, hidden_size=H,
                intermediate_size=I, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, num_local_experts=E, num_experts_per_tok=k,
                max_position_embeddings=64, rms_norm_eps=1e-5)


def _t(a) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor on the same bits (bf16 included)."""
    return causal_lm._from_numpy(np.asarray(a))


def _jqt(qt: QuantizedTensor) -> JQuantizedTensor:
    return JQuantizedTensor(jnp.asarray(qt.data.numpy()), jnp.asarray(qt.scales.numpy()),
                            qt.bits, qt.group_size, qt.in_dim)


def _assert_close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **FP32_TOL)
    else:
        err = np.abs(got - want).max()
        assert err <= BF16_ULP * np.abs(want).max(), err


def _x_and_ids(seed, R, IN, E, dtype):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(R, IN)).astype(np.float32)).astype(dtype)
    idx = rng.integers(0, E, R).astype(np.int32)
    return x, idx


# -- the three gathered matmuls against the JAX kernels ------------------------------

# (L, E, IN, OUT, R, layers): the JAX tests' shapes, and one whose IN and OUT
# do not divide the default tiles
K12_CASES = [(3, 4, 256, 384, 6, (0, 2)), (2, 3, 384, 640, 4, (1,))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", K12_CASES)
def test_gather_matmul_plain_matches_jax(case, dtype):
    L, E, IN, OUT, R, layers = case
    rng = np.random.default_rng(L * 10 + E)
    w = jnp.asarray(rng.normal(size=(L, E, IN, OUT)).astype(np.float32)).astype(dtype)
    x, idx = _x_and_ids(R, R, IN, E, dtype)
    ak.reset_launches()
    for l in layers:
        want = jmk.moe_gather_matmul(x, w, jnp.int32(l), jnp.asarray(idx), interpret=True)
        got = mk.moe_gather_matmul(_t(x), _t(w), l, torch.from_numpy(idx))
        assert got.dtype == _t(x).dtype and got.shape == (R, OUT)
        _assert_close(got, want, dtype)
    assert not ak.LAUNCHES   # the CPU runs the plain version


# (L, E, IN, OUT, R, group, layer): the JAX tests' shapes; IN = 128 at int4
# row-pads to 256 at quantize time and runs the full-scales mode there
QUANT_CASES = [(2, 4, 256, 384, 6, 32, 1), (1, 3, 128, 256, 4, 32, 0),
               (2, 3, 512, 640, 5, 64, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("case", QUANT_CASES)
def test_quantized_gather_matmul_plain_matches_jax(case, bits, dtype):
    """K11a / K11b: the port quantizes the experts to the JAX package's
    bytes, and its plain version gives the JAX kernel's products."""
    L, E, IN, OUT, R, group, l = case
    w = np.random.default_rng(IN + bits).normal(size=(L, E, IN, OUT)).astype(np.float32)
    jq = j_quantize_moe(jnp.asarray(w), bits=bits, group_size=group)
    tq = _quantize_moe_stacked(torch.from_numpy(w), bits, group)
    assert (tq.bits, tq.group_size, tq.in_dim) == (jq.bits, jq.group_size, jq.in_dim)
    np.testing.assert_array_equal(tq.data.numpy(), np.asarray(jq.data))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    if bits == 4 and IN == 128:
        assert tq.in_dim == 256 and tq.data.shape[2] == 128  # row-padded
    x, idx = _x_and_ids(R + bits, R, IN, E, dtype)
    jfn = jmk.moe_gather_matmul_int4 if bits == 4 else jmk.moe_gather_matmul_int8
    tfn = mk.moe_gather_matmul_int4 if bits == 4 else mk.moe_gather_matmul_int8
    want = jfn(x, jq.data, jq.scales, jnp.int32(l), jnp.asarray(idx), group=jq.group_size,
               interpret=True)
    got = tfn(_t(x), tq.data, tq.scales, l, torch.from_numpy(idx), tq.group_size)
    assert got.shape == (R, OUT)
    _assert_close(got, want, dtype)


def test_gather_matmul_repeats_unused_experts_and_clamped_ids():
    """Repeated ids, an expert no row names, and ids outside [0, E) (the
    plain versions clamp them, as the kernels do) against a direct
    per-row product."""
    rng = np.random.default_rng(9)
    L, E, IN, OUT = 2, 5, 64, 48
    w = torch.from_numpy(rng.normal(size=(L, E, IN, OUT)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(7, IN)).astype(np.float32))
    idx = torch.tensor([3, 3, 0, 3, -2, 9, 0], dtype=torch.int32)
    got = mk.moe_gather_matmul(x, w, 1, idx)
    ids = idx.long().clamp(0, E - 1)
    want = torch.stack([x[r] @ w[1, ids[r]] for r in range(7)])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# -- routing ---------------------------------------------------------------------------


def test_route_matches_jax_top_k():
    """The same experts per token as the JAX routing (sets; the order of
    a near-tie may differ) and the same renormalized weights; on exact ties
    (two identical router columns) the same order as lax.top_k."""
    rng = np.random.default_rng(3)
    H, E, k = 32, 8, 2
    h = rng.normal(size=(64, H)).astype(np.float32)
    rw = rng.normal(size=(H, E)).astype(np.float32)
    rw[:, 5] = rw[:, 2]        # experts 2 and 5 tie on every token
    probs = jax.nn.softmax(jnp.asarray(h) @ jnp.asarray(rw), axis=-1)
    jw, jidx = jax.lax.top_k(probs, k)
    jw = np.asarray(jw / jnp.sum(jw, axis=-1, keepdims=True))
    w, idx = mk.moe_route(torch.from_numpy(h), torch.from_numpy(rw), k)
    for t in range(h.shape[0]):
        assert set(idx[t].tolist()) == set(np.asarray(jidx[t]).tolist()), t
    np.testing.assert_allclose(np.sort(w.numpy(), -1), np.sort(jw, -1), rtol=1e-6, atol=1e-7)
    tie = (np.asarray(jidx) == 2).any(-1) & (np.asarray(jidx) == 5).any(-1)
    assert tie.any()
    np.testing.assert_array_equal(idx.numpy()[tie], np.asarray(jidx)[tie])


# -- the routed MLPs ---------------------------------------------------------------------


def _moe_weights(seed, H, I, E, L=2):
    rng = np.random.default_rng(seed)
    router = rng.normal(size=(L, H, E)).astype(np.float32)
    gw = (rng.normal(size=(L, E, H, 2 * I)) * 0.1).astype(np.float32)
    dw = (rng.normal(size=(L, E, I, H)) * 0.1).astype(np.float32)
    return router, gw, dw


@pytest.mark.parametrize("stacks", ["float32", "int8", "int4"])
@pytest.mark.parametrize("B", [3, 16])
def test_moe_mlp_gathered_matches_jax(stacks, B):
    """The routed decode MLP on float, int8 and int4 stacks (H = 256, so
    int4 runs at int4) against the JAX moe_mlp_gathered in interpret mode,
    at every layer; float stacks also against the JAX dense moe_mlp."""
    H, I, E = 256, 256, 4
    cfg = parse_model_config(_cfg(H, I, E))
    jcfg = j_parse(_cfg(H, I, E))
    router, gw, dw = _moe_weights(B, H, I, E)
    h = np.random.default_rng(B + 1).normal(size=(B, 1, H)).astype(np.float32)
    if stacks == "float32":
        tg, td = torch.from_numpy(gw), torch.from_numpy(dw)
        jg, jd = jnp.asarray(gw), jnp.asarray(dw)
    else:
        bits = int(stacks[3:])
        tg, td = (_quantize_moe_stacked(torch.from_numpy(w), bits, 64) for w in (gw, dw))
        assert tg.bits == bits
        jg, jd = _jqt(tg), _jqt(td)
    for l in range(2):
        want = jmk.moe_mlp_gathered(jnp.asarray(h), jnp.asarray(router[l]), jg, jd,
                                    jnp.int32(l), jcfg, interpret=True)
        for impl in ("kernel", "plain"):   # "kernel" runs the plain versions on the CPU
            got = mk.moe_mlp_gathered(torch.from_numpy(h), torch.from_numpy(router[l]),
                                      tg, td, l, cfg, impl)
            assert got.shape == (B, 1, H)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)
        if stacks == "float32":
            dense = jlm.moe_mlp(jnp.asarray(h), {"router_w": jnp.asarray(router[l]),
                                                 "moe_gate_up_w": jg[l],
                                                 "moe_down_w": jd[l]}, jcfg, impl="dense")
            np.testing.assert_allclose(got.numpy(), np.asarray(dense), **FP32_TOL)


@pytest.mark.parametrize("impl", ["dense", "routed", "auto"])
@pytest.mark.parametrize("B,S", [(3, 1), (4, 10)])
def test_moe_mlp_matches_jax(B, S, impl):
    """moe_mlp in both formulations (auto: dense below 32 tokens, routed
    at 32 and above) against the JAX moe_mlp of the same formulation."""
    H, I, E = 64, 96, 4
    cfg, jcfg = parse_model_config(_cfg(H, I, E)), j_parse(_cfg(H, I, E))
    router, gw, dw = _moe_weights(S, H, I, E, L=1)
    h = np.random.default_rng(B).normal(size=(B, S, H)).astype(np.float32)
    lp = {"router_w": router[0], "moe_gate_up_w": gw[0], "moe_down_w": dw[0]}
    want = jlm.moe_mlp(jnp.asarray(h), {k: jnp.asarray(v) for k, v in lp.items()}, jcfg,
                       impl=impl)
    got = causal_lm.moe_mlp(torch.from_numpy(h),
                            {k: torch.from_numpy(v) for k, v in lp.items()}, cfg, impl=impl)
    assert got.shape == (B, S, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32_TOL)


def test_moe_layer_params_dequantize_to_bf16_as_jax():
    """The dense route's layer weights of a quantized (and row-padded)
    stack: JAX _moe_layer_params' bf16 values and shapes."""
    H, I, E = 64, 96, 3
    router, gw, dw = _moe_weights(5, H, I, E)
    tg, td = (_quantize_moe_stacked(torch.from_numpy(w), 4, 32) for w in (gw, dw))
    assert tg.in_dim == 256 and td.in_dim == 256   # both row-padded
    for l in range(2):
        want = jlm._moe_layer_params({"router_w": jnp.asarray(router[l])},
                                     {"moe_gate_up_w": _jqt(tg), "moe_down_w": _jqt(td)},
                                     jnp.int32(l))
        got = causal_lm._moe_layer_params({"router_w": torch.from_numpy(router[l]),
                                           "moe_gate_up_w": tg, "moe_down_w": td}, l)
        for k in ("moe_gate_up_w", "moe_down_w"):
            assert got[k].dtype == torch.bfloat16 and got[k].shape == want[k].shape, k
            assert torch.equal(got[k], _t(want[k])), k


# -- quantize_params -------------------------------------------------------------------


@pytest.mark.parametrize("H,I,bits", [(64, 128, 4), (64, 128, 8), (256, 512, 4)])
def test_quantize_params_bytes_match_jax(H, I, bits):
    """Every quantized weight of a mixtral's params equals the JAX
    package's byte for byte. At H = 64, int4 expert stacks fall back to
    int8 (the contraction dims 64 and 128 are not multiples of 256), as in
    the JAX package; at H = 256, I = 512 they stay int4."""
    c = _cfg(H, I, E=4)
    jp = jlm.init_params(j_parse(c), seed=2, dtype=jnp.float32)
    tp = causal_lm.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    want = j_quantize_params(jp, bits=bits, group_size=64)
    got = quantize_params(tp, bits=bits, group_size=64)
    pairs = [(k, got["layers"][k], want["layers"][k]) for k in want["layers"]]
    pairs.append(("lm_head", got["lm_head"], want["lm_head"]))
    for k, g, w in pairs:
        if not isinstance(w, JQuantizedTensor):
            assert torch.equal(g, _t(w)), k
            continue
        assert (g.bits, g.group_size, g.in_dim) == (w.bits, w.group_size, w.in_dim), k
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data), err_msg=k)
        np.testing.assert_array_equal(g.scales.numpy(), np.asarray(w.scales), err_msg=k)
    moe_bits = {got["layers"][k].bits for k in ("moe_gate_up_w", "moe_down_w")}
    assert moe_bits == ({8} if (bits == 8 or H == 64) else {4})
    assert got["layers"]["moe_gate_up_w"].data.ndim == 4
