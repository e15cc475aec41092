"""The port's attention (tinygpt_tpu_torch.ops.attention /
attention_kernels) against the JAX package on the same numpy inputs.

The Hopper kernels run only on the card; on the CPU each wrapper runs its
plain PyTorch version, which is what these tests hold against the JAX
Pallas kernels (interpret mode, small tiles, as tests/test_attention_kernels.py
runs them) and against the JAX oracles. fp32 throughout; tolerance 2e-5,
as in the JAX package's own kernel tests (same math, another summation
order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops import attention as jattn
from tinygpt_tpu.ops import attention_kernels as jak
from tinygpt_tpu_torch.ops import attention as tattn
from tinygpt_tpu_torch.ops import attention_kernels as tak

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _prefill_inputs(B, Nq, Nk, T, D, S, pads, q_slot, seed):
    """Row b: pads[b] pad slots, then real tokens up to slot q_slot + S
    (slots below q_slot were written by an earlier prefill chunk)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Nq, S, D)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, Nk, T, D)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, Nk, T, D)).astype(np.float32) * 0.3
    slots = np.arange(T)[None, :]
    pad = np.asarray(pads)[:, None]
    valid = (slots >= pad) & (slots < q_slot + S)
    kv_pos = np.where(valid, slots - pad, 0).astype(np.int32)
    q_pos = (q_slot + np.arange(S))[None, :] - pad
    return q, k, v, valid, kv_pos, np.maximum(q_pos, 0).astype(np.int32)


PREFILL_CASES = [
    # (B, Nq, Nk, T, D, S, pads, q_slot, window)
    (2, 4, 2, 24, 64, 16, (0, 5), 0, None),
    (2, 4, 2, 24, 64, 16, (0, 5), 0, 4),
    (2, 4, 1, 32, 64, 16, (3, 11), 8, None),
    (2, 8, 2, 32, 128, 16, (0, 13), 8, 6),
]


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_flash_prefill_plain_matches_jax_kernel(case):
    """Real query rows. A pad row sees no slot: the port gives 0, the JAX
    kernel 0 or the mean of V over a tile it did not skip — a value no
    caller reads."""
    B, Nq, Nk, T, D, S, pads, q_slot, window = case
    q, k, v, valid, _, _ = _prefill_inputs(B, Nq, Nk, T, D, S, pads, q_slot, 0)
    scale = D ** -0.5
    want = jak.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        scale=scale, q_slot=q_slot, sliding_window=window, bq=8, bt=8,
        interpret=True)
    got = tak.flash_prefill(_t(q), _t(k), _t(v), _t(valid), scale,
                            q_slot=q_slot, sliding_window=window)
    for b, p in enumerate(pads):
        first_real = max(0, p - q_slot)
        np.testing.assert_allclose(got[b, :, first_real:].numpy(),
                                   np.asarray(want)[b, :, first_real:], **TOL)
        assert not got[b, :, :first_real].any()


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_sdpa_with_cache_matches_jax(case):
    B, Nq, Nk, T, D, S, pads, q_slot, window = case
    q, k, v, valid, kv_pos, q_pos = _prefill_inputs(B, Nq, Nk, T, D, S, pads,
                                                    q_slot, 1)
    qs = q.transpose(0, 2, 1, 3)  # [B, S, Nq, D]
    want = jattn.sdpa_with_cache(
        jnp.asarray(qs), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
        jnp.asarray(kv_pos), jnp.asarray(valid), sliding_window=window)
    got = tattn.sdpa_with_cache(_t(qs), _t(k), _t(v), _t(q_pos), _t(kv_pos),
                                _t(valid), sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_kernel_route_matches_oracle_on_real_rows(case):
    """attention_with_cache: the kernel route (slot causality) equals the
    plain route (position causality) on the real rows; pad rows differ
    by design (zeros vs the oracle's uniform mean)."""
    B, Nq, Nk, T, D, S, pads, q_slot, window = case
    q, k, v, valid, kv_pos, q_pos = _prefill_inputs(B, Nq, Nk, T, D, S, pads,
                                                    q_slot, 2)
    args = (_t(q.transpose(0, 2, 1, 3)), _t(k), _t(v), _t(q_pos), _t(kv_pos),
            _t(valid), q_slot)
    got = tattn.attention_with_cache(*args, sliding_window=window, kernel="kernel")
    want = tattn.attention_with_cache(*args, sliding_window=window, kernel="plain")
    for b, p in enumerate(pads):
        first_real = max(0, p - q_slot)
        np.testing.assert_allclose(got[b, first_real:].numpy(),
                                   want[b, first_real:].numpy(), **TOL)


def _decode_inputs(L, B, Nq, Nk, T, D, N, P, step, window, seed):
    """Frozen cache of P real slots per row (row 1 left-padded by 3), the
    chunk's query at in-flight step `step`."""
    rng = np.random.default_rng(seed)
    ks = rng.standard_normal((L, B, Nk, T, D)).astype(np.float32) * 0.3
    vs = rng.standard_normal((L, B, Nk, T, D)).astype(np.float32) * 0.3
    ki = rng.standard_normal((B, Nk, N, D)).astype(np.float32) * 0.3
    vi = rng.standard_normal((B, Nk, N, D)).astype(np.float32) * 0.3
    q = rng.standard_normal((B, 1, Nq, D)).astype(np.float32) * 0.3
    pads = np.array([0, 3] + [1] * (B - 2))[:B, None]
    slots = np.arange(T)[None, :]
    valid = (slots >= pads) & (slots < P)
    kv_pos = np.where(valid, slots - pads, 0).astype(np.int32)
    q_pos = (P - pads + step).astype(np.int32)          # [B, 1]
    mask = (kv_pos <= q_pos) & valid
    if window is not None:
        mask &= kv_pos > q_pos - window
    return q, ks, vs, ki, vi, valid, kv_pos, q_pos, mask


DECODE_CASES = [
    # (Nq, Nk, D, step, window)
    (4, 4, 64, 0, None),   # G = 1
    (4, 4, 64, 5, 6),
    (8, 2, 128, 3, None),  # G = 4
    (8, 2, 128, 6, 8),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_frozen_plain_matches_jax_kernel(case):
    Nq, Nk, D, step, window = case
    L, B, T, N, P = 2, 2, 16, 8, 10
    q, ks, vs, ki, vi, _, _, _, mask = _decode_inputs(L, B, Nq, Nk, T, D, N, P,
                                                      step, window, 3)
    for l in range(L):
        want = jak.flash_decode_frozen(
            jnp.asarray(q[:, 0]), jnp.asarray(ks), jnp.asarray(vs),
            jnp.asarray(mask), jnp.asarray(ki), jnp.asarray(vi),
            jnp.asarray(l, jnp.int32), jnp.asarray(step, jnp.int32),
            scale=D ** -0.5, window=window, bt=8, interpret=True)
        got = tak.flash_decode_frozen(_t(q[:, 0]), _t(ks), _t(vs), _t(mask),
                                      _t(ki), _t(vi), l, step, D ** -0.5, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"layer {l}")


@pytest.mark.parametrize("case", DECODE_CASES)
def test_sdpa_decode_frozen_matches_jax(case):
    Nq, Nk, D, step, window = case
    L, B, T, N, P = 1, 2, 16, 8, 10
    q, ks, vs, ki, vi, valid, kv_pos, q_pos, mask = _decode_inputs(
        L, B, Nq, Nk, T, D, N, P, step, window, 4)
    want = jattn.sdpa_decode_frozen(
        jnp.asarray(q), jnp.asarray(ks[0]), jnp.asarray(vs[0]),
        jnp.asarray(kv_pos), jnp.asarray(valid), jnp.asarray(ki),
        jnp.asarray(vi), jnp.asarray(step, jnp.int32), jnp.asarray(q_pos),
        sliding_window=window)
    got = tattn.sdpa_decode_frozen(_t(q), _t(ks[0]), _t(vs[0]), _t(kv_pos),
                                   _t(valid), _t(ki), _t(vi), step, _t(q_pos),
                                   sliding_window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # and the kernel's plain version agrees with the oracle
    kern = tak.flash_decode_frozen(_t(q[:, 0]), _t(ks), _t(vs), _t(mask),
                                   _t(ki), _t(vi), 0, step, D ** -0.5, window)
    np.testing.assert_allclose(kern.numpy(), got[:, 0].numpy(), **TOL)


def test_fully_masked_rows_are_zero():
    """A query row that sees no slot gives 0 in both kernels (safe_l)."""
    q = torch.randn(1, 2, 4, 64)
    k = torch.randn(1, 1, 8, 64)
    valid = torch.zeros(1, 8, dtype=torch.bool)
    assert not tak.flash_prefill(q, k, k, valid, 0.125).any()
    ks = torch.randn(1, 1, 1, 8, 64)
    out = tak.flash_decode_frozen(q[:, :, 0], ks, ks, valid,
                                  torch.randn(1, 1, 4, 64),
                                  torch.randn(1, 1, 4, 64), 0, 0, 0.125,
                                  window=None)
    assert out.abs().sum() > 0  # the in-flight slot 0 stays visible
    q1 = torch.randn(1, 2, 64)
    out = tak.flash_decode_frozen_plain(q1, ks, ks, valid, torch.randn(1, 1, 4, 64),
                                        torch.randn(1, 1, 4, 64), 0, 0, 0.125)
    assert torch.isfinite(out).all()


def test_no_fallback_off_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device gets no
    plain version and no launch: the wrapper raises."""
    q = torch.empty(1, 2, 4, 64, device="meta")
    k = torch.empty(1, 1, 8, 64, device="meta")
    valid = torch.empty(1, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tak.flash_prefill(q, k, k, valid, 0.125)
    with pytest.raises(ValueError, match="no kernel"):
        tak.flash_decode_frozen(q[:, :, 0], k[None], k[None], valid,
                                k[:, :, :4], k[:, :, :4], 0, 0, 0.125)


def test_cpu_calls_do_not_count_as_launches():
    tak.reset_launches()
    q = torch.randn(1, 2, 4, 64)
    k = torch.randn(1, 1, 8, 64)
    tak.flash_prefill(q, k, k, torch.ones(1, 8, dtype=torch.bool), 0.125)
    assert sum(tak.LAUNCHES.values()) == 0


# -- shapes the kernels take, checked at start ------------------------------------


def _cfg(Nq, Nk, D, model_type="llama"):
    from tinygpt_tpu_torch.hf.config import parse_model_config

    return parse_model_config(dict(
        model_type=model_type, vocab_size=101, hidden_size=Nq * D, intermediate_size=128,
        num_hidden_layers=1, num_attention_heads=Nq, num_key_value_heads=Nk,
        max_position_embeddings=64, head_dim=D))


@pytest.mark.parametrize("Nq,Nk,D", [(128, 8, 128),   # Llama-3.1-405B's heads: G = 16
                                     (64, 8, 128),    # G = 8 (8 drafts: S * G = 72)
                                     (12, 12, 64),    # GPT-2's
                                     (32, 8, 64)])
def test_check_kernel_shapes_accepts_what_the_kernels_take(Nq, Nk, D):
    """A pure function of the config: it decides without a card."""
    tak.check_kernel_shapes(_cfg(Nq, Nk, D), "cuda")


@pytest.mark.parametrize("Nq,Nk,D,match", [(4, 2, 96, "head dim 96"),
                                           (34, 2, 64, "17 query heads per KV head"),
                                           (6, 4, 64, "6 query heads over 4")])
def test_check_kernel_shapes_rejects_on_the_card_only(Nq, Nk, D, match):
    cfg = _cfg(Nq, Nk, D)
    with pytest.raises(ValueError, match=match):
        tak.check_kernel_shapes(cfg, torch.device("cuda"))
    tak.check_kernel_shapes(cfg, "cpu")  # the plain versions take any shape


def test_prepare_and_the_batcher_check_shapes_at_start(tmp_path, monkeypatch):
    """GPTEngine.prepare() refuses a head dim of 96 for the card before it
    loads a weight (so without a card here), and ContinuousBatcher's
    constructor checks its config on its params' device."""
    from tinygpt_tpu_torch.engine import scheduler
    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
    from tinygpt_tpu_torch.models import get_model
    from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

    d = write_random_model_dir(str(tmp_path / "d96"), dict(
        model_type="llama", vocab_size=300, hidden_size=192, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64), dtype=torch.float32)
    with pytest.raises(ValueError, match="head dim 96"):
        GPTEngine(GPTConfig(model_dir=d, device="cuda")).prepare()
    eng = GPTEngine(GPTConfig(model_dir=d, device="cpu", dtype="float32"))
    eng.prepare()  # the CPU takes it
    seen = []
    monkeypatch.setattr(scheduler, "check_kernel_shapes",
                        lambda cfg, dev: seen.append((cfg.head_dim, torch.device(dev))))
    cfg = eng.ctx.model_config
    scheduler.ContinuousBatcher(get_model("llama"), cfg, eng.ctx.params, eos_ids=set(),
                                config=scheduler.SchedulerConfig(dtype="float32"))
    assert seen == [(96, torch.device("cpu"))]
