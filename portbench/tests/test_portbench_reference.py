"""The plain reference against the program on a 2-layer model on the CPU,
in fp32: the same int4 weights through causal_lm.forward and through
reference/mistral.py give the same logits, dense and MoE (the program's
MoE prefill dequantizes the experts to bf16 even for fp32 activations, as
the JAX package does; here it is made to keep them in fp32, so that a
router near-tie cannot part the two). And the
reference's int4 unpacking against the program's, byte for byte."""

import numpy as np
import pytest
import torch

from portbench.weights import int4
from portbench.weights import mistral as weights
from portbench.reference import mistral as ref


def _cfg(moe: bool) -> dict:
    cfg = dict(model_type="mixtral" if moe else "mistral", vocab_size=1000,
               hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=512, rope_theta=1e6, rms_norm_eps=1e-5,
               sliding_window=None, tie_word_embeddings=False,
               quantization=dict(group_size=64), reference="mistral")
    if moe:
        cfg.update(num_local_experts=4, num_experts_per_tok=2)
    return cfg


def _to_fp32(w):
    return {k: (tuple(x.float() if x.dtype == torch.bfloat16 else x for x in v)
                if isinstance(v, tuple) else
                v.float() if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                else v) for k, v in w.items()}


@pytest.mark.parametrize("moe", [False, True])
def test_reference_matches_the_program_in_fp32(moe, monkeypatch):
    from portbench.systems.causal_lm import model_config, program_params
    from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
    from tinygpt_tpu_torch.models import causal_lm

    fp32 = causal_lm.dequantize
    monkeypatch.setattr(causal_lm, "dequantize", lambda qt, dtype=None: fp32(qt, torch.float32))

    cfg = _cfg(moe)
    w = _to_fp32(weights.make_weights(cfg, 2 ** 40 + 3, "cpu"))
    mc = model_config(cfg)
    params = program_params(cfg, w, "cpu")
    rng = np.random.default_rng(0)
    seqs = [rng.integers(3, 1000, n).tolist() for n in (37, 64)]
    with torch.inference_mode():
        want = ref.logits_at(cfg, w, seqs, [0, 10])
        for s, start, lw in zip(seqs, [0, 10], want):
            S = len(s)
            cache = create_kv_cache(mc, 1, S, dtype=torch.float32, device="cpu")
            ids = torch.tensor([s])
            pos = torch.arange(S)[None]
            got, _ = causal_lm.forward(params, mc, ids, cache, pos,
                                       torch.ones(1, S, dtype=torch.bool), attn_impl="plain")
            assert got.shape[1] == S
            err = (got[0, start:] - lw).abs().max().item()
            assert err < 1e-3 * lw.abs().max().item(), err


def test_unpacking_matches_the_programs():
    from tinygpt_tpu_torch.ops.quant import QuantizedTensor, dequantize

    g = torch.Generator().manual_seed(1)
    data, scales = int4.int4_stack(g, (3,), 256, 96, 64, "cpu")
    mine = ref.dequant_int4(data, scales, 64)
    theirs = dequantize(QuantizedTensor(data, scales, 4, 64, 256), torch.float32)
    assert torch.equal(mine, theirs)
    q = torch.cat([(data.view(torch.uint8) & 15), data.view(torch.uint8) >> 4], dim=-2)
    assert int(q.min()) >= 1 and int(q.max()) <= 15        # q = u - 8 in -7..7


def test_weights_repeat_from_a_seed_and_pad_the_head():
    cfg = dict(_cfg(False), vocab_size=3000)
    a = weights.make_weights(cfg, 5, "cpu")
    b = weights.make_weights(cfg, 5, "cpu")
    assert torch.equal(a["qkv"][0], b["qkv"][0]) and torch.equal(a["embed"], b["embed"])
    data, scales = a["head"]
    assert data.shape[-1] == 4096 and scales.shape[-1] == 4096
    pad = ref.dequant_int4(data, scales, 64)[:, 3000:]
    assert float(pad.abs().max()) == 0.0
    w = ref.dequant_int4(*a["gate_up"], 64)
    assert 0.015 < float(w.std()) < 0.025


def test_moe_routing_follows_each_tokens_pair(monkeypatch):
    """The MoE weights route each token to the experts of its own pair of
    routing coordinates in every layer (weights/mistral.py), the fact that
    readers.distinct_experts counts by: in each layer, the reference's
    top-2 experts of the tokens name as many experts as their pairs name
    coordinates, and tokens with one pair share their experts. Routing is
    exact: each token's logits are positive at its two experts and 0 at
    every other, since no layer writes the routing coordinates."""
    cfg = _cfg(True)
    w = weights.make_weights(cfg, 77, "cpu")
    seq = np.random.default_rng(1).integers(3, 1000, 60).tolist()
    seen = []
    real = ref._moe

    def moe(h, router, *a, **k):
        logits = h @ router.float()
        assert torch.equal((logits > 0).sum(dim=-1), torch.full((len(h),), 2))
        assert int((logits != 0).sum()) == 2 * len(h)
        seen.append(torch.topk(torch.softmax(logits, dim=-1), 2).indices)
        return real(h, router, *a, **k)

    E = cfg["num_local_experts"]
    for key in ("o", "moe_down"):
        assert float(ref.dequant_int4(*w[key], 64)[..., :E].abs().max()) == 0.0
    monkeypatch.setattr(ref, "_moe", moe)
    ref.logits_at(cfg, w, [seq], [0])
    pairs = w["route_pairs"][seq]
    for idx in seen:
        assert len(set(idx.flatten().tolist())) == len(set(pairs.flatten().tolist()))
        by_pair = {}
        for p, e in zip(map(tuple, np.sort(pairs, 1)), idx.sort(dim=1).values.tolist()):
            assert by_pair.setdefault(p, e) == e
