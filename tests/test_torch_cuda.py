"""The Hopper kernels against their plain PyTorch versions on a CUDA card.

Every test here needs the card and skips without one. The file imports
torch and the port only, so on the H100 it runs without JAX and without
the repository's conftest:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

The cases reach the edges that chip_smoke.py's main-path shapes do not:
one query row, caches that end inside a tile, 1 to 16 query heads per KV
head (more than 8 split over blocks), more than 64 verify rows per KV
head (K10), windows narrower than a tile, query rows that see no slot, and every
dtype the kernels take, e4m3 caches and pools included (decoded exactly,
so the same tolerances hold). Both sides compute in fp32 from the same inputs
in another order, then round the output once: tolerance 1e-4 in fp32,
one ulp of an output below 2 in fp16 (4e-3) and bf16 (2e-2).
"""

import pytest
import torch

from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
from tinygpt_tpu_torch.hf.config import parse_model_config
from tinygpt_tpu_torch.models import causal_lm
from tinygpt_tpu_torch.ops import attention_kernels as ak

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.float16: 4e-3, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype, dev):
    return torch.randn(shape, generator=gen).to(dtype).to(dev)


def _max_err(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err == err, "NaN in the kernel's output"
    return err


PREFILL_CASES = [
    # (D, dtype, Nq, Nk, S, T, pads, q_slot, window)
    (64, torch.float32, 4, 4, 1, 9, (0, 3), 8, None),        # one row, G = 1
    (128, torch.bfloat16, 8, 2, 7, 70, (0, 5, 69), 63, None),  # rows that see nothing
    (64, torch.float16, 8, 1, 130, 200, (0, 50), 70, 5),     # G = 8, narrow window
    (128, torch.float32, 32, 8, 65, 65, (0, 64), 0, 64),
    (64, torch.bfloat16, 6, 2, 100, 300, (10, 0), 200, 17),  # G = 3
]


@pytest.mark.parametrize("case", PREFILL_CASES)
def test_flash_prefill_kernel_matches_plain(dev, case):
    D, dtype, Nq, Nk, S, T, pads, q_slot, window = case
    gen = torch.Generator().manual_seed(0)
    B = len(pads)
    q = _randn(gen, B, Nq, S, D, dtype=dtype, dev=dev)
    k = _randn(gen, B, Nk, T, D, dtype=dtype, dev=dev)
    v = _randn(gen, B, Nk, T, D, dtype=dtype, dev=dev)
    slots = torch.arange(T, device=dev)[None, :]
    pad = torch.tensor(pads, device=dev)[:, None]
    valid = (slots >= pad) & (slots < q_slot + S)
    args = (q, k, v, valid, D ** -0.5, q_slot, window)
    ak.reset_launches()
    got = ak.flash_prefill(*args)
    assert ak.LAUNCHES["flash_prefill"] == 1
    want = ak.flash_prefill_plain(*args)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= TOL[dtype]
    for b, p in enumerate(pads):  # rows before the first real slot
        assert not got[b, :, : max(0, p - q_slot)].any()


DECODE_CASES = [
    # (D, dtype, Nq, Nk, L, T, N, pads, length, step, window)
    (64, torch.float32, 4, 4, 2, 1, 1, (0, 1), 1, 0, None),      # G = 1, T = 1
    (128, torch.bfloat16, 8, 4, 3, 37, 5, (0, 9, 37), 30, 4, None),  # G = 2, a row sees no frozen slot
    (64, torch.float16, 6, 2, 2, 300, 32, (0, 200), 290, 31, 50),    # G = 3
    (128, torch.float32, 10, 2, 2, 130, 32, (3, 0), 129, 0, 3),      # G = 5, window < step
    (128, torch.bfloat16, 8, 1, 4, 300, 16, (0, 100), 300, 15, 20),  # G = 8
    (128, torch.bfloat16, 128, 8, 2, 200, 8, (0, 77), 150, 7, None),  # G = 16: 2 blocks a head
    (64, torch.float32, 24, 2, 2, 100, 4, (5, 0), 90, 3, 30),        # G = 12: 2 blocks of 6
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_frozen_kernel_matches_plain(dev, case):
    D, dtype, Nq, Nk, L, T, N, pads, length, step, window = case
    gen = torch.Generator().manual_seed(1)
    B = len(pads)
    ks = _randn(gen, L, B, Nk, T, D, dtype=dtype, dev=dev)
    vs = _randn(gen, L, B, Nk, T, D, dtype=dtype, dev=dev)
    ki = _randn(gen, B, Nk, N, D, dtype=dtype, dev=dev)
    vi = _randn(gen, B, Nk, N, D, dtype=dtype, dev=dev)
    q = _randn(gen, B, Nq, D, dtype=dtype, dev=dev)
    slots = torch.arange(T, device=dev)[None, :]
    pad = torch.tensor(pads, device=dev)[:, None]
    valid = (slots >= pad) & (slots < length)
    kv_pos = (slots - pad).clamp(min=0)
    pos = length - pad + step
    mask = valid & (kv_pos <= pos)
    if window:
        mask &= kv_pos > pos - window
    for l in range(L):
        args = (q, ks, vs, mask, ki, vi, l, step, D ** -0.5, window)
        ak.reset_launches()
        got = ak.flash_decode_frozen(*args)
        assert ak.LAUNCHES["flash_decode_frozen"] == 1
        want = ak.flash_decode_frozen_plain(*args)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= TOL[dtype], f"layer {l}"


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros(1, 4, 8, 96, device=dev)
    k = torch.zeros(1, 2, 8, 96, device=dev)
    valid = torch.ones(1, 8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ak.flash_prefill(q, k, k, valid, 0.1)
    q, k = q[..., :64].contiguous(), k[..., :64].contiguous()
    with pytest.raises(TypeError, match="dtype"):
        ak.flash_prefill(q, k.half(), k.half(), valid, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ak.flash_prefill(q, k.transpose(2, 3).contiguous().transpose(2, 3), k,
                         valid, 0.1)
    with pytest.raises(ValueError, match="do not fit"):
        ak.flash_prefill(q, k, k, valid, 0.1, q_slot=1)
    qd = torch.zeros(1, 34, 64, device=dev)  # 17 query heads per KV head
    ks = torch.zeros(1, 1, 2, 8, 64, device=dev)
    ki = torch.zeros(1, 2, 4, 64, device=dev)
    with pytest.raises(ValueError, match="at most"):
        ak.flash_decode_frozen(qd, ks, ks, valid, ki, ki, 0, 0, 0.1)
    with pytest.raises(ValueError, match="out of range"):
        ak.flash_decode_frozen(qd[:, :4], ks, ks, valid, ki, ki, 0, 4, 0.1)


def test_model_on_the_card_matches_the_cpu(dev):
    """A 2-layer fp32 model with a window: prefill logits and two greedy
    decode chunks through the kernels on the card against the same
    params through the plain versions on the CPU (logits within 1e-4)."""
    cfg = parse_model_config(dict(
        model_type="mistral", vocab_size=211, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256, sliding_window=9))
    params = causal_lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(2)
    S, lens, chunk = 24, (24, 13, 1), 6
    ids = torch.randint(3, cfg.vocab_size, (len(lens), S), generator=gen)
    pad = torch.tensor([S - n for n in lens])[:, None]
    slots = torch.arange(S)[None, :]
    valid = slots >= pad
    positions = torch.where(valid, slots - pad, 0).to(torch.int32)

    def run(device):
        p = {k: v.to(device) if isinstance(v, torch.Tensor) else
             ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict) else v)
             for k, v in params.items()}
        cache = create_kv_cache(cfg, len(lens), S + 2 * chunk,
                                dtype=torch.float32, device=device)
        logits, cache = causal_lm.forward(
            p, cfg, ids.to(device), cache, positions.to(device),
            valid.to(device), last_only=True)
        tok = logits[:, -1].argmax(-1)
        toks = []
        for c in range(2):
            pos0 = torch.tensor(lens, device=device)[:, None] + c * chunk
            out, cache = causal_lm.decode_steps(p, cfg, tok, cache, pos0, chunk,
                                                lambda lg: lg.argmax(-1))
            toks.append(out)
            tok = out[-1]
        return logits.cpu(), torch.cat(toks).cpu()

    lg_cpu, toks_cpu = run("cpu")
    ak.reset_launches()
    lg_gpu, toks_gpu = run(dev)
    assert dict(ak.LAUNCHES) == {"flash_prefill": 2, "flash_decode_frozen": 2 * 2 * chunk}
    assert _max_err(lg_gpu, lg_cpu) <= 1e-4
    assert torch.equal(toks_gpu, toks_cpu)


# -- int4 dequant-matmul kernels (K4, K5b, K6, K7) -------------------------------
#
# Kernel and plain version dequantize the same bytes exactly in fp32 and sum
# in fp32 in another order (the tensor-core path splits fp32 activations into
# two bf16 parts, exact to about 2^-17), then round once. Tolerance, relative
# to the largest output: 1e-4 in fp32, one bf16 ulp (2^-7) in bf16.

from tinygpt_tpu_torch.ops import quant_kernels as qk  # noqa: E402
from tinygpt_tpu_torch.ops.quant import pad_x_to, quantize_weight  # noqa: E402

QTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


def _qclose(got, want, dtype, what=""):
    err = _max_err(got, want)
    scale = want.float().abs().max().item()
    assert err <= QTOL[dtype] * scale, (what, err, scale)


def _qweight(gen, L, IN, OUT, group, dev):
    w = torch.randn((L, IN, OUT), generator=gen) * 0.05
    qt = quantize_weight(w, bits=4, group_size=group)
    return qt.data.to(dev), qt.scales.to(dev), qt.group_size, qt.in_dim


MATMUL_CASES = [
    # (M, IN, OUT, group, L, dtype): IN 192 and 320 are row-padded to 256 / 512
    (1, 256, 384, 64, 2, torch.float32),
    (3, 192, 200, 64, 1, torch.bfloat16),
    (4, 4096, 1024, 64, 2, torch.bfloat16),
    (5, 512, 136, 32, 3, torch.float32),
    (32, 320, 256, 128, 2, torch.bfloat16),
    (33, 256, 384, 64, 2, torch.float32),
    (100, 192, 200, 64, 2, torch.bfloat16),
    (200, 1024, 520, 64, 2, torch.float32),
    (257, 4096, 256, 64, 1, torch.bfloat16),
]


@pytest.mark.parametrize("case", MATMUL_CASES)
def test_int4_matmul_kernels_match_plain(dev, case):
    M, IN, OUT, group, L, dtype = case
    gen = torch.Generator().manual_seed(3)
    data, scales, g, in_p = _qweight(gen, L, IN, OUT, group, dev)
    x = pad_x_to(_randn(gen, M, IN, dtype=dtype, dev=dev), in_p).contiguous()
    for l in range(L):
        ak.reset_launches()
        got = qk.matmul_dequant_int4_stacked(x, data, scales, l, g)
        assert ak.LAUNCHES["matmul_dequant_int4_stacked"] == 1
        want = qk.matmul_dequant_int4_stacked_plain(x, data, scales, l, g)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (M, OUT)
        _qclose(got, want, dtype, f"K5b layer {l}")
    got = qk.matmul_dequant_int4(x, data[0], scales[0], g)
    assert ak.LAUNCHES["matmul_dequant_int4"] == 1
    _qclose(got, qk.matmul_dequant_int4_plain(x, data[0], scales[0], g), dtype, "K4")


FUSED_CASES = [
    # (variant, M, IN, Nq, Nk, D, dtype); OUT = (Nq + 2 Nk) * D, so the
    # q || k / v boundary is at column (Nq + Nk) * D: 896 and 5120 fall
    # inside the TPU kernel's output tiles, and here the RoPE tiles are
    # single heads gated by their first column
    ("ln", 4, 256, 3, 1, 128, torch.float32),
    ("ln", 7, 192, 3, 1, 64, torch.bfloat16),              # padded rows
    ("silu_res", 4, 320, 2, 1, 64, torch.bfloat16),        # padded per segment
    ("silu_res", 1, 256, 3, 1, 128, torch.float32),
    ("ln_bias", 4, 256, 3, 1, 128, torch.bfloat16),
    ("ln_rope", 4, 256, 6, 1, 128, torch.float32),
    ("ln_rope", 4, 4096, 32, 8, 128, torch.bfloat16),     # Mistral-7B qkv
    ("ln_rope", 9, 192, 4, 2, 64, torch.bfloat16),
    ("ln_rope", 2, 256, 4, 2, 32, torch.float32),
    ("ln_bias_rope_qk", 4, 256, 6, 2, 128, torch.float32),
    ("ln_rope_qk", 4, 2048, 16, 8, 128, torch.bfloat16),  # qwen3-1.7B qkv
    ("ln_rope_qk", 3, 256, 4, 2, 64, torch.bfloat16),
]


@pytest.mark.parametrize("case", FUSED_CASES)
def test_int4_fused_kernel_matches_plain(dev, case):
    variant, M, IN, Nq, Nk, D, dtype = case
    gen = torch.Generator().manual_seed(4)
    L, OUT = 2, (Nq + 2 * Nk) * D
    data, scales, g, _ = _qweight(gen, L, IN, OUT, 64, dev)
    x = _randn(gen, M, 2 * IN if variant == "silu_res" else IN, dtype=dtype, dev=dev)
    kw = {}
    if variant.startswith("ln"):
        kw["ln"] = (1 + 0.1 * torch.randn((L, 1, IN), generator=gen)).to(dtype).to(dev)
        kw["invrms"] = torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + 1e-5)
    if variant == "silu_res":
        kw.update(silu=True, res=_randn(gen, M, OUT, dtype=dtype, dev=dev))
    if "bias" in variant:
        kw["bias"] = _randn(gen, L, 1, OUT, dtype=dtype, dev=dev)
    if "rope" in variant:
        ang = torch.rand((M, D // 2), generator=gen) * 6.3
        kw.update(rope_cos=torch.cat([ang.cos()] * 2, -1).to(dev),
                  rope_sin=torch.cat([ang.sin()] * 2, -1).to(dev),
                  rope_heads=Nq + Nk, rope_dim=D)
    if "qk" in variant:
        kw.update(qk_norm_w=tuple((1 + 0.1 * torch.randn((L, D), generator=gen))
                                  .to(dtype).to(dev) for _ in range(2)),
                  qk_heads=Nq, eps=1e-6)
    for l in range(L):
        ak.reset_launches()
        got = qk.matmul_dequant_int4_stacked_fused(x, data, scales, l, g, **kw)
        assert ak.LAUNCHES["matmul_dequant_int4_stacked_fused"] == 1
        want = qk.matmul_dequant_int4_stacked_fused_plain(x, data, scales, l, g, **kw)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (M, OUT)
        _qclose(got, want, dtype, f"{variant} layer {l}")


@pytest.mark.parametrize("M,H,I,dtype", [(4, 1024, 3072, torch.bfloat16),
                                         (1, 256, 320, torch.float32),
                                         (7, 192, 512, torch.bfloat16),
                                         (32, 512, 768, torch.float32)])
def test_int4_mlp_kernel_matches_plain(dev, M, H, I, dtype):
    gen = torch.Generator().manual_seed(5)
    L = 2
    gu, gus, g, _ = _qweight(gen, L, H, 2 * I, 64, dev)
    dn, dns, _, _ = _qweight(gen, L, I, H, 64, dev)
    x = _randn(gen, M, H, dtype=dtype, dev=dev)
    ln = (1 + 0.1 * torch.randn((L, H), generator=gen)).to(dtype).to(dev)
    inv = torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + 1e-5)
    for l in range(L):
        ak.reset_launches()
        got = qk.mlp_fused_int4_stacked(x, gu, gus, dn, dns, ln, inv, l, g)
        assert ak.LAUNCHES["mlp_fused_int4_stacked"] == 1
        want = qk.mlp_fused_int4_stacked_plain(x, gu, gus, dn, dns, ln, inv, l, g)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (M, H)
        _qclose(got, want, dtype, f"layer {l}")


def test_int4_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    gen = torch.Generator().manual_seed(6)
    data, scales, g, _ = _qweight(gen, 2, 256, 384, 64, dev)
    x = _randn(gen, 4, 256, dtype=torch.bfloat16, dev=dev)
    with pytest.raises(TypeError, match="dtype"):
        qk.matmul_dequant_int4_stacked(x.half(), data, scales, 0, g)
    with pytest.raises(ValueError, match="contiguous"):
        qk.matmul_dequant_int4_stacked(
            x.t().contiguous().t(), data, scales, 0, g)
    with pytest.raises(ValueError, match="expected"):
        qk.matmul_dequant_int4_stacked(x, data.cpu(), scales, 0, g)
    with pytest.raises(ValueError, match="layer"):
        qk.matmul_dequant_int4_stacked(x, data, scales, 2, g)
    with pytest.raises(ValueError, match="group"):
        qk.matmul_dequant_int4_stacked(x, data, scales.reshape(2, 8, 192), 0, 8)
    with pytest.raises(ValueError, match="rows"):
        qk.matmul_dequant_int4_stacked_fused(
            _randn(gen, 33, 256, dtype=torch.bfloat16, dev=dev), data, scales, 0, g)
    with pytest.raises(ValueError, match="RoPE"):
        c = torch.zeros(4, 96, device=dev)
        qk.matmul_dequant_int4_stacked_fused(x, data, scales, 0, g, rope_cos=c,
                                             rope_sin=c, rope_heads=1, rope_dim=96)
    dn, dns, _, _ = _qweight(gen, 2, 192, 256, 64, dev)  # I = 384 / 2
    ln = torch.ones(2, 256, device=dev, dtype=torch.bfloat16)
    inv = torch.ones(4, 1, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        qk.mlp_fused_int4_stacked(x.float(), data, scales, dn, dns, ln, inv, 0, g)
    with pytest.raises(ValueError, match="do not fit"):
        qk.mlp_fused_int4_stacked(x, data, scales, dn, dns, ln[:, :128], inv, 0, g)


# -- paged frozen-pool decode (K8) ------------------------------------------------
#
# Both sides compute in fp32 from the same inputs in another order and round
# the output once, so they differ by at most one ulp of an output: K2's TOL,
# and in bf16 no more than one ulp of the largest output (2^-7 of it), which
# at the serving shape (outputs below 0.5) is under 4e-3. Dead table entries
# point to the null block 0; "poisoned" cases fill block 0 with NaN, which a
# kernel that read a dead entry, or let a masked slot in as 0 * value, would
# carry into the output. Inactive rows keep stale lengths over zero tables
# (they read block 0 and nothing out of range).

from tinygpt_tpu_torch.ops import paged_attention as pa  # noqa: E402

PAGED_CASES = [
    # (D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, steps,
    #  window, poison)
    (128, torch.bfloat16, 4, 8, 64, 16, 257, 8,            # the serving shape
     tuple(512 + 17 * i for i in range(16)), (0,) * 16, (3, 9), (0, 7), None, False),
    (128, torch.float32, 4, 8, 64, 16, 257, 8,
     tuple(512 + 17 * i for i in range(16)), (0,) * 16, (), (0, 7), None, True),
    (64, torch.float32, 1, 4, 16, 8, 40, 4, (1, 17, 100, 128), (0, 5, 20, 0), (),
     (0, 3), 20, True),
    (128, torch.float16, 8, 1, 32, 4, 9, 8, (33, 64, 0), (0, 0, 0), (), (0, 7), None,
     True),
    (64, torch.bfloat16, 3, 2, 64, 3, 10, 5, (190, 64, 65), (0, 0, 10), (), (4,), 3,
     True),
    (128, torch.float32, 2, 2, 16, 4, 20, 6, (60, 33, 1000), (0, 0, 0), (2,), (0, 5),
     40, False),                                          # stale length > MB * bs
    (128, torch.bfloat16, 16, 8, 64, 4, 40, 4, (200, 37, 129), (0, 0, 3), (), (0, 3),
     None, True),                                         # G = 16 (Llama-3.1-405B)
    (64, torch.float16, 10, 1, 16, 6, 20, 4, (90, 17), (2, 0), (), (1,), 33, True),  # G = 10
]


def _paged_case(dev, D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts,
                inactive, poison, L=2, seed=3):
    gen = torch.Generator().manual_seed(seed)
    B = len(lengths)
    kp = _randn(gen, L, n_blocks, Nk, bs, D, dtype=dtype, dev=dev)
    vp = _randn(gen, L, n_blocks, Nk, bs, D, dtype=dtype, dev=dev)
    if poison:
        kp[:, 0] = float("nan")
        vp[:, 0] = float("nan")
    tables = torch.zeros(B, MB, dtype=torch.int32)
    ids = (torch.randperm(n_blocks - 1, generator=gen) + 1).tolist()
    for b in range(B):
        if b in inactive:
            continue
        nb = -(-lengths[b] // bs)
        tables[b, :nb] = torch.tensor(ids[:nb], dtype=torch.int32)
        ids = ids[nb:]
    q = _randn(gen, B, Nk * G, D, dtype=dtype, dev=dev)
    ki = _randn(gen, B, Nk, N, D, dtype=dtype, dev=dev)
    vi = _randn(gen, B, Nk, N, D, dtype=dtype, dev=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return (q, kp, vp, tables.to(dev), torch.tensor(lengths, **i32),
            torch.tensor(starts, **i32), ki, vi)


def _paged_tol(dtype, want):
    if dtype == torch.bfloat16:
        return min(TOL[dtype], 2.0 ** -7 * want.float().abs().max().item())
    return TOL[dtype]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_decode_frozen_kernel_matches_plain(dev, case):
    D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, steps, window, \
        poison = case
    q, kp, vp, tables, lens, sts, ki, vi = _paged_case(
        dev, D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, poison)
    for step in steps:
        for l in range(kp.shape[0]):
            args = (q, kp, vp, tables, lens, sts, ki, vi, l, step, D ** -0.5, window)
            ak.reset_launches()
            got = pa.paged_decode_frozen(*args)
            assert ak.LAUNCHES["paged_decode_frozen"] == 1
            want = pa.paged_decode_frozen_plain(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(want).all())
            assert _max_err(got, want) <= _paged_tol(dtype, want), f"step {step} layer {l}"


def test_paged_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q, kp, vp, tables, lens, sts, ki, vi = _paged_case(
        dev, 64, torch.float32, 2, 2, 16, 4, 9, 4, (20, 5), (0, 0), (), False)
    with pytest.raises(ValueError, match="out of range"):
        pa.paged_decode_frozen(q, kp, vp, tables, lens, sts, ki, vi, 0, 4, 0.1)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_decode_frozen(q, kp, vp, tables.long(), lens, sts, ki, vi, 0, 0, 0.1)
    with pytest.raises(ValueError, match="at most"):
        pa.paged_decode_frozen(q.repeat(1, 9, 1), kp, vp, tables, lens, sts, ki, vi,
                               0, 0, 0.1)
    # e4m3 pools take bf16 in-flight K/V, and both pools one dtype
    kp8 = kp.to(torch.float8_e4m3fn)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_decode_frozen(q, kp8, kp8, tables, lens, sts, ki, vi, 0, 0, 0.1)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_decode_frozen(q, kp8, vp, tables, lens, sts, ki.bfloat16(), vi.bfloat16(),
                               0, 0, 0.1)
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        pa.paged_decode_frozen(q, kp.half(), vp.half(), tables, lens, sts, ki, vi, 0, 0, 0.1)


def _card_cfg(max_position_embeddings=256):
    return parse_model_config(dict(
        model_type="mistral", vocab_size=211, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=max_position_embeddings,
        sliding_window=9))


def _batcher_streams(cfg, params, device, impl, prompts, max_new):
    """Greedy streams of a 3-row batcher (block 16, 6 blocks a row), one
    arrival per scheduler step; max_new[i] tokens for request i."""
    from tinygpt_tpu_torch.engine.scheduler import (
        ContinuousBatcher,
        Request,
        SchedulerConfig,
    )
    from tinygpt_tpu_torch.models import get_model

    p = {k: v.to(device) if isinstance(v, torch.Tensor) else
         ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict) else v)
         for k, v in params.items()}
    b = ContinuousBatcher(get_model("mistral"), cfg, p, eos_ids=set(),
                          config=SchedulerConfig(
                              batch_capacity=3, block_size=16, n_blocks=32,
                              max_blocks_per_seq=6, prefill_bucket=16,
                              dtype="float32", decode_quantum=4, attn_impl=impl))
    got, pending = {}, list(enumerate(prompts))
    while b.has_work or pending:
        if pending:
            i, pr = pending.pop(0)
            b.add_request(Request(request_id=i, prompt_ids=pr, max_new_tokens=max_new[i]))
        for ev in b.step():
            if ev.token_id is not None:
                got.setdefault(ev.request_id, []).append(ev.token_id)
    return got


def test_batcher_on_the_card_matches_the_cpu(dev):
    """The continuous batcher on the card (kernel route: K1 at admission,
    K8 in every decode step) against the same params through the plain
    versions on the CPU: identical greedy streams for staggered requests,
    more requests than rows, two sharing a prefix block."""
    cfg = _card_cfg()
    params = causal_lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(4)
    prefix = torch.randint(3, cfg.vocab_size, (16,), generator=gen).tolist()
    prompts = [prefix + torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (3, 30)]
    prompts += [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
                for n in (1, 40, 7)]
    max_new = [10] * len(prompts)
    want = _batcher_streams(cfg, params, "cpu", "plain", prompts, max_new)
    ak.reset_launches()
    got = _batcher_streams(cfg, params, dev, "kernel", prompts, max_new)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["paged_decode_frozen"] > 0 and ak.LAUNCHES["flash_prefill"] > 0
    assert got == want


def test_batcher_at_the_context_cap_on_the_card(dev):
    """A row's pool range (6 blocks of 16) equals the context (96): the
    request that fills it runs its pipelined quanta past position 95 and is
    released while another row decodes on. No device assert, and the
    streams equal the plain route's on the CPU."""
    cfg = _card_cfg(max_position_embeddings=96)
    params = causal_lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in (90, 5)]
    max_new = [6, 40]
    want = _batcher_streams(cfg, params, "cpu", "plain", prompts, max_new)
    got = _batcher_streams(cfg, params, dev, "kernel", prompts, max_new)
    torch.cuda.synchronize()
    assert [len(got[i]) for i in (0, 1)] == max_new
    assert got == want


# -- int8 dequant-matmul kernels (K3, K5a) ----------------------------------------
#
# As the int4 kernels: the same bytes dequantized exactly in fp32 (q * s,
# rounded once), fp32 sums in another order, one rounding; QTOL. int8 rows
# are never padded, so IN is any multiple of the group: 896 (7 groups of
# 128), 64 and 80 split unevenly over the GEMV's 8 blocks (some get none);
# 80 and 896 leave a last tensor-core stage shorter than 64 rows.

INT8_CASES = [
    # (M, IN, OUT, group, L, dtype)
    (1, 64, 64, 64, 2, torch.float32),
    (4, 896, 256, 128, 2, torch.bfloat16),
    (4, 4096, 6144, 128, 3, torch.bfloat16),      # Mistral-7B qkv
    (5, 80, 24, 16, 2, torch.float32),
    (32, 14336, 4096, 128, 2, torch.bfloat16),    # Mistral-7B down
    (33, 896, 136, 128, 2, torch.float32),
    (100, 64, 200, 32, 3, torch.bfloat16),
    (257, 80, 264, 16, 2, torch.bfloat16),
    (2048, 4096, 1024, 128, 2, torch.bfloat16),   # prefill-shaped
    (300, 14336, 512, 128, 2, torch.float32),
]


def _q8weight(gen, L, IN, OUT, group, dev):
    qt = quantize_weight(torch.randn((L, IN, OUT), generator=gen) * 0.05, bits=8,
                         group_size=group)
    assert qt.in_dim == IN
    return qt.data.to(dev), qt.scales.to(dev), qt.group_size


@pytest.mark.parametrize("case", INT8_CASES)
def test_int8_matmul_kernels_match_plain(dev, case):
    M, IN, OUT, group, L, dtype = case
    gen = torch.Generator().manual_seed(7)
    data, scales, g = _q8weight(gen, L, IN, OUT, group, dev)
    x = _randn(gen, M, IN, dtype=dtype, dev=dev)
    for l in range(L):  # every layer: the offset of layer l > 0 into the stack
        ak.reset_launches()
        got = qk.matmul_dequant_int8_stacked(x, data, scales, l, g)
        assert ak.LAUNCHES["matmul_dequant_int8_stacked"] == 1
        want = qk.matmul_dequant_int8_stacked_plain(x, data, scales, l, g)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (M, OUT)
        _qclose(got, want, dtype, f"K5a layer {l}")
    got = qk.matmul_dequant_int8(x, data[L - 1], scales[L - 1], g)
    assert ak.LAUNCHES["matmul_dequant_int8"] == 1
    _qclose(got, qk.matmul_dequant_int8_plain(x, data[L - 1], scales[L - 1], g), dtype,
            "K3")


def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """No fallback: an fp16 activation and a weight left on the CPU raise,
    as do shapes the kernels do not take."""
    gen = torch.Generator().manual_seed(8)
    data, scales, g = _q8weight(gen, 2, 256, 384, 64, dev)
    x = _randn(gen, 4, 256, dtype=torch.bfloat16, dev=dev)
    with pytest.raises(TypeError, match="dtype"):
        qk.matmul_dequant_int8_stacked(x.half(), data, scales, 0, g)
    with pytest.raises(TypeError, match="dtype"):
        qk.matmul_dequant_int8(x.half(), data[0], scales[0], g)
    with pytest.raises(ValueError, match="expected"):
        qk.matmul_dequant_int8_stacked(x, data.cpu(), scales, 0, g)
    with pytest.raises(ValueError, match="expected"):
        qk.matmul_dequant_int8(x, data[0], scales[0].cpu(), g)
    with pytest.raises(ValueError, match="layer"):
        qk.matmul_dequant_int8_stacked(x, data, scales, 2, g)
    with pytest.raises(ValueError, match="group"):
        qk.matmul_dequant_int8_stacked(x, data, scales, 0, 24)
    with pytest.raises(ValueError, match="columns"):
        qk.matmul_dequant_int8_stacked(x[:, :128].contiguous(), data, scales, 0, g)


def _model_dir(tmp_path, cfg):
    from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

    return write_random_model_dir(str(tmp_path / "m"), cfg, seed=9, dtype=torch.float32)


_TINY_DIR_CFG = dict(model_type="llama", vocab_size=503, hidden_size=256,
                     intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, max_position_embeddings=256)


def test_int8_engine_on_the_card_matches_the_cpu(dev, tmp_path):
    """GPTEngine(quantization="int8") on the card (K1, K5a and K3 in the
    prefill; K5a, K3 and K2 in decode) against the same dir on the CPU, in
    fp32: identical greedy tokens."""
    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine

    d = _model_dir(tmp_path, _TINY_DIR_CFG)
    kw = dict(model_dir=d, dtype="float32", max_tokens=12, prefill_bucket=16,
              decode_chunk=4, quantization="int8")
    prompts = ["Hello world", "the quick brown fox jumps over the lazy dog"]
    want = GPTEngine(GPTConfig(device="cpu", **kw))
    want.prepare()
    eng = GPTEngine(GPTConfig(device="cuda", **kw))
    eng.prepare()
    ak.reset_launches()
    got = eng.generate_sync(prompts)
    torch.cuda.synchronize()
    for name in ("flash_prefill", "flash_decode_frozen", "matmul_dequant_int8",
                 "matmul_dequant_int8_stacked"):
        assert ak.LAUNCHES[name] > 0, name
    assert [o.token_ids for o in got] == [o.token_ids for o in want.generate_sync(prompts)]


def test_awq_on_the_card_matches_the_cpu(dev, tmp_path):
    """AWQ of a 2-layer model on the card against the CPU, in fp32: the
    calibration statistics within 1e-5 relative, the same alpha for every
    layer and matrix (scales within 1e-5), and the int4 bytes equal up to a
    step in a few places."""
    from tinygpt_tpu_torch.hf.loader import load_model_dir
    from tinygpt_tpu_torch.ops import awq

    d = _model_dir(tmp_path, _TINY_DIR_CFG)
    calib = torch.randint(3, 503, (2, 64), generator=torch.Generator().manual_seed(1))
    out = {}
    for device in ("cpu", "cuda"):
        ctx = load_model_dir(d, dtype="float32", device=device)
        p, cfg = ctx.params, ctx.model_config
        for ln in ("input_ln", "post_ln"):  # salient channels
            p["layers"][ln][:, :4] *= 8
        stats = awq.collect_act_stats(p, cfg, calib.numpy())
        scales = {k: awq.search_scales(p["layers"][k], stats[s], 4, 64).cpu()
                  for k, s in (("qkv_w", "qkv_in"), ("gate_up_w", "gate_up_in"),
                               ("down_w", "down_in"))}
        q = awq.awq_quantize_params(p, cfg, calib.numpy(), bits=4, group_size=64)
        out[device] = ({k: v.cpu() for k, v in stats.items()}, scales,
                       {k: q["layers"][k].data.cpu() for k in scales})
    (st_c, sc_c, q_c), (st_g, sc_g, q_g) = out["cpu"], out["cuda"]
    for k in st_c:
        assert ((st_g[k] - st_c[k]).abs().max() / st_c[k].abs().max()).item() < 1e-5, k
    for k in sc_c:
        assert ((sc_g[k] - sc_c[k]).abs().max()).item() < 1e-5, k
        assert (q_g[k] != q_c[k]).float().mean().item() < 1e-3, k


# -- e4m3 caches (K1, K2, K8) and the speculative verify (K10) ----------------------
#
# An e4m3 cache decodes exactly to fp32 on both sides, so the tolerances
# above hold; beside an e4m3 cache the in-flight K/V are bf16.

E4M3 = torch.float8_e4m3fn


def _e4m3(x):
    from tinygpt_tpu_torch.engine.kv_cache import kv_cast

    return kv_cast(x * 4, E4M3)  # spread over e4m3's exponents


@pytest.mark.parametrize("case", [PREFILL_CASES[1], PREFILL_CASES[2], PREFILL_CASES[4],
                                  PREFILL_CASES[3]])
def test_flash_prefill_e4m3_matches_plain(dev, case):
    D, dtype, Nq, Nk, S, T, pads, q_slot, window = case
    gen = torch.Generator().manual_seed(10)
    B = len(pads)
    q = _randn(gen, B, Nq, S, D, dtype=dtype, dev=dev)
    k = _e4m3(_randn(gen, B, Nk, T, D, dtype=torch.float32, dev=dev))
    v = _e4m3(_randn(gen, B, Nk, T, D, dtype=torch.float32, dev=dev))
    slots = torch.arange(T, device=dev)[None, :]
    valid = (slots >= torch.tensor(pads, device=dev)[:, None]) & (slots < q_slot + S)
    args = (q, k, v, valid, D ** -0.5, q_slot, window)
    ak.reset_launches()
    got = ak.flash_prefill(*args)
    assert ak.LAUNCHES["flash_prefill"] == 1
    want = ak.flash_prefill_plain(*args)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= TOL[dtype] * 4  # outputs of e4m3 values x4 reach ~8


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_decode_frozen_e4m3_matches_plain(dev, case):
    D, dtype, Nq, Nk, L, T, N, pads, length, step, window = case
    gen = torch.Generator().manual_seed(11)
    B = len(pads)
    ks = _e4m3(_randn(gen, L, B, Nk, T, D, dtype=torch.float32, dev=dev))
    vs = _e4m3(_randn(gen, L, B, Nk, T, D, dtype=torch.float32, dev=dev))
    ki = _randn(gen, B, Nk, N, D, dtype=torch.bfloat16, dev=dev)
    vi = _randn(gen, B, Nk, N, D, dtype=torch.bfloat16, dev=dev)
    q = _randn(gen, B, Nq, D, dtype=dtype, dev=dev)
    slots = torch.arange(T, device=dev)[None, :]
    mask = (slots >= torch.tensor(pads, device=dev)[:, None]) & (slots < length)
    for l in range(L):
        args = (q, ks, vs, mask, ki, vi, l, step, D ** -0.5, window)
        ak.reset_launches()
        got = ak.flash_decode_frozen(*args)
        assert ak.LAUNCHES["flash_decode_frozen"] == 1
        want = ak.flash_decode_frozen_plain(*args)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= TOL[dtype] * 4, f"layer {l}"


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_decode_frozen_e4m3_matches_plain(dev, case):
    D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, steps, window, \
        poison = case
    q, kp, vp, tables, lens, sts, ki, vi = _paged_case(
        dev, D, torch.float32, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, poison)
    q = q.to(dtype)
    kp, vp = _e4m3(kp), _e4m3(vp)  # NaN stays NaN (0x7F) in the null block
    ki, vi = ki.bfloat16(), vi.bfloat16()
    for step in steps:
        for l in range(kp.shape[0]):
            args = (q, kp, vp, tables, lens, sts, ki, vi, l, step, D ** -0.5, window)
            got = pa.paged_decode_frozen(*args)
            want = pa.paged_decode_frozen_plain(*args)
            torch.cuda.synchronize()
            assert bool(torch.isfinite(want).all())
            assert _max_err(got, want) <= 4 * _paged_tol(dtype, want), f"step {step} layer {l}"


SPEC_CASES = [
    # (D, dtype, e4m3, G, S, Nk, bs, MB, n_blocks, n_rounds, round, lengths, starts,
    #  inactive, window, poison)
    (128, torch.bfloat16, False, 4, 5, 8, 64, 16, 257, 1, 0,   # the serving shape
     tuple(64 + 53 * i for i in range(16)), (0,) * 16, (3, 9), None, False),
    (128, torch.bfloat16, True, 4, 5, 8, 64, 16, 257, 1, 0,
     tuple(64 + 53 * i for i in range(16)), (0,) * 16, (), None, True),
    (128, torch.float32, False, 4, 5, 8, 64, 16, 257, 2, 1,
     tuple(64 + 53 * i for i in range(16)), (0,) * 16, (), 300, True),
    (64, torch.float32, True, 2, 3, 2, 16, 8, 40, 3, 2, (1, 17, 100, 60), (0, 5, 20, 0),
     (), 20, True),
    (64, torch.float16, False, 1, 2, 4, 16, 8, 40, 2, 1, (7, 128, 0, 33), (0, 0, 0, 3),
     (), None, False),
    (128, torch.bfloat16, False, 8, 8, 1, 32, 4, 12, 1, 0, (33, 64, 5), (0, 0, 0), (),
     None, True),                                          # 64 rows a KV head
    (128, torch.float32, False, 3, 4, 2, 16, 4, 20, 2, 1, (60, 33, 1000), (0, 0, 0),
     (2,), 7, False),                                      # a stale length > MB * bs
    (128, torch.bfloat16, False, 8, 9, 2, 64, 4, 20, 1, 0, (130, 64, 250), (0, 0, 0), (),
     None, True),                                          # S * G = 72: 2 row groups
    (128, torch.bfloat16, True, 16, 5, 2, 64, 4, 20, 2, 1, (130, 64, 200), (0, 0, 0), (),
     100, False),                                          # S * G = 80, e4m3, a window
    (64, torch.float32, False, 12, 12, 1, 16, 8, 40, 1, 0, (40, 100), (0, 7), (), 20,
     True),                                                # S * G = 144: 3 row groups
]


def _spec_case(dev, D, dtype, e4m3, G, S, Nk, bs, MB, n_blocks, n_rounds, rnd, lengths,
               starts, inactive, poison):
    """The K8 case's pools and tables, q [B, S, Nq, D], in-flight K/V over
    n_rounds * S slots, earlier rounds' slots accepted at random, and each
    row's verify slots after its accepted ones."""
    q1, kp, vp, tables, lens, sts, ki, vi = _paged_case(
        dev, D, torch.float32, G, Nk, bs, MB, n_blocks, n_rounds * S, lengths, starts,
        inactive, poison, seed=6)
    gen = torch.Generator().manual_seed(12)
    B = len(lengths)
    q = _randn(gen, B, S, Nk * G, D, dtype=dtype, dev=dev)
    infl_dt = torch.bfloat16 if e4m3 else dtype
    ki, vi = ki.to(infl_dt), vi.to(infl_dt)
    if e4m3:
        kp, vp = _e4m3(kp), _e4m3(vp)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    base = rnd * S
    N = n_rounds * S
    acc = torch.zeros(B, dtype=torch.int32)
    valid = torch.zeros(B, N, dtype=torch.bool)
    infl_slots = torch.zeros(B, N, dtype=torch.int32)
    for r in range(rnd):
        m = torch.randint(0, S, (B,), generator=gen)
        for b in range(B):
            for i in range(int(m[b]) + 1):
                valid[b, r * S + i] = True
                infl_slots[b, r * S + i] = lengths[b] + acc[b] + i
        acc += (m + 1).to(torch.int32)
    q_slots = (torch.tensor(lengths, dtype=torch.int32)[:, None] + acc[:, None]
               + torch.arange(S, dtype=torch.int32)[None, :])
    return (q, kp, vp, tables, lens, sts, ki, vi, valid.to(dev)), base, (
        q_slots.to(dev), infl_slots.to(dev))


@pytest.mark.parametrize("case", SPEC_CASES)
def test_paged_decode_spec_kernel_matches_plain(dev, case):
    D, dtype, e4m3, G, S, Nk, bs, MB, n_blocks, n_rounds, rnd, lengths, starts, inactive, \
        window, poison = case
    args, base, (q_slots, infl_slots) = _spec_case(
        dev, D, dtype, e4m3, G, S, Nk, bs, MB, n_blocks, n_rounds, rnd, lengths, starts,
        inactive, poison)
    for l in range(args[1].shape[0]):
        call = (*args, l, base, D ** -0.5, window, q_slots, infl_slots)
        ak.reset_launches()
        got = pa.paged_decode_spec(*call)
        assert ak.LAUNCHES["paged_decode_spec"] == 1
        want = pa.paged_decode_spec_plain(*call)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(want).all())
        tol = 4 * _paged_tol(dtype, want) if e4m3 else _paged_tol(dtype, want)
        assert _max_err(got, want) <= tol, f"layer {l}"


def test_paged_decode_spec_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    c = SPEC_CASES[4]
    args, base, (q_slots, infl_slots) = _spec_case(dev, *c[:14], c[15])
    q, kp, vp, tables, lens, sts, ki, vi, valid = args
    with pytest.raises(ValueError, match="out of range"):
        pa.paged_decode_spec(*args, 2, base, 0.1)
    with pytest.raises(ValueError, match="q_slots"):
        pa.paged_decode_spec(*args, 0, base, 0.1, 20)
    with pytest.raises(ValueError, match="query heads over"):
        pa.paged_decode_spec(q[:, :, :3].contiguous(), kp, vp, tables, lens, sts, ki, vi,
                             valid, 0, base, 0.1)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_decode_spec(q, kp, vp, tables, lens, sts, ki, vi, valid.int(), 0, base,
                             0.1)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_decode_spec(q, _e4m3(kp.float()), _e4m3(vp.float()), tables, lens, sts,
                             ki, vi, valid, 0, base, 0.1)  # e4m3 pools need bf16 in flight


def test_kv_cast_on_the_card_matches_the_cpu(dev):
    """The e4m3 cast of engine/kv_cache.kv_cast gives the CPU's bytes on
    the card: normals, subnormals, +-448 and past it (saturating), NaN."""
    from tinygpt_tpu_torch.engine.kv_cache import kv_cast

    gen = torch.Generator().manual_seed(13)
    x = torch.cat([torch.randn(4096, generator=gen) * 3, torch.randn(1024, generator=gen)
                   * 1e-3, torch.tensor([448.0, -448.0, 470.0, 500.0, -1000.0,
                                         float("inf"), float("nan"), 0.0137])])
    for dtype in (torch.float32, torch.bfloat16):
        cpu = kv_cast(x.to(dtype), E4M3).view(torch.uint8)
        card = kv_cast(x.to(dtype).to(dev), E4M3).view(torch.uint8).cpu()
        assert torch.equal(card, cpu), dtype


def _spec_batcher_streams(cfg, params, device, impl, prompts, max_new, **kw):
    from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, Request, SchedulerConfig
    from tinygpt_tpu_torch.models import get_model

    p = {k: v.to(device) if isinstance(v, torch.Tensor) else
         ({n: t.to(device) for n, t in v.items()} if isinstance(v, dict) else v)
         for k, v in params.items()}
    b = ContinuousBatcher(get_model("mistral"), cfg, p, eos_ids=set(),
                          config=SchedulerConfig(
                              batch_capacity=3, block_size=16, n_blocks=40,
                              max_blocks_per_seq=8, prefill_bucket=16, dtype="float32",
                              decode_quantum=8, attn_impl=impl, **kw))
    for i, pr in enumerate(prompts):
        b.add_request(Request(request_id=i, prompt_ids=pr, max_new_tokens=max_new))
    got = {}
    while b.has_work:
        for ev in b.step():
            if ev.token_id is not None:
                got.setdefault(ev.request_id, []).append(ev.token_id)
    return got, b


def test_spec_batcher_on_the_card_matches_the_cpu(dev):
    """Speculative quanta on the card (K10 in every verify layer, K1 at
    admission) against the same params through the plain versions on the
    CPU: identical greedy streams, drafts accepted, and the streams of
    plain quanta."""
    cfg = _card_cfg()
    params = causal_lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(14)
    phrase = torch.randint(3, cfg.vocab_size, (6,), generator=gen).tolist()
    prompts = [phrase * 4, torch.randint(3, cfg.vocab_size, (21,), generator=gen).tolist(),
               phrase * 2 + phrase[:3]]
    kw = dict(speculative="ngram", spec_draft_len=3, spec_ngram=2)
    want, _ = _spec_batcher_streams(cfg, params, "cpu", "plain", prompts, 16, **kw)
    ak.reset_launches()
    got, b = _spec_batcher_streams(cfg, params, dev, "kernel", prompts, 16, **kw)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["paged_decode_spec"] > 0 and b.spec_acceptance > 0
    assert got == want
    plain, _ = _spec_batcher_streams(cfg, params, dev, "kernel", prompts, 16)
    assert plain == want


def test_fp8_engine_and_spec_on_the_card(dev, tmp_path):
    """GPTEngine on the card: batch-1 speculation gives the chunked loop's
    greedy tokens (fp32; K1 at each round's slot), and an fp8 KV cache
    runs K1 and K2 on e4m3 with logits near the fp32 cache's."""
    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine

    d = _model_dir(tmp_path, _TINY_DIR_CFG)
    kw = dict(model_dir=d, dtype="float32", max_tokens=16, prefill_bucket=16,
              decode_chunk=4, device="cuda", spec_ngram=2)
    prompt = ["the cat sat on the mat. the cat sat on the"]
    spec = GPTEngine(GPTConfig(speculative="ngram", **kw))
    spec.prepare()
    ak.reset_launches()
    got = spec.generate_sync(prompt)[0].token_ids
    assert ak.LAUNCHES["flash_prefill"] > 1
    plain = GPTEngine(GPTConfig(**kw))
    plain.prepare()
    assert got == plain.generate_sync(prompt)[0].token_ids
    fp8 = GPTEngine(GPTConfig(kv_cache_dtype="fp8", **kw))
    fp8.prepare()
    ak.reset_launches()
    out = fp8.generate_sync(prompt + ["Hello world"])
    torch.cuda.synchronize()
    assert ak.LAUNCHES["flash_prefill"] > 0 and ak.LAUNCHES["flash_decode_frozen"] > 0
    assert all(len(o.token_ids) == 16 for o in out)


# -- K9: the single-layer paged decode (forward_paged) ----------------------------

K9_CASES = [
    # (D, dtype, G, Nk, bs, MB, n_blocks, lengths, starts, inactive, window, poison)
    (64, torch.bfloat16, 1, 12, 64, 16, 257,             # the GPT-2 serving shape
     tuple(64 * i + 1 + 37 * (i % 3) for i in range(16)), (0,) * 16, (3, 9), None, False),
    (128, torch.float32, 4, 8, 64, 16, 257,
     tuple(512 + 17 * i for i in range(16)), (0,) * 16, (), 24, True),
    (64, torch.float32, 1, 4, 16, 8, 40, (1, 17, 100, 128), (0, 5, 20, 0), (), 8, True),
    (128, torch.float16, 8, 1, 32, 4, 9, (33, 64, 0), (0, 0, 0), (), None, True),
    (64, torch.bfloat16, 3, 2, 64, 3, 10, (190, 64, 65), (0, 0, 10), (), 3, True),
    (128, torch.bfloat16, 16, 8, 64, 4, 40, (200, 37, 129), (0, 0, 3), (), None, True),
    (128, torch.float32, 2, 2, 16, 4, 20, (60, 33, 1000), (0, 0, 0), (2,), 40, False),
]


@pytest.mark.parametrize("case", K9_CASES)
@pytest.mark.parametrize("e4m3", [False, True])
def test_paged_decode_kernel_matches_plain(dev, case, e4m3):
    """K9 on one layer's pool (a view of the stack) against its plain
    version: ragged rows, starts, dead entries over a NaN block 0 (poison),
    inactive rows, windows, 1 to 16 query heads per KV head, e4m3 pools
    beside queries of every dtype (decoded exactly: the same tolerance)."""
    D, dtype, G, Nk, bs, MB, n_blocks, lengths, starts, inactive, window, poison = case
    q, kp, vp, tables, lens, sts, _, _ = _paged_case(
        dev, D, dtype, G, Nk, bs, MB, n_blocks, 1, lengths, starts, inactive, poison)
    if e4m3:
        kp, vp = _e4m3(kp.float()), _e4m3(vp.float())
    for l in range(kp.shape[0]):
        args = (q, kp[l], vp[l], tables, lens, sts, D ** -0.5, window)
        ak.reset_launches()
        got = pa.paged_decode(*args)
        assert ak.LAUNCHES["paged_decode"] == 1
        want = pa.paged_decode_plain(*args)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(want).all())
        assert _max_err(got, want) <= _paged_tol(dtype, want), f"layer {l}"


def test_paged_decode_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    q, kp, vp, tables, lens, sts, _, _ = _paged_case(
        dev, 64, torch.float32, 2, 2, 16, 4, 9, 1, (20, 5), (0, 0), (), False)
    with pytest.raises(ValueError, match="do not fit"):
        pa.paged_decode(q, kp, vp, tables, lens, sts, 0.1)  # the stack, not a layer
    with pytest.raises(ValueError, match="at most"):
        pa.paged_decode(q.repeat(1, 9, 1), kp[0], vp[0], tables, lens, sts, 0.1)
    with pytest.raises(TypeError, match="dtype"):
        pa.paged_decode(q, kp[0], vp[0], tables, lens.long(), sts, 0.1)
    with pytest.raises(TypeError, match="float8_e4m3fn"):
        pa.paged_decode(q, kp[0].half(), vp[0].half(), tables, lens, sts, 0.1)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode(torch.zeros(2, 4, 96, device=dev), torch.zeros(9, 2, 16, 96,
                        device=dev), torch.zeros(9, 2, 16, 96, device=dev), tables, lens,
                        sts, 0.1)


def _gpt2_cfg():
    return parse_model_config(dict(model_type="gpt2", vocab_size=211, n_embd=256,
                                   n_layer=2, n_head=4, n_positions=96))


def test_gpt2_on_the_card_matches_the_cpu(dev):
    """GPT-2 (2 layers, 4 heads of 64, fp32): the prefill logits (K1), two
    frozen decode chunks (K2) and forward_paged steps (K9) on the card
    against the same params through the plain versions on the CPU."""
    from tinygpt_tpu_torch.engine.paged_kv import PagedKVState
    from tinygpt_tpu_torch.models import gpt2

    cfg = _gpt2_cfg()
    params = gpt2.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    pcard = {k: v.to(dev) if isinstance(v, torch.Tensor) else
             {n: t.to(dev) for n, t in v.items()} for k, v in params.items()}
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(3, cfg.vocab_size, (2, 24), generator=gen, dtype=torch.int32)
    pos = torch.arange(24, dtype=torch.int32)[None].expand(2, 24).contiguous()
    pools = torch.randn(2, 2, 12, 4, 16, 64, generator=gen)
    outs = {}
    for where, p, impl in (("cpu", params, "plain"), (dev, pcard, "kernel")):
        cache = create_kv_cache(cfg, 2, 40, dtype=torch.float32, device=where)
        lg, cache = gpt2.forward(p, cfg, ids.to(where), cache, pos.to(where),
                                 torch.ones(2, 24, dtype=torch.bool, device=where),
                                 attn_impl=impl)
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        toks, cache = gpt2.decode_steps(p, cfg, tok, cache, pos[:, -1:].to(where) + 1, 8,
                                        lambda x: x.argmax(-1), attn_impl=impl)
        st = PagedKVState(
            k_pool=pools[0].clone().to(where), v_pool=pools[1].clone().to(where),
            block_tables=torch.tensor([[1, 2, 3, 4, 5, 6], [7, 8, 0, 0, 0, 0]],
                                      dtype=torch.int32, device=where),
            lengths=torch.tensor([94, 20], dtype=torch.int32, device=where),
            starts=torch.tensor([0, 2], dtype=torch.int32, device=where),
            active=torch.tensor([True, True], device=where))
        ak.reset_launches()
        paged = [gpt2.forward_paged(p, cfg, toks[i], st, attn_impl=impl)[0]
                 for i in range(4)]
        if impl == "kernel":
            torch.cuda.synchronize()
            assert ak.LAUNCHES["paged_decode"] == 4 * cfg.num_hidden_layers
        outs[impl] = (lg.cpu(), toks.cpu(), torch.stack(paged).cpu(), st.k_pool.cpu())
    (lg_c, toks_c, pg_c, kp_c), (lg_k, toks_k, pg_k, kp_k) = outs["plain"], outs["kernel"]
    assert (lg_k - lg_c).abs().max().item() <= 1e-4
    assert torch.equal(toks_k, toks_c)
    assert (pg_k - pg_c).abs().max().item() <= 1e-4
    assert (kp_k - kp_c).abs().max().item() <= 1e-4
