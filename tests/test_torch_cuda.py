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


# the int4 GEMV (M <= 32, csrc/int4_common.cuh): every row count of its
# n-tiling (1, 4, 5, 8 in one tile of 8 rows; 16 in two; 17 and 32 in four),
# OUT % 16 == 8 (rows copied 8 bytes at a time), OUT not a multiple of the
# 128-column tile, row-padded weights (x narrower than the stack), groups of
# 16, 64 and 128, and every K6 prologue / epilogue and K7 at each row count
GEMV_ROWS = (1, 4, 5, 8, 16, 17, 32)
INT4_GEMV_EDGES = [
    # (IN, OUT, group, dtype)
    (256, 264, 16, torch.bfloat16),
    (192, 136, 64, torch.float32),      # padded to 256 rows
    (1024, 520, 128, torch.bfloat16),
    (320, 4096, 64, torch.float32),     # padded to 512 rows
    (4096, 6144, 64, torch.bfloat16),   # Mistral-7B qkv
]


@pytest.mark.parametrize("M", GEMV_ROWS)
@pytest.mark.parametrize("case", INT4_GEMV_EDGES)
def test_int4_gemv_rows_and_edges_match_plain(dev, case, M):
    IN, OUT, group, dtype = case
    gen = torch.Generator().manual_seed(13)
    data, scales, g, in_p = _qweight(gen, 2, IN, OUT, group, dev)
    x = pad_x_to(_randn(gen, M, IN, dtype=dtype, dev=dev), in_p).contiguous()
    ak.reset_launches()
    got = qk.matmul_dequant_int4_stacked(x, data, scales, 1, g)
    assert ak.LAUNCHES["matmul_dequant_int4_stacked"] == 1
    _qclose(got, qk.matmul_dequant_int4_stacked_plain(x, data, scales, 1, g), dtype,
            f"K5b M={M} IN={IN} OUT={OUT}")
    got = qk.matmul_dequant_int4(x, data[0], scales[0], g)
    _qclose(got, qk.matmul_dequant_int4_plain(x, data[0], scales[0], g), dtype, "K4")


GEMV_FUSED_VARIANTS = ("ln", "res", "silu_res", "ln_bias", "ln_rope", "ln_rope_qk")


@pytest.mark.parametrize("M", GEMV_ROWS)
@pytest.mark.parametrize("variant", GEMV_FUSED_VARIANTS)
def test_int4_fused_variants_at_every_row_count_match_plain(dev, variant, M):
    """K6 at each row count, bf16 and fp32: heads of 64 (5 q, 2 k / v), so
    a 128-column tile holds two heads, the q / k and the q || k / v
    boundaries fall inside tiles and the last tile is half full."""
    gen = torch.Generator().manual_seed(14)
    L, IN, Nq, Nk, D = 2, 320, 5, 2, 64
    OUT = (Nq + 2 * Nk) * D
    data, scales, g, _ = _qweight(gen, L, IN, OUT, 64, dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = _randn(gen, M, 2 * IN if variant == "silu_res" else IN, dtype=dtype, dev=dev)
        kw = {}
        if variant.startswith("ln"):
            kw["ln"] = (1 + 0.1 * torch.randn((L, IN), generator=gen)).to(dtype).to(dev)
            kw["invrms"] = torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + 1e-5)
        if "res" in variant:
            kw["res"] = _randn(gen, M, OUT, dtype=dtype, dev=dev)
        if variant == "silu_res":
            kw["silu"] = True
        if "bias" in variant:
            kw["bias"] = _randn(gen, L, OUT, dtype=dtype, dev=dev)
        if "rope" in variant:
            ang = torch.rand((M, D // 2), generator=gen) * 6.3
            kw.update(rope_cos=torch.cat([ang.cos()] * 2, -1).to(dev),
                      rope_sin=torch.cat([ang.sin()] * 2, -1).to(dev),
                      rope_heads=Nq + Nk, rope_dim=D)
        if "qk" in variant:
            kw.update(qk_norm_w=tuple((1 + 0.1 * torch.randn((L, D), generator=gen))
                                      .to(dtype).to(dev) for _ in range(2)),
                      qk_heads=Nq, eps=1e-6)
        ak.reset_launches()
        got = qk.matmul_dequant_int4_stacked_fused(x, data, scales, 1, g, **kw)
        assert ak.LAUNCHES["matmul_dequant_int4_stacked_fused"] == 1
        want = qk.matmul_dequant_int4_stacked_fused_plain(x, data, scales, 1, g, **kw)
        torch.cuda.synchronize()
        _qclose(got, want, dtype, f"{variant} M={M} {dtype}")


@pytest.mark.parametrize("M", GEMV_ROWS)
@pytest.mark.parametrize("H,I", [(512, 640), (256, 328)])
def test_int4_mlp_at_every_row_count_matches_plain(dev, M, H, I):
    """K7 at each row count, bf16 and fp32: I % 16 == 0, where gate_up
    writes silu(g) * u in down's fragment order, and I % 16 == 8, where it
    writes the fp32 gate || up and down stages silu(g) * u itself."""
    gen = torch.Generator().manual_seed(15)
    L = 2
    gu, gus, g, _ = _qweight(gen, L, H, 2 * I, 64, dev)
    dn, dns, _, _ = _qweight(gen, L, I, H, 64, dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = _randn(gen, M, H, dtype=dtype, dev=dev)
        ln = (1 + 0.1 * torch.randn((L, H), generator=gen)).to(dtype).to(dev)
        inv = torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + 1e-5)
        ak.reset_launches()
        got = qk.mlp_fused_int4_stacked(x, gu, gus, dn, dns, ln, inv, 1, g)
        assert ak.LAUNCHES["mlp_fused_int4_stacked"] == 1
        want = qk.mlp_fused_int4_stacked_plain(x, gu, gus, dn, dns, ln, inv, 1, g)
        torch.cuda.synchronize()
        _qclose(got, want, dtype, f"M={M} {dtype}")


@pytest.mark.parametrize("M", [4, 16, 32])
def test_int4_gemv_every_split_matches_plain(dev, M):
    """The entry point at every cluster size the int4 plan picks from
    (quant_kernels._I4_SPLITS), whatever the plan would pick, bf16 and
    fp32 (a split whose blocks cannot hold their activations is refused);
    and a split with more blocks than 16-row units (blocks without
    rows)."""
    from tinygpt_tpu_torch.ops import cuda_build

    gen = torch.Generator().manual_seed(16)
    IN, OUT, group = 4096, 264, 64
    data, scales, g, _ = _qweight(gen, 2, IN, OUT, group, dev)
    small, small_s, _, _ = _qweight(gen, 2, 256, 264, 16, dev)   # 8 units of rows
    fn = cuda_build.function("int4_matmul.cu", "tg_int4_matmul", qk._MATMUL_ARGS)
    for dtype in (torch.bfloat16, torch.float32):
        for d, s, n, splits in ((data, scales, IN, qk._I4_SPLITS), (small, small_s, 256, (16,))):
            x = _randn(gen, M, n, dtype=dtype, dev=dev)
            gs = group if n == IN else 16
            want = qk.matmul_dequant_int4_stacked_plain(x, d, s, 1, gs)
            for split in splits:
                got = torch.empty(M, OUT, dtype=dtype, device=dev)
                err = fn(ak._ptr(x), ak._ptr(d), ak._ptr(s), ak._ptr(got), M, n, OUT, gs, 1,
                         qk._DTYPE_CODE[dtype], split, 0, qk._stream(x.device))
                if not qk.int4_gemv_plan(M, n, split, qk._int4_parts(dtype, False))[0]:
                    assert err, f"split {split}: activations that fit no block launched"
                    continue  # the plan never picks it
                cuda_build.check("int4_matmul.cu", err, "tg_int4_matmul")
                torch.cuda.synchronize()
                _qclose(got, want, dtype, f"M={M} IN={n} split {split} {dtype}")


# the matrices of the plan check: Mistral-7B, GPT-2 and qwen2-0.5B widths,
# and narrow ones whose blocks hold few rows
INT4_PLAN_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 32768),
                    (768, 2304), (768, 3072), (3072, 768), (896, 1152), (896, 9728),
                    (4864, 896), (256, 264), (512, 136)]


def _plan_fn(source, symbol, n_ints):
    import ctypes

    from tinygpt_tpu_torch.ops import cuda_build

    return cuda_build.function(source, symbol, [ctypes.c_int] * n_ints + [ctypes.c_void_p])


def _kernel_plan(fn, *args, n=8):
    import ctypes

    plan = (ctypes.c_int * n)()
    assert fn(*args, plan) == 0, args
    return tuple(plan)


def test_int4_gemv_host_plan_matches_the_kernels(dev):
    """The host's model of the int4 GEMV's plan (quant_kernels.int4_gemv_plan
    and the wrappers' _fused_act and _mlp_act) against what the three C
    entry points launch (their tg_int4_*_plan exports): the n-tiles a pass,
    the route and a block's shared memory, at every row count, every
    split, bf16 and fp32, aligned, padded and unaligned x, and each K6
    prologue; K7's gated choice where down takes its rows in one pass."""
    mm = _plan_fn("int4_matmul.cu", "tg_int4_matmul_plan", 5)
    fused = _plan_fn("int4_fused.cu", "tg_int4_fused_plan", 8)
    mlp = _plan_fn("int4_mlp.cu", "tg_int4_mlp_plan", 8)
    for dtype in (torch.bfloat16, torch.float32):
        code = qk._DTYPE_CODE[dtype]
        for M in range(1, qk.MAX_DECODE_ROWS + 1):
            for IN, OUT in INT4_PLAN_SHAPES:
                for C in qk._I4_SPLITS:
                    want = qk.int4_gemv_plan(M, IN, C, qk._int4_parts(dtype, False))
                    assert _kernel_plan(mm, M, IN, OUT, code, C, n=3) == want, (M, IN, C)
                    for in_x in (IN, IN - 64, IN - 4):
                        for ln, silu in ((False, False), (True, False), (False, True)):
                            parts, staged = qk._fused_act(dtype, silu, ln, in_x)
                            got = _kernel_plan(fused, M, in_x, IN, OUT, ln, silu, code, C, n=4)
                            want = (parts,) + qk.int4_gemv_plan(M, IN, C, parts, staged)
                            assert got == want, (M, in_x, IN, ln, silu, C)
            for H, I in ((4096, 14336), (768, 3072), (896, 4864), (512, 640), (256, 328)):
                Hp, Ip = -(-H // 128) * 128, -(-I // 128) * 128
                parts, staged_a, staged_b = qk._mlp_act(dtype, H, 2 * I)
                for ca in (1, 4, 16):
                    for cb in qk._I4_SPLITS + (qk.int4_gemv_split(M, Ip, H, parts, 132,
                                                                  staged_b),):
                        got = _kernel_plan(mlp, M, H, Hp, 2 * I, Ip, code, ca, cb)
                        gate = qk.int4_gemv_plan(M, Hp, ca, parts, staged_a)
                        down = qk.int4_gemv_plan(M, Ip, cb, parts, staged_b)
                        gated = not staged_b and 8 * down[0] >= M
                        assert got == (parts, *gate, gated, *down), (M, H, I, ca, cb)
                cb = qk.int4_gemv_split(M, Ip, H, parts, 132, staged_b)
                assert _kernel_plan(mlp, M, H, Hp, 2 * I, Ip, code, 1, cb)[4] == (not staged_b)


def test_int4_gemv_allocates_only_its_outputs(dev):
    """K5b and K6 allocate their output and nothing else on the card; K7 its
    output and the scratch between its two launches."""
    gen = torch.Generator().manual_seed(17)
    M, H, I = 16, 512, 640
    gu, gus, g, _ = _qweight(gen, 2, H, 2 * I, 64, dev)
    dn, dns, _, _ = _qweight(gen, 2, I, H, 64, dev)
    x = _randn(gen, M, H, dtype=torch.bfloat16, dev=dev)
    ln = torch.ones(2, H, dtype=torch.bfloat16, device=dev)
    inv = torch.ones(M, 1, device=dev)
    calls = (
        (lambda: qk.matmul_dequant_int4_stacked(x, gu, gus, 1, g), M * 2 * I * 2),
        (lambda: qk.matmul_dequant_int4_stacked_fused(x, gu, gus, 1, g, ln=ln, invrms=inv),
         M * 2 * I * 2),
        (lambda: qk.mlp_fused_int4_stacked(x, gu, gus, dn, dns, ln, inv, 1, g),
         M * H * 2 + qk._mlp_act_bytes(M, 2 * I, dn.shape[1] * 2, 2)),
    )
    for call, nbytes in calls:
        call()  # built and set up
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = call()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated(dev) - base <= -(-nbytes // 512) * 512
        del out


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


# the edges of the GEMV's split (clusters of quant_kernels.gemv_split's
# blocks splitting IN in 16-row units, 8 warps a block): a share with no
# rows (the entry point called with more blocks than units), IN = 64 (one
# unit a block, seven warps of eight without rows), OUT not a multiple of
# 256 (and OUT % 16 == 8, where rows take 8-byte copies), M = 5, 9 and 32,
# group 16, and a non-portable cluster of 16 at the down projection's IN
INT8_GEMV_EDGES = [
    # (M, IN, OUT, group, dtype, split: None for the plan's)
    (4, 64, 256, 64, torch.bfloat16, 16),     # 12 of 16 blocks hold no rows
    (1, 64, 64, 64, torch.float32, None),
    (5, 896, 264, 128, torch.bfloat16, None),
    (9, 4096, 1000, 128, torch.float32, None),
    (32, 4096, 4864, 128, torch.bfloat16, None),
    (32, 14336, 4096, 128, torch.bfloat16, 16),
    (4, 80, 24, 16, torch.float32, 5),
]


@pytest.mark.parametrize("case", INT8_GEMV_EDGES)
def test_int8_gemv_split_edges_match_plain(dev, case):
    from tinygpt_tpu_torch.ops import cuda_build

    M, IN, OUT, group, dtype, split = case
    gen = torch.Generator().manual_seed(9)
    data, scales, g = _q8weight(gen, 2, IN, OUT, group, dev)
    x = _randn(gen, M, IN, dtype=dtype, dev=dev)
    want = qk.matmul_dequant_int8_stacked_plain(x, data, scales, 1, g)
    if split is None:
        ak.reset_launches()
        got = qk.matmul_dequant_int8_stacked(x, data, scales, 1, g)
        assert ak.LAUNCHES["matmul_dequant_int8_stacked"] == 1
    else:  # the entry point itself, at a split the plan would not pick
        fn = cuda_build.function("int8_matmul.cu", "tg_int8_matmul", qk._MATMUL_ARGS)
        got = torch.empty(M, OUT, dtype=dtype, device=dev)
        err = fn(ak._ptr(x), ak._ptr(data), ak._ptr(scales), ak._ptr(got), M, IN, OUT, g, 1,
                 qk._DTYPE_CODE[dtype], split, 0, qk._stream(x.device))
        cuda_build.check("int8_matmul.cu", err, "tg_int8_matmul")
    torch.cuda.synchronize()
    _qclose(got, want, dtype, f"M={M} IN={IN} OUT={OUT} split={split}")


# the prefill regime's plan (M > 32, bf16: csrc/dequant_mm_tc.cuh): one and
# two row tiles of 128 and 256 rows of x (M = 33, 64, 65, 80, 129, 512,
# 2048), splits of the k walk over a cluster (the plan's, and every one
# through the entry point), OUT % 16 == 8 (weight rows copied by cp.async,
# not TMA), last stages shorter than 64 rows (IN = 80, 896), groups of 16
# to 128, every layer of the stack
DEQUANT_MM_EDGES = [
    # (bits, M, IN, OUT, group, L)
    (8, 33, 896, 136, 128, 2),
    (8, 64, 80, 264, 16, 3),
    (8, 65, 4096, 6144, 128, 2),     # Mistral-7B qkv
    (8, 80, 14336, 4096, 128, 2),    # Mistral-7B down at a verify round
    (8, 129, 64, 200, 32, 2),
    (8, 512, 4096, 4096, 128, 2),
    (8, 2048, 4096, 1024, 128, 2),
    (4, 33, 512, 520, 32, 2),
    (4, 64, 256, 200, 16, 3),
    (4, 65, 4096, 6144, 64, 2),
    (4, 80, 14336, 4096, 64, 2),
    (4, 129, 768, 2304, 64, 2),      # GPT-2 qkv
    (4, 512, 4096, 4096, 64, 2),
    (4, 2048, 3072, 768, 64, 2),     # GPT-2 proj
]


def _stack(bits, gen, L, IN, OUT, group, dev):
    if bits == 8:
        data, scales, g = _q8weight(gen, L, IN, OUT, group, dev)
        return data, scales, g, IN
    return _qweight(gen, L, IN, OUT, group, dev)


def _dequant_mm_fns(bits):
    if bits == 8:
        return (qk.matmul_dequant_int8_stacked, qk.matmul_dequant_int8_stacked_plain,
                "matmul_dequant_int8_stacked")
    return (qk.matmul_dequant_int4_stacked, qk.matmul_dequant_int4_stacked_plain,
            "matmul_dequant_int4_stacked")


@pytest.mark.parametrize("case", DEQUANT_MM_EDGES)
def test_dequant_mm_plan_edges_match_plain(dev, case):
    bits, M, IN, OUT, group, L = case
    gen = torch.Generator().manual_seed(10)
    data, scales, g, in_p = _stack(bits, gen, L, IN, OUT, group, dev)
    x = pad_x_to(_randn(gen, M, IN, dtype=torch.bfloat16, dev=dev), in_p).contiguous()
    kern, plain, name = _dequant_mm_fns(bits)
    for l in range(L):
        ak.reset_launches()
        got = kern(x, data, scales, l, g)
        assert ak.LAUNCHES[name] == 1
        want = plain(x, data, scales, l, g)
        torch.cuda.synchronize()
        assert got.shape == (M, OUT)
        _qclose(got, want, torch.bfloat16, f"int{bits} M={M} IN={IN} OUT={OUT} layer {l}")


@pytest.mark.parametrize("tile", [128, 256])
@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_mm_every_split_matches_plain(dev, bits, tile):
    """The entry point at every split of the k walk (1 to 8 blocks of a
    cluster) and both row tiles, whatever the plan would pick."""
    from tinygpt_tpu_torch.ops import cuda_build

    gen = torch.Generator().manual_seed(11)
    M, IN, OUT, group = 200, 1024, 264, 64
    data, scales, g, in_p = _stack(bits, gen, 2, IN, OUT, group, dev)
    x = _randn(gen, M, in_p, dtype=torch.bfloat16, dev=dev)
    _, plain, _ = _dequant_mm_fns(bits)
    want = plain(x, data, scales, 1, g)
    source, symbol = qk._MATMUL_LIBS[bits]
    fn = cuda_build.function(source, symbol, qk._MATMUL_ARGS)
    for split in range(1, 9):
        got = torch.empty(M, OUT, dtype=torch.bfloat16, device=dev)
        err = fn(ak._ptr(x), ak._ptr(data), ak._ptr(scales), ak._ptr(got), M, in_p, OUT, g, 1,
                 qk._DTYPE_CODE[torch.bfloat16], split, tile, qk._stream(x.device))
        cuda_build.check(source, err, symbol)
        torch.cuda.synchronize()
        _qclose(got, want, torch.bfloat16, f"int{bits} tile {tile} split {split}")


@pytest.mark.parametrize("bits", [8, 4])
def test_dequant_mm_prefill_call_is_one_kernel(dev, bits):
    """A bf16 call at M > 32 counts one launch and runs one kernel on the
    card, the wgmma kernel: no conversion, copy or fill beside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(12)
    data, scales, g, in_p = _stack(bits, gen, 2, 1024, 512, 64, dev)
    x = _randn(gen, 80, in_p, dtype=torch.bfloat16, dev=dev)
    kern, _, name = _dequant_mm_fns(bits)
    kern(x, data, scales, 1, g)  # built and set up
    torch.cuda.synchronize()
    for _ in range(3):  # a profiler session now and then comes back without device events
        ak.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kern(x, data, scales, 1, g)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        if names:
            break
    assert ak.LAUNCHES[name] == 1
    assert len(names) == 1 and "dequant_mm_tc" in names[0], names


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


# the edges of K1's tensor-core tiling (128 query rows a block in two
# warpgroups of 64, KV tiles of 64 slots): S around 64 and 128, caches that
# end inside a tile, q_slot > 0 with rows that see nothing, windows inside
# one tile and across tiles, 1 to 16 query heads per KV head, D = 64, and a
# row whose every block is padding (exact zeros)
K1_EDGE_CASES = [
    # (D, dtype, Nq, Nk, S, T, pads, q_slot, window)
    (128, torch.bfloat16, 8, 8, 1, 70, (0, 69), 69, None),         # S = 1, G = 1
    (128, torch.bfloat16, 24, 8, 63, 100, (0, 40, 99), 37, None),  # G = 3, rows see nothing
    (64, torch.float16, 64, 8, 65, 130, (0, 7), 65, 5),            # G = 8, window 5
    (128, torch.bfloat16, 128, 8, 127, 200, (3, 0), 0, 100),       # G = 16, window across tiles
    (64, torch.bfloat16, 16, 1, 129, 129, (0, 129), 0, None),      # a row of padding only
    (128, torch.float16, 32, 8, 129, 300, (0, 250), 171, 64),      # window of one tile
    (64, torch.bfloat16, 12, 12, 130, 131, (0, 1, 130), 1, None),  # GPT-2's heads
]


@pytest.mark.parametrize("e4m3", [False, True])
@pytest.mark.parametrize("case", K1_EDGE_CASES)
def test_flash_prefill_tiling_edges_match_plain(dev, case, e4m3):
    D, dtype, Nq, Nk, S, T, pads, q_slot, window = case
    gen = torch.Generator().manual_seed(30)
    B = len(pads)
    q = _randn(gen, B, Nq, S, D, dtype=dtype, dev=dev)
    if e4m3:
        k = _e4m3(_randn(gen, B, Nk, T, D, dtype=torch.float32, dev=dev))
        v = _e4m3(_randn(gen, B, Nk, T, D, dtype=torch.float32, dev=dev))
    else:
        k = _randn(gen, B, Nk, T, D, dtype=dtype, dev=dev)
        v = _randn(gen, B, Nk, T, D, dtype=dtype, dev=dev)
    slots = torch.arange(T, device=dev)[None, :]
    valid = (slots >= torch.tensor(pads, device=dev)[:, None]) & (slots < q_slot + S)
    args = (q, k, v, valid, D ** -0.5, q_slot, window)
    ak.reset_launches()
    got = ak.flash_prefill(*args)
    assert ak.LAUNCHES["flash_prefill"] == 1
    want = ak.flash_prefill_plain(*args)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= TOL[dtype] * (4 if e4m3 else 1)
    for b, p in enumerate(pads):  # rows before the first real slot: exact zeros
        assert not got[b, :, : max(0, p - q_slot)].any()


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


K8_SPLIT_CASES = [
    # (D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, step,
    #  window): inactive rows keep their lengths over a zero table
    (128, torch.bfloat16, 4, 8, 64, 16, 257, 8, (512, 767, 0, 1100, 600),
     (0, 0, 0, 0, 3), (2, 3), 7, None),      # ragged; a row at 0; a stale length
    (128, torch.bfloat16, 4, 2, 16, 40, 100, 8, (600, 130, 37), (0, 5, 0), (), 5,
     100),                                   # bs 16; a window across the shares
    (64, torch.float16, 16, 2, 64, 8, 40, 4, (500, 70), (0, 0), (), 3, 300),  # G = 16
    (64, torch.bfloat16, 1, 12, 64, 16, 300, 8, (700, 512, 45), (0, 0, 0), (), 0,
     None),                                  # GPT-2's heads, the first step
    (128, torch.float32, 8, 1, 32, 70, 80, 40, (2200, 31), (0, 0), (), 39,
     None),                                  # 40 in flight: two in-flight tiles
    (64, torch.bfloat16, 2, 2, 48, 9, 30, 6, (400, 97), (10, 0), (), 2, 64),  # bs 48
    (64, torch.bfloat16, 2, 2, 16, 4200, 4300, 8, (66000, 900), (0, 0), (), 7,
     None),                                  # 4,125 block ids: past the id cache at C <= 2
]


def _k8_split_call(args, C):
    """K8 through its C entry point at split C (1 to 8), not the plan's."""
    import ctypes

    from tinygpt_tpu_torch.ops import cuda_build

    q, kp, vp, tables, lens, sts, ki, vi, l, step, scale, window = args
    fn = cuda_build.function("paged_decode_frozen.cu", "tg_paged_decode_frozen",
                             pa._FROZEN_ARGS)
    B, Nq, D = q.shape
    _, n_blocks, Nk, bs, _ = kp.shape
    kv_code, _ = ak.kv_operands("paged_decode_frozen", q, kp)
    out = torch.empty_like(q)
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (q, kp, vp, tables, lens, sts, ki, vi,
                                                        out)),
             B, Nq, Nk, n_blocks, bs, tables.shape[1], ki.shape[2], D, ak._DTYPE_CODE[q.dtype],
             kv_code, l, step, scale, window or 0, C,
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0, (C, err)
    return out


@pytest.mark.parametrize("e4m3", [False, True])
@pytest.mark.parametrize("case", K8_SPLIT_CASES + PAGED_CASES[:2])
def test_paged_decode_frozen_every_split_matches_plain(dev, case, e4m3):
    """K8 at every cluster size C = 1 .. 8 against the plain version: ragged
    rows, a row at length 0, a stale length past the table, windows across
    share boundaries, G = 16, bs 16, 48 and 64, two in-flight tiles, a share
    longer than the block ids a block keeps (per-slot lookups), an e4m3
    pool beside bf16 in-flight K/V, the null block poisoned with NaN where
    no row is inactive; and the wrapper's own plan."""
    if len(case) == 14:  # a PAGED_CASES entry: its last step
        D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, steps, window, \
            poison = case
        step = steps[-1]
    else:
        D, dtype, G, Nk, bs, MB, n_blocks, N, lengths, starts, inactive, step, window = case
        poison = not inactive  # an inactive row reads the null block
    q, kp, vp, tables, lens, sts, ki, vi = _paged_case(
        dev, D, torch.float32 if e4m3 else dtype, G, Nk, bs, MB, n_blocks, N, lengths,
        starts, inactive, poison)
    if e4m3:
        q, kp, vp, ki, vi = q.to(dtype), _e4m3(kp), _e4m3(vp), ki.bfloat16(), vi.bfloat16()
    for l in range(kp.shape[0]):
        args = (q, kp, vp, tables, lens, sts, ki, vi, l, step, D ** -0.5, window)
        want = pa.paged_decode_frozen_plain(*args)
        tol = (4 if e4m3 else 1) * _paged_tol(dtype, want)
        assert bool(torch.isfinite(want).all())
        for C in range(1, 9):
            got = _k8_split_call(args, C)
            torch.cuda.synchronize()
            assert _max_err(got, want) <= tol, f"C={C} layer {l}"
        got = pa.paged_decode_frozen(*args)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= tol, f"plan layer {l}"


def test_paged_decode_frozen_pool_past_2_31_elements(dev):
    """The Mistral-7B serving pool at 1040 blocks holds more than 2^31
    elements a pool: K8 reads its last layer's last blocks through 64-bit
    offsets."""
    L, n_blocks, Nk, bs, D, G, N = 32, 1040, 8, 64, 128, 4, 8
    assert L * n_blocks * Nk * bs * D > 2 ** 31
    gen = torch.Generator(device=dev).manual_seed(9)
    kp = torch.zeros(L, n_blocks, Nk, bs, D, dtype=torch.bfloat16, device=dev)
    vp = torch.zeros_like(kp)
    tables = torch.zeros(2, 12, dtype=torch.int32)
    tables[0, :11] = torch.arange(n_blocks - 1, n_blocks - 12, -1)
    tables[1, :5] = torch.arange(n_blocks - 20, n_blocks - 15)
    used = tables[tables > 0].long().to(dev)
    for pool in (kp, vp):
        pool[L - 1, used] = torch.randn((len(used), Nk, bs, D), generator=gen,
                                        device=dev).bfloat16()
    q = torch.randn((2, Nk * G, D), generator=gen, device=dev).bfloat16()
    ki = torch.randn((2, Nk, N, D), generator=gen, device=dev).bfloat16()
    vi = torch.randn((2, Nk, N, D), generator=gen, device=dev).bfloat16()
    i32 = dict(dtype=torch.int32, device=dev)
    args = (q, kp, vp, tables.to(dev), torch.tensor([700, 300], **i32),
            torch.zeros(2, **i32), ki, vi, L - 1, N - 1, D ** -0.5, None)
    want = pa.paged_decode_frozen_plain(*args)
    for C in (1, 3, 8):
        got = _k8_split_call(args, C)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= _paged_tol(torch.bfloat16, want), C


def test_paged_decode_split_plan_reads_the_kernels_occupancy(dev):
    """K8's plan takes the blocks an SM from the library
    (tg_paged_decode_frozen_plan: the kernel's occupancy, registers and
    shared memory counted): at least one at every split, type, pool type,
    head dim, group and table width, within 227 KB; at the serve, GPT-2 and
    G = 16 shapes the plan picks C = 2, 2 and 1, the fastest of the
    split sweep on an H100 (PERF.md)."""
    fn = _plan_fn("paged_decode_frozen.cu", "tg_paged_decode_frozen_plan", 7)
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for kv_code in (ak._DTYPE_CODE[dtype], 3):
            for D in (64, 128):
                for G in (1, 3, 4, 8, 10, 16):
                    for MB in (3, 16, 4096):
                        for C in range(1, 9):
                            smem, per_sm = _kernel_plan(fn, 2 * G, 2, MB, D,
                                                        ak._DTYPE_CODE[dtype], kv_code, C, n=2)
                            assert per_sm >= 1 and smem <= 227 * 1024, (dtype, D, G, MB, C)
    bf16 = ak._DTYPE_CODE[torch.bfloat16]
    for Nq, Nk, D, want in ((32, 8, 128, 2), (12, 12, 64, 2), (128, 8, 128, 1)):
        per_sm = pa._paged_per_sm(Nq, Nk, 16, D, bf16, bf16, 0)
        assert ak.paged_decode_split(16, Nk, Nq // Nk, 16 * 64 + 8, per_sm,
                                     ak._sm_count(0)) == want, (Nq, Nk, per_sm)


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


# -- K9 and K10 redesigned: every split, the plans, pools past 2^31 --------------

K9_SPLIT_CASES = [
    # (D, dtype, G, Nk, bs, MB, n_blocks, lengths, starts, inactive, window):
    # inactive rows keep their lengths over a zero table
    (64, torch.bfloat16, 1, 12, 64, 16, 257, (1023, 1, 64, 0, 65, 900, 700),
     (0, 0, 0, 0, 5, 0, 17), (3, 5), None),  # the GPT-2 serving shape's rows
    (128, torch.bfloat16, 4, 8, 64, 16, 257, (512, 767, 0, 1100, 600),
     (0, 0, 0, 0, 3), (2, 3), 24),           # Mistral-7B's heads; window 24
    (128, torch.float32, 4, 2, 16, 40, 100, (600, 130, 37), (0, 5, 0), (), 8),  # bs 16
    (64, torch.float16, 16, 2, 64, 8, 40, (500, 70), (0, 0), (), None),        # G = 16
    (64, torch.bfloat16, 2, 2, 48, 9, 30, (400, 97), (10, 0), (), 64),          # bs 48
    (64, torch.bfloat16, 2, 2, 16, 4200, 4300, (66000, 900), (0, 0), (), None),  # past the ids
]


def _split_call(source, symbol, argtypes, ptrs, ints, scale, window, C):
    import ctypes

    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function(source, symbol, argtypes)
    err = fn(*(ctypes.c_void_p(None if t is None else t.data_ptr()) for t in ptrs), *ints,
             scale, window or 0, C, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0, (symbol, C, err)


def _k9_split_call(args, C):
    """K9 through its C entry point at split C (1 to 8), not the plan's."""
    q, kp, vp, tables, lens, sts, scale, window = args
    B, Nq, D = q.shape
    n_blocks, Nk, bs, _ = kp.shape
    kv_code, _ = ak.kv_operands("paged_decode", q, kp)
    out = torch.empty_like(q)
    _split_call("paged_decode.cu", "tg_paged_decode", pa._DECODE_ARGS,
                (q, kp, vp, tables, lens, sts, out),
                (B, Nq, Nk, n_blocks, bs, tables.shape[1], D, ak._DTYPE_CODE[q.dtype], kv_code),
                scale, window, C)
    return out


@pytest.mark.parametrize("e4m3", [False, True])
@pytest.mark.parametrize("case", K9_SPLIT_CASES)
def test_paged_decode_every_split_matches_plain(dev, case, e4m3):
    """K9 (K8's split without the in-flight slots) at every cluster size C
    = 1 .. 8 against the plain version: ragged rows up to 1,023 slots, a
    row at length 0, a stale length past the table, starts > 0, windows 8,
    24 and 64, G = 1 to 16, bs 16, 48 and 64, a share past the block ids a
    block keeps, e4m3 pools beside queries of every dtype, the null block
    poisoned with NaN where no row is inactive; and the wrapper's plan."""
    D, dtype, G, Nk, bs, MB, n_blocks, lengths, starts, inactive, window = case
    q, kp, vp, tables, lens, sts, _, _ = _paged_case(
        dev, D, dtype, G, Nk, bs, MB, n_blocks, 1, lengths, starts, inactive,
        poison=not inactive)
    if e4m3:
        kp, vp = _e4m3(kp.float()), _e4m3(vp.float())
    for l in range(kp.shape[0]):
        args = (q, kp[l], vp[l], tables, lens, sts, D ** -0.5, window)
        want = pa.paged_decode_plain(*args)
        assert bool(torch.isfinite(want).all())
        tol = _paged_tol(dtype, want)
        for C in range(1, 9):
            got = _k9_split_call(args, C)
            torch.cuda.synchronize()
            assert _max_err(got, want) <= tol, f"C={C} layer {l}"
        ak.reset_launches()
        got = pa.paged_decode(*args)
        assert ak.LAUNCHES["paged_decode"] == 1
        torch.cuda.synchronize()
        assert _max_err(got, want) <= tol, f"plan layer {l}"


def test_paged_decode_pool_past_2_31_elements(dev):
    """One layer's view of a Mistral-7B serving stack at 1040 blocks: K9
    reads the last layer's last blocks, past 2^31 elements from the stack's
    start, through 64-bit offsets, at every split."""
    L, n_blocks, Nk, bs, D, G = 32, 1040, 8, 64, 128, 4
    assert L * n_blocks * Nk * bs * D > 2 ** 31
    gen = torch.Generator(device=dev).manual_seed(9)
    kp = torch.zeros(L, n_blocks, Nk, bs, D, dtype=torch.bfloat16, device=dev)
    vp = torch.zeros_like(kp)
    tables = torch.zeros(2, 12, dtype=torch.int32)
    tables[0, :11] = torch.arange(n_blocks - 1, n_blocks - 12, -1)
    tables[1, :5] = torch.arange(n_blocks - 20, n_blocks - 15)
    used = tables[tables > 0].long().to(dev)
    for pool in (kp, vp):
        pool[L - 1, used] = torch.randn((len(used), Nk, bs, D), generator=gen,
                                        device=dev).bfloat16()
    q = torch.randn((2, Nk * G, D), generator=gen, device=dev).bfloat16()
    i32 = dict(dtype=torch.int32, device=dev)
    args = (q, kp[L - 1], vp[L - 1], tables.to(dev), torch.tensor([700, 300], **i32),
            torch.zeros(2, **i32), D ** -0.5, None)
    want = pa.paged_decode_plain(*args)
    for C in (1, 3, 8):
        got = _k9_split_call(args, C)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= _paged_tol(torch.bfloat16, want), C


def test_paged_decode_frozen_and_stepwise_agree(dev):
    """K8 and K9, one kernel with and without its in-flight slots, compute
    the same attention when the in-flight K/V sit in the pool at slots
    lengths0 .. lengths0 + step: the frozen quantum's step against the
    stepwise one's, within the tolerance of each against its plain
    version."""
    D, G, Nk, bs, MB, n_blocks, N, step = 128, 4, 8, 64, 16, 257, 8, 5
    lengths = tuple(512 + 17 * i for i in range(16))
    # each row's table covers its slots through lengths0 + step
    q, kp, vp, tables, lens, sts, ki, vi = _paged_case(
        dev, D, torch.bfloat16, G, Nk, bs, MB, n_blocks, N,
        tuple(n + step + 1 for n in lengths), (0,) * 16, (), False)
    lens = lens - (step + 1)
    got8 = pa.paged_decode_frozen(q, kp, vp, tables, lens, sts, ki, vi, 1, step, D ** -0.5)
    for b, n in enumerate(lengths):  # the in-flight slots written into layer 1's pool
        for j in range(step + 1):
            t = n + j
            blk = int(tables[b, t // bs])
            kp[1, blk, :, t % bs] = ki[b, :, j]
            vp[1, blk, :, t % bs] = vi[b, :, j]
    got9 = pa.paged_decode(q, kp[1], vp[1], tables, lens + step + 1, sts, D ** -0.5)
    want = pa.paged_decode_plain(q, kp[1], vp[1], tables, lens + step + 1, sts, D ** -0.5)
    torch.cuda.synchronize()
    tol = _paged_tol(torch.bfloat16, want)
    assert _max_err(got9, want) <= tol and _max_err(got8, want) <= tol


def test_paged_decode_plan_reads_the_kernels_occupancy(dev):
    """K9's plan takes the blocks an SM from its own library
    (tg_paged_decode_plan: the kernel's occupancy, registers and shared
    memory counted): at least one at every split, type, pool type, head
    dim, group and table width, within 227 KB; without the in-flight slots
    an e4m3 pool's ring holds 8-byte rows, so a block needs no more shared
    memory than K8's at the same shape."""
    fn = _plan_fn("paged_decode.cu", "tg_paged_decode_plan", 7)
    fn8 = _plan_fn("paged_decode_frozen.cu", "tg_paged_decode_frozen_plan", 7)
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for kv_code in (ak._DTYPE_CODE[dtype], 3):
            for D in (64, 128):
                for G in (1, 3, 4, 8, 10, 16):
                    for MB in (3, 16, 4096):
                        for C in range(1, 9):
                            args = (2 * G, 2, MB, D, ak._DTYPE_CODE[dtype], kv_code, C)
                            smem, per_sm = _kernel_plan(fn, *args, n=2)
                            assert per_sm >= 1 and smem <= 227 * 1024, args
                            assert smem <= _kernel_plan(fn8, *args, n=2)[0], args
    bf16 = ak._DTYPE_CODE[torch.bfloat16]
    for Nq, Nk, D in ((12, 12, 64), (32, 8, 128), (128, 8, 128)):
        per_sm = pa._paged_per_sm(Nq, Nk, 16, D, bf16, bf16, 0, "paged_decode.cu")
        C = ak.paged_decode_split(16, Nk, Nq // Nk, 16 * 64, per_sm, ak._sm_count(0))
        assert 1 <= C <= 8 and (C == 1 or 16 * Nk * (Nq // Nk // ak.group_tile(Nq // Nk))
                                * C <= ak._sm_count(0) * per_sm[C - 1]), (Nq, Nk, per_sm)


K10_SPLIT_CASES = [
    # SPEC_CASES' layout: (D, dtype, e4m3, G, S, Nk, bs, MB, n_blocks, n_rounds, round,
    #  lengths, starts, inactive, window, poison)
    (128, torch.bfloat16, False, 4, 5, 8, 64, 16, 257, 1, 0,   # the spec serve shape
     (904, 64, 0, 500, 848, 120), (0,) * 6, (2,), None, False),
    (128, torch.bfloat16, True, 4, 5, 8, 64, 16, 257, 3, 2,    # e4m3, round 2
     (904, 64, 700, 500), (0, 0, 5, 0), (), None, True),
    (128, torch.float16, False, 4, 5, 2, 16, 60, 200, 2, 1,    # fp16, bs 16, a window
     (900, 130, 37), (0, 5, 0), (), 100, True),
    (64, torch.bfloat16, False, 1, 5, 12, 64, 16, 257, 2, 1,   # GPT-2's heads
     (1000, 65, 300), (0, 5, 0), (), 24, True),
    (128, torch.bfloat16, False, 8, 9, 2, 64, 8, 40, 2, 1,     # S * G = 72
     (500, 64, 250), (0, 0, 0), (), None, True),
    (128, torch.bfloat16, True, 16, 5, 2, 64, 8, 40, 2, 1,     # S * G = 80, e4m3, window
     (400, 64, 200), (0, 0, 0), (), 100, False),
    (64, torch.bfloat16, False, 16, 5, 2, 48, 9, 30, 3, 2,     # S * G = 80 at D 64, bs 48
     (400, 97), (10, 0), (), 300, True),
    (128, torch.bfloat16, False, 4, 12, 1, 64, 40, 60, 6, 5,   # two in-flight tiles
     (2000, 31), (0, 0), (), None, True),
    (128, torch.float32, False, 4, 5, 2, 16, 4, 20, 2, 1,      # fp32: the FMA body
     (60, 33, 1000), (0, 0, 0), (2,), 7, False),
    (64, torch.float16, True, 2, 3, 2, 16, 8, 40, 3, 2,        # fp16 over e4m3: FMA body
     (1, 17, 100, 60), (0, 5, 20, 0), (), 20, True),
]


def _k10_split_call(args, base, q_slots, infl_slots, l, scale, window, C):
    """K10 through its C entry point at split C (1 to 8), not the plan's."""
    q, kp, vp, tables, lens, sts, ki, vi, valid = args
    B, S, Nq, D = q.shape
    _, n_blocks, Nk, bs, _ = kp.shape
    kv_code, _ = ak.kv_operands("paged_decode_spec", q, kp)
    out = torch.empty_like(q)
    slots = (q_slots, infl_slots) if window else (None, None)
    _split_call("paged_decode_spec.cu", "tg_paged_decode_spec", pa._SPEC_ARGS,
                (q, kp, vp, tables, lens, sts, ki, vi, valid, *slots, out),
                (B, S, Nq, Nk, n_blocks, bs, tables.shape[1], ki.shape[2], D,
                 ak._DTYPE_CODE[q.dtype], kv_code, l, base), scale, window, C)
    return out


@pytest.mark.parametrize("case", K10_SPLIT_CASES)
def test_paged_decode_spec_every_split_matches_plain(dev, case):
    """K10 at every cluster size C = 1 .. 8 against the plain version: the
    spec serve shape's rows (one released), rounds 0 to 3 with random
    acceptance, e4m3 pools beside bf16 in-flight K/V, fp16, windows across
    the shares and inside the round, S * G = 72 and 80 (three and two row
    groups), two in-flight tiles, bs 16, 48 and 64, the null block poisoned
    with NaN where no row is inactive; fp32 q and fp16 q over an e4m3 pool
    (the FMA body, which takes no split); and the wrapper's plan."""
    D, dtype, e4m3, G, S, Nk, bs, MB, n_blocks, n_rounds, rnd, lengths, starts, inactive, \
        window, poison = case
    args, base, (q_slots, infl_slots) = _spec_case(
        dev, D, dtype, e4m3, G, S, Nk, bs, MB, n_blocks, n_rounds, rnd, lengths, starts,
        inactive, poison)
    for l in range(args[1].shape[0]):
        call = (*args, l, base, D ** -0.5, window, q_slots, infl_slots)
        want = pa.paged_decode_spec_plain(*call)
        assert bool(torch.isfinite(want).all())
        tol = (4 if e4m3 else 1) * _paged_tol(dtype, want)
        for C in range(1, 9):
            got = _k10_split_call(args, base, q_slots, infl_slots, l, D ** -0.5, window, C)
            torch.cuda.synchronize()
            assert _max_err(got, want) <= tol, f"C={C} layer {l}"
        ak.reset_launches()
        got = pa.paged_decode_spec(*call)
        assert ak.LAUNCHES["paged_decode_spec"] == 1
        torch.cuda.synchronize()
        assert _max_err(got, want) <= tol, f"plan layer {l}"


def test_paged_decode_spec_pool_past_2_31_elements(dev):
    """The Mistral-7B serving stack at 1040 blocks: K10 reads its last
    layer's last blocks through 64-bit offsets, at every split."""
    L, n_blocks, Nk, bs, D, G, S = 32, 1040, 8, 64, 128, 4, 5
    assert L * n_blocks * Nk * bs * D > 2 ** 31
    gen = torch.Generator(device=dev).manual_seed(9)
    kp = torch.zeros(L, n_blocks, Nk, bs, D, dtype=torch.bfloat16, device=dev)
    vp = torch.zeros_like(kp)
    tables = torch.zeros(2, 12, dtype=torch.int32)
    tables[0, :11] = torch.arange(n_blocks - 1, n_blocks - 12, -1)
    tables[1, :5] = torch.arange(n_blocks - 20, n_blocks - 15)
    used = tables[tables > 0].long().to(dev)
    for pool in (kp, vp):
        pool[L - 1, used] = torch.randn((len(used), Nk, bs, D), generator=gen,
                                        device=dev).bfloat16()
    q = torch.randn((2, S, Nk * G, D), generator=gen, device=dev).bfloat16()
    ki = torch.randn((2, Nk, S, D), generator=gen, device=dev).bfloat16()
    vi = torch.randn((2, Nk, S, D), generator=gen, device=dev).bfloat16()
    i32 = dict(dtype=torch.int32, device=dev)
    args = (q, kp, vp, tables.to(dev), torch.tensor([700, 300], **i32),
            torch.zeros(2, **i32), ki, vi, torch.zeros(2, S, dtype=torch.bool, device=dev))
    want = pa.paged_decode_spec_plain(*args, L - 1, 0, D ** -0.5)
    for C in (1, 3, 8):
        got = _k10_split_call(args, 0, None, None, L - 1, D ** -0.5, None, C)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= _paged_tol(torch.bfloat16, want), C


def test_paged_decode_spec_plan_reads_the_kernels_occupancy(dev):
    """K10's plan takes the blocks an SM and the row groups from the
    library (tg_paged_decode_spec_plan): at least one block an SM at every
    split, type, pool type, head dim, S * G and table width, within 227 KB;
    the tensor-core body's rows a block are attention_kernels.spec_row_tile
    (the FMA body's 16 to 64), and its shared memory does not grow with
    the split (the cluster's states live in the ring's memory)."""
    fn = _plan_fn("paged_decode_spec.cu", "tg_paged_decode_spec_plan", 8)
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for kv_code in (ak._DTYPE_CODE[dtype], 3):
            tc = dtype == torch.bfloat16 or kv_code != 3 and dtype == torch.float16
            for D in (64, 128):
                for G, S in ((1, 5), (4, 5), (8, 9), (16, 5), (12, 12)):
                    for MB in (3, 16, 4096):
                        plans = [_kernel_plan(fn, 2 * G, 2, S, MB, D, ak._DTYPE_CODE[dtype],
                                              kv_code, C, n=4) for C in range(1, 9)]
                        for smem, per_sm, rows, n_rg in plans:
                            assert per_sm >= 1 and smem <= 227 * 1024, (dtype, D, G, S, MB)
                            assert n_rg == -(-S * G // rows)
                            if tc:
                                assert rows == ak.spec_row_tile(D, S * G)
                        if tc:
                            assert len({p[0] for p in plans}) == 1
    bf16 = ak._DTYPE_CODE[torch.bfloat16]
    per_sm, n_rg = pa._spec_plan(32, 8, 5, 16, 128, bf16, bf16, 0)
    assert n_rg == 1 and per_sm[0] >= 2  # the spec serve shape: two blocks an SM at least
    assert ak.paged_spec_split(16, 8, n_rg, 16 * 64 + 5, per_sm, ak._sm_count(0)) >= 2


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


# -- gathered-expert matmuls (K12, K11a, K11b) and mixtral -------------------------
#
# The Mixtral-8x7B matrices at two layers (called at layer 1: the layer and
# expert offsets), R = 8, 32 and 160 rows with repeated ids and an unused
# expert, and small shapes at the edges: a float stack whose rows end inside
# a step, an int4 stack row-padded at quantize time, one expert taking more
# rows than a block's group of 8, fp32 stacks, experts with enough column
# tiles to run without a cluster split. Tolerances as K3 to K7
# (QTOL): the same exact dequantization, summed in another order.

from tinygpt_tpu_torch.ops import moe_kernels as mk  # noqa: E402
from tinygpt_tpu_torch.ops.quant import _quantize_moe_stacked  # noqa: E402

MOE_KERNELS = {"float": (mk.moe_gather_matmul, mk.moe_gather_matmul_plain),
               8: (mk.moe_gather_matmul_int8, mk.moe_gather_matmul_int8_plain),
               4: (mk.moe_gather_matmul_int4, mk.moe_gather_matmul_int4_plain)}
MOE_NAMES = {"float": "moe_gather_matmul", 8: "moe_gather_matmul_int8",
             4: "moe_gather_matmul_int4"}


def _moe_stack(kind, L, E, IN, OUT, group, dev, wdtype=torch.bfloat16, seed=0):
    """A random expert stack on the card: (weight args before l, the group
    or None)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((L, E, IN, OUT), generator=gen, device=dev) * 0.02
    if kind == "float":
        return (w.to(wdtype),), None
    qt = _quantize_moe_stacked(w, kind, group)
    assert qt.bits == kind
    return (qt.data, qt.scales), qt.group_size


def _moe_ids(R, E, seed):
    """Expert ids with repeats and expert E - 1 unused."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, E - 1, (R,), generator=g, dtype=torch.int32)


MOE_FULL = [  # (kind, IN, OUT): the Mixtral-8x7B gate_up and down
    (k, i, o) for k in ("float", 8, 4) for i, o in ((4096, 28672), (14336, 4096))]


@pytest.mark.parametrize("kind,IN,OUT", MOE_FULL)
def test_moe_gather_kernels_at_mixtral_widths_match_plain(dev, kind, IN, OUT):
    stack, group = _moe_stack(kind, 2, 8, IN, OUT, 128, dev)
    kern, plain = MOE_KERNELS[kind]
    extra = () if group is None else (group,)
    for R in (8, 32, 160):
        idx = _moe_ids(R, 8, R).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = _randn(torch.Generator().manual_seed(R), R, IN, dtype=dtype, dev=dev)
            ak.reset_launches()
            got = kern(x, *stack, 1, idx, *extra)
            assert ak.LAUNCHES[MOE_NAMES[kind]] == 1
            want = plain(x, *stack, 1, idx, *extra)
            torch.cuda.synchronize()
            assert got.dtype == dtype and got.shape == (R, OUT)
            _qclose(got, want, dtype, f"{MOE_NAMES[kind]} R={R} {dtype}")


MOE_EDGES = [
    # (kind, L, E, IN, OUT, group, R, ids, wdtype)
    ("float", 2, 3, 72, 40, None, 5, None, torch.bfloat16),   # rows end inside a step
    ("float", 2, 4, 256, 264, None, 33, None, torch.float32),  # fp32 stack
    ("float", 1, 2, 64, 8, None, 1, None, torch.bfloat16),     # one row
    (8, 2, 4, 80, 136, 16, 5, None, None),                     # IN 80: uneven row split
    (8, 2, 2, 256, 64, 64, 40, [1] * 40, None),                # 40 rows, one expert
    (4, 2, 3, 128, 256, 32, 7, None, None),                    # row-padded to 256
    (4, 2, 4, 896, 512, 128, 12, None, None),                  # 896 -> 1024
    (4, 1, 8, 512, 1024, 64, 16, [7, -3, 12, 0] * 4, None),    # ids clamped
    ("float", 1, 64, 64, 2304, None, 33, None, torch.bfloat16),  # many column tiles:
    (4, 1, 66, 256, 2048, 64, 12, None, None),                 # no cluster split
]


@pytest.mark.parametrize("case", MOE_EDGES)
def test_moe_gather_kernels_at_the_edges_match_plain(dev, case):
    kind, L, E, IN, OUT, group, R, ids, wdtype = case
    stack, g = _moe_stack(kind, L, E, IN, OUT, group, dev, wdtype or torch.bfloat16, seed=3)
    kern, plain = MOE_KERNELS[kind]
    extra = () if g is None else (g,)
    idx = (_moe_ids(R, E, 5) if ids is None else torch.tensor(ids, dtype=torch.int32)).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = _randn(torch.Generator().manual_seed(6), R, IN, dtype=dtype, dev=dev)
        for l in range(L):
            got = kern(x, *stack, l, idx, *extra)
            want = plain(x, *stack, l, idx, *extra)
            torch.cuda.synchronize()
            _qclose(got, want, dtype, f"{case} layer {l} {dtype}")


MOE_TC_ROWS = (1, 8, 32, 33, 160)
MOE_TC_SPLITS = (1, 2, 4, 6, 8, 12, 16)  # cluster sizes beside the plan's (1, 2, 4, 8, 16)


def _moe_tc_call(x, w, l, idx, split):
    """K12 on a bf16 stack through its C entry point at split `split`."""
    import ctypes

    from tinygpt_tpu_torch.ops import cuda_build

    fn = cuda_build.function("moe_gather_matmul.cu", "tg_moe_gather_float", mk._FLOAT_ARGS)
    L, E, IN, OUT = w.shape
    out = torch.empty((x.shape[0], OUT), dtype=x.dtype, device=x.device)
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (x, w, idx, out)), x.shape[0], IN, OUT,
             E, l, ak._DTYPE_CODE[x.dtype], ak._DTYPE_CODE[w.dtype], split,
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0, (split, err)
    return out


@pytest.mark.parametrize("R", MOE_TC_ROWS)
def test_moe_gather_bf16_rows_and_splits_match_plain(dev, R):
    """K12 on a bf16 stack at R = 1, 8, 32, 33 and 160 rows, with repeats
    and an unused expert, and with every row on one expert (R / 64 passes),
    in bf16 and fp32 activations, at the plan's split and at every split
    of MOE_TC_SPLITS; IN 1040 is not a multiple of the splits' 16 rows a
    unit."""
    (w,), _ = _moe_stack("float", 2, 8, 1040, 392, None, dev, seed=4)
    for ids in (_moe_ids(R, 8, R), torch.full((R,), 5, dtype=torch.int32)):
        idx = ids.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = _randn(torch.Generator().manual_seed(R + 1), R, 1040, dtype=dtype, dev=dev)
            want = mk.moe_gather_matmul_plain(x, w, 1, idx)
            ak.reset_launches()
            got = mk.moe_gather_matmul(x, w, 1, idx)
            assert ak.LAUNCHES["moe_gather_matmul"] == 1
            torch.cuda.synchronize()
            _qclose(got, want, dtype, f"R={R} {dtype} plan")
            for split in MOE_TC_SPLITS:
                got = _moe_tc_call(x, w, 1, idx, split)
                torch.cuda.synchronize()
                _qclose(got, want, dtype, f"R={R} {dtype} split {split}")


def _moe_q_call(x, data, scales, l, idx, group, bits, split):
    """K11a (bits 8) or K11b (bits 4) through its C entry point at split
    `split` (above 8 rows, the plan's split for the launch over the experts
    that at most 8 rows name)."""
    import ctypes

    from tinygpt_tpu_torch.ops import cuda_build

    L, E, rows, OUT = data.shape
    out = torch.empty((x.shape[0], OUT), dtype=x.dtype, device=x.device)
    split_few = mk._q_splits(x, E, rows * (8 // bits), OUT, bits)[1]
    if bits == 8:
        fn = cuda_build.function("moe_gather_matmul.cu", "tg_moe_gather_int8", mk._INT8_ARGS)
        ints = (x.shape[0], rows, OUT, E, group, l)
    else:
        fn = cuda_build.function("moe_gather_matmul.cu", "tg_moe_gather_int4", mk._INT4_ARGS)
        ints = (x.shape[0], x.shape[1], 2 * rows, OUT, E, group, l)
    err = fn(*(ctypes.c_void_p(t.data_ptr()) for t in (x, data, scales, idx, out)), *ints,
             ak._DTYPE_CODE[x.dtype], split, split_few,
             ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    assert err == 0, (bits, split, err)
    return out


MOE_Q_CASES = [
    # (bits, IN, OUT, group): int8 at groups 16 and 128, OUT 392 (rows only
    # 8-byte aligned) and 384; int4 at group 128, and row-padded (1036 ->
    # 1280: x of 1036 columns, not a multiple of 8, staged through
    # registers) at group 16
    (8, 1040, 392, 16), (8, 1024, 384, 128), (4, 1024, 384, 128), (4, 1036, 392, 16)]


@pytest.mark.parametrize("R", MOE_TC_ROWS)
@pytest.mark.parametrize("case", MOE_Q_CASES)
def test_moe_gather_quant_rows_and_splits_match_plain(dev, case, R):
    """K11a and K11b at R = 1, 8, 32, 33 and 160 rows, with repeats and an
    unused expert, with every row on one expert (passes of 32 rows), and
    with 12 rows on one expert beside experts of few rows (both launches of
    a call above 8 rows), in bf16 and fp32 activations, at the plan's split
    (through the wrapper: one launch counted) and at every split of
    MOE_TC_SPLITS whose rows fit a block (tg_moe_gather_plan)."""
    bits, IN, OUT, group = case
    (data, scales), g = _moe_stack(bits, 2, 8, IN, OUT, group, dev, seed=7)
    kern, plain = MOE_KERNELS[bits]
    fn = _plan_fn("moe_gather_matmul.cu", "tg_moe_gather_plan", 5)
    stored = data.shape[2]
    skew = torch.cat([torch.full((min(R, 12),), 2, dtype=torch.int32), _moe_ids(R, 8, R)])[:R]
    for ids in (_moe_ids(R, 8, R), torch.full((R,), 5, dtype=torch.int32), skew):
        idx = ids.to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = _randn(torch.Generator().manual_seed(R + 2), R, IN, dtype=dtype, dev=dev)
            want = plain(x, data, scales, 1, idx, g)
            ak.reset_launches()
            got = kern(x, data, scales, 1, idx, g)
            assert ak.LAUNCHES[MOE_NAMES[bits]] == 1
            torch.cuda.synchronize()
            _qclose(got, want, dtype, f"{case} R={R} {dtype} plan")
            for split in MOE_TC_SPLITS:
                nt = _kernel_plan(fn, R, stored * (8 // bits), ak._DTYPE_CODE[dtype], bits,
                                  split, n=3)[0]
                if not nt or split > stored // 16:
                    continue
                got = _moe_q_call(x, data, scales, 1, idx, g, bits, split)
                torch.cuda.synchronize()
                _qclose(got, want, dtype, f"{case} R={R} {dtype} split {split}")


def test_moe_gather_host_plan_matches_the_kernel(dev):
    """moe_kernels._model_plan, the CPU tests' model of the gathered
    kernels' launches (K12 on bf16 stacks, K11a, K11b), against what the
    library reports (tg_moe_gather_plan, which the wrappers' plan reads
    through _library_plan): the n-tiles a pass, a block's shared memory and
    K11's blocks an SM (its occupancy: registers and shared memory), at
    every split the C entry points take, bf16 and fp32 activations, row
    counts 1 to 200 and widths from 16 to 65536."""
    fn = _plan_fn("moe_gather_matmul.cu", "tg_moe_gather_plan", 5)
    for bits in (16, 8, 4):
        for dtype, parts in ((torch.bfloat16, 1), (torch.float32, 2)):
            for R in sorted(set(range(1, 201, 7)) | {8, 16, 17, 32, 33, 64, 65, 160}):
                for IN in (16, 72, 1040, 4096, 14336, 65536):
                    for split in range(1, 17):
                        got = _kernel_plan(fn, R, IN, ak._DTYPE_CODE[dtype], bits, split, n=3)
                        assert got == mk._model_plan(R, IN, parts, split, bits), (
                            bits, R, IN, split)
                        assert got == mk._library_plan(R, IN, parts, split, bits)


def test_moe_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    """No fallback: CPU ids beside card weights, an fp16 activation, int64
    ids, a bad layer, group or scale dtype, and x wider than the stack
    raise."""
    (data, scales), g = _moe_stack(4, 2, 4, 256, 128, 64, dev)
    (w,), _ = _moe_stack("float", 2, 4, 256, 128, None, dev)
    x = _randn(torch.Generator().manual_seed(1), 4, 256, dtype=torch.bfloat16, dev=dev)
    idx = torch.tensor([0, 1, 1, 3], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="expected"):
        mk.moe_gather_matmul_int4(x, data, scales, 0, idx.cpu(), g)
    with pytest.raises(TypeError, match="dtype"):
        mk.moe_gather_matmul(x.half(), w, 0, idx)
    with pytest.raises(TypeError, match="int32"):
        mk.moe_gather_matmul(x, w, 0, idx.long())
    with pytest.raises(TypeError, match="stack"):
        mk.moe_gather_matmul(x, w.half(), 0, idx)
    with pytest.raises(ValueError, match="layer"):
        mk.moe_gather_matmul_int4(x, data, scales, 2, idx, g)
    with pytest.raises(ValueError, match="group"):
        mk.moe_gather_matmul_int4(x, data, scales, 0, idx, 24)
    with pytest.raises(TypeError, match="scales"):
        mk.moe_gather_matmul_int4(x, data, scales.half(), 0, idx, g)
    with pytest.raises(ValueError, match="columns"):
        mk.moe_gather_matmul_int4(torch.cat([x, x], 1), data, scales, 0, idx, g)
    with pytest.raises(ValueError, match="columns"):
        mk.moe_gather_matmul(x[:, :128].contiguous(), w, 0, idx)


def _mixtral_cfg():
    return parse_model_config(dict(model_type="mixtral", vocab_size=211, hidden_size=256,
                                   intermediate_size=512, num_hidden_layers=2,
                                   num_attention_heads=4, num_key_value_heads=2,
                                   num_local_experts=4, num_experts_per_tok=2,
                                   max_position_embeddings=96))


@pytest.mark.parametrize("weights", ["float32", "bfloat16", "int4"])
def test_mixtral_on_the_card_matches_the_cpu(dev, weights):
    """A tiny mixtral (4 experts, top 2, H = 256 so int4 stays int4): the
    prefill logits, two frozen decode chunks (K12 on float stacks, K11b on
    int4 ones, in every layer of every step) and forward_paged steps on the
    card against the same params through the plain versions on the CPU.
    fp32 and int4 in fp32: logits within 1e-4, identical tokens; bf16: the
    prefill logits within 0.05 (bf16 rounds at other places), the decode
    fed the CPU's tokens."""
    from tinygpt_tpu_torch.engine.paged_kv import PagedKVState
    from tinygpt_tpu_torch.ops.quant import QuantizedTensor, quantize_params

    cfg = _mixtral_cfg()
    dtype = torch.bfloat16 if weights == "bfloat16" else torch.float32
    params = causal_lm.init_params(cfg, seed=0, dtype=dtype, device="cpu")
    if weights == "int4":
        params = quantize_params(params, bits=4, group_size=64)
        assert params["layers"]["moe_gate_up_w"].bits == 4

    def to(v, where):
        if isinstance(v, QuantizedTensor):
            return QuantizedTensor(v.data.to(where), v.scales.to(where), v.bits,
                                   v.group_size, v.in_dim)
        return v if v is None else v.to(where)

    pcard = {k: {n: to(t, dev) for n, t in v.items()} if k == "layers" else to(v, dev)
             for k, v in params.items()}
    gen = torch.Generator().manual_seed(2)
    ids = torch.randint(3, cfg.vocab_size, (3, 24), generator=gen, dtype=torch.int32)
    pos = torch.arange(24, dtype=torch.int32)[None].expand(3, 24).contiguous()
    pools = torch.randn(2, 2, 12, 2, 16, 64, generator=gen).to(dtype)
    outs, fed = {}, None
    moe = "moe_gather_matmul_int4" if weights == "int4" else "moe_gather_matmul"
    for where, p, impl in (("cpu", params, "plain"), (dev, pcard, "kernel")):
        cache = create_kv_cache(cfg, 3, 48, dtype=dtype, device=where)
        lg, cache = causal_lm.forward(p, cfg, ids.to(where), cache, pos.to(where),
                                      torch.ones(3, 24, dtype=torch.bool, device=where),
                                      attn_impl=impl)
        seen = []

        def pick(x, where=where):
            seen.append(x.float().cpu())
            tok = x.argmax(-1) if fed is None else fed[len(seen) - 1].to(where)
            return tok.to(torch.int32)

        ak.reset_launches()
        tok = lg[:, -1].argmax(-1).to(torch.int32)
        for c in range(2):
            toks, cache = causal_lm.decode_steps(p, cfg, tok, cache,
                                                 pos[:, -1:].to(where) + 1 + 8 * c, 8, pick,
                                                 attn_impl=impl)
            tok = toks[-1]
        if impl == "kernel":
            torch.cuda.synchronize()
            assert ak.LAUNCHES[moe] == 2 * 16 * cfg.num_hidden_layers   # gate_up, down
        fed = torch.stack([s.argmax(-1) for s in seen]) if fed is None else fed
        st = PagedKVState(
            k_pool=pools[0].clone().to(where), v_pool=pools[1].clone().to(where),
            block_tables=torch.tensor([[1, 2, 3, 4, 5, 6], [7, 8, 0, 0, 0, 0]],
                                      dtype=torch.int32, device=where),
            lengths=torch.tensor([70, 20], dtype=torch.int32, device=where),
            starts=torch.tensor([0, 2], dtype=torch.int32, device=where),
            active=torch.tensor([True, True], device=where))
        paged = [causal_lm.forward_paged(p, cfg, fed[i, :2].to(torch.int32).to(where), st,
                                         attn_impl=impl)[0] for i in range(3)]
        outs[impl] = (lg.float().cpu(), torch.stack(seen), torch.stack(paged).float().cpu())
    (lg_c, dec_c, pg_c), (lg_k, dec_k, pg_k) = outs["plain"], outs["kernel"]
    tol = 0.05 if weights == "bfloat16" else 1e-4
    assert (lg_k - lg_c).abs().max().item() <= tol
    assert (dec_k - dec_c).abs().max().item() <= tol
    assert (pg_k - pg_c).abs().max().item() <= tol


# -- the one-layer decode kernel (K13) and the streaming engine -------------------
#
# flash_decode against its plain version, the tolerances above (one ulp of an
# output below 2; e4m3 caches decode exactly, outputs of e4m3 values x4
# reach ~8); then decode_step and GPTEngine.generate_async on the card
# against the CPU.

K13_CASES = [
    # (D, dtype, Nq, Nk, T, pads, length, window)
    (64, torch.float32, 4, 4, 1, (0,), 1, None),                # G = 1, T = 1
    (128, torch.bfloat16, 32, 8, 576, (0, 112, 212, 384), 576, None),  # the main path's
    (128, torch.bfloat16, 8, 4, 37, (0, 9, 37), 30, None),      # a row sees no slot
    (64, torch.float16, 6, 2, 300, (0, 200), 290, 50),          # G = 3, window
    (128, torch.float32, 10, 2, 130, (3, 0), 129, 3),           # G = 5, narrow window
    (128, torch.bfloat16, 128, 8, 200, (0, 77), 150, None),     # G = 16: 2 blocks a head
    (64, torch.float32, 24, 2, 100, (5, 0), 90, 30),            # G = 12: 2 blocks of 6
]


def _k13_inputs(dev, case, seed, e4m3=False):
    D, dtype, Nq, Nk, T, pads, length, window = case
    gen = torch.Generator().manual_seed(seed)
    B = len(pads)
    if e4m3:
        k = _e4m3(_randn(gen, B, Nk, T, D, dtype=torch.float32, dev=dev))
        v = _e4m3(_randn(gen, B, Nk, T, D, dtype=torch.float32, dev=dev))
    else:
        k = _randn(gen, B, Nk, T, D, dtype=dtype, dev=dev)
        v = _randn(gen, B, Nk, T, D, dtype=dtype, dev=dev)
    q = _randn(gen, B, Nq, D, dtype=dtype, dev=dev)
    slots = torch.arange(T, device=dev)[None, :]
    pad = torch.tensor(pads, device=dev)[:, None]
    valid = (slots >= pad) & (slots < length)
    kv_pos = (slots - pad).clamp(min=0)
    pos = (length - 1 - pad).clamp(min=0)
    mask = valid & (kv_pos <= pos)
    if window:
        mask &= kv_pos > pos - window
    return q, k, v, mask, D ** -0.5


@pytest.mark.parametrize("e4m3", [False, True])
@pytest.mark.parametrize("case", K13_CASES)
def test_flash_decode_kernel_matches_plain(dev, case, e4m3):
    q, k, v, mask, scale = _k13_inputs(dev, case, 20, e4m3)
    ak.reset_launches()
    got = ak.flash_decode(q, k, v, mask, scale)
    assert ak.LAUNCHES["flash_decode"] == 1
    want = ak.flash_decode_plain(q, k, v, mask, scale)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= TOL[q.dtype] * (4 if e4m3 else 1)
    for b in range(q.shape[0]):  # a row that sees no slot gives zeros
        if not mask[b].any():
            assert not got[b].any()
    got_u8 = ak.flash_decode(q, k, v, mask.to(torch.uint8), scale)
    assert torch.equal(got_u8, got)


# the edges of K13's split (clusters of decode_split's C blocks, each a
# share of the visible span in 32-slot tiles): spans of 0, 1 and fewer slots
# than C, a span inside one block's share, T that C does not divide, holes
# in the mask, the stream's batch-1 shape, and one e4m3 cache beside each
K13_EDGE_CASES = [
    # (D, dtype, Nq, Nk, T, visible (start, count) per row, or "holes")
    (128, torch.bfloat16, 32, 8, 576, ((0, 0), (100, 1), (300, 3), (0, 576))),
    (128, torch.bfloat16, 32, 8, 192, ((28, 108),)),           # the stream at batch 1
    (64, torch.float16, 12, 4, 1000, ((500, 40), (10, 990), (999, 1), (0, 0))),
    (128, torch.float32, 128, 8, 333, ((5, 300), (0, 333))),   # G = 16
    (64, torch.bfloat16, 8, 8, 4096, ((4000, 96),)),           # a long scan, span at the end
    (128, torch.bfloat16, 32, 8, 700, "holes"),                 # tiles the mask hides whole
]


@pytest.mark.parametrize("e4m3", [False, True])
@pytest.mark.parametrize("case", K13_EDGE_CASES)
def test_flash_decode_split_edges_match_plain(dev, case, e4m3):
    D, dtype, Nq, Nk, T, rows = case
    gen = torch.Generator().manual_seed(40)
    if rows == "holes":  # every other 64-slot stretch hidden, random bits in the rest
        mask = (torch.rand(3, T, generator=gen) < 0.5) & ((torch.arange(T) // 64) % 2 == 0)
    else:
        mask = torch.zeros(len(rows), T, dtype=torch.bool)
        for b, (a, n) in enumerate(rows):
            mask[b, a:a + n] = True
    B = mask.shape[0]
    mask = mask.to(dev)
    if e4m3:
        k = _e4m3(_randn(gen, B, Nk, T, D, dtype=torch.float32, dev=dev))
        v = _e4m3(_randn(gen, B, Nk, T, D, dtype=torch.float32, dev=dev))
    else:
        k = _randn(gen, B, Nk, T, D, dtype=dtype, dev=dev)
        v = _randn(gen, B, Nk, T, D, dtype=dtype, dev=dev)
    q = _randn(gen, B, Nq, D, dtype=dtype, dev=dev)
    ak.reset_launches()
    got = ak.flash_decode(q, k, v, mask, D ** -0.5)
    assert ak.LAUNCHES["flash_decode"] == 1
    want = ak.flash_decode_plain(q, k, v, mask, D ** -0.5)
    torch.cuda.synchronize()
    assert _max_err(got, want) <= TOL[dtype] * (4 if e4m3 else 1)
    for b in range(B):  # a row that sees no slot gives zeros
        if not mask[b].any():
            assert not got[b].any()


# the edges of K2's split (decode_split.cuh: the frozen span plus the
# in-flight tile, cut over clusters of decode_split(B, Nk, G, T + N)
# blocks): T shorter than one tile, every frozen slot hidden, window 1, and
# the cluster sizes the plan picks at B = 1 (8) and at B = 16 (1)
K2_EDGE_CASES = [
    # (D, dtype, Nq, Nk, T, N, step, window, frozen visible (start, count) per row, C)
    (128, torch.bfloat16, 32, 8, 20, 32, 31, None, ((3, 17), (0, 20)), 1),
    (128, torch.bfloat16, 32, 8, 576, 32, 5, None, ((0, 0), (0, 0), (0, 0), (0, 0)), 4),
    (64, torch.float32, 8, 2, 300, 16, 9, 1, ((0, 300), (10, 5)), 5),
    (128, torch.bfloat16, 32, 8, 1024, 32, 31, None, ((100, 900),), 8),
    (128, torch.bfloat16, 32, 8, 576, 32, 17, None, tuple((17 * b, 544 - 17 * b)
                                                          for b in range(16)), 1),
]


@pytest.mark.parametrize("e4m3", [False, True])
@pytest.mark.parametrize("case", K2_EDGE_CASES)
def test_flash_decode_frozen_split_edges_match_plain(dev, case, e4m3):
    D, dtype, Nq, Nk, T, N, step, window, rows, C = case
    B, L = len(rows), 2
    assert ak.decode_split(B, Nk, Nq // Nk, T + N) == C
    gen = torch.Generator().manual_seed(41)
    mask = torch.zeros(B, T, dtype=torch.bool)
    for b, (a, n) in enumerate(rows):
        mask[b, a:a + n] = True
    mask = mask.to(dev)
    if e4m3:
        ks = _e4m3(_randn(gen, L, B, Nk, T, D, dtype=torch.float32, dev=dev))
        vs = _e4m3(_randn(gen, L, B, Nk, T, D, dtype=torch.float32, dev=dev))
        itype = torch.bfloat16
    else:
        ks = _randn(gen, L, B, Nk, T, D, dtype=dtype, dev=dev)
        vs = _randn(gen, L, B, Nk, T, D, dtype=dtype, dev=dev)
        itype = dtype
    ki = _randn(gen, B, Nk, N, D, dtype=itype, dev=dev)
    vi = _randn(gen, B, Nk, N, D, dtype=itype, dev=dev)
    q = _randn(gen, B, Nq, D, dtype=dtype, dev=dev)
    for l in range(L):
        args = (q, ks, vs, mask, ki, vi, l, step, D ** -0.5, window)
        ak.reset_launches()
        got = ak.flash_decode_frozen(*args)
        assert ak.LAUNCHES["flash_decode_frozen"] == 1
        want = ak.flash_decode_frozen_plain(*args)
        torch.cuda.synchronize()
        assert _max_err(got, want) <= TOL[dtype] * (4 if e4m3 else 1), f"layer {l}"


def test_flash_decode_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    k = torch.zeros(1, 2, 8, 64, device=dev)
    mask = torch.ones(1, 8, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        ak.flash_decode(torch.zeros(1, 4, 96, device=dev), torch.zeros(1, 2, 8, 96, device=dev),
                        torch.zeros(1, 2, 8, 96, device=dev), mask, 0.1)
    with pytest.raises(ValueError, match="at most"):
        ak.flash_decode(torch.zeros(1, 34, 64, device=dev), k, k, mask, 0.1)
    with pytest.raises(ValueError, match="mask"):
        ak.flash_decode(torch.zeros(1, 4, 64, device=dev), k, k, mask[:, :7], 0.1)
    with pytest.raises(TypeError, match="dtype"):
        ak.flash_decode(torch.zeros(1, 4, 64, device=dev), k.half(), k.half(), mask, 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ak.flash_decode(torch.zeros(1, 4, 64, device=dev),
                        k.transpose(2, 3).contiguous().transpose(2, 3), k, mask, 0.1)


def test_decode_step_on_the_card_matches_the_cpu(dev):
    """A 2-layer fp32 model with a window: two left-padded rows, a prefill
    and eight decode_step calls through K1 and K13 on the card against the
    plain versions on the CPU (logits within 1e-4, same greedy tokens)."""
    cfg = parse_model_config(dict(
        model_type="mistral", vocab_size=211, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256, sliding_window=9))
    params = causal_lm.init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    gen = torch.Generator().manual_seed(3)
    S, lens, n = 24, (24, 13), 8
    ids = torch.randint(3, cfg.vocab_size, (len(lens), S), generator=gen)
    pad = torch.tensor([S - x for x in lens])[:, None]
    valid = torch.arange(S)[None, :] >= pad
    positions = torch.where(valid, torch.arange(S)[None, :] - pad, 0).to(torch.int32)

    def run(device):
        p = {k: v.to(device) if isinstance(v, torch.Tensor) else
             ({m: t.to(device) for m, t in v.items()} if isinstance(v, dict) else v)
             for k, v in params.items()}
        cache = create_kv_cache(cfg, len(lens), S + n, dtype=torch.float32, device=device)
        lg, cache = causal_lm.forward(p, cfg, ids.to(device), cache, positions.to(device),
                                      valid.to(device), last_only=True)
        out = [lg[:, -1].cpu()]
        for i in range(n):
            tok = out[-1].argmax(-1).to(torch.int32).to(device)
            pos = torch.tensor(lens, device=device)[:, None] + i
            lg, cache = causal_lm.decode_step(p, cfg, tok, cache, pos)
            out.append(lg[:, -1].cpu())
        return torch.stack(out)

    want = run("cpu")
    ak.reset_launches()
    got = run(dev)
    assert dict(ak.LAUNCHES) == {"flash_prefill": 2, "flash_decode": 2 * n}
    assert _max_err(got, want) <= 1e-4
    assert torch.equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("quantization", [None, "int4"])
def test_generate_async_on_the_card_matches_the_cpu(dev, tmp_path, quantization):
    """GPTEngine.generate_async on the card at stream_chunk 1 (decode_step,
    K13 once a layer a token) and 8 (K2), paced and not, in fp32 (int4:
    the fused route, K6 and K7): the CPU's greedy tokens and text, and
    generate_sync's on the card."""
    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine

    d = _model_dir(tmp_path, _TINY_DIR_CFG)
    kw = dict(model_dir=d, dtype="float32", max_tokens=17, prefill_bucket=16,
              quantization=quantization, awq=False if quantization else None)
    prompt = "the quick brown fox jumps over the lazy dog"
    cpu = GPTEngine(GPTConfig(device="cpu", **kw))
    cpu.prepare()
    want = cpu.generate_sync([prompt])[0]
    for chunk, pace in ((1, False), (8, True), (8, False)):
        eng = GPTEngine(GPTConfig(device="cuda", stream_chunk=chunk, stream_pace=pace,
                                  decode_chunk=chunk, **kw))
        eng.prepare()
        chunks = []
        ak.reset_launches()
        out = eng.generate_async(prompt, lambda c, done: (chunks.append(c), True)[1])
        torch.cuda.synchronize()
        attn = "flash_decode" if chunk == 1 else "flash_decode_frozen"
        assert ak.LAUNCHES[attn] == 2 * 16 and ak.LAUNCHES["flash_prefill"] == 2
        assert out.token_ids == want.token_ids == eng.generate_sync([prompt])[0].token_ids
        assert "".join(chunks) == want.text
