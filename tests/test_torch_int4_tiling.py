"""The arithmetic of the Hopper int4 GEMV (K4, K5b at M <= 32, K6 and K7,
csrc/int4_common.cuh), emulated here on the CPU and held against the JAX
kernels.

The card splits IN/2 (the packed rows) over the C blocks of a cluster
(quant_kernels.int4_gemv_split) and each block's rows over its k warps, in
16-row chunks. A nibble becomes the exact bf16 u - 8 (a byte permute, a
LOP3 under the exponent of 128, a bf16x2 subtraction of 136). The
activation goes in as P bf16 parts: one for bf16 x, two for a bf16 call's
fp32 activation (x * ln is exact in two, silu(g) * u within 2^-17), three
in fp32 (exact); the norm's row factor invrms multiplies the sums. Each
warp sums x * (u - 8) per group and plane in fp32 and adds the high
plane's sums, then the low plane's, each times its scale, to its
accumulators; then the block sums its k warps, and the cluster its ranks,
in a fixed order, and the epilogue rounds once. The emulation below
repeats that cut and that order in torch and is held against
tinygpt_tpu's matmul_dequant_int4, _stacked, _stacked_fused and
mlp_fused_int4_stacked in interpret mode (as tests/test_torch_quant_kernels.py
runs them), relative to the largest output: 2e-6 in fp32, one bf16 ulp
(2^-7) in bf16. The card tests (tests/test_torch_cuda.py) hold the kernel
itself against its plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops import quant as jq
from tinygpt_tpu.ops import quant_kernels as jk
from tinygpt_tpu_torch.ops import quant_kernels as qk

UNIT = 16   # packed rows of a chunk and of the split's unit
SMS = 132   # the H100's SMs
SHAPES = {  # (IN, OUT) of the main path's matrices
    "mistral_qkv": (4096, 6144), "mistral_o": (4096, 4096),
    "mistral_gate_up": (4096, 28672), "mistral_down": (14336, 4096),
    "mistral_head": (4096, 32768), "gpt2_qkv": (768, 2304), "gpt2_o": (768, 768),
    "gpt2_fc": (768, 3072), "gpt2_proj": (3072, 768), "qwen3_qkv": (2048, 4096),
    "qwen3_down": (6144, 2048), "qwen2_qkv": (896, 1152), "qwen2_down": (4864, 896),
}


def _ntiles(M: int) -> int:
    return 1 if M <= 8 else 2 if M <= 16 else 4


def _cut(half: int, C: int, nt: int) -> list:
    """The packed rows [r0, r1) of each (block rank, k warp), as the kernel
    cuts them: rank r takes 16-row units [r n16 / C, (r + 1) n16 / C), its
    k warp w (of 8 / nt) the units [u0 + w nu / kw, u0 + (w + 1) nu / kw)."""
    n16, kw = half // UNIT, 8 // nt
    cut = []
    for r in range(C):
        u0, u1 = r * n16 // C, (r + 1) * n16 // C
        nu = u1 - u0
        cut.append([((u0 + w * nu // kw) * UNIT, (u0 + (w + 1) * nu // kw) * UNIT)
                    for w in range(kw)])
    return cut


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("M", [1, 4, 16, 32])
def test_int4_split_covers_every_row_once(M, shape, parts):
    IN, OUT = SHAPES[shape]
    half = IN // 2
    C = qk.int4_gemv_split(M, IN, OUT, parts, SMS)
    assert C in qk._I4_SPLITS and C <= max(1, half // UNIT)
    nt, route, smem = qk.int4_gemv_plan(M, IN, C, parts)
    assert nt == _ntiles(M)  # one pass over the rows: every row of x in a block
    owner = np.zeros(half, np.int64)
    for warps in _cut(half, C, nt):
        for r0, r1 in warps:
            assert r0 <= r1 and (r1 - r0) % UNIT == 0
            owner[r0:r1] += 1
    assert (owner == 1).all()  # every packed row, exactly once
    nk = -(-half // UNIT // C) * UNIT
    assert route == qk._i4_route(M, parts, False)
    assert smem == qk._i4_smem(nt, nk, parts, route) <= qk._I4_SMEM


def test_int4_split_at_the_main_path():
    """The plan's pick at the Mistral-7B shapes, at the decode batch (M = 4)
    and the serving quantum (M = 16), for bf16 x (one part: K5b, K4, K6's
    o) and an fp32 activation (two parts: K6's qkv and head, K7), both on
    ring routes (two blocks an SM): the fastest C of chip_smoke.py's int4
    split sweep at every one of these matrices on the H100."""
    want = {"qkv": 4, "o": 6, "gate_up": 1, "down": 6, "head": 1}
    for k, C in want.items():
        for M in (4, 16):
            for parts in (1, 2):
                assert qk.int4_gemv_split(M, *SHAPES["mistral_" + k], parts, SMS) == C, (k, M)


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays: byte n of the result
    is byte (sel >> 4n) & 7 of the 8 bytes y:x."""
    out = np.zeros_like(x)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        b = (x >> (8 * k)) & 0xFF if k < 4 else (y >> (8 * (k - 4))) & 0xFF
        out |= b << (8 * n)
    return out


def _bf16x2(bits: np.ndarray) -> tuple:
    lo = (bits & 0xFFFF).astype(np.uint32) << 16
    hi = bits & 0xFFFF0000
    return lo.view(np.float32), hi.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("b", [0, 2])
def test_nibble_conversion_is_exact_for_every_byte(b):
    """Every byte pair at byte positions b, b + 1 of two rows' words, both
    planes: the permute, the LOP3 under 0x4300 and the subtraction of 136
    (exact in bf16: 128 + u - 136) give each nibble's u - 8, row a in the
    low half and row b in the high half of each pair."""
    u = np.arange(256, dtype=np.uint32)
    ra = (u << (8 * b)) | (np.roll(u, 1) << (8 * (b + 1)))   # row a: bytes b, b + 1
    rb = (np.roll(u, 7) << (8 * b)) | (np.roll(u, 3) << (8 * (b + 1)))
    sel = b | ((b + 1) << 4) | ((b + 4) << 8) | ((b + 5) << 12)
    x = _byte_perm(ra, rb, sel)
    for plane, shift in ((0, 0), (1, 4)):
        for pos, s8 in ((b, 0), (b + 1, 8)):
            t = (((x >> shift) >> s8) & 0x000F000F) | 0x43004300
            lo, hi = _bf16x2(t)
            lo, hi = lo - np.float32(136), hi - np.float32(136)
            want_a = ((ra >> (8 * pos)) & 0xFF) >> (4 * plane) & 0xF
            want_b = ((rb >> (8 * pos)) & 0xFF) >> (4 * plane) & 0xF
            assert np.array_equal(lo, want_a.astype(np.float32) - 8)
            assert np.array_equal(hi, want_b.astype(np.float32) - 8)


def _parts(a: torch.Tensor, P: int) -> torch.Tensor:
    """The activation as the kernel multiplies it: the sum of P bf16 parts,
    each the bf16 of what the earlier parts left."""
    out, rem = torch.zeros_like(a), a.clone()
    for _ in range(P):
        b = rem.to(torch.bfloat16).float()
        out, rem = out + b, rem - b
    return out


def test_activation_split_error():
    """Three parts are exact for fp32 activations; two are exact for a
    product of two bf16 values (x * ln) and within 2^-17 of any fp32 value
    (silu(g) * u); one is exact for bf16 x."""
    g = torch.Generator().manual_seed(0)
    a = torch.randn(4096, generator=g) * torch.exp(torch.randn(4096, generator=g) * 3)
    assert torch.equal(_parts(a, 3), a)
    assert ((_parts(a, 2) - a).abs() <= 2.0 ** -17 * a.abs()).all()
    xb = torch.randn(4096, generator=g).to(torch.bfloat16).float()
    lb = (1 + 0.1 * torch.randn(4096, generator=g)).to(torch.bfloat16).float()
    assert torch.equal(_parts(xb * lb, 2), xb * lb)
    assert torch.equal(_parts(xb, 1), xb)


def _planes(data: torch.Tensor) -> tuple:
    u = data.view(torch.uint8).to(torch.int32)
    return ((u & 0xF) - 8).float(), ((u >> 4) - 8).float()


def _gemv_emulated(a: torch.Tensor, data: torch.Tensor, scales: torch.Tensor, group: int,
                   C: int, nt: int) -> torch.Tensor:
    """The kernel's sums for the activation a [M, IN] (fp32, parts already
    summed) and one layer's packed data [IN/2, OUT], scales [IN/group, OUT]:
    per k warp and group, each plane's fp32 sums times its scale, high plane
    first; the k warps added in order, then the ranks."""
    half = data.shape[0]
    lo, hi = _planes(data)
    total = torch.zeros(a.shape[0], data.shape[1])
    for warps in _cut(half, C, nt):
        block = torch.zeros_like(total)
        for r0, r1 in warps:
            acc = torch.zeros_like(total)
            p = r0
            while p < r1:
                e = min(r1, (p // group + 1) * group)
                s_lo, s_hi = scales[p // group], scales[half // group + p // group]
                acc = acc + s_hi * (a[:, half + p:half + e] @ hi[p:e])
                acc = acc + s_lo * (a[:, p:e] @ lo[p:e])
                p = e
            block = block + acc
        total = total + block
    return total


def _act(x: torch.Tensor, dtype: str, IN: int, ln=None, silu=False) -> tuple:
    """The activation the kernel multiplies, [M, IN] padded with zeros, and
    its parts: x (bf16: one part), x * ln (bf16: two, exact), silu(g) * u
    (bf16: two); fp32: three."""
    xf = x.float()
    if silu:
        n = xf.shape[1] // 2
        v, P = torch.nn.functional.silu(xf[:, :n]) * xf[:, n:], 2
    else:
        v, P = (xf, 1) if ln is None else (xf * ln.float(), 2)
    P = 3 if dtype == "float32" else P
    v = torch.nn.functional.pad(v, (0, IN - v.shape[1]))
    return _parts(v, P), P


def _epilogue(acc, inv=None, bias=None, rope=None, res=None, out_dtype=torch.float32):
    """The fused epilogue on the fp32 sums, as the plain version runs it."""
    if inv is not None:
        acc = acc * inv
    if bias is not None:
        acc = acc + bias
    if rope is not None:
        cos, sin, heads, D, qk_w, qk_heads, eps = rope
        M = acc.shape[0]
        h = acc[:, :heads * D].reshape(M, heads, D)
        if qk_w is not None:
            nw = torch.where(torch.arange(heads)[:, None] < qk_heads, qk_w[0], qk_w[1])
            h = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + eps) * nw
        rot = torch.cat([-h[..., D // 2:], h[..., :D // 2]], -1)
        h = h * cos[:, None] + rot * sin[:, None]
        acc = torch.cat([h.reshape(M, heads * D), acc[:, heads * D:]], 1)
    if res is not None:
        acc = acc + res.float()
    return acc.to(out_dtype)


def _check(got: torch.Tensor, want, dtype: str, what: str) -> None:
    ref = np.asarray(jnp.asarray(want).astype(jnp.float32))
    err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= (2e-6 if dtype == "float32" else 2.0 ** -7), (what, err)


DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _quant(rng, shape, group):
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    j = jq.quantize_weight(w, bits=4, group_size=group)
    return j, torch.from_numpy(np.array(j.data)), torch.from_numpy(np.array(j.scales))


def _bf(a, tdt):
    return torch.from_numpy(np.asarray(a, np.float32)).to(tdt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 16, 32])
def test_matmul_emulation_matches_jax_kernels(M, dtype):
    """K4 and K5b: IN = 320 (rows padded to 512: x zero-padded), OUT = 264
    (a third, partial column tile), group 32."""
    rng = np.random.default_rng(M)
    jdt, tdt = DT[dtype]
    L, IN, OUT, G = 2, 320, 264, 32
    j, data, scales = _quant(rng, (L, IN, OUT), G)
    Ip = data.shape[1] * 2
    x = rng.standard_normal((M, Ip)).astype(np.float32)
    x[:, IN:] = 0
    jx, tx = jnp.asarray(x).astype(jdt), _bf(x, tdt)
    a, P = _act(tx, dtype, Ip)
    C = qk.int4_gemv_split(M, Ip, OUT, P, SMS)
    want = {"K5b": jk.matmul_dequant_int4_stacked(jx, j.data, j.scales, jnp.asarray(1, jnp.int32),
                                                  group=G, interpret=True),
            "K4": jk.matmul_dequant_int4(jx, j.data[1], j.scales[1], group=G, interpret=True)}
    got = _epilogue(_gemv_emulated(a, data[1], scales[1], G, C, _ntiles(M)), out_dtype=tdt)
    for name, w in want.items():
        _check(got, w, dtype, name)


FUSED_VARIANTS = ("ln", "res", "silu_res", "ln_bias", "ln_rope", "ln_rope_qk")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 16, 32])
@pytest.mark.parametrize("variant", FUSED_VARIANTS)
def test_fused_emulation_matches_jax_kernel(variant, M, dtype):
    """K6, every prologue and epilogue: heads of 64 (5 q, 2 k / v), IN = 192
    padded to 256, group 64."""
    rng = np.random.default_rng(hash((variant, M)) % 2 ** 32)
    jdt, tdt = DT[dtype]
    L, IN, Nq, Nk, D, G, EPS = 2, 192, 5, 2, 64, 64, 1e-6
    OUT = (Nq + 2 * Nk) * D
    j, data, scales = _quant(rng, (L, IN, OUT), G)
    Ip = data.shape[1] * 2
    silu = variant == "silu_res"
    x = (rng.standard_normal((M, 2 * IN if silu else IN)) * (0.5 if silu else 1)).astype(
        np.float32)
    jkw, tkw, ep = {}, {}, {}
    ln = None
    if variant.startswith("ln"):
        ln = (1 + 0.1 * rng.standard_normal((L, IN))).astype(np.float32)
        inv = (1 / np.sqrt((x ** 2).mean(-1, keepdims=True) + EPS)).astype(np.float32)
        jkw.update(ln=jnp.asarray(ln[:, None]).astype(jdt), invrms=jnp.asarray(inv))
        ep["inv"] = torch.from_numpy(inv)
    if "res" in variant:
        res = rng.standard_normal((M, OUT)).astype(np.float32)
        jkw["res"] = jnp.asarray(res).astype(jdt)
        ep["res"] = _bf(res, tdt)
    if silu:
        jkw["silu"] = True
    if "bias" in variant:
        bias = rng.standard_normal((L, OUT)).astype(np.float32)
        jkw["bias"] = jnp.asarray(bias[:, None]).astype(jdt)
        ep["bias"] = _bf(bias[1], tdt).float()
    if "rope" in variant:
        ang = rng.random((M, D // 2)).astype(np.float32) * 6.3
        cos = np.concatenate([np.cos(ang)] * 2, -1).astype(np.float32)
        sin = np.concatenate([np.sin(ang)] * 2, -1).astype(np.float32)
        jkw.update(rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin), rope_heads=Nq + Nk,
                   rope_dim=D)
        qkw = None
        if "qk" in variant:
            qn = (1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32)
            kn = (1 + 0.1 * rng.standard_normal((L, D))).astype(np.float32)
            jkw.update(qk_norm_w=(jnp.asarray(qn).astype(jdt), jnp.asarray(kn).astype(jdt)),
                       qk_heads=Nq, eps=EPS)
            qkw = (_bf(qn[1], tdt).float(), _bf(kn[1], tdt).float())
        ep["rope"] = (torch.from_numpy(cos), torch.from_numpy(sin), Nq + Nk, D, qkw, Nq, EPS)
    want = jk.matmul_dequant_int4_stacked_fused(
        jnp.asarray(x).astype(jdt), j.data, j.scales, jnp.asarray(1, jnp.int32), group=G,
        interpret=True, **jkw)
    a, P = _act(_bf(x, tdt), dtype, Ip, ln=None if ln is None else _bf(ln[1], tdt), silu=silu)
    C = qk.int4_gemv_split(M, Ip, OUT, P, SMS)
    got = _epilogue(_gemv_emulated(a, data[1], scales[1], G, C, _ntiles(M)), out_dtype=tdt,
                    **ep)
    _check(got, want, dtype, variant)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 16, 32])
def test_mlp_emulation_matches_jax_kernel(M, dtype):
    """K7: gate_up with the norm prologue, its epilogue forming silu(g) * u
    (times invrms) in the down call's parts, then down with the residual:
    H = 256, I = 512, group 16 (the JAX kernel's tiling takes no padded
    rows and wants 8 groups a tile)."""
    rng = np.random.default_rng(100 + M)
    jdt, tdt = DT[dtype]
    L, H, I, G, EPS = 2, 256, 512, 16, 1e-6
    gj, gd, gs = _quant(rng, (L, H, 2 * I), G)
    dj, dd, ds = _quant(rng, (L, I, H), G)
    x = rng.standard_normal((M, H)).astype(np.float32)
    ln = (1 + 0.1 * rng.standard_normal((L, H))).astype(np.float32)
    inv = (1 / np.sqrt((x ** 2).mean(-1, keepdims=True) + EPS)).astype(np.float32)
    want = jk.mlp_fused_int4_stacked(
        jnp.asarray(x).astype(jdt), gj.data, gj.scales, dj.data, dj.scales,
        jnp.asarray(ln[:, None]).astype(jdt), jnp.asarray(inv), jnp.asarray(1, jnp.int32),
        group=G, bk=256, interpret=True)
    tx = _bf(x, tdt)
    Hp, Ip = gd.shape[1] * 2, dd.shape[1] * 2
    a, P = _act(tx, dtype, Hp, ln=_bf(ln[1], tdt))
    C = qk.int4_gemv_split(M, Hp, 2 * I, P, SMS)
    gu = _gemv_emulated(a, gd[1], gs[1], G, C, _ntiles(M)) * torch.from_numpy(inv)
    act = torch.nn.functional.silu(gu[:, :I]) * gu[:, I:]
    act = _parts(torch.nn.functional.pad(act, (0, Ip - I)), P)
    C = qk.int4_gemv_split(M, Ip, H, P, SMS)
    got = _epilogue(_gemv_emulated(act, dd[1], ds[1], G, C, _ntiles(M)), res=tx, out_dtype=tdt)
    _check(got, want, dtype, "K7")
