"""The prefill regime of the Hopper dequant-matmul kernels (K3/K5a and
K4/K5b at M > 32, bf16 activations: csrc/dequant_mm_tc.cuh), its plan,
layout and arithmetic emulated here on the CPU and held against the JAX
kernels.

The card computes out^T = W^T x^T with the weight as wgmma's register
operand: a block owns 128 weight columns and `tile` rows of x, the C
blocks of a cluster split the k walk's 64-row stages
(quant_kernels.dequant_mm_plan), and each consumer thread converts its
fragment's bytes, read from a 128-byte-swizzled raw tile, into bf16(q * s)
through the magic number 2^23. The emulation repeats that cut, that
rounding and the rank-order sum of the split's fp32 tiles, and is held
against tinygpt_tpu's matmul_dequant_int8(_stacked) and
matmul_dequant_int4(_stacked) in interpret mode (as tests/test_torch_int8.py
runs them), relative to the largest output: bf16 2^-7 (one ulp: both
round each dequantized weight to bf16 once, as the TPU kernels' bm > 32
branch does, and the output once; K3's TPU kernel keeps its weights exact,
and the weights' rounding stays well inside the ulp), fp32 2e-6 (the
mma.sync route: x split exactly into three bf16 parts, exact products,
fp32 sums in another order). The card
tests (tests/test_torch_cuda.py) hold the kernel itself against its plain
version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops import quant_kernels as jqk
from tinygpt_tpu_torch.ops import quant_kernels as qk
from tinygpt_tpu_torch.ops.quant import pad_x_to, quantize_weight

SMS = 132               # the H100's SMs
COLS = 128              # weight columns a block
STAGE = 64              # weight rows (int8) or packed rows (int4) a stage
RAW = STAGE * COLS      # bytes of a stage's raw weight tile
PART_LD = COLS + 8      # floats a row of a split's partial tile
SMEM_MAX = 227 * 1024

MISTRAL = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
           "down": (14336, 4096)}
GPT2 = {"qkv": (768, 2304), "o": (768, 768), "fc": (768, 3072), "proj": (3072, 768)}
EDGES = {"in64": (64, 200), "in80": (80, 264), "in896": (896, 136)}


def _stages(rows: int) -> int:
    return -(-rows // STAGE)


def _scale_rows(rows: int, group: int) -> int:
    """The scale rows a stage's box holds: those its 64 rows touch, at most."""
    return max((k0 + STAGE - 1) // group - k0 // group + 1 for k0 in range(0, rows, STAGE))


def _stage_bytes(planes: int, tile: int, sr: int) -> int:
    return -(-(planes * tile * 128 + RAW + planes * sr * COLS * 4) // 1024) * 1024


def _cut(M, IN, OUT, bits, plan):
    """The kernel's blocks as (rows, columns, stage range, rank, C): grid
    (M tiles x C, column tiles), rank r of C taking stages [r n / C,
    (r + 1) n / C)."""
    tile, C = plan
    n = _stages(IN if bits == 8 else IN // 2)
    blocks = []
    for mt in range(-(-M // tile)):
        for r in range(C):
            for ct in range(-(-OUT // COLS)):
                blocks.append(((mt * tile, min(M, (mt + 1) * tile)),
                               (ct * COLS, min(OUT, (ct + 1) * COLS)),
                               (r * n // C, (r + 1) * n // C), r, C))
    return blocks


SHAPES = [(bits, IN, OUT, group) for bits, group in ((8, 128), (4, 64))
          for IN, OUT in list(MISTRAL.values()) + list(GPT2.values())] + [
    (8, 64, 200, 16), (8, 80, 264, 16), (8, 896, 136, 128), (4, 256, 200, 64),
    (4, 512, 520, 32), (4, 256, 264, 16)]


@pytest.mark.parametrize("M", [33, 64, 65, 80, 129, 512, 2048])
@pytest.mark.parametrize("bits,IN,OUT,group", SHAPES)
def test_plan_covers_every_row_column_and_k_once(M, bits, IN, OUT, group):
    tile, C = plan = qk.dequant_mm_plan(M, IN, OUT, bits, SMS)
    rows = IN if bits == 8 else IN // 2
    assert tile in qk._TC_TILES and (tile == 128) == (M <= 128)
    assert 1 <= C <= qk._TC_MAX_SPLIT and C <= _stages(rows)
    # every (row of x, weight column) pair in exactly one tile, and every k
    # of it in exactly one block of the split
    cover = {}
    for (m0, m1), (c0, c1), (s0, s1), r, _ in _cut(M, IN, OUT, bits, plan):
        assert m0 < m1 and c0 < c1 and s0 < s1          # no block without work
        cover.setdefault((m0, m1, c0, c1), []).append((s0, s1))
    rows_seen = np.zeros(M, np.int64)
    cols_seen = np.zeros(OUT, np.int64)
    for (m0, m1, c0, c1), spans in cover.items():
        k = np.zeros(rows, np.int64)
        for s0, s1 in spans:
            k[s0 * STAGE:min(rows, s1 * STAGE)] += 1
        assert (k == 1).all()
        if c0 == 0:
            rows_seen[m0:m1] += 1
        if m0 == 0:
            cols_seen[c0:c1] += 1
    assert (rows_seen == 1).all() and (cols_seen == 1).all()
    # the split's reduction: rank r sums rows [r tile / C, (r + 1) tile / C)
    # of the tile over the cluster
    red = np.zeros(tile, np.int64)
    for r in range(C):
        red[r * tile // C:(r + 1) * tile // C] += 1
    assert (red == 1).all()
    # shared memory: at least two stages, and the partial tile fits the ring
    planes = 2 if bits == 4 else 1
    sb = _stage_bytes(planes, tile, _scale_rows(rows, group))
    ns = min(8, (SMEM_MAX - 1024 - 16 * 8) // sb)
    assert ns >= 2 and 1024 + ns * sb + 16 * ns <= SMEM_MAX
    assert C == 1 or tile * PART_LD * 4 <= ns * sb


def test_plan_at_the_main_path():
    """Mistral-7B at a verify round (M = 80), an admission (512) and the
    4 x 512 prefill (2048), both formats: the picks that a sweep of both
    tiles and splits of 1 to 8 on the H100 found fastest. At 2048 every
    shape has at least 256 blocks and takes no split."""
    want = {80: {"qkv": (128, 2), "o": (128, 3), "gate_up": (128, 1), "down": (128, 3)},
            512: {"qkv": (256, 1), "o": (256, 2), "gate_up": (256, 1), "down": (256, 2)},
            2048: {k: (256, 1) for k in MISTRAL}}
    for bits in (8, 4):
        got = {M: {k: qk.dequant_mm_plan(M, IN, OUT, bits, SMS) for k, (IN, OUT) in MISTRAL.items()}
               for M in want}
        assert got == want, bits


def _byte_perm(x: np.ndarray, y, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays: byte n of the result
    is byte (sel >> 4n) & 7 of the 8 bytes y:x."""
    y = np.broadcast_to(np.asarray(y, np.uint32), x.shape)
    out = np.zeros_like(x)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        b = (x >> (8 * k)) & 0xFF if k < 4 else (y >> (8 * (k - 4))) & 0xFF
        out |= b << np.uint32(8 * n)
    return out


def _magic(w: np.ndarray, j: int, bias: float) -> np.ndarray:
    bits = _byte_perm(w, 0x4B000000, 0x7440 | j)
    return bits.view(np.float32) - np.float32(bias)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def test_conversions_are_exact_for_every_byte():
    """int8: every q in every byte of the combined word, through q ^ 0x80
    and 2^23 + 128; int4: every byte's two nibbles, each plane through
    2^23 + 8. Then bf16(q * s) is the TPU kernel's own value (fp32 product,
    one rounding to bf16) at random scales."""
    q = np.arange(-128, 128, dtype=np.int8).view(np.uint8).astype(np.uint32)
    rng = np.random.default_rng(0)
    for j in range(4):
        word = (q << np.uint32(8 * j)) | np.uint32(0x5A5A5A5A & ~(0xFF << (8 * j)))
        f = _magic(word ^ np.uint32(0x80808080), j, 8388736.0)
        assert np.array_equal(f, np.arange(-128, 128, dtype=np.float32))
        for plane in (0, 1):
            nib = ((word >> np.uint32(4 * plane)) & np.uint32(0x0F0F0F0F))
            f = _magic(nib, j, 8388616.0)
            want = ((q >> np.uint32(4 * plane)) & 0xF).astype(np.float32) - 8
            assert np.array_equal(f, want)
    f = np.arange(-128, 128, dtype=np.float32)
    for s in rng.uniform(1e-4, 0.1, size=64).astype(np.float32):
        got = _bf16(f * s)                       # the kernel: fp32 product, then bf16
        want = np.asarray(jnp.asarray(f * s).astype(jnp.bfloat16).astype(jnp.float32))
        assert np.array_equal(got, want)


def _smem_image(tile: np.ndarray) -> np.ndarray:
    """A [64][128] byte tile as TMA's 128-byte swizzle lays it out: 16-byte
    chunk c of row r at chunk c ^ (r % 8)."""
    img = np.zeros(64 * 128, np.uint8)
    for r in range(64):
        for c in range(8):
            d = r * 128 + ((c ^ (r % 8)) * 16)
            img[d:d + 16] = tile[r, c * 16:(c + 1) * 16]
    return img


def test_fragment_loads_read_the_right_bytes_without_bank_conflicts():
    """Each consumer thread's four 16-bit loads of a step (rows k, k+1,
    k+8, k+9 at its columns lc, lc + 1) from the swizzled raw tile, and the
    byte permute that pairs them; a warp's load touches each bank at one
    word. The producer's cp.async route (OUT % 16 != 0) lays 8-byte pieces
    out as TMA does."""
    rng = np.random.default_rng(1)
    tile = rng.integers(0, 256, (64, 128), dtype=np.uint8)
    img = _smem_image(tile)
    pieces = np.zeros_like(img)
    for r in range(64):
        for c in range(0, 128, 8):
            d = r * 128 + ((((c >> 4) ^ (r & 7)) << 4) | (c & 8))
            pieces[d:d + 8] = tile[r, c:c + 8]
    assert np.array_equal(pieces, img)
    u16 = lambda off: int(img[off]) | int(img[off + 1]) << 8  # noqa: E731
    for ks in range(4):
        for warp in range(8):
            for which, (dk, odd) in enumerate(((0, 0), (1, 1), (8, 0), (9, 1))):
                words = {}
                for lane in range(32):
                    ct = warp * 32 + lane
                    wg, w, g, t = ct // 128, (ct // 32) % 4, lane // 4, lane % 4
                    lc = 64 * wg + 16 * w + 2 * g
                    ch = lc >> 4
                    off_e = 2 * t * 128 + ((ch ^ (2 * t)) << 4) + 2 * g
                    off_o = (2 * t + 1) * 128 + ((ch ^ (2 * t + 1)) << 4) + 2 * g
                    off = ks * 16 * 128 + (8 * 128 if dk >= 8 else 0) + (off_o if odd else off_e)
                    k = 16 * ks + 2 * t + dk
                    assert u16(off) == int(tile[k, lc]) | int(tile[k, lc + 1]) << 8
                    words.setdefault((off // 4) % 32, set()).add(off // 4)
                assert all(len(v) == 1 for v in words.values()), (ks, warp, which)
    # the combined word: (k, c), (k + 1, c), (k, c + 1), (k + 1, c + 1)
    L0 = np.array([0x2211], np.uint32)
    L1 = np.array([0x4433], np.uint32)
    assert _byte_perm(L0, L1, 0x5140)[0] == 0x44223311


def _emulate(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, group: int, bits: int,
             dtype: str, C: int) -> torch.Tensor:
    """One layer through the kernel's arithmetic. x [M, IN] (its dtype's
    values), q [IN, OUT] int (original row order), s [IN / group, OUT].
    bf16: weights bf16(q * s), the C blocks' fp32 partial products over
    their stages, summed in rank order, one rounding. fp32 (the mma.sync
    route): x = hi + mid + lo in bf16 (exact), exact products, each
    (group, 64-row stage) piece's sum times its scale."""
    M, IN = x.shape
    rows = IN if bits == 8 else IN // 2
    planes = (0,) if bits == 8 else (0, rows)    # a plane's first k
    xf = x.float()
    if dtype == "bfloat16":
        w = (q.float() * s.repeat_interleave(group, 0)).bfloat16().float()
        n = _stages(rows)
        total = torch.zeros(M, q.shape[1])
        for r in range(C):
            k0, k1 = r * n // C * STAGE, min(rows, (r + 1) * n // C * STAGE)
            total = total + sum(xf[:, p + k0:p + k1] @ w[p + k0:p + k1] for p in planes)
        return total.bfloat16()
    hi = xf.bfloat16().float()
    mid = (xf - hi).bfloat16().float()
    lo = (xf - hi - mid).bfloat16().float()
    assert torch.equal(hi + mid + lo, xf)   # the three bf16 parts are exact
    acc = torch.zeros(M, q.shape[1])
    for a0 in range(0, rows, STAGE):
        for p in planes:
            a = a0
            while a < min(rows, a0 + STAGE):
                b = min(rows, a0 + STAGE, (a // group + 1) * group)
                part = sum(h[:, p + a:p + b] @ q[p + a:p + b].float() for h in (hi, mid, lo))
                acc = acc + s[(p + a) // group] * part
                a = b
    return acc


def _ref_tol(dtype: str) -> float:
    return 2e-6 if dtype == "float32" else 2.0 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [33, 80, 160])
@pytest.mark.parametrize("bits,IN,OUT,group", [(8, 336, 264, 48), (4, 512, 264, 64),
                                               (4, 256, 200, 32)])
def test_emulation_matches_jax_kernels(bits, IN, OUT, group, M, dtype):
    """IN = 336 leaves a last stage of 16 rows; each case is emulated at
    the plan's split and at a split of 3 (the most the plan takes)."""
    rng = np.random.default_rng(IN + 7 * M + bits)
    w = (rng.standard_normal((2, IN, OUT)) * 0.05).astype(np.float32)
    qt = quantize_weight(torch.from_numpy(w), bits=bits, group_size=group)
    x = rng.standard_normal((M, IN)).astype(np.float32)
    tx = pad_x_to(torch.from_numpy(x), qt.in_dim).to(getattr(torch, dtype))
    jx = jnp.asarray(tx.float().numpy()).astype(getattr(jnp, dtype))
    jd, js = jnp.asarray(qt.data.numpy()), jnp.asarray(qt.scales.numpy())
    if bits == 8:
        want = {0: jqk.matmul_dequant_int8(jx, jd[0], js[0], group=group, interpret=True),
                1: jqk.matmul_dequant_int8_stacked(jx, jd, js, 1, group=group, interpret=True)}
        q = {l: qt.data[l].to(torch.int32) for l in (0, 1)}
    else:
        want = {0: jqk.matmul_dequant_int4(jx, jd[0], js[0], group=group, interpret=True),
                1: jqk.matmul_dequant_int4_stacked(jx, jd, js, jnp.asarray(1, jnp.int32),
                                                   group=group, interpret=True)}
        q = {l: qk.unpack_int4(qt.data[l]).to(torch.int32) for l in (0, 1)}
    splits = {qk.dequant_mm_plan(M, qt.in_dim, OUT, bits, SMS)[1], qk._TC_MAX_SPLIT}
    for layer in (0, 1):
        ref = np.asarray(want[layer]).astype(np.float32)
        for C in splits:
            got = _emulate(tx, q[layer], qt.scales[layer], group, bits, dtype, C)
            err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
            assert err <= _ref_tol(dtype), (layer, C, err)
