"""The arithmetic of K11a and K11b's tensor-core design (moe_gather_matmul_int8
and _int4, csrc/moe_gather_matmul.cu: moe_gather_q_kernel), emulated here on
the CPU and held against the JAX kernels.

On the card a block owns 128 columns of one expert (256 at 16 or 32 rows a
pass) and takes the rows routed to it in row order, a pass holding those of min(R, 32) (n-tiles of 8
rows: moe_kernels.moe_gather_plan at the plan's split, moe_gather_split);
the SK blocks of a cluster split the stored rows (packed rows for int4) in
16-row units, each block's k warps (4 at 8 rows a pass, else 1) its units
again. A 16-row chunk is
an mma.sync of the exact bf16 weights (a nibble's u - 8, a byte's q) and
the activations as bf16 parts (bf16 x as it is; fp32 x as hi + lo); int4's
chunk is two k-steps, the low plane at x columns p and the high plane at
IN/2 + p. Each warp sums each group and plane in fp32 and adds the sums
times the group's scale to its accumulators after the group's last chunk,
or after its own last chunk where the split cuts a group; the block adds its
k warps, the cluster its blocks, and the sum is rounded once to x's type.
`_k11_emulated` repeats that cut and that order in fp32 (the order of the
sums inside an mma differs on the card: the tolerances cover it) and is held
against tinygpt_tpu's moe_gather_matmul_int8 / _int4 in interpret mode
within QUANT_TOL of the largest output: 1e-4 in fp32, 2^-7 (one bf16 ulp)
in bf16. Expert ids outside [0, E) are clamped by the port's kernel, and by
the JAX kernel's block index. The card tests (tests/test_torch_cuda.py) hold
the kernels themselves against their plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops import moe_kernels as jmk
from tinygpt_tpu_torch.ops import moe_kernels as mk
from tinygpt_tpu_torch.ops.quant import _quantize_moe_stacked, pad_x_to

QUANT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
UNIT = 16  # stored rows of a chunk and of the split's unit
FEW = 8    # above this many rows, the experts that at most FEW rows name take
           # passes of one n-tile in a launch of their own


def _parts(x: torch.Tensor) -> list:
    """x as the kernel's bf16 parts, in fp32: bf16 x itself; fp32 x as
    hi = bf16(x) and lo = bf16(x - hi)."""
    if x.dtype == torch.bfloat16:
        return [x.float()]
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()]


def _planes(data: torch.Tensor, bits: int) -> list:
    """An expert's stored rows as the exact values the kernel multiplies:
    int8 q, or int4's low and high nibble planes u - 8."""
    if bits == 8:
        return [data.float()]
    u = data.view(torch.uint8).int()
    return [((u & 15) - 8).float(), ((u >> 4) - 8).float()]


def _k11_emulated(x, data, scales, l, idx, group, bits, split, split_few):
    """K11a (bits 8) or K11b (bits 4) at splits (split, split_few): per
    expert, its rows in passes of the plan's n-tiles (one n-tile, at
    split_few, for an expert that at most 8 rows name where R > 8), per
    rank its 16-row units, per k warp its share of them, chunk by chunk,
    each group's sums scaled once."""
    R = x.shape[0]
    _, E, rows, OUT = data.shape
    IN = 2 * rows if bits == 4 else rows
    parts = _parts(pad_x_to(x, IN))
    ids = idx.long().clamp(0, E - 1)
    out = torch.zeros(R, OUT)
    n16 = rows // UNIT
    for e in range(E):
        every = (ids == e).nonzero()[:, 0]
        if R > FEW and len(every) <= FEW:
            nt, sk = mk.moe_gather_plan(FEW, IN, len(parts), split_few, bits)[0], split_few
        else:
            nt, sk = mk.moe_gather_plan(R, IN, len(parts), split, bits)[0], split
        assert nt, (R, IN, sk)
        kw = 4 if nt == 1 else 1  # the k warps of a block
        q = _planes(data[l, e], bits)
        s = scales[l, e]
        for p0 in range(0, len(every), 8 * nt):
            rr = every[p0:p0 + 8 * nt]
            total = torch.zeros(len(rr), OUT)
            for rank in range(sk):
                u0, u1 = rank * n16 // sk, (rank + 1) * n16 // sk
                block = torch.zeros(len(rr), OUT)
                for wk in range(kw):
                    a, b = u0 + wk * (u1 - u0) // kw, u0 + (wk + 1) * (u1 - u0) // kw
                    acc = torch.zeros(len(rr), OUT)
                    pacc = [torch.zeros(len(rr), OUT) for _ in q]
                    for u in range(a, b):
                        r = u * UNIT
                        for pl, qp in enumerate(q):
                            cols = slice(pl * rows + r, pl * rows + r + UNIT)
                            for xp in parts:
                                pacc[pl] += xp[rr, cols] @ qp[r:r + UNIT]
                        if (r + UNIT) % group == 0 or u == b - 1:
                            for pl in range(len(q)):
                                acc = acc + s[r // group + pl * (rows // group)] * pacc[pl]
                                pacc[pl] = torch.zeros_like(acc)
                    block += acc
                total += block
            out[rr] = total
    return out.to(x.dtype)


QUANT_CASES = [
    # (bits, E, IN, OUT, group, ids): repeats and an unused expert, clamped
    # ids, one row, 40 rows (passes of 32), 40 rows on one expert (two
    # passes), 17 rows with one expert named by 12 (the launch of R's
    # n-tiles) and three by few (the launch of one), groups of 16, 64 and
    # 128, int4 stacks row-padded at quantize
    # time (200 -> 256: x columns past 200 read as zeros; 96 -> 256: the high
    # plane is all pad)
    (8, 4, 256, 136, 16, [0, 2, 2, 1, 0, 2, 1, 2]),
    (8, 3, 128, 64, 64, [1]),
    (8, 4, 192, 40, 64, [7, -3, 1, 3, 0, 1, 9, 2]),
    (8, 2, 256, 64, 128, [1] * 40),
    (8, 4, 128, 40, 16, [0] * 12 + [1, 2, 3, 1, 2]),
    (4, 4, 256, 136, 64, [0, 2, 2, 1, 0, 2, 1, 2]),
    (4, 3, 200, 64, 16, [7, -3, 1, 2, 0, 1, 9, 2]),
    (4, 2, 96, 40, 128, [1]),
    (4, 4, 512, 64, 128, [i % 3 for i in range(40)]),
    (4, 2, 256, 8, 64, [1] * 40),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", QUANT_CASES)
def test_k11_emulation_matches_jax_kernel(case, dtype):
    bits, E, IN, OUT, group, ids = case
    rng = np.random.default_rng(IN + OUT + bits)
    w = torch.from_numpy(rng.standard_normal((2, E, IN, OUT)).astype(np.float32) * 0.05)
    qt = _quantize_moe_stacked(w, bits, group)
    assert qt.group_size == group
    x = torch.from_numpy(rng.standard_normal((len(ids), IN)).astype(np.float32)).to(dtype)
    idx = torch.tensor(ids, dtype=torch.int32)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.float32 if dtype == torch.float32
                                              else jnp.bfloat16)
    jfn = jmk.moe_gather_matmul_int4 if bits == 4 else jmk.moe_gather_matmul_int8
    want = np.asarray(jfn(jx, jnp.asarray(qt.data.numpy()), jnp.asarray(qt.scales.numpy()),
                          jnp.int32(1), jnp.asarray(np.clip(ids, 0, E - 1).astype(np.int32)),
                          group, interpret=True)).astype(np.float32)
    parts = len(_parts(x))
    plan = [mk.moe_gather_split(R, E, qt.in_dim, OUT, parts, bits=bits)
            for R in (len(ids), min(len(ids), FEW))]
    for splits in ((1, 1), (2, 2), (2, 1), plan):
        got = _k11_emulated(x, qt.data, qt.scales, 1, idx, group, bits, *splits)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= QUANT_TOL[dtype] * np.abs(want).max(), splits


def _byte_perm(x: np.ndarray, y, sel: int) -> np.ndarray:
    """CUDA's __byte_perm (default mode) on uint32 arrays (or scalars)."""
    x, y = np.asarray(x, dtype=np.uint32), np.asarray(y, dtype=np.uint32)
    out = np.zeros(np.broadcast(x, y).shape, dtype=np.uint32)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        src = x if k < 4 else y
        out |= ((src >> np.uint32(8 * (k % 4))) & np.uint32(0xFF)) << np.uint32(8 * n)
    return out


def _bf16_pair(bits: np.ndarray) -> tuple:
    """The two bf16 halves of 32-bit words as fp32 (low half, high half)."""
    lo = (bits & 0xFFFF).astype(np.uint32) << 16
    hi = (bits & 0xFFFF0000).astype(np.uint32)
    return lo.view(np.float32), hi.view(np.float32)


def _thread_bytes(tb: int) -> tuple:
    """A thread's tb bytes of stored rows 4t .. 4t + 3, as its words
    (Rw[row][word], uint32 arrays over 256 draws) and as bytes [row][col]:
    every byte value at every row and column across the draws."""
    n = np.arange(256, dtype=np.uint32)
    cols = [[(n + 37 * r + 11 * c) % 256 for c in range(tb)] for r in range(4)]
    words = [[sum(cols[r][4 * w + k] << np.uint32(8 * k) for k in range(min(4, tb)))
              for w in range(max(1, tb // 4))] for r in range(4)]
    return words, cols


def _want_pairs(vals: list, ci: int) -> list:
    """m-tile ci's A fragment of a thread, as the (k 2t, 2t + 1) pairs of
    mma rows g and g + 8 (the thread's columns 2 ci and 2 ci + 1): stored
    rows (4t, 4t + 1) then (4t + 2, 4t + 3)."""
    c0, c1 = 2 * ci, 2 * ci + 1
    return [(vals[0][c0], vals[1][c0]), (vals[0][c1], vals[1][c1]),
            (vals[2][c0], vals[3][c0]), (vals[2][c1], vals[3][c1])]


@pytest.mark.parametrize("tb", [16, 8, 4])
def test_int8_fragments_are_exact_for_every_byte(tb):
    """K11a's A fragments (q8_pair) at a thread's tb bytes a row (warps of
    128, 64 and 32 columns), every byte value at every position: the XOR
    bias, the permute under 0x4B00 00uu (the float 2^23 + q + 128), the
    subtraction of 2^23 + 128 and the permute that packs the two floats'
    high halves give each m-tile's exact bf16 q, in mma fragment order."""
    words, cols = _thread_bytes(tb)
    q = [[c.astype(np.int32) - 256 * (c >= 128) for c in row] for row in cols]
    biased = [[w ^ np.uint32(0x80808080) for w in row] for row in words]

    def pair(r0, r1, w, j):
        f0, f1 = (_byte_perm(biased[r][w], 0x4B000000, 0x7440 | j).view(np.float32)
                  - np.float32(8388736.0) for r in (r0, r1))
        return _bf16_pair(_byte_perm(f0.view(np.uint32), f1.view(np.uint32), 0x7632))

    for ci in range(tb // 2):
        w, b = ci // 2, (ci % 2) * 2
        got = [pair(0, 1, w, b), pair(0, 1, w, b + 1), pair(2, 3, w, b), pair(2, 3, w, b + 1)]
        for (lo, hi), (wa, wb) in zip(got, _want_pairs(q, ci)):
            assert np.array_equal(lo, wa.astype(np.float32))
            assert np.array_equal(hi, wb.astype(np.float32))


@pytest.mark.parametrize("tb", [16, 8, 4])
def test_int4_fragments_are_exact_for_every_byte(tb):
    """K11b's A fragments at a thread's tb bytes a row, both nibble planes,
    every byte value at every position: the permute that pairs two rows'
    bytes (b, b + 1), the plane's shift, the LOP3 under 0x4300 and the
    subtraction of 136 (exact in bf16: 128 + u - 136) give each m-tile's
    exact u - 8, in mma fragment order."""
    words, cols = _thread_bytes(tb)

    def nib(x):
        lo, hi = _bf16_pair((x & np.uint32(0x000F000F)) | np.uint32(0x43004300))
        return lo - np.float32(136), hi - np.float32(136)

    for plane in (0, 1):
        u = [[(c >> np.uint32(4 * plane)) & 0xF for c in row] for row in cols]
        for ci in range(tb // 2):
            w, b = ci // 2, (ci % 2) * 2
            sel = b | ((b + 1) << 4) | ((b + 4) << 8) | ((b + 5) << 12)
            x01 = _byte_perm(words[0][w], words[1][w], sel) >> np.uint32(4 * plane)
            x23 = _byte_perm(words[2][w], words[3][w], sel) >> np.uint32(4 * plane)
            got = [nib(x01), nib(x01 >> np.uint32(8)), nib(x23), nib(x23 >> np.uint32(8))]
            for (lo, hi), (wa, wb) in zip(got, _want_pairs(u, ci)):
                assert np.array_equal(lo, wa.astype(np.float32) - 8)
                assert np.array_equal(hi, wb.astype(np.float32) - 8)


def test_group_scaled_sums_are_inside_the_tolerance_where_bf16_weights_are_not():
    """Why the scale multiplies each group's fp32 sums and is never folded
    into a bf16 weight: at Mixtral's down (IN 14336, group 128), x @
    (s * (u - 8)) with fp32 x in two parts stays within 1e-5 of the largest
    output, while bf16(s * (u - 8)) puts it near 2^-9 of it, past the fp32
    tolerance (1e-4)."""
    rng = np.random.default_rng(5)
    IN, OUT, group = 14336, 64, 128
    x = torch.from_numpy(rng.standard_normal((4, IN)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-8, 8, (IN, OUT)).astype(np.float64))
    s = torch.from_numpy(rng.uniform(0.001, 0.01, (IN // group, OUT)))
    w = (q.reshape(IN // group, group, OUT) * s[:, None, :]).reshape(IN, OUT)
    exact = x.double() @ w
    summed = torch.zeros_like(exact)
    for gi in range(IN // group):
        k = slice(gi * group, (gi + 1) * group)
        summed += sum(p.double()[:, k] @ q[k] for p in _parts(x)) * s[gi]
    folded = x.double() @ w.float().bfloat16().double()
    top = exact.abs().max()
    assert (summed - exact).abs().max() <= 1e-5 * top
    assert (folded - exact).abs().max() > QUANT_TOL[torch.float32] * top


MIXTRAL = {"gate_up": (4096, 28672), "down": (14336, 4096)}


@pytest.mark.parametrize("bits", [8, 4])
def test_k11_split_plan_at_mixtral(bits):
    """moe_gather_split for K11a / K11b at Mixtral-8x7B's widths (8
    experts), on the CPU model of the library's plan (_model_plan): one pass
    over up to 32 rows an expert, however the rows fall; a block's shared
    memory inside the SM's; the live blocks fill the card at least
    _MOE_FILL an SM; no other split runs more blocks an SM; and, for bf16
    x, the splits the H100 sweep found fastest (PERF.md)."""
    want = {8: {(8, "gate_up"): 2, (8, "down"): 8, (32, "gate_up"): 2, (32, "down"): 8,
                (160, "gate_up"): 2, (160, "down"): 8},
            4: {(8, "gate_up"): 1, (8, "down"): 4, (32, "gate_up"): 2, (32, "down"): 8,
                (160, "gate_up"): 2, (160, "down"): 8}}[bits]
    for (R, key), split in want.items():
        IN, OUT = MIXTRAL[key]
        for parts in (1, 2):
            got = mk.moe_gather_split(R, 8, IN, OUT, parts, bits=bits)
            nt, smem, per_sm = mk._model_plan(R, IN, parts, got, bits)
            assert 8 * nt >= min(R, 32) and smem <= mk._TC_SMEM, (R, key, parts)
            assert 8 * -(-OUT // mk._q_shape(nt)[1]) * got >= mk._MOE_FILL * 132
            assert per_sm == max(mk._model_plan(R, IN, parts, S, bits)[2] for S in mk._MOE_SPLITS)
            if parts == 1:
                assert got == split, (R, key)


def test_k11_blocks_an_sm_model():
    """_q_per_sm: two blocks of K11b and three of K11a an SM by registers,
    fewer where a block's shared memory (its static part, allocation in
    128-byte units and the 1 KB the SM reserves a block) leaves no room."""
    assert mk._q_per_sm(1, 57600, 8) == 3 and mk._q_per_sm(1, 57600, 4) == 2
    assert mk._q_per_sm(4, 100000, 8) == 1 and mk._q_per_sm(2, 57600, 4) == 2
    assert mk._q_per_sm(1, 98560, 8) == 2 and mk._q_per_sm(1, 155904, 8) == 1
    block = 233472 // 4 - 1024   # four blocks' worth, before the static part
    assert mk._q_per_sm(1, block - 48, 8) == 3   # registers bind first


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("R", [1, 8, 9, 16, 17, 32, 33, 160])
def test_k11_pass_holds_32_rows_at_every_split(R, bits):
    """A pass holds the rows of min(R, 32) at every split a launch takes,
    at any width: n-tiles 1, 2 or 4, never fewer; a split whose staged rows
    do not fit a block is not launched ((0, 0)), and the block's shared
    memory is the rings and the staged parts of both nibble planes."""
    full = 1 if R <= 8 else 2 if R <= 16 else 4
    for IN in (256, 1024, 4096, 14336, 65536):
        rows = IN // 2 if bits == 4 else IN
        for parts in (1, 2):
            for split in range(1, 17):
                nt, smem = mk.moe_gather_plan(R, IN, parts, split, bits)
                nk = -(-(rows // UNIT) // split) * UNIT
                need = mk._q_shape(full)[0] * mk._Q_WARP_RING + parts * (
                    2 if bits == 4 else 1) * 8 * full * ((2 * nk & ~63) + 32)
                assert (nt, smem) == ((full, need) if need <= mk._TC_SMEM else (0, 0))
