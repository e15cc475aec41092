"""The arithmetic of K12's tensor-core design on bf16 stacks
(moe_gather_matmul, csrc/moe_gather_matmul.cu: moe_gather_tc_kernel), emulated
here on the CPU and held against the JAX kernel.

On the card a block owns 128 columns of one expert and takes the rows
routed to it in row order, up to 8 n-tiles of 8 rows a pass and never
fewer than those of min(R, 32) (moe_kernels.moe_gather_plan at the plan's
split, moe_gather_split); the SK blocks of a cluster split IN in 16-row
units, each block's two k warps its units in halves; each 16-row chunk is
an mma.sync of the exact bf16 weights
and the activations as bf16 parts (bf16 x as it is; fp32 x as hi + lo, two
parts), summed in fp32; the block adds its k warps, the cluster its blocks,
and the sum is rounded once to x's type. `_k12_emulated` repeats that
chunk by chunk in fp32 (the order of the fp32 sums inside an mma differs on
the card: the tolerances cover it) and is held against tinygpt_tpu's
moe_gather_matmul in interpret mode within QUANT_TOL: 1e-4 of the largest
output in fp32, 2^-7 (one bf16 ulp) in bf16. Expert ids outside [0, E) are
clamped by the port's kernel, and by the JAX kernel's block index.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops import moe_kernels as jmk
from tinygpt_tpu_torch.ops import moe_kernels as mk

QUANT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
UNIT = 16  # weight rows of a chunk and of the split's unit


def _parts(x: torch.Tensor) -> list:
    """x as the kernel's bf16 parts, in fp32: bf16 x itself; fp32 x as
    hi = bf16(x) and lo = bf16(x - hi)."""
    if x.dtype == torch.bfloat16:
        return [x.float()]
    hi = x.bfloat16().float()
    return [hi, (x - hi).bfloat16().float()]


def _k12_emulated(x, w, l, idx, split):
    """K12 on a bf16 stack at split `split`: per expert, its rows in passes
    of 8 n-tiles of 8 (the plan's n-tiles), per rank its 16-row units, per k
    warp half of them, chunk by chunk in fp32."""
    R, IN = x.shape
    _, E, _, OUT = w.shape
    nt, _ = mk.moe_gather_plan(R, IN, len(_parts(x)), split)
    ids = idx.long().clamp(0, E - 1)
    parts = _parts(x)
    out = torch.zeros(R, OUT)
    n16 = -(-IN // UNIT)
    for e in range(E):
        rows = (ids == e).nonzero()[:, 0]
        we = w[l, e].float()
        for p0 in range(0, len(rows), 8 * nt):
            rr = rows[p0:p0 + 8 * nt]
            total = torch.zeros(len(rr), OUT)
            for rank in range(split):
                u0, u1 = rank * n16 // split, (rank + 1) * n16 // split
                block = torch.zeros(len(rr), OUT)
                for wk in range(2):
                    a, b = u0 + wk * (u1 - u0) // 2, u0 + (wk + 1) * (u1 - u0) // 2
                    acc = torch.zeros(len(rr), OUT)
                    for u in range(a, b):
                        k = slice(u * UNIT, min((u + 1) * UNIT, IN))
                        for xp in parts:
                            acc += xp[rr, k] @ we[k]
                    block += acc
                total += block
            out[rr] = total
    return out.to(x.dtype)


MOE_CASES = [
    # (E, IN, OUT, ids): repeats and an unused expert, clamped ids, one row,
    # 40 rows, 70 rows on one expert (two passes of 64 rows at most), IN not a
    # multiple of the 16-row unit
    (4, 256, 136, [0, 2, 2, 1, 0, 2, 1, 2]),
    (4, 72, 40, [7, -3, 1, 3, 0, 1, 9, 2]),
    (3, 128, 64, [1]),
    (4, 200, 64, [i % 3 for i in range(40)]),
    (2, 64, 8, [1] * 70),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MOE_CASES)
def test_k12_emulation_matches_jax_kernel(case, dtype):
    E, IN, OUT, ids = case
    rng = np.random.default_rng(IN + OUT)
    w = torch.from_numpy(rng.standard_normal((2, E, IN, OUT)).astype(np.float32) * 0.05)
    w = w.bfloat16()
    x = torch.from_numpy(rng.standard_normal((len(ids), IN)).astype(np.float32)).to(dtype)
    idx = torch.tensor(ids, dtype=torch.int32)
    jx = jnp.asarray(x.float().numpy()).astype(jnp.float32 if dtype == torch.float32
                                              else jnp.bfloat16)
    jw = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    want = np.asarray(jmk.moe_gather_matmul(
        jx, jw, jnp.int32(1), jnp.asarray(np.clip(ids, 0, E - 1).astype(np.int32)),
        interpret=True)).astype(np.float32)
    for split in (1, 2, mk.moe_gather_split(len(ids), E, IN, OUT, len(_parts(x)))):
        got = _k12_emulated(x, w, 1, idx, split).float().numpy()
        assert np.abs(got - want).max() <= QUANT_TOL[dtype] * np.abs(want).max(), split


def test_two_bf16_parts_of_an_fp32_activation_are_well_inside_its_tolerance():
    """Why fp32 x goes in as two bf16 parts, not three: at the Mixtral
    widths' IN (4096, and the down projection's 14336), two parts (hi + lo,
    within 2^-16 of x) put the product within 1e-5 of the largest output,
    a tenth of QUANT_TOL (1e-4); three would be exact to fp32."""
    rng = np.random.default_rng(3)
    for IN in (4096, 14336):
        x = torch.from_numpy(rng.standard_normal((8, IN)).astype(np.float32))
        w = torch.from_numpy(rng.standard_normal((IN, 64)).astype(np.float32) * 0.02)
        w = w.bfloat16().double()
        exact = x.double() @ w
        two = sum(p.double() @ w for p in _parts(x))
        assert (two - exact).abs().max() <= 1e-5 * exact.abs().max()


def test_moe_split_plan():
    """moe_gather_split at Mixtral-8x7B's widths (gate_up 4096 -> 28672,
    down 14336 -> 4096; 8 experts): the fastest split of the H100 sweep
    (down at R = 160 tied with SK 16); one pass over up to 32 rows an
    expert, however the rows fall; live blocks at least _MOE_FILL an SM."""
    want = {(8, 4096): 1, (8, 14336): 2, (32, 4096): 4, (32, 14336): 8,
            (160, 4096): 4, (160, 14336): 8}
    for (R, IN), split in want.items():
        OUT = 28672 if IN == 4096 else 4096
        assert mk.moe_gather_split(R, 8, IN, OUT, 1) == split, (R, IN)
        nt, smem = mk.moe_gather_plan(R, IN, 1, split)
        assert 8 * nt >= min(R, 32) and smem <= mk._TC_SMEM
        assert 8 * -(-OUT // mk._TC_COLS) * split >= mk._MOE_FILL * 132
    assert mk.moe_gather_plan(160, 14336, 1, 16)[0] == 4   # 32 rows a pass
    with pytest.raises(ValueError, match="fit"):
        mk.moe_gather_split(8, 8, 1 << 20, 64, 2)


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("R", [1, 7, 8, 9, 16, 17, 31, 32, 33, 64, 65, 160])
def test_k12_pass_holds_32_rows_at_every_split(R, parts):
    """Up to 32 rows an expert are one pass over its weight at every split
    a launch takes, at any R and width: the n-tiles (8 rows each) never
    fall below those of min(R, 32), and a split whose rows do not fit a
    block is not launched ((0, 0)); past 32, a pass takes up to 64 rows
    while two blocks still fit an SM."""
    for IN in (16, 72, 1040, 4096, 14336, 16384, 65536):
        for split in range(1, 17):
            nt, smem = mk.moe_gather_plan(R, IN, parts, split)
            if nt:
                assert 8 * nt >= min(R, 32) and smem <= mk._TC_SMEM, (IN, split)
                full = 1 if R <= 8 else 2 if R <= 16 else 4 if R <= 32 else 8
                assert nt <= full
                if nt < full:   # cut only where twice the rows keep a second block off
                    nk = -(-(-(-IN // UNIT)) // split) * UNIT
                    assert mk._TC_RING + parts * 16 * nt * (2 * nk + 16) > mk._TC_PAIR
