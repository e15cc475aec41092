"""The arithmetic of the Hopper int8 GEMV (K3 and K5a at M <= 32,
csrc/int8_matmul.cu), emulated here on the CPU and held against the JAX
kernels.

The card splits IN over the C blocks of a cluster (quant_kernels.gemv_split)
and each block's rows over its 8 warps, in 16-row units; it turns each
weight byte into a float through the magic number 2^23 (one byte permute,
one subtraction), sums x * q per group in fp32 and multiplies each group's
sum by its scale once; then it sums the warps, and the cluster's blocks, in
a fixed order, and rounds once. The emulation below repeats that cut and
that order in torch and is held against tinygpt_tpu's
matmul_dequant_int8 and matmul_dequant_int8_stacked in interpret mode (as
tests/test_torch_int8.py runs them), relative to the largest output: 2e-6
in fp32 (both sum exact products in fp32, in another order), one bf16 ulp
(2^-7) in bf16, where both round one fp32 sum. The card tests
(tests/test_torch_cuda.py) hold the kernel itself against its plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops import quant_kernels as jqk
from tinygpt_tpu_torch.ops import quant_kernels as qk
from tinygpt_tpu_torch.ops.quant import quantize_weight

UNIT = 16       # rows of the split's unit
WARPS = 8       # warps of a block
SR = 8          # rows of a ring stage
COLS = 256      # columns of a block
SMS = 132       # the H100's SMs


def _cut(IN: int, C: int) -> list:
    """The rows [r0, r1) of each (block rank, warp), as the kernel cuts IN:
    rank r takes 16-row units [r n16 / C, (r + 1) n16 / C), its warp w the
    units [u0 + w nu / 8, u0 + (w + 1) nu / 8) of them."""
    n16 = IN // UNIT
    cut = []
    for r in range(C):
        u0, u1 = r * n16 // C, (r + 1) * n16 // C
        nu = u1 - u0
        cut.append([((u0 + w * nu // WARPS) * UNIT, (u0 + (w + 1) * nu // WARPS) * UNIT)
                    for w in range(WARPS)])
    return cut


@pytest.mark.parametrize("OUT", [256, 4096, 4864, 28672, 32768])
@pytest.mark.parametrize("IN", [64, 896, 4096, 14336])
@pytest.mark.parametrize("M", [1, 4, 32])
def test_gemv_split_covers_every_row_once(M, IN, OUT):
    C = qk.gemv_split(M, IN, OUT, SMS)
    assert C in qk._GEMV_SPLITS or C == IN // UNIT
    assert 1 <= C <= 16 and C <= IN // UNIT
    owner = np.zeros(IN, np.int64)
    for warps in _cut(IN, C):
        for r0, r1 in warps:
            assert r0 <= r1 and (r1 - r0) % SR == 0   # whole ring stages
            owner[r0:r1] += 1
    assert (owner == 1).all()  # every row of IN, exactly once
    # a block stages its rows' activations: at most the plan's cap
    assert -(-IN // UNIT // C) * UNIT <= 4096


def test_gemv_split_at_the_main_path():
    """The Mistral-7B int8 decode (M = 4), about three blocks for four SMs:
    the head and gate_up one block a column tile (128 and 112 blocks), qkv
    4 (96), o and down 6 (96); GPT-2's qkv 12 and o 16 (a non-portable
    cluster)."""
    got = {k: qk.gemv_split(4, IN, OUT, SMS) for k, (IN, OUT) in {
        "head": (4096, 32768), "gate_up": (4096, 28672), "qkv": (4096, 6144),
        "o": (4096, 4096), "down": (14336, 4096), "gpt2_qkv": (768, 2304),
        "gpt2_o": (768, 768)}.items()}
    assert got == {"head": 1, "gate_up": 1, "qkv": 4, "o": 6, "down": 6, "gpt2_qkv": 12,
                   "gpt2_o": 16}


def _byte_perm(x: np.ndarray, y: int, sel: int) -> np.ndarray:
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays: byte n of the result
    is byte (sel >> 4n) & 7 of the 8 bytes y:x."""
    out = np.zeros_like(x)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        b = (x >> (8 * k)) & 0xFF if k < 4 else np.full_like(x, (y >> (8 * (k - 4))) & 0xFF)
        out |= b << (8 * n)
    return out


def test_magic_number_conversion_is_exact_for_every_byte():
    """Every byte, in each of the four positions of a word: the permute into
    0x4B0000uu (uu = q ^ 0x80) is the float 2^23 + q + 128, and one fp32
    subtraction of 2^23 + 128 leaves q exactly."""
    q = np.arange(-128, 128, dtype=np.int8)
    for j in range(4):
        words = (q.view(np.uint8).astype(np.uint32) << (8 * j)) | np.uint32(0x5A5A5A5A & ~(0xFF << (8 * j)))
        biased = words ^ np.uint32(0x80808080)
        bits = _byte_perm(biased, 0x4B000000, 0x7440 | j)
        f = bits.view(np.float32) - np.float32(8388736.0)
        assert f.dtype == np.float32
        assert np.array_equal(f, q.astype(np.float32))


def _gemv_emulated(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, group: int) -> torch.Tensor:
    """The GEMV's arithmetic for x [M, IN] (fp32 values) and one layer's q
    [IN, OUT] int8, s [IN/group, OUT]: each warp's rows summed in fp32 per
    group (cut at the group's end and at the warp's end), each group's sum
    times its scale; the warps' sums added in order, then the blocks'."""
    M, IN = x.shape
    OUT = q.shape[1]
    C = qk.gemv_split(M, IN, OUT, SMS)
    qf = q.float()
    total = torch.zeros(M, OUT)
    for warps in _cut(IN, C):
        block = torch.zeros(M, OUT)
        for r0, r1 in warps:
            acc = torch.zeros(M, OUT)
            a = r0
            while a < r1:
                b = min(r1, (a // group + 1) * group)
                acc = acc + s[a // group] * (x[:, a:b] @ qf[a:b])
                a = b
            block = block + acc
        total = total + block
    return total


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 4, 8, 32])
@pytest.mark.parametrize("IN,group", [(64, 64), (896, 128), (4096, 128)])
def test_gemv_emulation_matches_jax_kernels(IN, group, M, dtype):
    rng = np.random.default_rng(IN + 7 * M)
    OUT = 264   # a second column tile, OUT % 256 != 0
    w = (rng.standard_normal((2, IN, OUT)) * 0.05).astype(np.float32)
    qt = quantize_weight(torch.from_numpy(w), bits=8, group_size=group)
    x = rng.standard_normal((M, IN)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    jd, js = jnp.asarray(qt.data.numpy()), jnp.asarray(qt.scales.numpy())
    want = {
        "K3": jqk.matmul_dequant_int8(jx, jd[0], js[0], group=group, interpret=True),
        "K5a": jqk.matmul_dequant_int8_stacked(jx, jd, js, 1, group=group, interpret=True),
    }
    for name, layer in (("K3", 0), ("K5a", 1)):
        got = _gemv_emulated(tx.float(), qt.data[layer], qt.scales[layer], group).to(tx.dtype)
        ref = np.asarray(want[name]).astype(np.float32)
        err = np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()
        assert err <= (2e-6 if dtype == "float32" else 2.0 ** -7), (name, err)
