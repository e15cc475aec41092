"""The arithmetic of the Hopper designs of K1 (flash_prefill), K13
(flash_decode) and K2 (flash_decode_frozen), emulated here on the CPU and
held against the JAX kernels.

The card computes P = exp(S - m) in fp32 and rounds it to q's type (bf16 or
fp16) for each 64-slot tile before P V on the tensor cores, with fp32 row
max, row sum and accumulator (csrc/flash_prefill.cu); K13 splits each row's
visible span over the C blocks of a cluster and merges their partial
softmax states (csrc/flash_decode.cu). The emulations below repeat that
arithmetic in torch on the CPU, tile by tile and share by share, and are
held against tinygpt_tpu's Pallas kernels in interpret mode (one block each,
as tests/test_attention_kernels.py runs them) within the tolerances of the
card tests (tests/test_torch_cuda.py: 2e-2 bf16, 4e-3 fp16, 1e-4 fp32):
rounding P to bf16 fits the bf16 limit before any chip run.

The split plan (attention_kernels.decode_split, and `_shares` below, which
emulates how each block of the kernel cuts its share of the span) is
checked directly: every visible slot goes to exactly one block, at most 8
blocks a cluster, and no share is shorter than 64 slots unless the span is.
K2 runs the same kernel (csrc/decode_split.cuh) with its in-flight slots as
the span's last tile (`_k2_shares`). The card tests
(test_flash_decode_split_edges_match_plain,
test_flash_decode_frozen_split_edges_match_plain) hold the kernels' own
splits against the plain versions.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops import attention_kernels as jak
from tinygpt_tpu_torch.ops import attention_kernels as tak

TOL = {torch.float32: 1e-4, torch.float16: 4e-3, torch.bfloat16: 2e-2}
LOG2E = 1.4426950408889634
BN = 64         # K1's KV tile
TS = 32         # K13's tile (one word of mask bits)
MIN_TILES = 2   # K13's tiles of a share, unless the span is shorter


def _round(x: np.ndarray, dtype) -> np.ndarray:
    """x rounded to dtype and back to fp32 (the kernel's inputs)."""
    return torch.from_numpy(x).to(dtype).float().numpy()


# -- K13's split plan --------------------------------------------------------------


def _shares(mask_row, C: int) -> list:
    """The slots [start, end) that each of the C blocks of a K13 cluster
    walks for one mask row, as the kernel's `share` cuts them: the tiles
    from the first to the last visible slot's, cut into at most C shares of
    at least MIN_TILES tiles, as equal as whole tiles allow; the blocks past
    the last share get (0, 0)."""
    vis = [t for t, x in enumerate(mask_row) if x]
    shares = [(0, 0)] * C
    if not vis:
        return shares
    T = len(mask_row)
    t_lo, t_hi = vis[0] // TS, vis[-1] // TS + 1
    n = t_hi - t_lo
    ce = max(1, min(C, n // MIN_TILES))
    for r in range(ce):
        j0, j1 = t_lo + r * n // ce, t_lo + (r + 1) * n // ce
        shares[r] = (j0 * TS, min(j1 * TS, T))
    return shares


@pytest.mark.parametrize("B,Nk,G,T,want", [
    (4, 8, 4, 576, 4),     # the model phase's per-token step: 4 blocks a cluster
    (1, 8, 4, 192, 3),     # the stream at batch 1 (its 108 visible slots use 2)
    (1, 8, 4, 64, 1),      # two tiles: one share
    (16, 8, 4, 2048, 1),   # 128 clusters fill the card alone
    (1, 1, 1, 100000, 8),  # at most 8 blocks a cluster
    (2, 8, 16, 1024, 4),   # G = 16: two group tiles of 8 a KV head
    (4, 12, 1, 300, 2),    # GPT-2's heads
])
def test_decode_split_plan(B, Nk, G, T, want):
    C = tak.decode_split(B, Nk, G, T)
    assert C == want
    assert 1 <= C <= 8
    clusters = B * Nk * (G // tak.group_tile(G))
    assert C == 1 or C * clusters <= 132


@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("T,density,seed", [
    (576, 1.0, 0), (576, 0.2, 1), (192, 0.6, 2), (1000, 0.05, 3), (70, 0.5, 4),
    (4096, 0.01, 5), (33, 1.0, 6),
])
def test_decode_shares_cover_every_visible_slot_once(C, T, density, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(T) < density
    shares = _shares(mask, C)
    assert len(shares) == C
    owner = np.zeros(T, np.int64)
    for a, b in shares:
        assert 0 <= a <= b <= T
        owner[a:b] += 1
    assert (owner[mask] == 1).all()  # every visible slot, exactly once
    used = [(a, b) for a, b in shares if b > a]
    assert used == [s for s in shares[:len(used)]]  # the first ranks hold the shares
    if mask.any():
        first, last = np.flatnonzero(mask)[[0, -1]]
        span_tiles = last // TS - first // TS + 1
        assert len(used) <= max(1, span_tiles // 2)
        if len(used) > 1:  # no share below two tiles (64 slots)
            assert all(math.ceil(b / TS) - a // TS >= 2 for a, b in used)
    else:
        assert not used


def test_decode_shares_of_an_empty_or_single_slot_row():
    assert _shares(np.zeros(100, bool), 4) == [(0, 0)] * 4
    row = np.zeros(100, bool)
    row[77] = True
    assert _shares(row, 4) == [(64, 96), (0, 0), (0, 0), (0, 0)]


# -- K1: P rounded to q's type a tile, fp32 softmax state -----------------------------


def _k1_emulated(q, k, v, valid, scale, q_slot, window, ptype):
    """K1's tensor-core arithmetic: for each 64-slot tile, S = Q K^T in
    fp32, scaled into log2 units, masked; the online max and sum in fp32;
    P = exp2(S - m) rounded to ptype; O = alpha O + P V in fp32."""
    B, Nq, S, D = q.shape
    Nk, T = k.shape[1], k.shape[2]
    G = Nq // Nk
    kk, vv = k.repeat_interleave(G, 1), v.repeat_interleave(G, 1)
    rows = q_slot + torch.arange(S)[:, None]
    m = torch.full((B, Nq, S, 1), -math.inf)
    l = torch.zeros(B, Nq, S, 1)
    o = torch.zeros(B, Nq, S, D)
    for t0 in range(0, T, BN):
        t1 = min(t0 + BN, T)
        cols = torch.arange(t0, t1)[None, :]
        vis = cols <= rows
        if window:
            vis = vis & (cols > rows - window)
        vis = vis[None] & valid[:, None, t0:t1]                # [B, S, n]
        s = (q @ kk[:, :, t0:t1].transpose(-1, -2)) * (scale * LOG2E)
        s = s.masked_fill(~vis[:, None], -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_use = torch.where(m_new == -math.inf, torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(s - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + p.to(ptype).float() @ vv[:, :, t0:t1]
        m = m_new
    return torch.where(l > 0, o / torch.where(l > 0, l, torch.ones_like(l)), 0.0)


K1_CASES = [
    # (B, Nq, Nk, D, S, T, pads, q_slot, window)
    (2, 4, 2, 64, 40, 200, (0, 37), 160, None),    # q_slot > 0, three and a bit tiles
    (2, 8, 1, 128, 24, 136, (5, 120), 100, 70),    # G = 8, a window across tiles
    (2, 3, 3, 64, 48, 128, (0, 90), 80, 20),       # G = 1, a window narrower than a tile
    (1, 16, 1, 64, 72, 72, (3,), 0, None),         # G = 16, S = T
]


@pytest.mark.parametrize("ptype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", K1_CASES)
def test_k1_emulation_matches_jax_kernel(case, ptype):
    B, Nq, Nk, D, S, T, pads, q_slot, window = case
    rng = np.random.default_rng(11)
    q = _round(rng.standard_normal((B, Nq, S, D)).astype(np.float32), ptype)
    k = _round(rng.standard_normal((B, Nk, T, D)).astype(np.float32), ptype)
    v = _round(rng.standard_normal((B, Nk, T, D)).astype(np.float32), ptype)
    slots = np.arange(T)[None, :]
    valid = (slots >= np.asarray(pads)[:, None]) & (slots < q_slot + S)
    scale = D ** -0.5
    want = np.asarray(jak.flash_prefill(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid), scale=scale,
        q_slot=q_slot, sliding_window=window, bq=S, bt=T, interpret=True))
    got = _k1_emulated(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                       torch.from_numpy(valid), scale, q_slot, window, ptype)
    got = got.to(ptype).float().numpy()   # the kernel writes q's type
    for b, p in enumerate(pads):
        first = max(0, p - q_slot)        # rows before it see no slot
        assert np.abs(got[b, :, first:] - want[b, :, first:]).max() <= TOL[ptype]
        assert not got[b, :, :first].any()


# -- K13: the cluster's partial states, merged ---------------------------------------


def _k13_emulated(q, k, v, mask, scale, C):
    """K13's split: each block's online-softmax state (m, l, acc) over its
    share of the visible slots (_shares), then the C states merged
    as rank 0 merges them; a block with no visible slot holds m = -1e30."""
    B, Nq, D = q.shape
    Nk = k.shape[1]
    G = Nq // Nk
    out = torch.zeros(B, Nq, D)
    for b in range(B):
        qb = q[b].reshape(Nk, G, D) * scale
        states = []
        for a, e in _shares(mask[b].tolist(), C):
            vis = mask[b, a:e]
            s = torch.einsum("kgd,ktd->kgt", qb, k[b, :, a:e]).masked_fill(~vis, -1e30)
            m = s.amax(-1, keepdim=True) if e > a else torch.full((Nk, G, 1), -1e30)
            p = torch.exp(s - m) * vis
            states.append((m, p.sum(-1, keepdim=True), p @ v[b, :, a:e]))
        M = torch.stack([m for m, _, _ in states]).amax(0)
        L = sum(l * torch.exp(m - M) for m, l, _ in states)
        O = sum(acc * torch.exp(m - M) for m, _, acc in states)
        out[b] = torch.where(L > 0, O / torch.where(L > 0, L, torch.ones_like(L)),
                             0.0).reshape(Nq, D)
    return out


K13_CASES = [
    # (Nq, Nk, D, T, visible (start, count) per row)
    (32, 8, 128, 576, ((0, 576), (112, 464), (300, 3), (575, 1))),  # spans of 576, 464, 3, 1
    (32, 8, 128, 192, ((28, 108),)),                                # the stream at batch 1
    (12, 4, 64, 1000, ((500, 40), (10, 990), (0, 0))),              # one share; a row sees nothing
    (16, 1, 64, 333, ((5, 300), (0, 333))),                         # G = 16; T not a tile multiple
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K13_CASES)
def test_k13_emulation_matches_jax_kernel(case, dtype):
    Nq, Nk, D, T, rows = case
    B = len(rows)
    rng = np.random.default_rng(12)
    q = _round(rng.standard_normal((B, Nq, D)).astype(np.float32), dtype)
    k = _round(rng.standard_normal((B, Nk, T, D)).astype(np.float32), dtype)
    v = _round(rng.standard_normal((B, Nk, T, D)).astype(np.float32), dtype)
    mask = np.zeros((B, T), bool)
    for b, (a, n) in enumerate(rows):
        mask[b, a:a + n] = True
    scale = D ** -0.5
    want = np.asarray(jak.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                       jnp.asarray(mask), scale=scale, bt=T, interpret=True))
    C = tak.decode_split(B, Nk, Nq // Nk, T)
    got = _k13_emulated(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        torch.from_numpy(mask), scale, C)
    got = got.to(dtype).float().numpy()
    for b in range(B):
        if mask[b].any():
            assert np.abs(got[b] - want[b]).max() <= TOL[dtype]
        else:  # the JAX kernel gives the mean of V there; the port gives zeros
            assert not got[b].any()


# -- K2: the frozen slots' shares, with the in-flight slots as the span's last tile -----


def _k2_shares(mask_row, N: int, step: int, window, C: int) -> list:
    """The frozen slots [a, b) and the in-flight slots [c, d) that each of
    the C blocks of a K2 cluster walks for one row, as decode_split.cuh cuts
    them: the in-flight slot j is the virtual slot T_w + j (T_w the frozen
    tiles' slots), visible for j <= step and step - j < window, and the
    virtual row is cut as K13 cuts its mask row (_shares)."""
    T = len(mask_row)
    Tw = -(-T // TS) * TS
    j_lo = max(0, step - window + 1) if window else 0
    virt = np.zeros(Tw + N, bool)
    virt[:T] = mask_row
    virt[Tw + j_lo:Tw + step + 1] = True
    return [((min(a, T), min(b, T)), (min(max(a - Tw, 0), N), min(max(b - Tw, 0), N)))
            for a, b in _shares(virt, C)]


@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("T,density,N,step,window,seed", [
    (576, 1.0, 32, 31, None, 0), (576, 0.3, 32, 0, None, 1), (192, 0.0, 8, 7, None, 2),
    (1000, 0.05, 32, 17, 5, 3), (20, 1.0, 32, 31, 1, 4), (33, 0.5, 16, 3, 40, 5),
    (4096, 0.01, 64, 50, None, 6),
])
def test_k2_shares_cover_every_visible_slot_once(C, T, density, N, step, window, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random(T) < density
    j = np.arange(N)
    infl = (j <= step) & ((step - j < window) if window else True)
    shares = _k2_shares(mask, N, step, window, C)
    frozen, inflight = np.zeros(T, np.int64), np.zeros(N, np.int64)
    for (a, b), (c, d) in shares:
        frozen[a:b] += 1
        inflight[c:d] += 1
    assert (frozen[mask] == 1).all() and (inflight[infl] == 1).all()
    # the in-flight slots go with the last share that holds any slot
    holders = [r for r, ((a, b), (c, d)) in enumerate(shares) if b > a or d > c]
    assert holders == list(range(len(holders)))
    assert [r for r, (_, (c, d)) in enumerate(shares) if d > c] == [holders[-1]]
    if not mask.any():  # every frozen slot hidden: rank 0 walks the in-flight tile alone
        assert holders == [0]


def _k2_emulated(q, ks, vs, mask, ki, vi, l, step, scale, window, C):
    """K2's split: each block's online-softmax state over its share of the
    frozen and in-flight slots (_k2_shares), the C states merged as rank 0
    merges them; a block with no visible slot holds m = -1e30."""
    B, Nq, D = q.shape
    Nk, T = ks.shape[2], ks.shape[3]
    N = ki.shape[2]
    G = Nq // Nk
    j = torch.arange(N)
    vis_i = (j <= step) & ((step - j < window) if window else torch.ones(N, dtype=torch.bool))
    out = torch.zeros(B, Nq, D)
    for b in range(B):
        qb = q[b].reshape(Nk, G, D) * scale
        states = []
        for (fa, fb), (ia, ib) in _k2_shares(mask[b].numpy(), N, step, window, C):
            k = torch.cat([ks[l, b, :, fa:fb], ki[b, :, ia:ib]], dim=1)
            v = torch.cat([vs[l, b, :, fa:fb], vi[b, :, ia:ib]], dim=1)
            vis = torch.cat([mask[b, fa:fb], vis_i[ia:ib]])
            s = torch.einsum("kgd,ktd->kgt", qb, k).masked_fill(~vis, -1e30)
            m = s.amax(-1, keepdim=True) if k.shape[1] else torch.full((Nk, G, 1), -1e30)
            p = torch.exp(s - m) * vis
            states.append((m, p.sum(-1, keepdim=True), p @ v))
        M = torch.stack([m for m, _, _ in states]).amax(0)
        L = sum(lsum * torch.exp(m - M) for m, lsum, _ in states)
        O = sum(acc * torch.exp(m - M) for m, _, acc in states)
        out[b] = torch.where(L > 0, O / torch.where(L > 0, L, torch.ones_like(L)),
                             0.0).reshape(Nq, D)
    return out


K2_CASES = [
    # (Nq, Nk, D, T, N, frozen visible (start, count) per row, e4m3)
    (32, 8, 128, 576, 32, ((0, 544), (112, 432), (300, 3), (0, 0)), False),  # the main path's; an all-pad row
    (24, 2, 64, 300, 16, ((10, 290), (0, 0)), False),   # G = 12: 2 group tiles of 6
    (128, 8, 128, 200, 8, ((0, 150), (77, 73)), False),  # G = 16: 2 group tiles of 8
    (8, 2, 64, 20, 32, ((3, 17), (0, 20)), False),       # T shorter than one tile
    (32, 8, 128, 333, 32, ((5, 300), (0, 0)), True),     # an e4m3 cache, bf16 in-flight K/V
]


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("at_last", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K2_CASES)
def test_k2_emulation_matches_jax_kernel(case, dtype, at_last, window):
    Nq, Nk, D, T, N, rows, e4m3 = case
    B, L, l = len(rows), 2, 1
    step = N - 1 if at_last else 0
    rng = np.random.default_rng(13)
    q = _round(rng.standard_normal((B, Nq, D)).astype(np.float32), dtype)
    if e4m3:
        ks8, vs8 = (jnp.asarray(rng.standard_normal((L, B, Nk, T, D)).astype(np.float32) * 0.5)
                    .astype(jnp.float8_e4m3fn) for _ in range(2))
        ks, vs = (np.asarray(a).astype(np.float32) for a in (ks8, vs8))
        jks, jvs = ks8, vs8
        itype = torch.bfloat16
    else:
        ks, vs = (_round(rng.standard_normal((L, B, Nk, T, D)).astype(np.float32), dtype)
                  for _ in range(2))
        jks, jvs = jnp.asarray(ks), jnp.asarray(vs)
        itype = dtype
    ki, vi = (_round(rng.standard_normal((B, Nk, N, D)).astype(np.float32), itype)
              for _ in range(2))
    mask = np.zeros((B, T), bool)
    for b, (a, n) in enumerate(rows):
        mask[b, a:a + n] = True
    scale = D ** -0.5
    jinfl = (lambda a: jnp.asarray(a).astype(jnp.bfloat16)) if e4m3 else jnp.asarray
    want = np.asarray(jak.flash_decode_frozen(
        jnp.asarray(q), jks, jvs, jnp.asarray(mask), jinfl(ki), jinfl(vi),
        jnp.asarray(l, jnp.int32), jnp.asarray(step, jnp.int32), scale=scale, window=window,
        interpret=True)).astype(np.float32)
    C = tak.decode_split(B, Nk, Nq // Nk, T + N)
    got = _k2_emulated(*(torch.from_numpy(a) for a in (q, ks, vs, mask, ki, vi)), l, step,
                       scale, window, C)
    got = got.to(dtype).float().numpy()   # the kernel writes q's type
    assert np.abs(got - want).max() <= TOL[dtype]
