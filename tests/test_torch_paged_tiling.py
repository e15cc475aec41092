"""The arithmetic of K8's Hopper design (paged_decode_frozen,
csrc/paged_decode_frozen.cu), emulated here on the CPU and held against the
JAX kernel.

K8 cuts each row's visible span into 32-slot tiles aligned to absolute slot
numbers, the pool slots [lo, hi) first and the in-flight slots [j_lo, step]
after them, and the span's tiles into the C shares of a cluster
(tg::share); each block reads its share's block ids once, then walks its
tiles, and rank 0 merges the C partial softmax states. `_k8_shares` below
repeats that cut from the same scalars the kernel reads, and the tests hold
it to the plain version's visibility: every visible slot in exactly one
share, the in-flight tile with the highest rank that holds a share, every
tile of a share holding a visible slot (the kernel walks them without a
check), and the block ids a share reads covering its pool slots.
`_k8_emulated` runs the split softmax share by share (base 2, q pre-scaled
by scale * log2 e, as the kernel) and is held against
tinygpt_tpu's paged_decode_frozen_tpu in interpret mode within the card
tests' tolerances (1e-4 fp32, 2e-2 bf16, the output rounded to q's type).
The plan, attention_kernels.paged_decode_split, is checked at the serve,
GPT-2 and G = 16 shapes from the blocks an SM the card runs. The card
tests (test_paged_decode_frozen_every_split_matches_plain) hold the kernel
itself at every C against the plain version.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops.paged_attention import paged_decode_frozen_tpu
from tinygpt_tpu_torch.ops import attention_kernels as tak

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOG2E = 1.4426950408889634
TS = 32          # K8's tile (tg::kTileSlots)
MIN_TILES = 2    # tiles of a share, unless the span is shorter (tg::kMinShareTiles)
CACHE = 2048     # block ids a block keeps (kTableCache)


def _span(length, start, MB, bs, step, window):
    """The kernel's visible ranges and tiles of one row: (lo, hi, j_lo,
    t_lo, n_pt, jt_lo, n_t)."""
    lo, j_lo = max(start, 0), 0
    if window:
        lo = max(lo, length + step - window + 1)
        j_lo = max(step - window + 1, 0)
    hi = min(length, MB * bs)
    t_lo = lo // TS
    n_pt = (hi - 1) // TS + 1 - t_lo if hi > lo else 0
    jt_lo = j_lo // TS
    return lo, hi, j_lo, t_lo, n_pt, jt_lo, n_pt + step // TS + 1 - jt_lo


def _share(n, C, rank):
    """tg::share: tiles [s0, s1) of rank `rank` of a cluster of C blocks."""
    ce = max(1, min(C, n // MIN_TILES))
    return (rank * n // ce, (rank + 1) * n // ce) if n > 0 and rank < ce else (0, 0)


def _k8_shares(length, start, MB, bs, step, window, C):
    """Per rank: (the pool slots, the in-flight slots, every tile of the
    share showing a slot, the block indices [bi0, bi0 + nb) of the table the
    block reads once) as the kernel cuts them."""
    lo, hi, j_lo, t_lo, n_pt, jt_lo, n_t = _span(length, start, MB, bs, step, window)
    out = []
    for rank in range(C):
        s0, s1 = _share(n_t, C, rank)
        pool, infl, full = [], [], True
        for v in range(s0, s1):
            if v < n_pt:
                base = (t_lo + v) * TS
                got = [t for t in range(base, base + TS) if lo <= t < hi]
                pool += got
            else:
                base = (jt_lo + v - n_pt) * TS
                got = [j for j in range(base, base + TS) if j_lo <= j <= step]
                infl += got
            full = full and bool(got)
        pe = min(s1, n_pt)
        ids = range(0)
        if s0 < pe:
            bi0 = max(lo, (t_lo + s0) * TS) // bs
            nb = min((min(hi, (t_lo + pe) * TS) - 1) // bs + 1 - bi0, min(MB, CACHE))
            ids = range(bi0, bi0 + nb)
        out.append((pool, infl, full, ids))
    return out


# 66,000 slots of bs 16: 4,125 block ids, so the share of a cluster of C <= 2
# runs past the CACHE ids a block keeps and looks its later ids up per slot
LONG_ROW = (66000, 0, 4200, 16, 8, 7, None)
SHARE_ROWS = [
    # (length, start, MB, bs, N, step, window)
    (767, 0, 16, 64, 8, 7, None),       # the serve shape's longest row
    (512, 0, 16, 64, 8, 0, None),       # its shortest, the first step
    (0, 0, 16, 64, 8, 7, None),         # a released row: the in-flight slots alone
    (1100, 0, 16, 64, 8, 3, None),      # a stale length past the table
    (600, 5, 40, 16, 8, 5, 100),        # bs 16 (tiles straddle blocks), a window
    (2200, 0, 70, 32, 40, 39, None),    # two in-flight tiles
    (2200, 0, 70, 32, 40, 39, 37),      # a window inside the in-flight slots
    (400, 10, 9, 48, 6, 2, 64),         # bs 48
    (45, 44, 16, 64, 8, 7, None),       # one pool slot
    LONG_ROW,                           # a share past the block-id cache
]


@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("row", SHARE_ROWS)
def test_k8_shares_cover_every_visible_slot_once(row, C):
    length, start, MB, bs, N, step, window = row
    t = np.arange(MB * bs)
    vis_p = (t >= start) & (t < length)
    j = np.arange(N)
    vis_i = j <= step
    if window:
        vis_p &= t > length + step - window
        vis_i &= step - j < window
    shares = _k8_shares(length, start, MB, bs, step, window, C)
    seen_p, seen_i = np.zeros(MB * bs, np.int64), np.zeros(N, np.int64)
    past = False
    for pool, infl, full, ids in shares:
        seen_p[pool] += 1
        seen_i[infl] += 1
        assert full  # the kernel walks every tile of a share without a check
        cached = [s // bs for s in pool if s // bs - ids.start < len(ids)]
        assert all(b in ids for b in cached)
        if len(ids) < min(MB, CACHE):
            assert len(cached) == len(pool)  # the cache holds the whole share
        past = past or len(cached) < len(pool)
    assert past == (row == LONG_ROW and C <= 2)  # where the per-slot lookup runs
    assert (seen_p == vis_p).all() and (seen_i == vis_i).all()
    holders = [r for r, (p, i, _, _) in enumerate(shares) if p or i]
    assert holders == list(range(len(holders)))
    assert [r for r, (_, i, _, _) in enumerate(shares) if i] == [holders[-1]]
    if not vis_p.any():  # no pool slot: rank 0 walks the in-flight tile alone
        assert holders == [0]


@pytest.mark.parametrize("B,Nk,G,per_sm,want", [
    (16, 8, 4, 2, 2),    # the serve shape: two blocks an SM (registers)
    (16, 12, 1, 6, 2),   # GPT-2's: six an SM (shared memory)
    (16, 8, 16, 1, 1),   # G = 16: one an SM, 256 clusters already two waves
    (1, 8, 4, 2, 8),     # one row: 8 clusters, room for 8 blocks each
    (4, 2, 1, 8, 8),
    (64, 8, 4, 2, 1),    # 512 clusters: two waves already
])
def test_k8_split_plan(B, Nk, G, per_sm, want):
    """paged_decode_split from the kernel's blocks an SM: C grows while the
    clusters give fewer than two blocks an SM, the clusters of C + 1 all
    run at once, and the shares keep two tiles; the serve, GPT-2 and G = 16
    shapes take the fastest C of the H100 sweep (2, 2, 1). K2's decode_split
    (one block an SM) would give 1 at the serve shape."""
    T = 16 * 64 + 8
    C = tak.paged_decode_split(B, Nk, G, T, (per_sm,) * 8)
    assert C == want
    groups = B * Nk * (G // tak.group_tile(G))
    assert C == 1 or groups * C <= 132 * per_sm
    assert tak.paged_decode_split(B, Nk, G, 100, (per_sm,) * 8) <= -(-100 // TS) // MIN_TILES
    if (B, Nk, G) == (16, 8, 4):
        assert tak.decode_split(B, Nk, G, T) == 1


def _k8_emulated(q, kp, vp, tables, lengths, starts, ki, vi, l, step, scale, window, C):
    """K8's split on fp32 inputs: each rank's base-2 online-softmax state
    over its share (_k8_shares), the C states merged as rank 0 merges them;
    a rank with no slot holds m = -1e30."""
    B, Nq, D = q.shape
    _, _, Nk, bs, _ = kp.shape
    MB = tables.shape[1]
    G = Nq // Nk
    out = torch.zeros(B, Nq, D)
    for b in range(B):
        qb = q[b].reshape(Nk, G, D) * (scale * LOG2E)
        states = []
        for pool, infl, _, _ in _k8_shares(int(lengths[b]), int(starts[b]), MB, bs, step,
                                           window, C):
            t = torch.tensor(pool, dtype=torch.long)
            blk = tables[b, t // bs].long() if len(pool) else t
            blk = torch.where((blk >= 0) & (blk < kp.shape[1]), blk, 0)
            k = torch.cat([kp[l, blk, :, t % bs].permute(1, 0, 2), ki[b, :, infl]], dim=1)
            v = torch.cat([vp[l, blk, :, t % bs].permute(1, 0, 2), vi[b, :, infl]], dim=1)
            if k.shape[1] == 0:
                states.append((torch.full((Nk, G, 1), -1e30), torch.zeros(Nk, G, 1),
                               torch.zeros(Nk, G, D)))
                continue
            s = torch.einsum("kgd,ktd->kgt", qb, k)
            m = s.amax(-1, keepdim=True)
            p = torch.exp2(s - m)
            states.append((m, p.sum(-1, keepdim=True), p @ v))
        M = torch.stack([m for m, _, _ in states]).amax(0)
        L = sum(lsum * torch.exp2(m - M) for m, lsum, _ in states)
        O = sum(acc * torch.exp2(m - M) for m, _, acc in states)
        out[b] = torch.where(L > 0, O / torch.where(L > 0, L, torch.ones_like(L)),
                             0.0).reshape(Nq, D)
    return out


K8_CASES = [
    # (G, Nk, D, bs, MB, lengths, starts, inactive, N, e4m3)
    (1, 2, 64, 16, 6, (90, 17, 0), (2, 0, 0), (2,), 4, False),         # a row at length 0
    (4, 2, 128, 32, 4, (128, 33, 100), (0, 0, 5), (), 6, False),
    (16, 1, 64, 16, 5, (75, 30), (0, 3), (), 4, False),                 # G = 16: 2 group tiles
    (4, 1, 128, 16, 4, (60, 200), (0, 0), (1,), 5, True),               # e4m3; a stale length
]


def _round(x, dtype):
    return torch.from_numpy(x).to(dtype).float().numpy()


@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("window", [None, 19])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K8_CASES)
def test_k8_emulation_matches_jax_kernel(case, dtype, window, C):
    G, Nk, D, bs, MB, lengths, starts, inactive, N, e4m3 = case
    B, L, l, step = len(lengths), 2, 1, N - 2
    rng = np.random.default_rng(17)
    n_blocks = 1 + sum(-(-n // bs) for b, n in enumerate(lengths) if b not in inactive)
    tables = np.zeros((B, MB), np.int32)
    ids = list(rng.permutation(np.arange(1, n_blocks)))
    for b, n in enumerate(lengths):
        if b not in inactive:
            nb = -(-n // bs)
            tables[b, :nb] = ids[:nb]
            ids = ids[nb:]
    q = _round(rng.standard_normal((B, Nk * G, D)).astype(np.float32), dtype)
    pools = [rng.standard_normal((L, n_blocks, Nk, bs, D)).astype(np.float32) * 0.5
             for _ in range(2)]
    if e4m3:
        jpools = [jnp.asarray(p).astype(jnp.float8_e4m3fn) for p in pools]
        pools = [np.asarray(p).astype(np.float32) for p in jpools]
        itype, jitype = torch.bfloat16, jnp.bfloat16
    else:
        pools = [_round(p, dtype) for p in pools]
        jpools = [jnp.asarray(p) for p in pools]
        itype, jitype = dtype, jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ki, vi = (_round(rng.standard_normal((B, Nk, N, D)).astype(np.float32), itype)
              for _ in range(2))
    lens, sts = np.array(lengths, np.int32), np.array(starts, np.int32)
    jq = jnp.asarray(q).astype(jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    want = np.asarray(paged_decode_frozen_tpu(
        jq, *jpools, jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(sts),
        jnp.asarray(ki).astype(jitype), jnp.asarray(vi).astype(jitype),
        jnp.asarray(l, jnp.int32), jnp.asarray(step, jnp.int32), scale=D ** -0.5,
        sliding_window=window, interpret=True)).astype(np.float32)
    got = _k8_emulated(*(torch.from_numpy(a) for a in (q, *pools, tables, lens, sts, ki, vi)),
                       l, step, D ** -0.5, window, C)
    got = got.to(dtype).float().numpy()   # the kernel writes q's type
    assert np.abs(got - want).max() <= TOL[dtype]
