"""The arithmetic of K9's and K10's Hopper designs, emulated here on the
CPU and held against the JAX kernels.

K9 (paged_decode, csrc/paged_decode.cu) is K8's split over the block table
(csrc/paged_split.cuh) without the in-flight slots: each row's visible pool
slots [lo, hi) in 32-slot tiles aligned to absolute slot numbers, the tiles
cut into the C shares of a cluster (tg::share), each block reading its
row's first block ids at its start, rank 0 merging the C base-2 softmax
states.
`_k9_shares` repeats that cut from the kernel's scalars and `_k9_emulated`
the split softmax; the latter is held against tinygpt_tpu's
paged_decode_tpu in interpret mode (1e-4 fp32, 2e-2 bf16).

K10 (paged_decode_spec, csrc/paged_decode_spec.cu) cuts each row's span,
the pool slots [lo, hi) (lo raised by position 0's window) and then the
in-flight slots [0, min(base + S, N)), into 64-slot tiles, and the tiles
into C shares; each of a block's 4 warps owns 16 slots of every tile and
decides from scalars which (verify position, slot) pairs it sees.
`_k10_subtiles` and `_k10_visible` repeat that and are held to the plain
version's masks: every pair the plain version sees is seen once, by
exactly one share, and no other pair. `_k10_emulated` runs the
tensor-core body's arithmetic (scores in fp32, a base-2 online softmax per
warp over its sub-tiles whose reference moves only when a score passes it
by more than 2^8, P rounded to bf16 before P V and the row sums l taken
from the rounded P, the warps' then the ranks' states merged) and is held against paged_decode_spec_tpu in
interpret mode, and paged_decode_spec_xla where a window binds (the TPU
kernel has none), at S * G = 20, 72 and 80 within the card tests' tolerance
(one ulp of the largest output in bf16, 1e-4 fp32). The plans
(attention_kernels.paged_decode_split for K9, paged_spec_split for K10)
are checked at the GPT-2, Mistral-7B, Mixtral and spec shapes from given
blocks-an-SM tuples. The card tests hold the kernels themselves at every
split against their plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tinygpt_tpu.ops.paged_attention import (
    paged_decode_spec_tpu,
    paged_decode_spec_xla,
    paged_decode_tpu,
)
from tinygpt_tpu_torch.ops import attention_kernels as tak

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOG2E = 1.4426950408889634
TS = 32          # K9's tile (tg::kTileSlots)
MIN_TILES = 2    # tiles of a share, unless the span is shorter (tg::kMinShareTiles)
CACHE = 2048     # block ids a block keeps (kTableCache)
TS10 = 64        # K10's tile (kTile): 4 warps of SUB slots
SUB = 16
WARPS = 4
LAZY = 8.0       # log2 of the most a weight may reach before K10 moves its reference


def _share(n, C, rank):
    """tg::share: tiles [s0, s1) of rank `rank` of a cluster of C blocks."""
    ce = max(1, min(C, n // MIN_TILES))
    return (rank * n // ce, (rank + 1) * n // ce) if n > 0 and rank < ce else (0, 0)


# -- K9: K8's split without the in-flight slots ----------------------------------


def _k9_span(length, start, MB, bs, window):
    """K9's visible pool range and its tiles: (lo, hi, t_lo, n_pt)."""
    lo = max(start, 0)
    if window:
        lo = max(lo, length - window)
    hi = min(length, MB * bs)
    t_lo = lo // TS
    return lo, hi, t_lo, (hi - 1) // TS + 1 - t_lo if hi > lo else 0


def _k9_shares(length, start, MB, bs, window, C):
    """Per rank: (the pool slots, every tile of the share showing a slot,
    the block indices the block reads once), as the kernel cuts them (the
    span is the pool tiles alone: n_t = n_pt; every block reads its row's
    first min(MB, CACHE) block ids at its start, beside the row's
    scalars)."""
    lo, hi, t_lo, n_pt = _k9_span(length, start, MB, bs, window)
    out = []
    for rank in range(C):
        s0, s1 = _share(n_pt, C, rank)
        pool, full = [], True
        for v in range(s0, s1):
            base = (t_lo + v) * TS
            got = [t for t in range(base, base + TS) if lo <= t < hi]
            pool += got
            full = full and bool(got)
        out.append((pool, full, range(min(MB, CACHE))))
    return out


K9_LONG_ROW = (66000, 0, 4200, 16, None)
K9_SHARE_ROWS = [
    # (length, start, MB, bs, window)
    (1023, 0, 16, 64, None),    # the GPT-2 serving shape's longest row
    (1, 0, 16, 64, None),       # one slot
    (65, 5, 16, 64, None),      # starts > 0
    (700, 17, 16, 64, 8),       # window 8
    (999, 0, 16, 64, 24),       # window 24
    (30, 20, 16, 64, 24),       # a window reaching below the start
    (0, 0, 16, 64, None),       # a released row: no slot, no tile
    (900, 0, 16, 64, None),     # an inactive row's stale length (over a zero table)
    (1100, 0, 16, 64, None),    # a stale length past the table
    (600, 5, 40, 16, 24),       # bs 16: tiles straddle blocks
    (400, 10, 9, 48, None),     # bs 48
    K9_LONG_ROW,                # a row past the block-id cache
]


@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("row", K9_SHARE_ROWS)
def test_k9_shares_cover_every_visible_slot_once(row, C):
    length, start, MB, bs, window = row
    t = np.arange(MB * bs)
    vis = (t >= start) & (t < length)
    if window:
        vis &= t > length - 1 - window
    shares = _k9_shares(length, start, MB, bs, window, C)
    seen = np.zeros(MB * bs, np.int64)
    past = False
    for pool, full, ids in shares:
        seen[pool] += 1
        assert full  # the kernel walks every tile of a share without a check
        cached = [s // bs for s in pool if s // bs - ids.start < len(ids)]
        assert all(b in ids for b in cached)
        if len(ids) < min(MB, CACHE):
            assert len(cached) == len(pool)  # the cache holds the whole share
        past = past or len(cached) < len(pool)
    assert past == (row == K9_LONG_ROW)  # where the per-slot lookup runs
    assert (seen == vis).all()
    holders = [r for r, (p, _, _) in enumerate(shares) if p]
    assert holders == list(range(len(holders)))  # no in-flight tile: ranks 0.. in turn
    if not vis.any():
        assert holders == []  # nothing to walk: every rank writes its empty state


def _k9_emulated(q, kp, vp, tables, lengths, starts, scale, window, C):
    """K9's split on fp32 inputs: each rank's base-2 online-softmax state
    over its share (_k9_shares), the C states merged as rank 0 merges them;
    a rank with no slot holds m = -1e30, a row with none writes zeros."""
    B, Nq, D = q.shape
    _, Nk, bs, _ = kp.shape
    MB = tables.shape[1]
    G = Nq // Nk
    out = torch.zeros(B, Nq, D)
    for b in range(B):
        qb = q[b].reshape(Nk, G, D) * (scale * LOG2E)
        states = []
        for pool, _, _ in _k9_shares(int(lengths[b]), int(starts[b]), MB, bs, window, C):
            if not pool:
                states.append((torch.full((Nk, G, 1), -1e30), torch.zeros(Nk, G, 1),
                               torch.zeros(Nk, G, D)))
                continue
            t = torch.tensor(pool, dtype=torch.long)
            blk = tables[b, t // bs].long()
            blk = torch.where((blk >= 0) & (blk < kp.shape[0]), blk, 0)
            k = kp[blk, :, t % bs].permute(1, 0, 2)
            v = vp[blk, :, t % bs].permute(1, 0, 2)
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


K9_CASES = [
    # (G, Nk, D, bs, MB, lengths, starts, inactive, e4m3)
    (1, 3, 64, 16, 8, (100, 17, 0, 1), (0, 5, 0, 0), (2,), False),  # GPT-2's G = 1
    (4, 2, 128, 32, 4, (128, 33, 100), (0, 0, 5), (), False),        # Mistral-7B's G = 4
    (16, 1, 64, 16, 5, (75, 30), (0, 3), (), False),                  # G = 16: 2 group tiles
    (4, 1, 128, 16, 4, (60, 200), (0, 0), (1,), True),                # e4m3; a stale length
    (1, 2, 64, 64, 3, (190, 64, 129), (0, 0, 10), (), False),         # tiles inside blocks
]


def _round(x, dtype):
    return torch.from_numpy(x).to(dtype).float().numpy()


def _tables(rng, lengths, inactive, bs, MB):
    """Row b owns ceil(lengths[b] / bs) distinct random blocks; its later
    entries, and an inactive row's whole table, are dead (0)."""
    n_blocks = 1 + sum(-(-n // bs) for b, n in enumerate(lengths) if b not in inactive)
    tables = np.zeros((len(lengths), MB), np.int32)
    ids = list(rng.permutation(np.arange(1, n_blocks)))
    for b, n in enumerate(lengths):
        if b not in inactive:
            nb = -(-n // bs)
            tables[b, :nb] = ids[:nb]
            ids = ids[nb:]
    return tables, n_blocks


@pytest.mark.parametrize("C", [1, 3, 8])
@pytest.mark.parametrize("window", [None, 8, 24])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K9_CASES)
def test_k9_emulation_matches_jax_kernel(case, dtype, window, C):
    G, Nk, D, bs, MB, lengths, starts, inactive, e4m3 = case
    B = len(lengths)
    rng = np.random.default_rng(23)
    tables, n_blocks = _tables(rng, lengths, inactive, bs, MB)
    q = _round(rng.standard_normal((B, Nk * G, D)).astype(np.float32), dtype)
    pools = [rng.standard_normal((n_blocks, Nk, bs, D)).astype(np.float32) * 0.5
             for _ in range(2)]
    if e4m3:
        jpools = [jnp.asarray(p).astype(jnp.float8_e4m3fn) for p in pools]
        pools = [np.asarray(p).astype(np.float32) for p in jpools]
    else:
        pools = [_round(p, dtype) for p in pools]
        jpools = [jnp.asarray(p).astype(jnp.float32 if dtype == torch.float32
                                        else jnp.bfloat16) for p in pools]
    lens, sts = np.array(lengths, np.int32), np.array(starts, np.int32)
    jq = jnp.asarray(q).astype(jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    want = np.asarray(paged_decode_tpu(
        jq, *jpools, jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(sts),
        scale=D ** -0.5, sliding_window=window, interpret=True)).astype(np.float32)
    got = _k9_emulated(*(torch.from_numpy(a) for a in (q, *pools, tables, lens, sts)),
                       D ** -0.5, window, C)
    got = got.to(dtype).float().numpy()   # the kernel writes q's type
    # a row that sees no slot (here: a stale length past the table under a
    # window) is zeros in the kernel; the JAX kernel gives a mean there
    seen = np.array([bool(_k9_shares(n, st, MB, bs, window, 1)[0][0])
                     for n, st in zip(lengths, starts)])
    assert np.abs(got[seen] - want[seen]).max() <= TOL[dtype]
    assert not got[~seen].any()


# -- K10: a split over the slots, both products on the tensor cores --------------


def _k10_span(length, start, MB, bs, N, S, base, q_slot0, window):
    """K10's span of one row: (lo, hi, n_infl, t_lo, n_pt, n_t)."""
    lo = max(start, 0)
    if window:
        lo = max(lo, q_slot0 - window + 1)   # position 0's bound
    hi = min(length, MB * bs)
    n_infl = max(min(base + S, N), 0)
    t_lo = lo // TS10
    n_pt = (hi - 1) // TS10 + 1 - t_lo if hi > lo else 0
    return lo, hi, n_infl, t_lo, n_pt, n_pt + -(-n_infl // TS10)


def _k10_subtiles(span, C):
    """Per rank: the warps' sub-tiles of its share, each (is a pool
    sub-tile, its first slot), in the order a warp walks them, and whether
    every tile of the share holds a slot of the span."""
    lo, hi, n_infl, t_lo, n_pt, n_t = span
    out = []
    for rank in range(C):
        s0, s1 = _share(n_t, C, rank)
        subs, full = [[] for _ in range(WARPS)], True
        for v in range(s0, s1):
            f0 = (t_lo + v) * TS10 if v < n_pt else (v - n_pt) * TS10
            full = full and (f0 + TS10 > lo and f0 < hi if v < n_pt else f0 < n_infl)
            for w in range(WARPS):
                f = f0 + w * SUB
                if (f + SUB > lo and f < hi) if v < n_pt else f < n_infl:  # holds(v)
                    subs[w].append((v < n_pt, f))
        out.append((subs, full))
    return out


def _k10_visible(pool, x, s, span, infl_valid_b, base, q_slots_b, infl_slots_b, window):
    """Whether verify position s sees slot x of a sub-tile, from the
    kernel's scalars (x a pool slot, or an in-flight slot)."""
    lo, hi, n_infl = span[:3]
    if pool:
        vis, slot = lo <= x < hi, x
    else:
        vis = x < n_infl and (bool(infl_valid_b[x]) or base <= x <= base + s)
        slot = 0
        if vis and window:
            slot = (q_slots_b[x - base] if x >= base else infl_slots_b[x])
    S = len(q_slots_b)
    if window:
        vis = vis and slot > q_slots_b[min(s, S - 1)] - window
    return vis


def _spec_inputs(rng, lengths, starts, inactive, bs, MB, S, rnd):
    """Tables, in-flight validity and slots at round `rnd` (earlier rounds'
    drafts accepted at random), each row's verify slots after its accepted
    ones, as chip_smoke and the card tests make them."""
    B = len(lengths)
    tables, n_blocks = _tables(rng, lengths, inactive, bs, MB)
    N = (rnd + 1) * S
    valid = np.zeros((B, N), bool)
    infl_slots = np.zeros((B, N), np.int32)
    acc = np.zeros(B, np.int32)
    for r in range(rnd):
        m = rng.integers(0, S, B)
        for b in range(B):
            for i in range(m[b] + 1):
                valid[b, r * S + i] = True
                infl_slots[b, r * S + i] = lengths[b] + acc[b] + i
        acc += m + 1
    q_slots = (np.array(lengths, np.int32)[:, None] + acc[:, None]
               + np.arange(S, dtype=np.int32)[None, :])
    return tables, n_blocks, N, rnd * S, valid, q_slots, infl_slots


K10_SHARE_ROWS = [
    # (lengths, starts, inactive, bs, MB, S, rnd, window)
    ((904, 64, 0, 500), (0, 0, 0, 7), (2,), 64, 16, 5, 0, None),   # the spec serve shape
    ((700, 130, 33), (0, 5, 0), (), 64, 16, 5, 1, None),           # round 1
    ((700, 130, 33), (0, 5, 0), (), 16, 50, 5, 2, None),           # round 2, bs 16
    ((700, 130, 1100), (0, 5, 0), (2,), 64, 16, 9, 2, 100),        # a window; a stale length
    ((300, 90), (0, 0), (), 32, 12, 5, 1, 7),                      # a window inside the round
    ((2000, 40), (3, 0), (), 64, 40, 12, 6, 300),                  # two in-flight tiles
]


@pytest.mark.parametrize("C", range(1, 9))
@pytest.mark.parametrize("row", K10_SHARE_ROWS)
def test_k10_shares_see_every_visible_pair_once(row, C):
    lengths, starts, inactive, bs, MB, S, rnd, window = row
    rng = np.random.default_rng(5 + rnd)
    _, _, N, base, valid, q_slots, infl_slots = _spec_inputs(
        rng, lengths, starts, inactive, bs, MB, S, rnd)
    T = MB * bs
    for b, (length, start) in enumerate(zip(lengths, starts)):
        # the plain version's masks (paged_decode_spec_plain)
        t, j, s = np.arange(T)[None, :], np.arange(N)[None, :], np.arange(S)[:, None]
        mask_f = np.broadcast_to((t < length) & (t >= start), (S, T))
        mask_i = valid[b][None, :] | ((j >= base) & (j <= base + s))
        if window:
            qs = q_slots[b][:, None]
            mask_f = mask_f & (t > qs - window)
            own = q_slots[b][np.clip(j[0] - base, 0, S - 1)]
            slot_j = np.where(j[0] >= base, own, infl_slots[b])
            mask_i = mask_i & (slot_j[None, :] > qs - window)
        span = _k10_span(length, start, MB, bs, N, S, base, q_slots[b, 0], window)
        seen_f, seen_i = np.zeros((S, T), np.int64), np.zeros((S, N), np.int64)
        holders = []
        for rank, (subs, full) in enumerate(_k10_subtiles(span, C)):
            assert full  # every tile of a share holds a slot of the span
            if any(subs):
                holders.append(rank)
            for warp in subs:
                for pool, f in warp:
                    for x in range(f, f + SUB):
                        for p in range(S):
                            if _k10_visible(pool, x, p, span, valid[b], base, q_slots[b],
                                            infl_slots[b], window):
                                (seen_f if pool else seen_i)[p, x] += 1
        assert (seen_f == mask_f).all() and (seen_i == mask_i).all()
        assert holders == list(range(len(holders)))
        n_t = span[-1]
        if n_t > span[4]:  # the in-flight tiles go with the last share
            last = [r for r, (subs, _) in enumerate(_k10_subtiles(span, C))
                    if any(not pool for w in subs for pool, _ in w)]
            assert last == [holders[-1]]


def _k10_emulated(q, kp, vp, tables, lengths, starts, ki, vi, valid, base, scale, window,
                  q_slots, infl_slots, C, rounded):
    """K10's tensor-core body on fp32 inputs (one layer's pools): for each
    (row, KV head, row group of spec_row_tile rows), each rank's warps fold
    their sub-tiles of its share into base-2 online-softmax states (the
    reference m moving only when a score passes it by more than LAZY; P
    rounded to bf16 before P V, l summed from the rounded P, when
    `rounded`), the warps' states merge into the block's, the C blocks'
    into the output; a row that sees nothing writes zeros."""
    B, S, Nq, D = q.shape
    _, Nk, bs, _ = kp.shape
    MB, N = tables.shape[1], ki.shape[2]
    G = Nq // Nk
    R = S * G
    RM = tak.spec_row_tile(D, R)
    sc = scale * LOG2E
    out = torch.zeros(B, S, Nq, D)

    def merge(states):
        M = torch.stack([m for m, _, _ in states]).amax(0)
        xs = [torch.where(M == -torch.inf, 0.0, torch.exp2(m - M)) for m, _, _ in states]
        return (M, sum(lsum * x for (_, lsum, _), x in zip(states, xs)),
                sum(acc * x[:, None] for (_, _, acc), x in zip(states, xs)))

    for b in range(B):
        span = _k10_span(int(lengths[b]), int(starts[b]), MB, bs, N, S, base,
                         int(q_slots[b, 0]) if window else 0, window)
        lo, hi, n_infl = span[:3]
        for kvh in range(Nk):
            qrows = q[b, :, kvh * G:(kvh + 1) * G].reshape(R, D)      # s-major rows
            for r0 in range(0, R, RM):
                rows = torch.arange(r0, r0 + RM)
                qb = torch.zeros(RM, D)
                qb[:min(RM, R - r0)] = qrows[r0:r0 + RM]
                blocks = []
                for subs, _ in _k10_subtiles(span, C):
                    warps = []
                    for warp in subs:
                        m = torch.full((RM,), -torch.inf)
                        lsum, acc = torch.zeros(RM), torch.zeros(RM, D)
                        for pool, f in warp:
                            x = torch.arange(f, f + SUB)
                            if pool:
                                inr = (x >= lo) & (x < hi)
                                blk = tables[b, (x // bs).clamp(max=MB - 1)].long()
                                blk = torch.where((blk >= 0) & (blk < kp.shape[0]), blk, 0)
                                k, v = kp[blk, kvh, x % bs], vp[blk, kvh, x % bs]
                            else:
                                inr = x < n_infl
                                xc = x.clamp(max=N - 1)
                                k, v = ki[b, kvh, xc], vi[b, kvh, xc]
                            k = torch.where(inr[:, None], k, 0.0)   # zero-filled rows
                            v = torch.where(inr[:, None], v, 0.0)
                            vis = torch.tensor([[_k10_visible(
                                pool, int(xx), int(rr) // G, span, valid[b], base,
                                q_slots[b].tolist(), infl_slots[b].tolist(), window)
                                for xx in x] for rr in rows])
                            s = torch.where(vis, (qb @ k.T) * sc, -torch.inf)
                            # the reference moves only past m + LAZY (kLazy)
                            mx = s.amax(1)
                            move = mx > m + LAZY
                            alpha = torch.where(move, torch.exp2(m - mx), 1.0)
                            m = torch.where(move, mx, m)
                            ref = torch.where(m == -torch.inf, 0.0, m)
                            p = torch.exp2(s - ref[:, None])
                            assert p.max() <= 2.0 ** LAZY
                            if rounded:
                                p = p.to(torch.bfloat16).float()
                            lsum = lsum * alpha + p.sum(1)
                            acc = acc * alpha[:, None] + p @ v
                        warps.append((m, lsum, acc))
                    blocks.append(merge(warps))
                _, L, O = merge(blocks)
                o = torch.where(L[:, None] > 0, O / torch.where(L > 0, L, 1.0)[:, None], 0.0)
                for i in range(min(RM, R - r0)):
                    rr = r0 + i
                    out[b, rr // G, kvh * G + rr % G] = o[i]
    return out


K10_CASES = [
    # (G, S, Nk, D, bs, MB, lengths, starts, inactive, rnd, e4m3)
    (4, 5, 2, 128, 32, 8, (200, 64, 0), (0, 5, 0), (2,), 0, False),   # S * G = 20
    (4, 5, 1, 128, 16, 12, (150, 40), (0, 0), (), 2, True),           # S * G = 20, e4m3
    (8, 9, 1, 128, 32, 6, (130, 64), (0, 0), (), 1, False),           # S * G = 72
    (16, 5, 1, 128, 64, 3, (150, 33), (0, 3), (), 1, False),          # S * G = 80
    (16, 5, 1, 64, 16, 10, (120, 70), (0, 0), (), 0, False),          # 80 at D = 64
    (1, 5, 2, 64, 16, 8, (100, 1), (2, 0), (), 2, False),             # GPT-2's G = 1
]


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K10_CASES)
def test_k10_emulation_matches_jax_kernel(case, dtype, window):
    G, S, Nk, D, bs, MB, lengths, starts, inactive, rnd, e4m3 = case
    B = len(lengths)
    rng = np.random.default_rng(31 + rnd)
    tables, n_blocks, N, base, valid, q_slots, infl_slots = _spec_inputs(
        rng, lengths, starts, inactive, bs, MB, S, rnd)
    q = _round(rng.standard_normal((B, S, Nk * G, D)).astype(np.float32), dtype)
    L, l = 2, 1
    pools = [rng.standard_normal((L, n_blocks, Nk, bs, D)).astype(np.float32) * 0.5
             for _ in range(2)]
    jt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    if e4m3:
        jpools = [jnp.asarray(p).astype(jnp.float8_e4m3fn) for p in pools]
        pools = [np.asarray(p).astype(np.float32) for p in jpools]
        itype, jitype = torch.bfloat16, jnp.bfloat16
    else:
        pools = [_round(p, dtype) for p in pools]
        jpools = [jnp.asarray(p).astype(jt) for p in pools]
        itype, jitype = dtype, jt
    ki, vi = (_round(rng.standard_normal((B, Nk, N, D)).astype(np.float32), itype)
              for _ in range(2))
    lens, sts = np.array(lengths, np.int32), np.array(starts, np.int32)
    args = (jnp.asarray(q).astype(jt),)
    rest = (jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(sts),
            jnp.asarray(ki).astype(jitype), jnp.asarray(vi).astype(jitype),
            jnp.asarray(valid))
    if window is None:
        want = paged_decode_spec_tpu(*args, *jpools, *rest, jnp.asarray(l, jnp.int32),
                                     jnp.asarray(base, jnp.int32), scale=D ** -0.5,
                                     interpret=True)
    else:
        want = paged_decode_spec_xla(*args, jpools[0][l], jpools[1][l], *rest,
                                     jnp.asarray(base, jnp.int32), D ** -0.5,
                                     sliding_window=window, q_slots=jnp.asarray(q_slots),
                                     infl_slots=jnp.asarray(infl_slots))
    want = torch.from_numpy(np.asarray(want).astype(np.float32))
    got = _k10_emulated(torch.from_numpy(q), *(torch.from_numpy(p[l]) for p in pools),
                        torch.from_numpy(tables), lens, sts, torch.from_numpy(ki),
                        torch.from_numpy(vi), valid, base, D ** -0.5, window, q_slots,
                        infl_slots, C=3, rounded=dtype == torch.bfloat16)
    got = got.to(dtype).float()   # the kernel writes q's type
    if dtype == torch.bfloat16:   # the card tests' tolerance: one ulp of the largest output
        tol = min(TOL[dtype], 2.0 ** -7 * want.abs().max().item())
    else:
        tol = TOL[dtype]
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("C", [1, 2, 8])
def test_k10_emulation_does_not_depend_on_the_split(C):
    """The split changes only the order of the online softmax: the S * G =
    20 case at C = 1, 2, 8 agrees with C = 3 to fp32 rounding."""
    G, S, Nk, D, bs, MB, lengths, starts, inactive, rnd, _ = K10_CASES[0]
    B = len(lengths)
    rng = np.random.default_rng(7)
    tables, n_blocks, N, base, valid, q_slots, infl_slots = _spec_inputs(
        rng, lengths, starts, inactive, bs, MB, S, 1)
    q = torch.randn(B, S, Nk * G, D, generator=torch.Generator().manual_seed(1))
    kp, vp = (torch.randn(n_blocks, Nk, bs, D) for _ in range(2))
    ki, vi = (torch.randn(B, Nk, N, D) for _ in range(2))
    call = (q, kp, vp, torch.from_numpy(tables), np.array(lengths), np.array(starts), ki, vi,
            valid, base, D ** -0.5, None, q_slots, infl_slots)
    a = _k10_emulated(*call, C=C, rounded=False)
    b = _k10_emulated(*call, C=3, rounded=False)
    assert (a - b).abs().max().item() <= 1e-5


# -- the plans --------------------------------------------------------------------


@pytest.mark.parametrize("B,Nk,G,T,per_sm,want", [
    (16, 12, 1, 1024, 6, 2),    # GPT-2's stepwise quantum: 192 clusters
    (16, 8, 4, 1024, 2, 2),     # Mistral-7B / Mixtral-8x7B: 32/8 heads, 16 rows
    (8, 8, 4, 1024, 2, 4),      # the mixtral_serve stepwise quantum's 8 live rows
    (16, 8, 16, 1024, 1, 1),    # G = 16: 256 clusters already two waves
    (1, 12, 1, 64, 6, 1),       # one short row: no share of two tiles to split off
])
def test_k9_split_plan(B, Nk, G, T, per_sm, want):
    """K9's plan is K8's rule over its own occupancy (tg_paged_decode_plan)
    and the pool's MB * bs slots (no in-flight slot)."""
    C = tak.paged_decode_split(B, Nk, G, T, (per_sm,) * 8)
    assert C == want
    groups = B * Nk * (G // tak.group_tile(G))
    assert C == 1 or groups * C <= 132 * per_sm
    assert C <= max(1, -(-T // TS) // MIN_TILES)


@pytest.mark.parametrize("D,R,rows", [(128, 5, 16), (128, 20, 32), (128, 72, 32),
                                       (128, 80, 32), (64, 20, 32), (64, 72, 64),
                                       (64, 80, 64), (64, 16, 16)])
def test_k10_row_tile(D, R, rows):
    """A block's query rows: its accumulators stay at 128 floats a thread
    (rows x D / 32 lanes of a warp), so D = 128 takes 32 rows and D = 64 64."""
    assert tak.spec_row_tile(D, R) == rows
    assert rows * D // 32 <= 256


@pytest.mark.parametrize("B,Nk,S,G,D,per_sm,want", [
    (16, 8, 5, 4, 128, 2, 2),    # the spec serve shape: 128 clusters, two blocks an SM
    (16, 8, 5, 4, 128, 1, 1),    # one block an SM: the 128 clusters fill the card
    (16, 8, 9, 8, 128, 2, 1),    # S * G = 72: 3 row groups, 384 clusters
    (16, 8, 5, 16, 128, 2, 1),   # S * G = 80
    (16, 12, 5, 1, 64, 3, 2),    # GPT-2's heads
    (2, 8, 5, 4, 128, 2, 8),     # two rows: room for clusters of 8
])
def test_k10_split_plan(B, Nk, S, G, D, per_sm, want):
    """paged_spec_split from the kernel's blocks an SM (tg_paged_decode_spec_
    plan): C grows while the clusters give fewer than two blocks an SM and
    those of C + 1 all run at once, the 64-slot tiles of MB * bs + N slots
    giving shares of two tiles."""
    n_rg = -(-(S * G) // tak.spec_row_tile(D, S * G))
    T = 16 * 64 + S
    C = tak.paged_spec_split(B, Nk, n_rg, T, (per_sm,) * 8)
    assert C == want
    assert C == 1 or B * Nk * n_rg * C <= 132 * per_sm
    assert tak.paged_spec_split(B, Nk, n_rg, 100, (per_sm,) * 8) == 1  # 2 tiles: one share
