"""The traffic generators repeat exactly from a seed, and every seed offers
the same requests (sizes and due times), with other token ids."""

import numpy as np

from portbench.traffic import closed_loop, lengths, open_loop

CHAT = dict(kind="open_loop", rate_per_s=4.0, lead_in_s=12.0, schedule_seed=20261018,
            prompt=dict(dist="lognormal", median=1024, sigma=0.7, min=128, max=4096),
            output=dict(dist="lognormal", median=192, sigma=0.6, min=32, max=512))
BATCH = dict(kind="closed_loop", clients=32, pool=512, lead_in_s=30.0, start_spread_s=16.0,
             schedule_seed=20261018,
             prompt=dict(dist="uniform", min=256, max=1024),
             output=dict(dist="uniform", min=128, max=384))


def _window(tr, lead, seconds):
    return [r for r in tr.pop_due(1e9) if lead <= r["due"] < lead + seconds]


def test_open_loop_repeats_from_a_seed():
    a = open_loop.Traffic(CHAT, 3_000_000_001, 32768, 40).pop_due(1e9)
    b = open_loop.Traffic(CHAT, 3_000_000_001, 32768, 40).pop_due(1e9)
    assert a == b
    c = open_loop.Traffic(CHAT, 3_000_000_002, 32768, 40).pop_due(1e9)
    assert a != c


def test_open_loop_window_is_the_same_work_for_every_seed():
    sets = []
    for seed in (1, 2, 2 ** 33 + 5):
        w = _window(open_loop.Traffic(CHAT, seed, 32768, 40), 12.0, 40)
        assert len(w) == 160                      # rate x seconds, exactly
        sets.append([(r["due"], len(r["prompt"]), r["max_new"]) for r in w])
        dues = np.array([r["due"] for r in w])
        assert np.all(np.diff(dues) >= 0) and dues[0] == 12.0
    assert sets[0] == sets[1] == sets[2]
    other = dict(CHAT, schedule_seed=7)
    w = _window(open_loop.Traffic(other, 1, 32768, 40), 12.0, 40)
    assert [(r["due"], len(r["prompt"]), r["max_new"]) for r in w] != sets[0]
    assert sorted(len(r["prompt"]) for r in w) == sorted(x[1] for x in sets[0])


def test_open_loop_lengths_follow_the_mix():
    w = _window(open_loop.Traffic(CHAT, 7, 32768, 40), 12.0, 40)
    p = np.array([len(r["prompt"]) for r in w])
    o = np.array([r["max_new"] for r in w])
    assert p.min() >= 128 and p.max() <= 4096 and abs(np.median(p) - 1024) < 40
    assert o.min() >= 32 and o.max() <= 512 and abs(np.median(o) - 192) < 10
    ids = np.concatenate([r["prompt"] for r in w])
    assert ids.min() >= 3 and ids.max() < 32768


def test_pop_due_releases_requests_on_time():
    tr = open_loop.Traffic(CHAT, 5, 32768, 10)
    first = tr.pop_due(1.0)
    assert all(r["due"] <= 1.0 for r in first)
    assert tr.next_due() > 1.0
    rest = tr.pop_due(1e9)
    assert len(first) + len(rest) == round(4.0 * 12.0) + 40


def test_closed_loop_repeats_and_refills_on_finish():
    a = closed_loop.Traffic(BATCH, 11, 32000, 40)
    b = closed_loop.Traffic(BATCH, 11, 32000, 40)
    ra, rb = a.pop_due(16.0), b.pop_due(16.0)
    assert ra == rb and len(ra) == 32
    rc = closed_loop.Traffic(BATCH, 12, 32000, 40).pop_due(16.0)
    assert [(len(r["prompt"]), r["max_new"]) for r in rc] == [
        (len(r["prompt"]), r["max_new"]) for r in ra] and rc != ra
    # client i starts at i * 16 / 32 s
    assert [r["due"] for r in ra] == [0.5 * i for i in range(32)]
    assert a.pop_due(100.0) == []                 # nobody is free until one finishes
    # the first round is staggered: shares (i + 0.5) / 32 of its drawn output
    assert len({r["max_new"] for r in ra}) > 16
    a.on_finish(ra[3]["id"], 20.5)
    nxt = a.pop_due(20.5)
    assert len(nxt) == 1 and nxt[0]["due"] == 20.5 and 128 <= nxt[0]["max_new"] <= 384


def test_quantiles_are_fixed_and_clipped():
    q = lengths.quantiles(dict(dist="uniform", min=256, max=1024), 512)
    assert q.min() >= 256 and q.max() <= 1024 and len(set(q.tolist())) > 400
    g = lengths.exponential_gaps(4.0, 160, 40.0)
    assert abs(g.sum() - 40.0) < 1e-9 and np.all(g > 0)
