"""The port's program spans and counters, on the CPU: utils/profiler.span
off (one shared null context: no torch call, no clock read, nothing
recorded, about the cost of a bare `with`) and on (records with parent links, record_function ranges in a trace);
the spans ContinuousBatcher records over a pipelined run with an admission
burst, a later arrival and several quanta (issue and read-back linked by
the quantum's number, the next quantum issued before the last is read,
one emission a quantum read, the MoE prefill's host sync inside its
admission only); `stats` against a counting wrapper around the model's
entries; and tools/span_trace.py's arithmetic on synthetic Chrome
events."""

import importlib.util
import json
import timeit
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, Request, SchedulerConfig
from tinygpt_tpu_torch.hf.config import parse_model_config
from tinygpt_tpu_torch.models import causal_lm, get_model
from tinygpt_tpu_torch.utils import profiler

ROOT = Path(__file__).resolve().parents[1]
_BASE = dict(vocab_size=101, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             max_position_embeddings=256, rms_norm_eps=1e-5)
CONFIGS = {
    "llama": dict(_BASE, model_type="llama", tie_word_embeddings=True),
    "mixtral": dict(_BASE, model_type="mixtral", num_local_experts=4,
                    num_experts_per_tok=2),
}
BENCH_SPANS = {"arrivals", "step", "admission", "decode_quantum"}


def _tool():
    spec = importlib.util.spec_from_file_location("span_trace",
                                                  ROOT / "tools" / "span_trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def spans_on():
    profiler.take_spans()
    prev = profiler.set_spans(True)
    try:
        yield
    finally:
        profiler.set_spans(prev)
        profiler.take_spans()


def _counting(model, counts, batcher):
    """The model's entries behind a namespace that counts as the benchmark's
    system does: a forward an admission, a decode_paged_steps a quantum,
    its steps, live row-steps and the K/V slots its attention reads."""

    def forward(*a, **kw):
        counts["admissions"] += 1
        return model.forward(*a, **kw)

    def decode_paged_steps(params, cfg, tok0, state, n_steps, sample_fn, attn_impl="kernel"):
        b = batcher[0]
        rows = list(b.running)
        counts["quanta"] += 1
        counts["decode_steps"] += n_steps
        counts["row_steps"] += len(rows) * n_steps
        counts["kv_slots"] += (n_steps * int(np.sum(b._lengths[rows]))
                               + len(rows) * n_steps * (n_steps + 1) // 2)
        return model.decode_paged_steps(params, cfg, tok0, state, n_steps, sample_fn,
                                        attn_impl=attn_impl)

    return SimpleNamespace(forward=forward, decode_paged_steps=decode_paged_steps)


def _serve(fam, **sc):
    """A pipelined run: three requests at once (one burst), a fourth two
    steps later. Returns (batcher, the counting wrapper's counts)."""
    cfg = parse_model_config(CONFIGS[fam])
    params = causal_lm.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    counts = dict(admissions=0, quanta=0, decode_steps=0, row_steps=0, kv_slots=0)
    holder = []
    b = ContinuousBatcher(_counting(get_model(cfg.model_type), counts, holder), cfg, params,
                          eos_ids=set(),
                          config=SchedulerConfig(**dict(dict(
                              block_size=16, prefill_bucket=16, dtype="float32",
                              batch_capacity=4, decode_quantum=4), **sc)))
    holder.append(b)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, 101, n).tolist() for n in (20, 37, 9, 40)]
    for i in range(3):
        b.add_request(Request(request_id=i, prompt_ids=prompts[i], max_new_tokens=14))
    step = 0
    while b.has_work:
        if step == 2:
            b.add_request(Request(request_id=3, prompt_ids=prompts[3], max_new_tokens=9))
        b.step()
        step += 1
        assert step < 200
    return b, counts


def test_span_off_is_the_shared_null_context_and_does_nothing(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("a disabled span called torch or read the clock")

    profiler.take_spans()
    assert profiler.set_spans(False) is False
    monkeypatch.setattr(profiler.torch.profiler, "record_function", boom)
    with monkeypatch.context() as m:
        m.setattr(profiler.time, "perf_counter_ns", boom)
        a = profiler.span("tg.decode.issue", q=1, rows=2, steps=8)
        assert a is profiler.span("tg.step")
        with a as got:
            profiler.note(prefix=3)
    assert got is None
    assert profiler.take_spans() == ([], 0)


def test_span_off_costs_about_a_bare_with_statement():
    """The disabled span against a `with` of the same null context, timed
    in turns, so that a loaded CPU slows both alike (quiet: about 0.3 µs
    against 0.2 µs)."""
    null = profiler.span("tg.step")

    def off():
        with profiler.span("tg.decode.issue", q=1, rows=32, steps=8):
            pass

    def bare():
        with null:
            pass

    ratios = [timeit.timeit(off, number=2000) / timeit.timeit(bare, number=2000)
              for _ in range(25)]
    assert sorted(ratios)[len(ratios) // 2] < 4.0, ratios


def test_span_on_records_nesting_attrs_and_bounds_its_buffer(spans_on, monkeypatch):
    with profiler.span("tg.a", x=1):
        with profiler.span("tg.b"):
            profiler.note(y=2)
        with profiler.span("tg.c"):
            pass
    recs, dropped = profiler.take_spans()
    assert dropped == 0 and [r.name for r in recs] == ["tg.b", "tg.c", "tg.a"]
    a = recs[2]
    assert a.parent == -1 and recs[0].parent == recs[1].parent == a.id
    assert a.attrs == {"x": 1} and recs[0].attrs == {"y": 2}
    assert a.start_ns <= recs[0].start_ns <= recs[0].end_ns <= recs[1].start_ns <= a.end_ns
    assert profiler.take_spans() == ([], 0)
    monkeypatch.setattr(profiler, "SPAN_BUFFER", 3)
    monkeypatch.setattr(profiler, "_records", profiler.collections.deque(maxlen=3))
    for i in range(5):
        with profiler.span("tg.n", i=i):
            pass
    recs, dropped = profiler.take_spans()
    assert dropped == 2 and [r.attrs["i"] for r in recs] == [2, 3, 4]


@pytest.mark.parametrize("fam,chunk", [("llama", 0), ("llama", 16), ("mixtral", 0)])
def test_batcher_spans_link_issue_readback_and_emission(spans_on, fam, chunk):
    b, _ = _serve(fam, prefill_chunk_tokens=chunk)
    recs, dropped = profiler.take_spans()
    assert dropped == 0
    names = {r.name for r in recs}
    assert not names & BENCH_SPANS
    assert all(n.startswith("tg.") for n in names)
    by_id = {r.id: r for r in recs}
    issue = {r.attrs["q"]: r for r in recs if r.name == "tg.decode.issue"}
    back = {r.attrs["q"]: r for r in recs if r.name == "tg.decode.readback"}
    emit = [r.attrs["q"] for r in recs if r.name == "tg.decode.emit"]
    assert len(issue) >= 4 and set(issue) == set(back) == set(emit)
    assert sorted(emit) == sorted(set(emit))      # one emission a quantum read
    assert b.stats["quanta"] == len(issue)
    assert sum(r.attrs["steps"] for r in issue.values()) == b.stats["decode_steps"]
    pipelined = 0
    for q, r in back.items():
        assert r.start_ns >= issue[q].end_ns
        if q + 1 in issue and issue[q + 1].start_ns < r.start_ns:
            pipelined += 1
    assert pipelined >= 2
    # every span but the steps opens inside a tg.step, on this thread
    for r in recs:
        if r.name == "tg.step":
            assert r.parent == -1
            continue
        top = r
        while top.parent != -1:
            top = by_id[top.parent]
        assert top.name == "tg.step"
    assert {by_id[r.parent].name for r in recs if r.name == "tg.decode.readback"} <= {
        "tg.step", "tg.drain"}
    assert any(by_id[r.parent].name == "tg.drain" for r in recs
               if r.name == "tg.decode.readback")
    admits = [r for r in recs if r.name == "tg.admit"]
    rids = {r.attrs["rid"] for r in admits}
    assert rids == {0, 1, 2, 3}
    for r in recs:
        if r.name in ("tg.admit.prefill", "tg.admit.readback"):
            assert r.attrs["rid"] in rids
    assert all("prompt" in r.attrs and "prefix" in r.attrs for r in admits)
    n_prefill = sum(r.name == "tg.admit.prefill" for r in recs)
    assert n_prefill == b.stats["admissions"]
    assert sum(r.name == "tg.admit.readback" for r in recs) == 4
    if chunk:
        assert n_prefill > 4 and len(admits) == n_prefill
    groups = [r for r in recs if r.name == "tg.moe.group"]
    if fam == "mixtral":
        # the routed MoE prefill (32 tokens and more): one a layer, inside the
        # admissions only
        assert groups and len(groups) % CONFIGS[fam]["num_hidden_layers"] == 0
        assert all(by_id[g.parent].name == "tg.admit.prefill" for g in groups)
    else:
        assert not groups


@pytest.mark.parametrize("fam,chunk", [("llama", 0), ("llama", 16), ("mixtral", 0)])
def test_stats_equal_a_counting_wrapper(fam, chunk):
    b, counts = _serve(fam, prefill_chunk_tokens=chunk)
    assert b.stats == counts
    assert counts["quanta"] >= 4 and counts["kv_slots"] > counts["row_steps"] > 0


def test_cpu_trace_holds_the_batcher_spans(tmp_path):
    with profiler.trace(str(tmp_path)) as t:
        _serve("llama")
    assert profiler.set_spans(False) is False    # trace() restored the switch
    with open(t["path"]) as f:
        events = json.load(f)["traceEvents"]
    got = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"tg.step", "tg.admit", "tg.admit.prefill", "tg.admit.readback", "tg.drain",
            "tg.decode.issue", "tg.decode.readback", "tg.decode.emit"} <= got
    profiler.take_spans()


# -- tools/span_trace.py on synthetic Chrome events ---------------------------


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def _events():
    """Device busy [0, 10], [30, 40], [60, 100], [120, 130] µs; issue spans
    [5, 45] and [100, 140]; an admission [50, 125] holding a tg.moe.group
    [55, 70]; a benchmark span over all; launches at 1, 6, 20, 44, 46, 101
    and 139 (cuLaunchKernelEx), and a copy call at 7."""
    ev = [_x("k", "kernel", a, b - a) for a, b in ((0, 10), (30, 40), (60, 100))]
    ev += [_x("memcpy", "gpu_memcpy", 120, 10),
           _x("tg.decode.issue", "user_annotation", 5, 40),
           _x("tg.decode.issue", "user_annotation", 100, 40),
           _x("tg.admit", "user_annotation", 50, 75),
           _x("tg.moe.group", "user_annotation", 55, 15),
           _x("decode_quantum", "user_annotation", 0, 200),
           _x("cudaMemcpyAsync", "cuda_runtime", 7, 1)]
    ev += [_x("cudaLaunchKernel", "cuda_runtime", t, 1) for t in (1, 6, 20, 44, 46, 101)]
    ev += [_x("cuLaunchKernelEx", "cuda_driver", 139, 1), {"ph": "i", "name": "x", "ts": 3}]
    return ev


def test_span_trace_reduces_launches_idle_and_labels():
    st = _tool()
    red = st.reduce_spans(_events())
    assert red["idle"] == [(10.0, 30.0), (40.0, 60.0), (100.0, 120.0)]
    assert red["launches"] == [1.0, 6.0, 20.0, 44.0, 46.0, 101.0, 139.0]
    assert set(red["spans"]) == {"tg.decode.issue", "tg.admit", "tg.moe.group"}
    # inside [5, 45] or [100, 140]: 6, 20, 44, 101, 139
    assert st.count_inside(red["launches"], red["spans"]["tg.decode.issue"]) == 5
    # idle ∩ issue: [10, 30] whole, [40, 45], [100, 120] whole = 45 µs
    assert st.overlap_us(red["idle"], red["spans"]["tg.decode.issue"]) == pytest.approx(45.0)
    # idle ∩ admit [50, 125]: [50, 60] and [100, 120] = 30 µs
    assert st.overlap_us(red["idle"], red["spans"]["tg.admit"]) == pytest.approx(30.0)
    # midpoints 20 (the first issue), 50 (the admission, at its start) and
    # 110 (inside the admission and the second issue, which started later)
    labels = dict(map(tuple, st.idle_by_span(red["idle"], red["spans"])))
    assert labels == pytest.approx({"tg.decode.issue": 40e-6, "tg.admit": 20e-6})
    red["idle"].append((135.0, 300.0))          # midpoint 217.5: under no span
    labels = dict(map(tuple, st.idle_by_span(red["idle"], red["spans"])))
    assert labels == pytest.approx({"tg.decode.issue": 40e-6, "tg.admit": 20e-6,
                                    "none": 165e-6})
    out = st.device_readings(st.reduce_spans(_events()), 200e-6, 10)
    assert out["decode_launches_per_step"] == pytest.approx(0.5)
    assert out["issue_idle_pct"] == pytest.approx(22.5)
    assert out["admission_idle_pct"] == pytest.approx(15.0)
    assert (out["kernels"], out["launches"]) == (3, 7)
    assert out["calls"][:2] == [("cudaLaunchKernel", 6), ("cudaMemcpyAsync", 1)]
    assert st.device_readings(dict(idle=[], spans={}, launches=[], calls={}, kernels=0),
                              1.0, 0) == dict(idle_by_span=[], kernels=0, launches=0, calls=[])


def test_span_trace_host_readings_over_the_window():
    st = _tool()
    R = profiler.SpanRecord

    def r(i, name, a, b, **attrs):
        return R(i, name, int(a * 1e9), int(b * 1e9), -1, attrs)

    recs = [r(0, "tg.decode.issue", 0.5, 0.6, q=1, steps=8),      # before the window
            r(1, "tg.decode.issue", 1.0, 1.05, q=2, steps=8),
            r(2, "tg.decode.readback", 1.06, 1.07, q=1),
            r(3, "tg.decode.issue", 1.1, 1.16, q=3, steps=4),
            r(4, "tg.decode.readback", 1.17, 1.19, q=2),
            r(5, "tg.decode.readback", 2.5, 2.6, q=3)]             # after it
    out = st.host_readings(recs, 1.0, 2.0)
    assert out["quantum_issue_ms"] == pytest.approx(110.0 / 12)
    assert out["readback_wait_ms"] == pytest.approx(30.0 / 16)
    assert st.host_readings(recs, 3.0, 4.0) == {}
