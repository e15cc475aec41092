"""The metric arithmetic on synthetic timelines: TTFT from the due time,
requests censored at the window's end, whole-window rates, and the trace's
busy union and labelled idle gaps."""

from types import SimpleNamespace

import pytest

from portbench import costs, harness, readers
from portbench.trace import reduce_events


def _req(i, due, first=None, last=None, finish=None, n=0, admitted=None, prompt=10):
    return dict(id=i, due=due, first=first, last=last, finish=finish, admitted=admitted,
                tokens=[5] * n, max_new=n, prompt=[3] * prompt, reason=None)


def _rec(reqs, steps=(), w0=10.0, w1=20.0):
    return SimpleNamespace(requests=list(reqs), steps=list(steps), w0=w0, w1=w1,
                           seconds=w1 - w0, setup_s=1.5, trace=None,
                           cfg=dict(hidden_size=64, num_attention_heads=4,
                                    num_key_value_heads=2, intermediate_size=128,
                                    num_hidden_layers=2, vocab_size=100,
                                    quantization=dict(group_size=64)))


def test_ttft_counts_from_the_due_time_and_censors_at_the_window_end():
    reqs = [_req(i, 10.0 + 0.5 * i, first=10.0 + 0.5 * i + 0.1) for i in range(19)]
    reqs.append(_req(19, 19.5))                   # no first token by 20: counts 0.5
    reqs.append(_req(20, 5.0, first=30.0))        # due in the lead-in: not counted
    reqs.append(_req(21, 19.0, first=25.0))       # first token after the window: 1.0
    r = _rec(reqs)
    xs = sorted([0.1] * 19 + [0.5, 1.0])
    import numpy as np

    assert readers.ttft_s(r) == pytest.approx(float(np.percentile(xs, 95)))
    assert len(readers.due_in_window(r)) == 21


def test_tpot_over_requests_that_finished_in_the_window():
    reqs = [_req(0, 9.0, first=11.0, last=13.0, finish=13.0, n=21),   # 100 ms a token
            _req(1, 11.0, first=12.0, last=22.0, finish=22.0, n=11),  # finished after
            _req(2, 2.0, first=3.0, last=10.5, finish=10.5, n=16)]    # 500 ms
    r = _rec(reqs)
    import numpy as np

    assert readers.tpot_ms(r) == pytest.approx(float(np.percentile([100.0, 500.0], 95)))


def test_queue_wait_and_rates_over_the_whole_window():
    reqs = [_req(0, 10.0, admitted=10.5), _req(1, 12.0, admitted=None)]
    steps = [dict(t0=9.0, t1=9.1, admitted=[], tokens=99, steps=8, admissions=0,
                  row_steps=8, kv_slots=100),
             dict(t0=11.0, t1=11.2, admitted=[], tokens=40, steps=8, admissions=0,
                  row_steps=32, kv_slots=1000),
             dict(t0=12.0, t1=12.1, admitted=[10], tokens=1, steps=0, admissions=1,
                  row_steps=0, kv_slots=0)]
    r = _rec(reqs, steps)
    assert readers.queue_wait_s(r) == pytest.approx(0.5 + 0.95 * (8.0 - 0.5))
    assert harness.reader("out_tok_s")(r) == pytest.approx(41 / 10.0)
    assert readers.decode_step_ms(r) == pytest.approx(200.0 / 8)
    assert readers.rows_per_step(r) == pytest.approx(32 / 8)
    fl = costs.prefill_flops(r.cfg, 10) + costs.decode_flops(r.cfg, 32, 1000)
    assert readers.window_mfu_pct(r) == pytest.approx(100 * fl / 10.0 / costs.PEAK_BF16_FLOPS)
    assert harness.reader("setup_s")(r) == 1.5


def test_rates_move_the_edges_to_the_ends_of_straddling_steps():
    def step(t0, t1, tokens):
        return dict(t0=t0, t1=t1, admitted=[], tokens=tokens, steps=8, admissions=0,
                    row_steps=256, kv_slots=0)

    # a step runs over each edge: the one before the window lends it
    # neither tokens nor its time up to 10.4; the last one adds its tokens
    # and its time up to 20.3
    steps = [step(9.6, 10.4, 256), step(10.4, 15.0, 256), step(15.2, 19.8, 256),
             step(19.8, 20.3, 256)]
    r = _rec([], steps)
    assert readers.step_window(r) == (steps[1:], pytest.approx(20.3 - 10.4))
    assert harness.reader("out_tok_s")(r) == pytest.approx(3 * 256 / (20.3 - 10.4))
    fl = costs.decode_flops(r.cfg, 3 * 256, 0)
    assert readers.window_mfu_pct(r) == pytest.approx(
        100 * fl / (20.3 - 10.4) / costs.PEAK_BF16_FLOPS)
    # a host stall after the last step, up to the window's end, counts as time
    r = _rec([], steps[:3])
    assert harness.reader("out_tok_s")(r) == pytest.approx(2 * 256 / (20.0 - 10.4))


def test_trace_busy_union_and_labelled_gaps():
    ev = [dict(ph="X", cat="kernel", name="k8", ts=0.0, dur=10.0),
          dict(ph="X", cat="kernel", name="k6", ts=5.0, dur=10.0),    # overlaps: 0..15
          dict(ph="X", cat="gpu_memcpy", name="copy", ts=20.0, dur=5.0),
          dict(ph="X", cat="kernel", name="k8", ts=125.0, dur=25.0),
          dict(ph="X", cat="user_annotation", name="step", ts=0.0, dur=100.0),
          dict(ph="X", cat="user_annotation", name="decode_quantum", ts=0.0, dur=19.0),
          dict(ph="X", cat="user_annotation", name="arrivals", ts=100.0, dur=50.0),
          dict(ph="X", cat="gpu_user_annotation", name="step", ts=0.0, dur=500.0)]
    s = reduce_events(ev, 200e-6)
    assert s["busy_s"] == pytest.approx(45e-6)
    assert s["kernels"]["k8"] == pytest.approx(35e-6)
    # gap 15..20 (mid 17.5: decode_quantum), 25..125 (mid 75: in step, no child: emit)
    assert s["gaps"] == pytest.approx({"decode_quantum": 5e-6, "emit": 100e-6})
    rec = _rec([])
    rec.trace = dict(s, kv_slots=0, quantum_rows=[])
    assert readers.device_idle_pct(rec) == pytest.approx(100 * (1 - 45 / 200))
    assert readers.paged_decode_roofline(rec) is None       # nothing to read: no number


def test_paged_roofline_counts_the_slots_read():
    rec = _rec([])
    name = "void tg::(anonymous namespace)::paged_split_kernel<__nv_bfloat16, __nv_bfloat16, 128, 4, true>(x)"
    rec.trace = dict(busy_s=1.0, window_s=2.0, kernels={name: 1e-3, "other": 5.0},
                     gaps={}, kv_slots=1000, quantum_rows=[])
    want = 100 * 1000 * costs.kv_bytes_per_slot(rec.cfg) / costs.HBM_BYTES_PER_S / 1e-3
    assert readers.paged_decode_roofline(rec) == pytest.approx(want)
    assert not readers.is_paged_decode_frozen(name.replace("true", "false"))


def test_distinct_experts_from_the_tokens_each_step_took_in():
    import numpy as np

    pairs = np.array([[0, 1], [1, 2], [3, 0], [0, 1]])     # token -> routing pair
    tokens = {7: [0, 1, 2], 8: [3, 3]}                     # served tokens by request
    # one quantum of 3 steps: request 7 from its first decode step, request 8
    # from its second (its token 1 in), past its last token at step 1
    quanta = [(3, [(7, 0), (8, 1)])]
    # step 0: tokens 0 and 3 -> {0, 1}; step 1: token 1 -> {1, 2}; step 2: token 2 -> {3, 0}
    assert readers.distinct_experts(quanta, tokens, pairs) == 2 + 2 + 2
