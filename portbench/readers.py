"""Arithmetic shared by the metric readers (metrics/<name>.py).

A reader gets the run's record `rec`: the configuration and workload, the
window [w0, w1] on the host clock, set-up seconds, the requests (due,
admitted, first, last, finish times, prompt, served tokens), the steps
(start and end, prompts admitted, decode steps, live row-steps, K/V slots
read, tokens emitted) and, in a traced run, the trace's summary
(trace.py) with the counts of the work issued inside its slice. A reader
returns None where it finds nothing to read.
"""

from __future__ import annotations

import numpy as np

from portbench import costs


def p95(xs):
    return float(np.percentile(xs, 95)) if len(xs) else None


def due_in_window(rec):
    return [r for r in rec.requests if rec.w0 <= r["due"] < rec.w1]


def steps_in_window(rec):
    return [s for s in rec.steps if rec.w0 <= s["t0"] < rec.w1]


def step_window(rec):
    """(steps, seconds) for a rate over the window: the steps that started
    in it, over the time from the window's start, or the end of a step that
    was running then, to the window's end, or the end of the last of those
    steps where it ran on. So a step that straddles an edge adds neither
    its tokens without its time nor its time without its tokens, and every
    gap between steps, a stall of the host too, counts as time."""
    st = steps_in_window(rec)
    start = max([rec.w0] + [s["t1"] for s in rec.steps if s["t0"] < rec.w0])
    end = max([rec.w1] + [s["t1"] for s in st])
    return st, end - start


def ttft_s(rec):
    """First token minus due time, over every request due in the window; a
    request with no first token by the window's end counts at the end."""
    return p95([(r["first"] if r["first"] is not None and r["first"] <= rec.w1 else rec.w1)
                - r["due"] for r in due_in_window(rec)])


def tpot_ms(rec):
    """(last - first) / (tokens - 1) of each request that finished in the
    window."""
    xs = [1e3 * (r["last"] - r["first"]) / (len(r["tokens"]) - 1) for r in rec.requests
          if r["finish"] is not None and rec.w0 <= r["finish"] <= rec.w1
          and len(r["tokens"]) > 1]
    return p95(xs)


def queue_wait_s(rec):
    """Due time to the start of the step in which the request left the
    waiting queue (or the window's end), every request due in the window."""
    return p95([(r["admitted"] if r["admitted"] is not None and r["admitted"] <= rec.w1
                 else rec.w1) - r["due"] for r in due_in_window(rec)])


def decode_only(rec):
    return [s for s in steps_in_window(rec) if s["steps"] and not s["admissions"]]


def decode_step_ms(rec):
    st = decode_only(rec)
    n = sum(s["steps"] for s in st)
    return 1e3 * sum(s["t1"] - s["t0"] for s in st) / n if n else None


def rows_per_step(rec):
    st = [s for s in steps_in_window(rec) if s["steps"]]
    n = sum(s["steps"] for s in st)
    return sum(s["row_steps"] for s in st) / n if n else None


def prefill_mfu_pct(rec):
    st = [s for s in steps_in_window(rec) if s["admitted"]]
    wall = sum(s["t1"] - s["t0"] for s in st)
    if not wall:
        return None
    flops = sum(costs.prefill_flops(rec.cfg, n) for s in st for n in s["admitted"])
    return 100.0 * flops / wall / costs.PEAK_BF16_FLOPS


def decode_mfu_pct(rec):
    st = decode_only(rec)
    wall = sum(s["t1"] - s["t0"] for s in st)
    if not wall:
        return None
    flops = sum(costs.decode_flops(rec.cfg, s["row_steps"], s["kv_slots"]) for s in st)
    return 100.0 * flops / wall / costs.PEAK_BF16_FLOPS


def window_mfu_pct(rec):
    st, seconds = step_window(rec)
    if not st:
        return None
    flops = sum(costs.prefill_flops(rec.cfg, n) for s in st for n in s["admitted"])
    flops += sum(costs.decode_flops(rec.cfg, s["row_steps"], s["kv_slots"]) for s in st)
    return 100.0 * flops / seconds / costs.PEAK_BF16_FLOPS


def kernel_s(rec, match):
    """Device seconds of the traced kernels whose name `match` accepts."""
    if rec.trace is None:
        return 0.0
    return sum(v for k, v in rec.trace["kernels"].items() if match(k))


def is_paged_decode_frozen(name: str) -> bool:
    """K8: the paged split kernel with its in-flight slots (INFL true)."""
    return (("paged_split_kernel" in name and ", true>" in name)
            or "paged_decode_frozen_kernel" in name)


def is_moe_gather(name: str) -> bool:
    """K11a, K11b and K12: the gathered-expert kernels."""
    return "moe_gather" in name


def paged_decode_roofline(rec):
    """The K/V bytes the traced quanta's live rows must read (each row's
    context at each step, bf16) over the HBM peak, against K8's device
    time."""
    t = kernel_s(rec, is_paged_decode_frozen)
    if not t or not rec.trace["kv_slots"]:
        return None
    need = rec.trace["kv_slots"] * costs.kv_bytes_per_slot(rec.cfg, 2)
    return 100.0 * need / costs.HBM_BYTES_PER_S / t


def distinct_experts(quanta, tokens, pairs):
    """Distinct experts a layer, summed over the decode steps of `quanta`
    ([(steps, [(request id, decode steps before)])]): step s of a row whose
    request had d decode steps takes its served token d as input (token 0
    came from the prefill), and a token's experts are its routing pair
    (weights/mistral.py: the same count in every layer). Rows past their last
    served token (a finished request running out the quantum) need
    nothing."""
    total = 0
    for n_steps, rows in quanta:
        for s in range(n_steps):
            need = set()
            for rid, d in rows:
                toks = tokens.get(rid, ())
                if d + s < len(toks):
                    need.update(pairs[toks[d + s]].tolist())
            total += len(need)
    return total


def moe_roofline(rec):
    """The expert bytes the traced quanta's live rows must read (each
    step's distinct experts a layer, from the tokens it took in) over the
    HBM peak, against the gathered-expert kernels' device time."""
    t = kernel_s(rec, is_moe_gather)
    quanta = rec.trace and rec.trace.get("quantum_rows")
    if not t or not quanta or rec.route_pairs is None:
        return None
    tokens = {r["id"]: r["tokens"] for r in rec.requests}
    n = distinct_experts(quanta, tokens, rec.route_pairs)
    g = rec.cfg["quantization"]["group_size"]
    need = costs.int4_bytes(costs.dims(rec.cfg)["L"] * n * costs.expert_params(rec.cfg), g)
    return 100.0 * need / costs.HBM_BYTES_PER_S / t


def device_idle_pct(rec):
    if rec.trace is None or not rec.trace["window_s"]:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
