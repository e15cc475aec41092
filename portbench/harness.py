"""The benchmark's harness: finds a cell's files by name and runs it.

Everything that belongs to one configuration, traffic mix or metric sits
in a file of its own, found by the name that BENCHMARK.json gives:

  configs/<config>.json     the sizes (HF config keys), quantization,
                            `weights`, `system` and `reference` module names
  workloads/<cell>.json     config, chips, traffic (kind and parameters),
                            scheduler, warm-up, check limits
  traffic/<kind>.py         a generator (open_loop, closed_loop)
  weights/<weights>.py      the model's weights, made on the device from the seed
  systems/<system>.py       the system under test, built on the weights
  reference/<reference>.py  the plain fp32 reference
  metrics/<metric>.py       read(rec) -> number or None, one a metric

A run: weights from the seed on the device, the system built and warmed
on the cell's own shapes (set-up), the traffic started `lead_in_s` before
the window, the window of `seconds`, then the check against the
reference, and one result.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from portbench import check
from portbench.trace import Tracer

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tinygpt_tpu")
TRACE_SLICE_S = 4.0  # the device trace's slice, at the end of the window


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_cell(name: str):
    """(workload, config) dicts of a cell."""
    wl = load_json("workloads", name)
    return wl, load_json("configs", wl["config"])


def module(kind: str, name: str):
    return importlib.import_module(f"portbench.{kind}.{name}")


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The configuration's weights, from weights/<cfg["weights"]>.py."""
    return module("weights", cfg["weights"]).make_weights(cfg, seed, device)


def reader(name: str):
    """metrics/<name>.py's read function (a name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """[(name, unit)] of the metrics a run of `cell` reports: the
    end-to-end ones untraced, the per-layer ones traced."""
    key = "per_layer" if trace else "end_to_end"
    return [(m["name"], m["unit"]) for m in bench[key]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _say(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if str(device).startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def warm(system, workload: dict, cfg: dict, seed: int) -> None:
    """Requests at the extremes of the cell's prompt lengths, each for two
    decode quanta and a token, through the batcher until it is idle: every
    kernel, plan and allocation the window meets."""
    t = workload["traffic"]
    n = int(workload.get("warmup", {}).get("requests", 2))
    rng = np.random.default_rng(int(seed) + 7)
    q = system.batcher.sc.decode_quantum
    lens = [t["prompt"]["min"], t["prompt"]["max"]] * n
    for i, p in enumerate(lens):
        system.batcher.add_request(system.request(
            -1 - i, rng.integers(3, cfg["vocab_size"], p).tolist(), 2 * q + 1))
    while system.batcher.has_work:
        system.batcher.step()


def serve(system, traffic, tracer, t0: float, w0: float, w1: float, trace_at) -> SimpleNamespace:
    """Drives the batcher from `t0` to the window's end `w1`: each loop adds
    the requests now due, then runs one scheduler step. Returns the
    record of requests and steps."""
    b = system.batcher
    reqs, steps = {}, []
    counts = system.counts
    tr_marks = {}
    while True:
        now = time.perf_counter()
        if now >= w1:
            break
        if trace_at is not None:
            if tracer.t0 is None and now >= trace_at[0]:
                tr_marks["start"] = dict(counts)
                system.quantum_rows = []
                tracer.start()
            elif tracer.t0 is not None and tracer.t1 is None and now >= trace_at[1]:
                tracer.stop()
                tr_marks["stop"] = dict(counts)
        with tracer.span("arrivals"):
            for r in traffic.pop_due(now - t0):
                reqs[r["id"]] = dict(id=r["id"], due=t0 + r["due"], prompt=r["prompt"],
                                     max_new=r["max_new"], admitted=None, first=None,
                                     last=None, finish=None, reason=None, tokens=[])
                b.add_request(system.request(r["id"], r["prompt"], r["max_new"]))
            if not b.has_work:
                wait = min(t0 + traffic.next_due(), w1) - time.perf_counter()
                if wait > 0:
                    time.sleep(min(wait, 0.002))
                continue
        waiting = {r.request_id for r in b.waiting}
        before = dict(counts)
        ts = time.perf_counter()
        with tracer.span("step"):
            events = b.step()
        te = time.perf_counter()
        admitted = []
        if waiting:
            for rid in waiting - {r.request_id for r in b.waiting}:
                reqs[rid]["admitted"] = ts
                admitted.append(len(reqs[rid]["prompt"]))
        n_tok = 0
        for ev in events:
            r = reqs[ev.request_id]
            if ev.token_id is not None:
                n_tok += 1
                r["tokens"].append(ev.token_id)
                r["first"] = r["first"] or te
                r["last"] = te
            if ev.finished:
                r["finish"], r["reason"] = te, ev.finish_reason
                traffic.on_finish(ev.request_id, te - t0)
        steps.append(dict(t0=ts, t1=te, admitted=admitted, tokens=n_tok, waiting=len(b.waiting),
                          admissions=counts["admissions"] - before["admissions"],
                          steps=counts["steps"] - before["steps"],
                          row_steps=counts["row_steps"] - before["row_steps"],
                          kv_slots=counts["kv_slots"] - before["kv_slots"]))
    if tracer.t0 is not None and tracer.t1 is None:
        tracer.stop()
        tr_marks["stop"] = dict(counts)
    return SimpleNamespace(requests=reqs, steps=steps, trace_marks=tr_marks)


def run(workload: dict, cfg: dict, seed: int, seconds: float, trace: bool, *,
        device, metrics: list, t_process0: float, fault=None, kv_cache_dtype=None,
        control_act=False) -> dict:
    """One run of a cell: the result dict (correct, attempted, failed,
    metrics, device, [breakdown], numbers, checks). control.py's options:
    `kv_cache_dtype` runs the program's own fp8 pool; `control_act` also
    reads the fp8-activation reference on the same sample
    (`control_numbers`) and judges it by the cell's limits
    (`control_correct`)."""
    import torch

    on_card = str(device).startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    tracer = Tracer(trace and on_card)
    marks = [("start", time.perf_counter())]
    sysmod = module("systems", cfg["system"])
    marks.append(("import", time.perf_counter()))
    weights = make_weights(cfg, seed, device)
    _sync(device)
    marks.append(("weights", time.perf_counter()))
    system = sysmod.System(cfg, workload, weights, seed, device, tracer.span,
                           kv_cache_dtype=kv_cache_dtype, fault=fault)
    _sync(device)
    marks.append(("system", time.perf_counter()))
    warm(system, workload, cfg, seed)
    _sync(device)
    marks.append(("warm-up", time.perf_counter()))
    if tracer.enabled:
        tracer.warm(lambda: warm(system, workload, cfg, seed + 1))
        _sync(device)
        marks.append(("profiler warm-up", time.perf_counter()))
    _say(f"set-up phases (s): process start to harness {marks[0][1] - t_process0:.3f}, "
         + ", ".join(f"{b[0]} {b[1] - a[1]:.3f}" for a, b in zip(marks[:-1], marks[1:])))
    traffic = module("traffic", workload["traffic"]["kind"]).Traffic(
        workload["traffic"], seed, cfg["vocab_size"], seconds)
    t0 = time.perf_counter()
    w0, w1 = t0 + traffic.lead_in, t0 + traffic.lead_in + seconds
    setup_s = t0 - t_process0
    _say(f"set-up {setup_s:.3f} s; traffic from now, window "
         f"[{traffic.lead_in:.1f}, {traffic.lead_in + seconds:.1f}] s")
    # the device is traced over the window's last TRACE_SLICE_S seconds (its
    # second half at most); the profiler slows the host, so a traced run's
    # host-clock metrics cover the window up to the slice
    trace_at = ((max(w1 - TRACE_SLICE_S, 0.5 * (w0 + w1)), float("inf"))
                if tracer.enabled else None)
    rec = serve(system, traffic, tracer, t0, w0, w1, trace_at)
    _sync(device)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    tr = None
    if tracer.t1 is not None:
        tr = tracer.summary()
        a, z = rec.trace_marks["start"], rec.trace_marks["stop"]
        tr.update({k: z[k] - a[k] for k in ("steps", "row_steps", "kv_slots", "quanta")})
        tr["quantum_rows"] = system.quantum_rows
    host_w1 = tracer.t0 if tracer.t0 is not None else w1
    r = SimpleNamespace(cfg=cfg, workload=workload, seconds=host_w1 - w0, w0=w0, w1=host_w1,
                        setup_s=setup_s, requests=list(rec.requests.values()),
                        steps=rec.steps, trace=tr, route_pairs=weights.get("route_pairs"))
    values = {}
    for name, unit in metrics:
        v = reader(name)(r)
        if v is not None:
            values[name] = {"value": float(v), "unit": unit}
    in_win = [q for q in r.requests if w0 <= q["due"] < w1]
    failed = sum(1 for q in in_win
                 if q["reason"] is not None and len(q["tokens"]) < q["max_new"])
    done = [q for q in r.requests if q["finish"] is not None and w0 <= q["finish"] <= w1
            and len(q["tokens"]) == q["max_new"]]
    _say(f"window: {len(in_win)} requests due, {len(done)} finished in it, "
         f"{sum(s['tokens'] for s in r.steps if w0 <= s['t0'] < w1)} tokens, "
         f"{len(r.steps)} steps; " + ", ".join(f"{k} {v['value']:.6g}" for k, v in values.items()))
    system.close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ck = workload["check"]
    chosen = check.sample(done, seed, ck["tokens"], ck["max_requests"])
    t_chk = time.perf_counter()
    nums = check.numbers(check.gaps(cfg, weights, chosen)) if chosen else {}
    correct, checks = check.judge(nums, ck["limits"])
    _say(f"check: {len(chosen)} requests, {sum(len(q['tokens']) for q in chosen)} served "
         f"tokens against the reference in {time.perf_counter() - t_chk:.1f} s")
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=int(workload["chips"]) if on_card else 0, memory_peak_bytes=int(peak))
    result = dict(correct=correct, attempted=len(in_win), failed=failed, metrics=values,
                  device=dev)
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["window_s"]
        ops = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(tr["gaps"].items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[k[:120], v] for k, v in ops],
                               "idle_gaps": [[k, v] for k, v in gaps]}
    if control_act and chosen:
        cn = check.numbers(check.control_gaps(cfg, weights, chosen))
        result["control_numbers"] = cn
        result["control_correct"] = check.judge(cn, ck["limits"])[0]
    for k, v in nums.items():
        if k not in checks:
            _say(f"read {k} {v} (no limit)")
    for k, c in checks.items():       # the last lines: each number compared, its limit
        _say(f"check {k} {c['value']} limit {c['limit']}")
    result["numbers"] = nums
    result["checks"] = checks
    return result
