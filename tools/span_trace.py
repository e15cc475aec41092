"""Runs one cell of the port's benchmark with the program's spans on, and
prints what the spans and counters read beside the benchmark's result.

    python3 tools/span_trace.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--spans 0|1]

from the root of a checkout, on a CUDA card. It drives portbench/harness.py
as portbench/run.py does, with three wrappers and no edit to the benchmark:
the program's spans (utils/profiler.span) are turned on when the traffic
starts (`--spans 1`, the default) and taken at the window's end; a traced
run keeps the Chrome trace's events; the batcher's `stats` are read where
the device trace starts and stops. The last line of standard output is the
benchmark's result with one more key, `span_readings`:

  quantum_issue_ms     summed tg.decode.issue spans that started in the
                       window before the device trace, over their steps
  readback_wait_ms     summed tg.decode.readback spans in the same window,
                       over the steps of the quanta they read
  decode_step_ms       the benchmark's reader over the same window (wall
                       of the steps that ran only a quantum, over steps)
  decode_launches_per_step   launch calls inside tg.decode.issue
                       annotations in the device trace, over the decode
                       steps the batcher counted across it
  issue_idle_pct, admission_idle_pct   device-idle time intersecting
                       tg.decode.issue / tg.admit annotations, over the
                       trace's slice
  idle_by_span         the slice's idle seconds by the innermost tg.* span
                       open at each gap's middle ("none" outside any)
  stats                the batcher's counters across the slice
"""

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench.trace import DEVICE_CATS, Tracer, _merge, reduce_events  # noqa: E402

LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx", "cudaGraphLaunch")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def reduce_spans(events) -> dict:
    """From Chrome trace events (times in µs): the merged device-busy
    intervals, the idle gaps between them, the intervals of each tg.*
    annotation, the sorted host times of the launch calls, and the count of
    every LAUNCH_CATS call by name and of the device's kernels (to
    check that LAUNCHES names every launch the trace holds)."""
    busy, ann, launches, calls, kernels = [], {}, [], {}, 0
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            busy.append([a, b])
            kernels += cat == "kernel"
        elif cat == "user_annotation" and name.startswith("tg."):
            ann.setdefault(name, []).append((a, b))
        elif cat in LAUNCH_CATS:
            calls[name] = calls.get(name, 0) + 1
            if name in LAUNCHES:
                launches.append(a)
    merged = _merge(busy)
    idle = [(b, c) for (_, b), (c, _) in zip(merged[:-1], merged[1:]) if c > b]
    return dict(idle=idle, spans={k: sorted(v) for k, v in ann.items()},
                launches=sorted(launches), calls=calls, kernels=kernels)


def union(iv):
    """Sorted disjoint intervals covering `iv`."""
    return [tuple(x) for x in _merge([list(x) for x in iv])]


def count_inside(times, iv) -> int:
    """Times (sorted) that fall inside the union of intervals `iv`."""
    return sum(bisect.bisect_right(times, b) - bisect.bisect_left(times, a)
               for a, b in union(iv))


def overlap_us(idle, iv) -> float:
    """Length of the intersection of the idle gaps with the union of `iv`."""
    u = union(iv)
    starts = [a for a, _ in u]
    total = 0.0
    for a, b in idle:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(u) and u[i][0] < b:
            total += max(0.0, min(b, u[i][1]) - max(a, u[i][0]))
            i += 1
    return total


def idle_by_span(idle, spans, top: int = 10):
    """[[label, s]]: each idle gap's seconds under the innermost tg.* span
    open at its middle (the latest-starting one that holds it; spans nest on
    the batcher's thread), "none" outside any; the largest `top`."""
    flat = sorted((a, b, name) for name, iv in spans.items() for a, b in iv)
    starts = [a for a, _, _ in flat]
    out = {}
    for a, b in idle:
        t = 0.5 * (a + b)
        label = "none"
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if flat[i][1] >= t:
                label = flat[i][2]
                break
        out[label] = out.get(label, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]


def host_readings(records, t0: float, t1: float) -> dict:
    """quantum_issue_ms and readback_wait_ms over the spans (profiler
    SpanRecords) that started in [t0, t1) on the host clock (s)."""
    a, b = int(t0 * 1e9), int(t1 * 1e9)
    steps = {r.attrs["q"]: r.attrs["steps"] for r in records if r.name == "tg.decode.issue"}
    issue = [r for r in records if r.name == "tg.decode.issue" and a <= r.start_ns < b]
    back = [r for r in records if r.name == "tg.decode.readback" and a <= r.start_ns < b
            and r.attrs["q"] in steps]
    out = {}
    n = sum(r.attrs["steps"] for r in issue)
    if n:
        out["quantum_issue_ms"] = sum(r.end_ns - r.start_ns for r in issue) * 1e-6 / n
    n = sum(steps[r.attrs["q"]] for r in back)
    if n:
        out["readback_wait_ms"] = sum(r.end_ns - r.start_ns for r in back) * 1e-6 / n
    return out


def device_readings(red: dict, window_s: float, decode_steps: int) -> dict:
    """decode_launches_per_step, issue_idle_pct, admission_idle_pct and
    idle_by_span of one traced slice (`red` from reduce_spans)."""
    sp, idle = red["spans"], red["idle"]
    out = {"idle_by_span": idle_by_span(idle, sp), "kernels": red["kernels"],
           "launches": len(red["launches"]),
           "calls": sorted(red["calls"].items(), key=lambda kv: -kv[1])[:12]}
    issue = sp.get("tg.decode.issue", [])
    if decode_steps and issue:
        out["decode_launches_per_step"] = count_inside(red["launches"], issue) / decode_steps
    for key, name in (("issue_idle_pct", "tg.decode.issue"),
                      ("admission_idle_pct", "tg.admit")):
        if name in sp and window_s:
            out[key] = 100.0 * overlap_us(idle, sp[name]) * 1e-6 / window_s
    return out


class KeepingTracer(Tracer):
    """The benchmark's tracer, which also keeps reduce_spans of its events
    and the batcher's stats where it starts and stops."""

    batcher = None
    kept = None
    marks = None

    def start(self) -> None:
        super().start()
        self.marks = {"start": dict(self.batcher.stats)}

    def stop(self) -> None:
        super().stop()
        self.marks["stop"] = dict(self.batcher.stats)

    def summary(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.kept = reduce_spans(events)
        self.prof = None
        return reduce_events(events, self.t1 - self.t0)


def wrap_serve(serve, spans_on: bool, seen: dict):
    """harness.serve with the program's spans on for the traffic and its
    arguments and record kept in `seen`."""
    from tinygpt_tpu_torch.utils import profiler

    def wrapped(system, traffic, tracer, t0, w0, w1, trace_at):
        if isinstance(tracer, KeepingTracer):
            tracer.batcher = system.batcher
        profiler.take_spans()  # what set-up and warm-up recorded
        profiler.set_spans(spans_on)
        try:
            rec = serve(system, traffic, tracer, t0, w0, w1, trace_at)
        finally:
            profiler.set_spans(False)
        seen.update(rec=rec, tracer=tracer, w0=w0, w1=w1, spans=profiler.take_spans())
        return rec

    return wrapped


def readings(seen: dict) -> dict:
    """span_readings (module docstring) of one run."""
    from portbench import readers

    tr = seen["tracer"]
    w0 = seen["w0"]
    w1 = tr.t0 if tr.t0 is not None else seen["w1"]
    records, dropped = seen["spans"]
    out = dict(host_readings(records, w0, w1), spans_recorded=len(records),
               spans_dropped=dropped)
    step_ms = readers.decode_step_ms(SimpleNamespace(steps=seen["rec"].steps, w0=w0, w1=w1))
    if step_ms is not None:
        out["decode_step_ms"] = step_ms
    if isinstance(tr, KeepingTracer) and tr.kept is not None:
        a, z = tr.marks["start"], tr.marks["stop"]
        d = {k: z[k] - a[k] for k in a}
        out.update(device_readings(tr.kept, tr.t1 - tr.t0, d["decode_steps"]), stats=d)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    os.environ.setdefault("TINYGPT_LOG_LEVEL", "WARNING")
    import torch

    from portbench import harness
    from portbench.run import power_limit

    if not torch.cuda.is_available():
        print("span_trace: needs a CUDA card", file=sys.stderr)
        return 2
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    workload, cfg = harness.load_cell(args.workload)
    seen = {}
    harness.serve = wrap_serve(harness.serve, bool(args.spans), seen)
    harness.Tracer = KeepingTracer
    torch.cuda.set_device(0)
    with torch.inference_mode():
        result = harness.run(workload, cfg, args.seed, args.seconds, bool(args.trace),
                             device="cuda", t_process0=T_PROCESS0,
                             metrics=harness.metrics_for(bench, args.workload,
                                                         bool(args.trace)))
    result.pop("numbers")
    result["device"]["card"] = power_limit()
    result["span_readings"] = readings(seen)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
