"""Host spans and the device trace of a `--trace 1` run.

The benchmark's own host spans (`arrivals`, `step`, and inside a step
`admission` and `decode_quantum`) are torch.profiler.record_function
ranges opened from the benchmark's files; outside a traced run they are
no-ops. The device is traced over the window's last seconds
(torch.profiler, CPU and CUDA activity), between two synchronisations, so
that every kernel in the trace belongs to work issued inside the slice.
The profiler records every host op, which lengthens the host's side: the
idle share it reads is an upper bound.

From the Chrome trace (written under TMPDIR, read, deleted): the union of
device-activity intervals (kernels, copies, sets), the device time by
kernel name, and the idle gaps between busy intervals, each labelled by
the innermost host span open at its midpoint (inside `step` but outside
its children: `emit`, the batcher's own bookkeeping and token emission).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CHILD_SPANS = ("admission", "decode_quantum")


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.t0 = self.t1 = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def warm(self, fn) -> None:
        """Pays the profiler's first start (CUPTI) in set-up, over `fn`."""
        import torch

        with self._profile():
            fn()
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof = self._profile()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        """busy_s, window_s, kernels {name: device s}, gaps {label: idle s}."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None
        return reduce_events(events, self.t1 - self.t0)


def _merge(iv):
    iv.sort()
    out = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events, window_s: float) -> dict:
    """The trace's device busy time, kernel times and labelled idle gaps
    (times in seconds; Chrome trace times are microseconds)."""
    busy_iv, kernels, spans = [], {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            a, d = float(e["ts"]), float(e.get("dur", 0.0))
            busy_iv.append([a, a + d])
            kernels[e["name"]] = kernels.get(e["name"], 0.0) + d * 1e-6
        elif cat == "user_annotation":
            a = float(e["ts"])
            spans.setdefault(e["name"], []).append((a, a + float(e.get("dur", 0.0))))
    merged = _merge(busy_iv)
    busy = sum(b - a for a, b in merged) * 1e-6
    index = {k: (sorted(v), [s for s, _ in sorted(v)]) for k, v in spans.items()}

    def inside(name, t):
        if name not in index:
            return False
        iv, starts = index[name]
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and iv[i][0] <= t <= iv[i][1]

    def label(t):
        for name in CHILD_SPANS:
            if inside(name, t):
                return name
        if inside("step", t):
            return "emit"
        if inside("arrivals", t):
            return "arrivals"
        return "other"

    gaps = {}
    for (_, b), (c, _) in zip(merged[:-1], merged[1:]):
        lab = label(0.5 * (b + c))
        gaps[lab] = gaps.get(lab, 0.0) + (c - b) * 1e-6
    return dict(busy_s=busy, window_s=window_s, kernels=kernels, gaps=gaps)
