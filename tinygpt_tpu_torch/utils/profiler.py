"""Profiling: program spans, device traces and fenced wall timing.

Counterpart of tinygpt_tpu/utils/profiler.py, on torch.profiler. `span`
marks a named stretch of the host's work (an admission, a decode
quantum's issue or read-back): off by default, when it returns one shared
null context and does nothing else; on (`set_spans(True)`, or inside
`trace`), it opens a torch.profiler.record_function range, which lands in
any running trace as a `user_annotation` on the kernels' clock, and
appends a `SpanRecord` (perf_counter_ns times, the enclosing span, its
attributes) to a bounded buffer that `take_spans` empties. `trace`
records the host's operators and, when a card is present, its kernels,
copies and runtime calls, and writes them as one Chrome trace (JSON, which
Perfetto and chrome://tracing open). `device_fence` gives trustworthy wall
timing: it copies what a computation produced to the host, which waits for
the computation.

What the trace says of one kernel is not always its time: torch.profiler
has read single calls of the port's cluster kernels 20 % to 30 % low on
the H100 (PERF.md). Time such calls with CUDA events around many of them.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Any, List, NamedTuple, Optional

import numpy as np
import torch

from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("profiler")

_SEQ = itertools.count()

SPAN_BUFFER = 1 << 20  # records kept; the oldest go first


class SpanRecord(NamedTuple):
    """One closed span. `id` numbers spans in the order they opened;
    `parent` is the id of the span open around it on the same thread
    (-1 at the top); times are time.perf_counter_ns()."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int
    attrs: dict


_spans_on = False
_NULL = contextlib.nullcontext()
_records: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_dropped = 0
_ids = itertools.count()
_local = threading.local()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start", "rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1].id if stack else -1
        self.id = next(_ids)
        stack.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _local.stack.pop()
        global _dropped
        if len(_records) == SPAN_BUFFER:
            _dropped += 1
        _records.append(SpanRecord(self.id, self.name, self.start, end, self.parent,
                                   self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager around a named stretch of the host's work. Off
    (the default), the one shared null context; on, a record_function
    range and a SpanRecord with `attrs` (see the module docstring)."""
    if not _spans_on:
        return _NULL
    return _Span(name, attrs)


def note(**attrs) -> None:
    """Adds `attrs` to the innermost span open on this thread, for values
    known only inside it; nothing when spans are off or none is open."""
    if _spans_on:
        stack = getattr(_local, "stack", None)
        if stack:
            stack[-1].attrs.update(attrs)


def set_spans(on: bool) -> bool:
    """Turns spans on or off for every thread; returns the previous
    setting."""
    global _spans_on
    prev, _spans_on = _spans_on, bool(on)
    return prev


def take_spans() -> tuple[List[SpanRecord], int]:
    """(the closed spans recorded since the last call, oldest first by
    end time; how many older ones the full buffer dropped), and empties
    the buffer."""
    global _dropped
    out, n = [], _dropped
    while _records:
        out.append(_records.popleft())
    _dropped = 0
    return out, n


@contextmanager
def trace(log_dir: Optional[str] = None, annotate: Optional[str] = None):
    """Capture a trace of the block into a Chrome trace file under
    `log_dir` (default: tinygpt_trace in the temporary directory), inside
    a span named `annotate` when given. Spans are on for the block, so the
    program's spans are in the file (and in the buffer). Yields a dict
    whose "path" is the file's, once the block has ended.

    with profiler.trace("traces", annotate="generate") as t:
        engine.generate_sync(prompts)
    print(t["path"])
    """
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "tinygpt_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    info: dict = {}
    with torch.profiler.profile(activities=activities) as prof:
        prev = set_spans(True)
        try:
            with span(annotate) if annotate else _NULL:
                yield info
        finally:
            set_spans(prev)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_SEQ)}.json")
    prof.export_chrome_trace(path)
    info["path"] = path
    log.info("trace written to %s", path)


def _to_numpy(x: Any) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach()
    if x.dtype in (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2):
        x = x.float()  # numpy has none of these: widened exactly to fp32
    return x.cpu().numpy()


def device_fence(x: Any) -> Any:
    """Copy everything in `x` (a tensor, or dicts, lists and tuples of
    them; None stays None) to host numpy arrays, which waits for the
    computations that produce them, and return the copies in the same
    structure. numpy has no bfloat16 or float8: such tensors come back as
    float32 arrays of the same values."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: device_fence(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        items = [device_fence(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else type(x)(items)
    return _to_numpy(x)


@contextmanager
def timed_fenced(result_holder: dict, key: str = "seconds"):
    """Time a block whose last device output the caller stores in
    result_holder['value']; the fence is applied before the clock stops."""
    t0 = time.perf_counter()
    yield result_holder
    if "value" in result_holder:
        result_holder["value"] = device_fence(result_holder["value"])
    result_holder[key] = time.perf_counter() - t0
