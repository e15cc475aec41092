"""Profiling: device traces and fenced wall timing.

Counterpart of tinygpt_tpu/utils/profiler.py, on torch.profiler. `trace`
records the host's operators and, when a card is present, its kernels,
copies and runtime calls, and writes them as one Chrome trace (JSON, which
Perfetto and chrome://tracing open); `annotation` marks a named span in
it. `device_fence` gives trustworthy wall timing: it copies what a
computation produced to the host, which waits for the computation.

What the trace says of one kernel is not always its time: torch.profiler
has read single calls of the port's cluster kernels 20 % to 30 % low on
the H100 (PERF.md). Time such calls with CUDA events around many of them.
"""

from __future__ import annotations

import itertools
import os
import tempfile
import time
from contextlib import contextmanager
from typing import Any, Optional

import numpy as np
import torch

from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("profiler")

_SEQ = itertools.count()


@contextmanager
def trace(log_dir: Optional[str] = None, annotate: Optional[str] = None):
    """Capture a trace of the block into a Chrome trace file under
    `log_dir` (default: tinygpt_trace in the temporary directory), inside
    a span named `annotate` when given. Yields a dict whose "path" is the
    file's, once the block has ended.

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
        if annotate:
            with torch.profiler.record_function(annotate):
                yield info
        else:
            yield info
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{next(_SEQ)}.json")
    prof.export_chrome_trace(path)
    info["path"] = path
    log.info("trace written to %s", path)


def annotation(name: str):
    """Named span inside an active trace (host side)."""
    return torch.profiler.record_function(name)


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
