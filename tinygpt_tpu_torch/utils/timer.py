"""Wall-clock timing helper (reference: TinyTorch Utils/Timer.h usage in
examples/inference/main.cpp:97-115)."""

from __future__ import annotations

import time
from contextlib import contextmanager


@contextmanager
def timed():
    """Yield a zero-arg callable returning elapsed seconds."""
    t0 = time.perf_counter()
    yield lambda: time.perf_counter() - t0
