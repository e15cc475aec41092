"""Builds the package's host-side C++ cores with g++ and loads them with ctypes.

Two sources under ``tinygpt_tpu_torch/csrc/`` run on the host, not on the
card: ``kvpool.cpp`` (the KV-pool index of the continuous batcher,
``engine/native_pool.py``) and ``tokenizer.cpp`` (the byte-level BPE
encoder, ``tokenizer/native.py``). Each becomes one shared library with a
plain C interface, compiled with ``$CXX`` (default ``g++``) at first use
and cached under ``tinygpt_tpu_torch/_build/`` (listed in ``.gitignore``),
beside the CUDA libraries of ``ops/cuda_build.py``. The library's file name
carries a hash of its sources and flags, so an edited source is rebuilt
and a stale library is never loaded. Several processes may build one
library at once (the test runner's workers do): each compiles to a name of
its own and moves the result into place with ``os.replace``, so a reader
never sees a half-written file.

Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

from tinygpt_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR
from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("ops.host_build")

# source -> the files it includes besides the C++ standard library
SOURCES = {
    "kvpool.cpp": (),
    "tokenizer.cpp": ("unicode_tables.inc",),
}
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_LOCK = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def native_disabled() -> bool:
    """TINYGPT_NO_NATIVE (any non-empty value) keeps the host cores off:
    the pool index and the tokenizer then run their Python versions."""
    return bool(os.environ.get("TINYGPT_NO_NATIVE"))


def compiler() -> Optional[str]:
    """The C++ compiler ($CXX, else g++) when it is on PATH, else None."""
    return shutil.which(os.environ.get("CXX", "g++"))


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for name in (source,) + SOURCES[source]:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}-{_digest(source)}.so"


def build(source: str) -> float:
    """Compiles `source` unless its library exists. Returns the seconds
    spent (0.0 when it existed). Raises RuntimeError when there is no
    compiler or the build fails, with the compiler's messages."""
    out = library_path(source)
    if out.exists():
        return 0.0
    cxx = compiler()
    if cxx is None:
        raise RuntimeError(
            f"no C++ compiler ({os.environ.get('CXX', 'g++')}) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)],
            capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{source}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed on {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_all() -> Dict[str, float]:
    """Compiles every host source whose library is missing. Returns
    {source: seconds} for the sources built now."""
    return {s: build(s) for s in SOURCES if not library_path(s).exists()}


def load(source: str) -> Optional[ctypes.CDLL]:
    """The library built from `source` (built first if missing), or None,
    with a warning, when it cannot be built or loaded."""
    with _LOCK:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        try:
            build(source)
            lib = ctypes.CDLL(str(library_path(source)))
        except (RuntimeError, OSError) as e:
            log.warning("host library %s unavailable: %s", source, e)
            return None
        _libs[source] = lib
        return lib
