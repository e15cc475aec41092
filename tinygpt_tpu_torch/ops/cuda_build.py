"""Builds the package's CUDA kernels with nvcc and loads them with ctypes.

Each source under ``tinygpt_tpu_torch/csrc/`` becomes one shared library
with a plain C interface, compiled for Hopper (``sm_90a``) at first use and
cached under ``tinygpt_tpu_torch/_build/`` (listed in ``.gitignore``). The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale library is never loaded. All missing
libraries are built together, one nvcc process per source.

Nothing here runs at import: the CPU tests import the package on machines
without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

SOURCES = ("flash_prefill.cu", "flash_decode_frozen.cu", "flash_decode.cu",
           "int4_matmul.cu", "int4_fused.cu", "int4_mlp.cu", "paged_decode_frozen.cu",
           "int8_matmul.cu", "paged_decode_spec.cu", "paged_decode.cu",
           "moe_gather_matmul.cu")
HEADERS = ("attention_common.cuh", "decode_split.cuh", "int4_common.cuh",
           "hopper_common.cuh", "dequant_mm_tc.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _digest(source: str) -> str:
    h = hashlib.sha256()
    for name in (source,) + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def build_all() -> Dict[str, float]:
    """Compiles every source whose library is missing, all at once.
    Returns {source: seconds} for the sources built now; nvcc's output,
    with ptxas' register and spill counts, is kept beside each library as
    a .log file. Raises with nvcc's messages when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in SOURCES if not library_path(s).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for src in todo:
        out = library_path(src)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    seconds, failed = {}, []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return seconds


def build_log(source: str) -> str:
    """nvcc's output from the build of `source` (ptxas' -v report)."""
    p = library_path(source).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def function(source: str, name: str, argtypes: list):
    """C function `name` of the library built from `source` (built first
    if missing), declared with `argtypes` and an int (cudaError_t) result."""
    lib = _libs.get(source)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(library_path(source)))
        lib.tg_error_string.argtypes = [ctypes.c_int]
        lib.tg_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(source: str, err: int, what: str) -> None:
    """Raises when a launcher of `source`'s library returned a CUDA error."""
    if err != 0:
        msg = _libs[source].tg_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
