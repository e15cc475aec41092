#!/usr/bin/env python3
"""Knock-out builds of K10's tensor-core split (csrc/paged_decode_spec.cu):
each variant cuts one part of the kernel out, and all are timed at the
spec serve shape (chip_smoke.py's main path case, 32 layers walked, CUDA
events around a graph of calls) at clusters of 1, 2 and 3 blocks.

    python3 tools/spec_knockouts.py [BUILD_DIR]

Variants (switches compiled into a copy of the source in BUILD_DIR): the
products and softmax (no_math), the merges after the loop (no_merge: every
accumulator is summed into one value so that the products stay), both,
the per-tile reload of q's fragments (no_q_ldsm: the K fragments reused),
and a block of one m-tile of 16 rows (one_mtile). Needs nvcc and a card."""

import collections
import ctypes
import os
import subprocess
import sys

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tinygpt_tpu_torch.ops import cuda_build  # noqa: E402
from tinygpt_tpu_torch.ops import paged_attention as pa  # noqa: E402
from tinygpt_tpu_torch.ops.attention_kernels import _DTYPE_CODE, _ptr  # noqa: E402

out_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(str(cuda_build.BUILD_DIR), "ko")
os.makedirs(out_dir, exist_ok=True)
src = (cuda_build.CSRC_DIR / "paged_decode_spec.cu").read_text()
src = src.replace("  auto compute = [&](int v, int st) {\n",
                  "  auto compute = [&](int v, int st) {\n#ifdef KO_MATH\n    return;\n#endif\n")
src = src.replace("  auto issue = [&](int v, int st) {\n",
                  "  auto issue = [&](int v, int st) {\n#ifdef KO_STREAM\n    return;\n#endif\n")
src = src.replace(
    "  tg::cp_wait<0>();\n  __syncthreads();  // the ring's memory is free now\n",
    "  tg::cp_wait<0>();\n#ifdef KO_MERGE\n  float sum_ = l[0][0] + m[0][0];\n"
    "  for (int mt_ = 0; mt_ < MT; ++mt_) for (int n_ = 0; n_ < ND; ++n_)"
    " for (int e_ = 0; e_ < 4; ++e_) sum_ += acc[mt_][n_][e_];\n"
    "  static_cast<T*>(a.out)[(size_t)blockIdx.x * kThreads + tid] = tg::from_float<T>(sum_);\n"
    "  return;\n#endif\n  __syncthreads();  // the ring's memory is free now\n")
qld = ("        ldsm4(qa, qs + swz<ROWB>(mt * 16 + ((lane >> 3) & 1) * 8 + (lane & 7),\n"
       "                                 ks * 2 + (lane >> 4)));\n")
assert qld in src
src = src.replace(qld, "#ifdef KO_QLD\n        qa[0] = kb[0] ^ mt; qa[1] = kb[1]; qa[2] = kb[2];"
                  " qa[3] = kb[3];\n#else\n" + qld + "#endif\n")
a = src.index("  auto compute = [&](int v, int st) {")
b = src.index("  // the share's tiles in turn")
src = (src[:a] + "#ifdef KO_MT1\n  constexpr int MTC = 1;\n#else\n  constexpr int MTC = MT;\n#endif\n"
       + src[a:b].replace("mt < MT;", "mt < MTC;") + src[b:])
assert src.count("#ifdef KO_") == 5, src.count("#ifdef KO_")
path = os.path.join(out_dir, "paged_decode_spec.cu")
open(path, "w").write(src)
variants = {"base": [], "no_math": ["-DKO_MATH"], "no_merge": ["-DKO_MERGE"],
            "no_math_merge": ["-DKO_MATH", "-DKO_MERGE"], "no_q_ldsm": ["-DKO_QLD"],
            "one_mtile": ["-DKO_MT1"], "one_mtile_no_q": ["-DKO_MT1", "-DKO_QLD"]}
nvcc = cuda_build.nvcc_path()
procs = {v: subprocess.Popen([nvcc, *cuda_build.NVCC_FLAGS, *flags, "-I", str(cuda_build.CSRC_DIR),
                              "-o", os.path.join(out_dir, f"{v}.so"), path],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
         for v, flags in variants.items()}
for v, p in procs.items():
    log, _ = p.communicate()
    assert p.returncode == 0, log[-3000:]
cs.E4M3 = torch.float8_e4m3fn
L = 32
lens = [0 if b in (3, 9) else n for b, n in enumerate(cs.SPEC_LENGTHS)]
args, base, _, _ = cs._spec_kernel_case(L, 32, 8, 128, lens, {3: 0, 9: 0}, torch.bfloat16,
                                        False, 0, seed=300)
q, kp, vp, tables, lens_t, starts, ki, vi, valid = args
B, S, Nq, D = q.shape
out = torch.empty_like(q)
null = ctypes.c_void_p(None)
res = collections.defaultdict(dict)
for v in variants:
    fn = ctypes.CDLL(os.path.join(out_dir, f"{v}.so")).tg_paged_decode_spec
    fn.argtypes = pa._SPEC_ARGS
    fn.restype = ctypes.c_int
    for C in (1, 2, 3):
        def call(layer, C=C):
            err = fn(_ptr(q), _ptr(kp), _ptr(vp), _ptr(tables), _ptr(lens_t), _ptr(starts),
                     _ptr(ki), _ptr(vi), _ptr(valid), null, null, _ptr(out), B, S, Nq, 8,
                     kp.shape[1], 64, 16, ki.shape[2], D, _DTYPE_CODE[q.dtype],
                     _DTYPE_CODE[q.dtype], layer, base, D ** -0.5, 0, C,
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            assert err == 0, err
        res[v][C] = cs.events_ms(call, L)
    print(v, {c: round(t, 4) for c, t in res[v].items()}, "ms", flush=True)
