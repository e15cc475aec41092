#!/usr/bin/env python3
"""K8's machine code in two trees of the port, compared instruction by
instruction.

    python3 tools/paged_sass.py PARENT_ROOT [BUILD_DIR]

Builds PARENT_ROOT's and this tree's csrc/paged_decode_frozen.cu with
cuda_build.NVCC_FLAGS (into BUILD_DIR, default the package's _build/),
disassembles both with cuobjdump -sass, and matches K8's instantiations by
their template arguments (paged_decode_frozen_kernel<T, C, D, GT> or
paged_split_kernel<T, C, D, GT, true>; the anonymous namespace's name
differs between the builds and is left out). Needs nvcc and cuobjdump."""

import os
import re
import subprocess
import sys

here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, here)
from tinygpt_tpu_torch.ops import cuda_build  # noqa: E402

parent = os.path.abspath(sys.argv[1])
out_dir = sys.argv[2] if len(sys.argv) > 2 else str(cuda_build.BUILD_DIR)
os.makedirs(out_dir, exist_ok=True)
nvcc = cuda_build.nvcc_path()
cuobj = os.path.join(os.path.dirname(nvcc), "cuobjdump")
procs = {}
for name, root in (("parent", parent), ("change", here)):
    procs[name] = subprocess.Popen(
        [nvcc, *cuda_build.NVCC_FLAGS, "-o", os.path.join(out_dir, f"sass_{name}.so"),
         os.path.join(root, "tinygpt_tpu_torch", "csrc", "paged_decode_frozen.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
funcs = {}
for name, p in procs.items():
    log, _ = p.communicate()
    assert p.returncode == 0, log[-3000:]
    sass = subprocess.run([cuobj, "-sass", os.path.join(out_dir, f"sass_{name}.so")],
                          capture_output=True, text=True).stdout
    cur, code = None, {}
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            code[cur] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if cur and m:
            code[cur].append(m.group(1))
    dem = subprocess.run(["c++filt"], input="\n".join(code), capture_output=True,
                         text=True).stdout.splitlines()
    keyed = {}
    for mangled, d in zip(code, dem):
        d = d.replace("(anonymous namespace)::", "").replace("tg::", "").split("(")[0]
        m = re.search(r"(paged_decode_frozen_kernel|paged_split_kernel)<(.*)>$", d)
        if not m:
            continue
        args = [x.strip() for x in m.group(2).split(",")]
        if m.group(1) == "paged_split_kernel":
            if args[-1] != "true":
                continue
            args = args[:-1]
        keyed[", ".join(args)] = code[mangled]
    funcs[name] = keyed
same = [k for k in funcs["change"] if funcs["parent"].get(k) == funcs["change"][k]]
print(f"K8 instantiations: parent {len(funcs['parent'])}, this tree {len(funcs['change'])}; "
      f"identical instruction for instruction: {len(same)}")
for k in sorted(funcs["change"]):
    a, b = funcs["parent"].get(k), funcs["change"][k]
    if a != b:
        print("  DIFFERENT", k, len(b), None if a is None else len(a))
