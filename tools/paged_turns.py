#!/usr/bin/env python3
"""One turn of a comparison of two trees of the port on one card: this
tree's chip_smoke.py phases run over the package of the tree at ROOT.

    python3 tools/paged_turns.py ROOT LABEL

Run parent, change, change, parent (a process a turn, both trees on the
same card, one after another) and compare the printed lines. A turn runs the
paged phase (K8, K9 and the wide groups), the spec_kernels phase (K10),
K8's outputs at the serve shape as a digest of their bytes (equal digests:
bitwise-equal outputs), the gpt2_serve phase (frozen and stepwise quanta),
the spec_serve phase on the Mistral-7B shape in int4 and the mixtral_serve
phase on Mixtral-8x7B in int4. A LABEL starting with "parent" marks a
package whose K9 and K10 entry points take no split argument: the split
sweeps are left out there."""

import collections
import hashlib
import importlib.util
import os
import sys
import time

root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
sys.path.insert(0, root)
here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)

import torch  # noqa: E402

import tinygpt_tpu_torch  # noqa: E402

assert tinygpt_tpu_torch.__file__.startswith(root), tinygpt_tpu_torch.__file__
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.E4M3 = torch.float8_e4m3fn
if label.startswith("parent"):
    cs.split_sweep = lambda *a, **k: None
    cs._k9_entry = lambda *a, **k: (None, 1, ())
    cs._k10_sweep = lambda *a, **k: None
print(f"== turn {label} over {tinygpt_tpu_torch.__file__}", flush=True)

from tinygpt_tpu_torch.engine.kv_cache import kv_cast  # noqa: E402
from tinygpt_tpu_torch.hf.config import parse_model_config  # noqa: E402
from tinygpt_tpu_torch.models import causal_lm, gpt2  # noqa: E402
from tinygpt_tpu_torch.ops import paged_attention as pa  # noqa: E402
from tinygpt_tpu_torch.ops.quant import quantize_params  # noqa: E402

table = collections.defaultdict(dict)
sec = {}
t = time.perf_counter()
cs.phase_paged_kernels(table)
sec["paged"] = time.perf_counter() - t
t = time.perf_counter()
cs.phase_spec_kernels(table)
sec["spec_kernels"] = time.perf_counter() - t
# K8's outputs, bitwise: the serve shape at steps 0 and 7, layers 0 and 31,
# bf16 and e4m3 pools, with and without a window
h = hashlib.sha256()
q, kp, vp, tables, lens, starts, ki, vi = cs._paged_case(32, 32, 8, 128, cs.PAGED_LENGTHS, {},
                                                         torch.bfloat16, seed=200)
for pools in ((kp, vp), (kv_cast(kp, cs.E4M3), kv_cast(vp, cs.E4M3))):
    for step in (0, 7):
        for layer in (0, 31):
            for w in (None, 300):
                o = pa.paged_decode_frozen(q, *pools, tables, lens, starts, ki, vi, layer, step,
                                           128 ** -0.5, w)
                h.update(o.view(torch.int16).cpu().numpy().tobytes())
print(f"[k8-digest] {label} {h.hexdigest()}", flush=True)
del q, kp, vp, ki, vi, pools
torch.cuda.empty_cache()
t = time.perf_counter()
gp = gpt2.init_params(parse_model_config(cs.GPT2_124M), seed=0, dtype=torch.bfloat16,
                      device="cuda")
cs.phase_gpt2_serve(table, gp)
del gp
torch.cuda.empty_cache()
sec["gpt2_serve"] = time.perf_counter() - t
t = time.perf_counter()
p4 = causal_lm.init_params(parse_model_config(cs.MISTRAL_7B), seed=0, dtype=torch.bfloat16,
                           device="cuda")
p4 = quantize_params(p4, bits=4, group_size=cs.INT4_GROUP)
torch.cuda.empty_cache()
cs.phase_spec_serve(table, p4)
del p4
torch.cuda.empty_cache()
sec["spec_serve"] = time.perf_counter() - t
t = time.perf_counter()
cfg = parse_model_config(dict(cs.MIXTRAL_8X7B, num_hidden_layers=cs.MIXTRAL_LAYERS[4]))
mp = cs._mixtral_params(cfg, 4, seed=0)
cs.phase_mixtral_serve(table, mp)
del mp
torch.cuda.empty_cache()
sec["mixtral_serve"] = time.perf_counter() - t
for k in ("paged_decode", "paged_decode_spec", "paged_decode_frozen"):
    print(f"[table] {label} {k} {dict(table[k])}", flush=True)
print(f"[seconds] {label} " + " ".join(f"{k} {v:.1f}" for k, v in sec.items()), flush=True)
