"""Readings from which a cell's `check.limits` are set: the program as the
cell runs it (sound runs) and the control, on seeds of their own, in one
process.

    python3 portbench/control.py --workload mistral7b_int4.chat \\
        --sound 101,102,... --control 201,202,203 --seconds 10 [--out FILE]

Two controls, the nearest precision below the bf16 that the configurations
state: the program with its own lower-precision path switched on, the KV
pool in fp8 (e4m3) (`--control` seeds, runs of their own); and the
reference in fp8 activations (reference/mistral.py, `act_fp8`), read at
each position of every sound run's own prompts and served tokens (the
token it puts first, judged by the fp32 reference, and by the cell's
limits through check.judge as a run is judged). Each run is
the harness's whole run at the cell's size and load (with a shorter
window, long enough to finish the mix's longest requests), compared with
the reference exactly as a benchmark run compares; the line printed for it
holds every number read. A limit lies above the largest sound reading and
below the smallest control reading (PERF.md). The benchmark's own runs do
not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def readings(cell, seeds, seconds, kv):
    workload, cfg = harness.load_cell(cell)
    out = []
    for seed in seeds:
        with torch.inference_mode():
            r = harness.run(workload, cfg, seed, seconds, False, device="cuda", metrics=[],
                            t_process0=time.perf_counter(), kv_cache_dtype=kv,
                            control_act=kv is None)
        row = dict(seed=seed, kv=kv or "bf16", correct=r["correct"], **r["numbers"])
        if "control_numbers" in r:
            row["act_fp8"] = dict(r["control_numbers"], correct=r["control_correct"])
        print("[control] " + json.dumps(row), flush=True)
        out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--sound", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    rows = (readings(args.workload, seeds(args.sound), args.seconds, None)
            + readings(args.workload, seeds(args.control), args.seconds, "fp8"))
    for kv in ("bf16", "fp8"):
        rs = [r for r in rows if r["kv"] == kv and "max_gap" in r]
        if rs:
            print(f"[control] {kv}: max_gap {min(r['max_gap'] for r in rs):.4g} .. "
                  f"{max(r['max_gap'] for r in rs):.4g}, mean_gap "
                  f"{min(r['mean_gap'] for r in rs):.4g} .. "
                  f"{max(r['mean_gap'] for r in rs):.4g} over {len(rs)} seeds, "
                  f"{sum(r['correct'] for r in rs)} correct", flush=True)
    act = [r["act_fp8"] for r in rows if r.get("act_fp8")]
    if act:
        print(f"[control] fp8 activations: max_gap {min(a['max_gap'] for a in act):.4g} .. "
              f"{max(a['max_gap'] for a in act):.4g}, mean_gap "
              f"{min(a['mean_gap'] for a in act):.4g} .. {max(a['mean_gap'] for a in act):.4g} "
              f"over {len(act)} seeds, {sum(a['correct'] for a in act)} correct", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(workload=args.workload, rows=rows,
                                                  card=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
