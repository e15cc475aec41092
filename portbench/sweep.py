"""Finds an open-loop cell's knee: the highest offered rate at which the
batcher's waiting queue does not grow across the window.

    python3 portbench/sweep.py --workload mistral7b_int4.chat --rates 3,4,5,6 \\
        --seconds 20 --seed 1 [--out FILE]

One process, one set-up (weights, system, warm-up); then for each rate the
cell's traffic at that rate (its own lead-in, then the window), after which
every request still queued or running is cancelled and the batcher drained.
Each rate's line: requests due and finished in the window, the waiting
queue's slope over the window (requests/s, a least-squares fit over the
steps) and its mean over the window's last quarter, ttft and tpot p95,
output tokens/s and decode ms a step. The knee goes into the workload file
as a number, by hand: `rate_per_s` is 0.8 of it.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness, readers  # noqa: E402
from portbench.trace import Tracer  # noqa: E402


def one_rate(system, workload, cfg, rate, seed, seconds):
    params = dict(workload["traffic"], rate_per_s=rate)
    traffic = harness.module("traffic", params["kind"]).Traffic(params, seed,
                                                                cfg["vocab_size"], seconds)
    t0 = time.perf_counter()
    w0, w1 = t0 + traffic.lead_in, t0 + traffic.lead_in + seconds
    rec = harness.serve(system, traffic, Tracer(False), t0, w0, w1, None)
    r = SimpleNamespace(cfg=cfg, seconds=seconds, w0=w0, w1=w1,
                        requests=list(rec.requests.values()), steps=rec.steps)
    st = [s for s in rec.steps if w0 <= s["t0"] < w1]
    ts = np.array([s["t0"] - w0 for s in st])
    q = np.array([s["waiting"] for s in st], dtype=float)
    slope = float(np.polyfit(ts, q, 1)[0]) if len(st) > 2 else float("nan")
    tail = float(q[ts >= 0.75 * seconds].mean()) if len(st) else float("nan")
    done = [x for x in r.requests if x["finish"] is not None and w0 <= x["finish"] <= w1]
    row = dict(rate=rate, due=len(readers.due_in_window(r)), finished=len(done),
               queue_slope=slope, queue_tail=tail, ttft_p95_s=readers.ttft_s(r),
               tpot_p95_ms=readers.tpot_ms(r),
               out_tok_s=sum(s["tokens"] for s in st) / seconds,
               decode_step_ms=readers.decode_step_ms(r), rows=readers.rows_per_step(r))
    b = system.batcher
    for x in rec.requests.values():
        if x["finish"] is None:
            b.cancel(x["id"])
    while b.has_work:
        b.step()
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out")
    args = ap.parse_args()
    workload, cfg = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    with torch.inference_mode():
        system = harness.module("systems", cfg["system"]).System(
            cfg, workload, harness.make_weights(cfg, args.seed, "cuda"), args.seed, "cuda",
            Tracer(False).span)
        harness.warm(system, workload, cfg, args.seed)
        for rate in (float(x) for x in args.rates.split(",")):
            row = one_rate(system, workload, cfg, rate, args.seed, args.seconds)
            rows.append(row)
            print("[sweep] " + json.dumps(row), flush=True)
    card = torch.cuda.get_device_name(0)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(workload=args.workload, card=card,
                                                  seconds=args.seconds, rows=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
