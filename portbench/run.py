"""Runs one cell of the port's benchmark on the card and prints its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, portbench/ and the
program (tinygpt_tpu_torch/). The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer ones), device, [breakdown], checks. The
numbers compared with the reference, each with its limit, are also the last
lines of standard error.

Exits 2, printing no result, without a CUDA card (or with fewer than the
cell asks for), 3 if the process holds JAX or the JAX package once the
window has closed, and 1 on any other failure (such as a checkout without
the program).
"""

import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the port builds its kernel libraries under tinygpt_tpu_torch/_build/,
# inside the checkout
os.environ.setdefault("OMP_NUM_THREADS", "4")
os.environ.setdefault("TINYGPT_LOG_LEVEL", "WARNING")
sys.path.insert(0, str(ROOT))


def power_limit() -> str:
    """nvidia-smi's name and power limit of the card, or "not read"."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    workload, cfg = harness.load_cell(args.workload)
    import torch

    need = int(workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: {args.workload} needs {need} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    with torch.inference_mode():
        result = harness.run(workload, cfg, args.seed, args.seconds, bool(args.trace),
                             device="cuda", t_process0=T_PROCESS0,
                             metrics=harness.metrics_for(bench, args.workload,
                                                         bool(args.trace)))
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"portbench: the process holds {', '.join(leaked)}: the port must not "
              f"load JAX or the JAX package", file=sys.stderr)
        return 3
    result["device"]["card"] = power_limit()
    result.pop("numbers")
    checks = result.pop("checks")
    result["checks"] = checks  # the compared numbers come last
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
