"""Batch-inference CLI of the PyTorch/CUDA port.

    python -m tinygpt_tpu_torch.cli --model DIR [--prompt TEXT ...]

Counterpart of tinygpt_tpu/cli.py: --model/--dtype/--max-tokens and the
sampler flags, a fixed prompt batch (overridable with --prompt), and
token/s timing. Runs on the CUDA device unless --device says otherwise.
Weight-only quantization: `--quantization int8`, or `--quantization int4`
with AWQ by default (`--awq-calib FILE` to calibrate on your own text,
`--no-awq` for plain round-to-nearest). `--speculative ngram` decodes a
single prompt by n-gram speculation (a batch of prompts takes the chunked
loop). `--stream` streams the first prompt through
GPTEngine.generate_async, printing text as it arrives.

`--mesh DP,SP,TP` or `DP,SP,PP,TP` runs the engine sharded, one process a
rank, each joining the process group from the torch env first
(parallel.distributed.initialize):

    torchrun --nproc-per-node N -m tinygpt_tpu_torch.cli --model DIR --mesh 1,1,N

one rank a card over NCCL (`--dist-backend gloo` for ranks that share a
card or run on the CPU). Rank 0 prints the results.
"""

from __future__ import annotations

import argparse
import sys
import time

from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
from tinygpt_tpu_torch.ops.sampling import SamplerConfig
from tinygpt_tpu_torch.parallel import distributed

DEFAULT_PROMPTS = [
    "The meaning of life is",
    "Once upon a time,",
    "In a shocking finding, scientists discovered",
    "The best way to learn programming is",
]



def parse_mesh(text):
    """"DP,SP,TP" or "DP,SP,PP,TP" -> a tuple of ints (None: no mesh)."""
    if not text:
        return None
    shape = tuple(int(x) for x in text.split(","))
    if len(shape) not in (3, 4):
        raise ValueError(f"--mesh {text!r}: want DP,SP,TP or DP,SP,PP,TP")
    return shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tinygpt_tpu_torch", description="batch inference example"
    )
    ap.add_argument("--model", required=True, help="HF model directory")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "float16", "bfloat16",
                             "fp32", "fp16", "bf16"])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--max-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--min-p", type=float, default=None)
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt", action="append", default=None,
                    help="prompt (repeatable); default: 4 fixed prompts")
    ap.add_argument("--stream", action="store_true",
                    help="stream the first prompt's text as it is generated")
    ap.add_argument("--quantization", default=None, choices=["int8", "int4"],
                    help="weight-only quantization")
    ap.add_argument("--quant-group-size", type=int, default=None,
                    help="default: 64 for int4, 128 for int8")
    ap.add_argument("--awq", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="AWQ activation-aware scaling before "
                         "quantization (default: on for int4; "
                         "--no-awq forces plain RTN)")
    ap.add_argument("--awq-calib", default=None, metavar="TEXT_FILE",
                    help="calibration text for --awq (default: built-in)")
    ap.add_argument("--mesh", default=None, metavar="DP,SP,TP",
                    help="device mesh (DP,SP,TP or DP,SP,PP,TP), one process "
                         "a rank (torchrun)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend under --mesh (default: nccl "
                         "on a CUDA device, gloo on the CPU)")
    ap.add_argument("--speculative", default=None, choices=["ngram"],
                    help="speculative decoding (one prompt; greedy exact, "
                         "sampled via exact rejection sampling)")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh)
    if mesh is not None:
        # join the process group of the torch env (torchrun's); a no-op
        # without one, and then the engine refuses a mesh of several ranks
        distributed.initialize(backend=args.dist_backend, device=args.device)
    lead = distributed.world()[0] == 0

    engine = GPTEngine(GPTConfig(
        model_dir=args.model,
        dtype=args.dtype,
        max_tokens=args.max_tokens,
        sampler=SamplerConfig(
            temperature=args.temperature, top_p=args.top_p,
            min_p=args.min_p, top_k=args.top_k,
        ),
        seed=args.seed,
        device=args.device,
        quantization=args.quantization,
        quant_group_size=args.quant_group_size,
        awq=args.awq,
        awq_calib_path=args.awq_calib,
        speculative=args.speculative,
        mesh_shape=mesh,
    ))
    t0 = time.perf_counter()
    engine.prepare()
    print(f"[load] {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    prompts = args.prompt or DEFAULT_PROMPTS

    if args.stream:
        if lead:
            print(f">>> {prompts[0]}", flush=True)
        t0 = time.perf_counter()
        out = engine.generate_async(
            prompts[0],
            lambda chunk, done: (lead and print(chunk, end="", flush=True), True)[1],
        )
        dt = time.perf_counter() - t0
        print(f"\n[{len(out.token_ids)} tokens, "
              f"{len(out.token_ids) / dt:.2f} token/s]", file=sys.stderr)
        return 0

    t0 = time.perf_counter()
    outs = engine.generate_sync(prompts)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(o.token_ids) for o in outs)
    for p, o in zip(prompts, outs):
        if lead:
            print(f">>> {p}\n{o.text}\n")
    print(
        f"[generate] {total_tokens} tokens in {dt * 1e3:.0f} ms "
        f"({total_tokens / dt:.2f} token/s)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
