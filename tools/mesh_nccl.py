"""The sharded engine path over NCCL on four cards, one rank a card.

    python3 tools/mesh_nccl.py [--ranks 4] [--layers 32] [--log FILE]

Builds the kernels once, then starts one process a rank on cuda:{rank}
with backend "nccl" (the default for a CUDA device) and runs, at the
Mistral-7B shape with random weights (seed 0):

  * int4 (group 64) and bf16 at tp = ranks, mesh (1, 1, ranks): rank 0 first
    runs the same params unsharded on its card (the single-rank reference);
    then every rank prefills chip_smoke.py's four prompts and decodes one
    chunk of 32 steps fed the reference's tokens: the logits of every
    position within chip_smoke.py's bf16 model tolerance, every rank's
    free-running tokens equal; prefill ms, decode ms a step and each rank's
    busy ms a step (torch.profiler) beside the single rank's;
  * int4 at dp = 2 x tp = ranks / 2 (2, 1, ranks / 2): each dp shard two of
    the four prompts; the same checks on its rows;
  * then the entry points as their users start them, on chip_smoke.py's
    2-layer model dir in fp32, over NCCL on cards 0 and 1:
    `torchrun --standalone --nproc-per-node 2 -m tinygpt_tpu_torch.cli
    --mesh 1,1,2` prints what one process prints, and `torchrun ... -m
    tinygpt_tpu_torch.server --mesh 1,1,2` answers two concurrent greedy
    completions (one streamed) with one process's texts, then stops on
    SIGTERM, every rank with it.

Every rank's lines go to FILE (default: mesh_nccl.log in the kernels'
build directory); the parent prints the summary lines, the card's name
and power limit, and exits non-zero if a rank failed or outlived the
timeout. Times on a card that shares nothing: the layouts'
scaling on NVLink (unlike chip_smoke.py's mesh phase, 2 ranks on one
card over gloo).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TIMEOUT_S = 900


def _leg(cs, rank, ranks, layers, bits, mesh_shape, label):
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops.quant import quantize_params
    from tinygpt_tpu_torch.parallel import distributed

    tag = f"[nccl] {label}"
    S = max(cs.PROMPT_LENS)
    T = S + cs.DECODE_CHUNK
    cfg = parse_model_config(dict(cs.MISTRAL_7B, num_hidden_layers=layers))
    params = causal_lm.init_params(cfg, seed=0, dtype=torch.bfloat16, device=cs.DEVICE)
    if bits:
        params = quantize_params(params, bits=bits, group_size=cs.INT4_GROUP)
    torch.cuda.empty_cache()
    batch = cs._left_padded_batch(S, cs.PROMPT_LENS, cfg.vocab_size, seed=1)
    B = len(cs.PROMPT_LENS)
    fed = torch.zeros((1 + cs.DECODE_CHUNK, B), dtype=torch.int32, device=cs.DEVICE)
    ref = None
    if rank == 0:
        cs._run_route(params, cfg, batch, T, "kernel", n_chunks=1)      # warm-up
        ref = cs._run_route(params, cfg, batch, T, "kernel", n_chunks=1)
        fed.copy_(ref[1])
        prof = cs._profile_decode(params, cfg, batch, T, label=f"{label} one rank", tag=tag)
        if prof:
            cs.log(f"{tag}: one rank busy {prof['busy_ms']:.3f} ms a step, wall "
                   f"{prof['wall_ms']:.3f} ms")
    world = torch.distributed.group.WORLD
    distributed.broadcast(fed, 0, world)
    eng = cs._mesh_engine(params, cfg, mesh_shape, dtype="bfloat16")
    del params
    torch.cuda.empty_cache()
    lp, lcfg = eng.ctx.params, eng._run_cfg
    dp = mesh_shape[0]
    d = eng._dp_index
    rows = slice(d * B // dp, (d + 1) * B // dp)
    mine = tuple(t[rows] for t in batch)
    cs._run_route(lp, lcfg, mine, T, "kernel", n_chunks=1, force=fed[:, rows])   # warm-up
    cs._mesh_reset()
    got = cs._run_route(lp, lcfg, mine, T, "kernel", n_chunks=1, force=fed[:, rows])
    launches = cs._mesh_launches()
    free = cs._run_route(lp, lcfg, mine, T, "kernel", n_chunks=1)
    cs.log(f"{tag} rank {rank}: prefill {got[2]:.2f} ms, decode {got[3]:.3f} ms/step, "
           f"{len(launches)} kernels launched: {json.dumps(launches)}")
    if not launches.get("flash_prefill") or not launches.get("flash_decode_frozen"):
        raise cs.PhaseError(f"{tag} rank {rank}: K1 or K2 not launched ({launches})")
    everyone = distributed.all_gather(free[1][None].to(torch.int64).contiguous(), world)
    same = everyone.reshape(ranks, -1, free[1].shape[1])
    peers = [r for r in range(ranks) if r // (ranks // dp) == rank // (ranks // dp)]
    if not all(torch.equal(same[peers[0]], same[r]) for r in peers):
        raise cs.PhaseError(f"{tag}: the ranks of dp shard {d} parted ways")
    prof = cs._profile_decode(lp, lcfg, mine, T, label=f"{label} rank {rank}", tag=tag)
    if prof:
        cs.log(f"{tag} rank {rank}: busy {prof['busy_ms'] - prof['collective_ms']:.3f} ms a "
               f"step without the NCCL kernels ({prof['collective_ms']:.3f} ms of them, "
               f"with their waits for the other ranks), wall {prof['wall_ms']:.3f} ms")
    # every shard's logits to rank 0, checked there against the reference
    lg = got[0].contiguous()
    gathered = distributed.all_gather(lg[None], world)
    if rank == 0:
        parts = [gathered[r * (ranks // dp)] for r in range(dp)]
        mesh_lg = torch.cat(parts, dim=1)
        cs._check_routes(f"{label}, {layers} layers, against one rank",
                         (mesh_lg, None), ref, cs.MODEL_LOGIT_TOL["bfloat16"], tag=tag)
        cs.log(f"{tag}: one rank: prefill {ref[2]:.2f} ms, decode {ref[3]:.3f} ms/step")
    del eng, lp
    torch.cuda.empty_cache()


ENTRY_PROMPTS = ("Hello world", "The best way to learn programming is")
ENTRY_TOKENS = 8


def _torchrun(n: int):
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={n}", "-m"]


def _cli(cs, d: str, env: dict, extra=()) -> None:
    args = ["tinygpt_tpu_torch.cli", "--model", d, "--dtype", "float32", "--max-tokens",
            str(ENTRY_TOKENS), *extra] + [a for p in ENTRY_PROMPTS for a in ("--prompt", p)]
    one = subprocess.run([sys.executable, "-m"] + args, env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    two = subprocess.run(_torchrun(2) + args + ["--mesh", "1,1,2"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    for what, r in (("one process", one), ("torchrun", two)):
        if r.returncode:
            raise cs.PhaseError(f"[nccl] cli, {what}: exit {r.returncode}: {r.stderr[-3000:]}")
    if two.stdout != one.stdout:
        raise cs.PhaseError(f"[nccl] cli --mesh 1,1,2 printed {two.stdout!r}, one process "
                            f"{one.stdout!r}")
    print(f"[nccl] cli: torchrun --nproc-per-node 2 --mesh 1,1,2 (nccl) printed what one "
          f"process prints ({len(one.stdout)} chars)", flush=True)


def _serve(cs, d: str, env: dict, mesh: bool, log_path: str, extra=()):
    """Start the server (one process, or torchrun's two ranks), wait for
    /health, send the two completions at once, stop it with SIGTERM.
    Returns (the two texts, seconds to stop)."""
    port = cs._mesh_port()
    args = ["tinygpt_tpu_torch.server", "--model", d, "--dtype", "float32", "--host",
            "127.0.0.1", "--port", str(port), "--max-tokens", str(ENTRY_TOKENS), *extra]
    cmd = (_torchrun(2) + args + ["--mesh", "1,1,2"]) if mesh else [sys.executable, "-m"] + args
    with open(log_path, "w") as f:
        proc = subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
    url = f"http://127.0.0.1:{port}"
    what = "torchrun --mesh 1,1,2" if mesh else "one process"

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url + path, data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.read().decode()

    def completion(prompt, stream):
        body = call("/v1/completions", {"prompt": prompt, "max_tokens": ENTRY_TOKENS,
                                        "temperature": 0, "stream": stream})
        if not stream:
            return json.loads(body)["choices"][0]["text"]
        frames = [f[6:] for f in body.split("\n\n") if f.startswith("data: ")]
        return "".join(json.loads(f)["choices"][0].get("text", "") for f in frames[:-1])

    try:
        deadline = time.perf_counter() + 300
        while True:
            if proc.poll() is not None:
                with open(log_path) as f:
                    raise cs.PhaseError(f"[nccl] server, {what}: exit {proc.returncode}: "
                                        f"{f.read()[-3000:]}")
            try:
                call("/health")
                break
            except OSError:
                if time.perf_counter() > deadline:
                    raise cs.PhaseError(f"[nccl] server, {what}: not up in 300 s")
                time.sleep(1)
        with concurrent.futures.ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(completion, p, i == 1) for i, p in enumerate(ENTRY_PROMPTS)]
            texts = [f.result() for f in futs]
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=90)
        except subprocess.TimeoutExpired:
            raise cs.PhaseError(f"[nccl] server, {what}: still running 90 s after SIGTERM")
        stopped = time.perf_counter() - t0
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)  # nothing of the server outlives it
        except ProcessLookupError:
            pass
        proc.wait()
    return texts, stopped


def entry_points(cs) -> int:
    """The CLI and the server under torchrun over NCCL (module docstring)."""
    from tinygpt_tpu_torch.ops import cuda_build

    d = tempfile.mkdtemp(prefix="nccl_entry_", dir=cuda_build.BUILD_DIR)
    env = dict(os.environ, PYTHONPATH=ROOT)
    try:
        cs._write_model_dir(d)
        _cli(cs, d, env)
        one, _ = _serve(cs, d, env, False, os.path.join(d, "serve1.log"))
        two, stopped = _serve(cs, d, env, True, os.path.join(d, "serve2.log"))
        with open(os.path.join(d, "serve2.log")) as f:
            tail = f.read()[-2000:]
        if two != one:
            raise cs.PhaseError(f"[nccl] server --mesh 1,1,2 answered {two!r}, one process "
                                f"{one!r}")
        print(f"[nccl] server: torchrun --nproc-per-node 2 --mesh 1,1,2 (nccl) answered two "
              f"concurrent greedy completions (one streamed) with one process's texts "
              f"{[t[:30] for t in one]}; stopped on SIGTERM in {stopped:.1f} s", flush=True)
        print(f"[nccl] server log tail:\n{tail}", flush=True)
    except cs.PhaseError as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    finally:
        shutil.rmtree(d, ignore_errors=True)
    return 0


def rank_main(rank: int, ranks: int, port: int, layers: int) -> int:
    import torch

    import chip_smoke as cs
    from tinygpt_tpu_torch.parallel import distributed

    cs.DEVICE = f"cuda:{rank}"
    cs.E4M3 = torch.float8_e4m3fn
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"localhost:{port}", ranks, rank, device=cs.DEVICE)
    try:
        with torch.inference_mode():
            for bits, shape, label in (
                    (4, (1, 1, ranks), f"tp={ranks} int4"),
                    (None, (1, 1, ranks), f"tp={ranks} bf16"),
                    (4, (2, 1, ranks // 2), f"dp=2 x tp={ranks // 2} int4")):
                t0 = time.perf_counter()
                _leg(cs, rank, ranks, layers, bits, shape, label)
                cs.log(f"[nccl] {label} rank {rank}: {time.perf_counter() - t0:.1f} s")
    except cs.PhaseError as e:
        print(f"rank {rank} FAILED: {e}", flush=True)
        return 1
    distributed.barrier()
    return 0


def main() -> int:
    args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
    if "--rank" in args:
        return rank_main(int(args["--rank"]), int(args["--ranks"]), int(args["--port"]),
                         int(args["--layers"]))
    import torch

    import chip_smoke as cs
    from tinygpt_tpu_torch.ops import cuda_build

    ranks = int(args.get("--ranks", 4))
    layers = int(args.get("--layers", 32))
    if torch.cuda.device_count() < ranks:
        print(f"needs {ranks} cards, found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(f"[nccl] {len(built)} kernel libraries built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    port = cs._mesh_port()
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    d = tempfile.mkdtemp(prefix="nccl_", dir=cuda_build.BUILD_DIR)
    procs = [cs._mesh_start([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                             "--ranks", str(ranks), "--port", str(port), "--layers",
                             str(layers)], os.path.join(d, f"rank{r}.log"), cwd=ROOT)
             for r in range(ranks)]
    try:
        outs = cs._mesh_wait(procs, TIMEOUT_S, "nccl ranks")
    except cs.PhaseError as e:
        print(f"FAILED: {e}", flush=True)
        return 1
    log_path = args.get("--log", str(cuda_build.BUILD_DIR / "mesh_nccl.log"))
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    with open(log_path, "w") as f:
        for r, out in enumerate(outs):
            f.write(f"---- rank {r}\n{out}")
    keys = ("prefill", "busy", "against one rank", "one rank", " s\n")
    for r, out in enumerate(outs):
        for line in out.splitlines(keepends=True):
            if line.startswith("[nccl]") and any(k in line for k in keys):
                print(line[:400].rstrip(), flush=True)
    t0 = time.perf_counter()
    rc = entry_points(cs)
    print(f"[nccl] entry points: {time.perf_counter() - t0:.1f} s", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout)
    return rc


if __name__ == "__main__":
    sys.exit(main())
