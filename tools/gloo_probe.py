"""Which torch.distributed gloo collectives take CUDA tensors, and what
they cost, with two processes sharing one card.

    python3 tools/gloo_probe.py

Each rank runs all_reduce, broadcast, all_gather, all_gather_into_tensor
and broadcast_object_list on fp32, bf16 and int32 tensors on cuda:0 and
prints "ok" and the result or the error, then times an all_reduce of
4 x 4,096 bf16 and an all_gather of 4 x 16,384 fp32 (µs a call, 50 and 20
calls). send and recv are left out: on a CUDA tensor gloo aborts the
process ("writev ... Bad address"), which is why
parallel/distributed.send and recv stage CUDA tensors on the host.
"""

import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor", "broadcast_object")


def _op(op, x, ws):
    """Runs one collective on x; returns what this rank saw."""
    if op == "all_reduce":
        dist.all_reduce(x)
        return x[0].item()
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(ws)]
        dist.all_gather(parts, x)
        return [t[0].item() for t in parts]
    if op == "all_gather_into_tensor":
        out = torch.empty(x.numel() * ws, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out[:: x.numel()].tolist()
    if op == "broadcast":
        dist.broadcast(x, 0)
        return x[0].item()
    box = [{"r": dist.get_rank()}]
    dist.broadcast_object_list(box, src=0)
    return box


def _us(fn, n):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def rank_main(rank, ws, port):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=ws)
    torch.cuda.set_device(0)
    for dt in (torch.float32, torch.bfloat16, torch.int32):
        for op in OPS:
            try:
                got = _op(op, torch.full((8,), rank + 1, dtype=dt, device="cuda"), ws)
                torch.cuda.synchronize()
                print(rank, f"{op}:{dt}", "ok", got, flush=True)
            except Exception as e:  # noqa: BLE001 - the probe reports it
                print(rank, f"{op}:{dt}", "err", str(e)[:160], flush=True)
            dist.barrier()
    x = torch.ones(4 * 4096, dtype=torch.bfloat16, device="cuda")
    for _ in range(5):
        dist.all_reduce(x)
    print(rank, "ar_us_4x4096_bf16", _us(lambda: dist.all_reduce(x), 50), flush=True)
    parts = [torch.empty(4 * 16384, device="cuda") for _ in range(ws)]
    y = torch.ones(4 * 16384, device="cuda")
    print(rank, "ag_us_4x16384_f32", _us(lambda: dist.all_gather(parts, y), 20), flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    mp.spawn(rank_main, args=(2, port), nprocs=2)
    sys.exit(0)
