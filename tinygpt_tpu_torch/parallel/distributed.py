"""Multi-process runtime: process bootstrap, hybrid meshes and the
collectives every sharded module calls.

Counterpart of tinygpt_tpu/parallel/distributed.py on torch.distributed.
The model is explicit SPMD: one process per rank, every rank runs the
SAME program on the same requests, holds its own shard of the weights and
of the KV cache, and meets the others only in the collectives below.

  * `initialize()` joins the process group from the standard torch env
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, as torchrun sets them) or
    from explicit arguments; with nothing configured it is a logged no-op
    (a world of one rank), as the JAX initialize is;
  * the backend is explicit: "nccl" for a CUDA device, "gloo" for the CPU,
    or the caller's choice (two ranks sharing one card take "gloo": NCCL
    refuses two ranks on one device). Nothing swaps one for the other.
    Under "nccl" a rank's current CUDA device is cuda:{LOCAL_RANK}, the
    card its engine runs on: NCCL's object collectives (broadcast_object,
    barrier) place their buffers on the current device;
  * `hybrid_mesh` puts `dcn_dp` on nodes (LOCAL_WORLD_SIZE ranks a node,
    node-major ranks as torchrun numbers them) so tp's all-reduces stay
    inside a node; on one node it falls back to the flat layout with a
    warning;
  * the collective helpers (all_reduce, all_gather, broadcast, send, recv)
    take a group and skip a group of one rank. Under gloo, send and recv
    of a CUDA tensor go through a host copy, by the backend's name: gloo's
    point-to-point ops take CPU tensors only.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("parallel.distributed")

# gloo ops that take CPU tensors only: a CUDA tensor is staged on the host
_GLOO_HOST_OPS = frozenset({"send", "recv"})


def default_backend(device) -> str:
    """"nccl" for a CUDA device, "gloo" otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> bool:
    """Join the process group. Arguments fall back to MASTER_ADDR /
    MASTER_PORT (the coordinator `host:port`), WORLD_SIZE and RANK; with
    none of them it is a no-op and returns False (a world of one rank).
    `backend` defaults to default_backend(device); under "nccl" the
    current CUDA device becomes cuda:{LOCAL_RANK} (else cuda:{rank}).
    Returns True once this process is in a group (also when it already
    was)."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        log.info("single-process runtime (no coordinator configured)")
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator address, the "
                         "world size and this process's rank (MASTER_ADDR / "
                         "MASTER_PORT, WORLD_SIZE, RANK)")
    backend = backend or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    log.info("process group up: rank %d of %d (%s)", process_id, num_processes, backend)
    return True


def world() -> Tuple[int, int]:
    """(this process's rank, the world size); (0, 1) outside a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_rank() -> int:
    """This process's rank on its node (LOCAL_RANK, as torchrun sets it),
    else its global rank."""
    return int(os.environ.get("LOCAL_RANK", world()[0]))


def hybrid_mesh(dcn_dp: int = 1, dp: int = 1, sp: int = 1, tp: Optional[int] = None):
    """Mesh ("dcn_dp", "dp", "sp", "tp") over the world: the leading axis
    crosses nodes (data parallel only: no per-layer collectives), the inner
    axes stay within a node so tp's all-reduces ride the node's links.
    torchrun numbers ranks node by node, so the node-major reshape is the
    hybrid layout when dcn_dp equals the nodes; otherwise the layout is the
    flat one, with a warning."""
    from tinygpt_tpu_torch.parallel.sharding import Mesh

    n = world()[1]
    ranks = hybrid_ranks(n, int(os.environ.get("LOCAL_WORLD_SIZE", n)), dcn_dp, dp, sp, tp)
    return Mesh(ranks, ("dcn_dp", "dp", "sp", "tp"))


def hybrid_ranks(n: int, per_node: int, dcn_dp: int = 1, dp: int = 1, sp: int = 1,
                 tp: Optional[int] = None) -> np.ndarray:
    """The ranks array [dcn_dp, dp, sp, tp] of hybrid_mesh for a world of
    n ranks, per_node a node."""
    if tp is None:
        tp = n // dcn_dp // (dp * sp)
    if dcn_dp * dp * sp * tp != n:
        raise ValueError(f"dcn_dp({dcn_dp}) * dp({dp}) * sp({sp}) * tp({tp}) != {n}")
    nodes = n // per_node
    if dcn_dp > 1 and nodes != dcn_dp:
        log.warning("hybrid mesh: %d node(s) for dcn_dp=%d; flat layout", nodes, dcn_dp)
    return np.arange(n).reshape(dcn_dp, dp, sp, tp)


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this process's row range under pure data-parallel
    input feeding: processes own contiguous equal slices of the batch."""
    pi, pc = world()
    if global_batch % pc:
        raise ValueError(f"batch {global_batch} not divisible by {pc} processes")
    size = global_batch // pc
    return pi * size, size


# -- collectives --------------------------------------------------------------


def group_size(group) -> int:
    """Ranks in `group`; None is a group of one (an axis of size 1)."""
    return 1 if group is None else dist.get_world_size(group)


def _host_staged(op: str, t: torch.Tensor, group=None) -> bool:
    return (t.device.type == "cuda" and op in _GLOO_HOST_OPS
            and dist.get_backend(group) == "gloo")


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of `t` over the group, in place; returns t."""
    if group_size(group) > 1:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along `dim`, in group-rank order."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """`t` from global rank `src` to every rank of the group, in place."""
    if group_size(group) > 1:
        dist.broadcast(t, src, group=group)
    return t


def send(t: torch.Tensor, dst: int, group=None) -> None:
    """Blocking send of `t` to global rank `dst`."""
    if _host_staged("send", t, group):
        t = t.cpu()
    dist.send(t.contiguous(), dst, group=group)


def recv(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """Blocking receive into `t` from global rank `src`; returns t."""
    if _host_staged("recv", t, group):
        buf = torch.empty(t.shape, dtype=t.dtype)
        dist.recv(buf, src, group=group)
        t.copy_(buf)
        return t
    dist.recv(t, src, group=group)
    return t


def broadcast_object(obj, src: int = 0, group=None):
    """A picklable object from global rank `src` to every rank."""
    if not dist.is_initialized():
        return obj
    box: List = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def barrier(group=None) -> None:
    if dist.is_initialized():
        dist.barrier(group=group)
