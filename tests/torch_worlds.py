"""Multi-process gloo worlds on the CPU for the port's sharded tests.

A `World` spawns n ranks once (tests start one a module, in a fixture):
each joins a gloo process group and then runs the jobs the test process
sends it, one at a time, every rank the same job, and returns each rank's
result. The ranks import the port and torch only; the test process holds
the JAX package and compares. A job is a function of this module, called
with its arguments on every rank; a rank whose job raises returns the
exception, and a rank that does not answer within the job's timeout fails
the test.
"""

from __future__ import annotations

import os
import queue
import socket
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

JOB_TIMEOUT_S = 240


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank: int, size: int, port: int, jobs, results) -> None:
    os.environ.setdefault("TINYGPT_LOG_LEVEL", "WARNING")
    torch.set_num_threads(1)
    from tinygpt_tpu_torch.parallel import distributed

    distributed.initialize(f"localhost:{port}", size, rank, backend="gloo", device="cpu")
    while True:
        job = jobs.get()
        if job is None:
            break
        name, args = job
        try:
            out = globals()[name](*args)
        except BaseException as e:  # noqa: BLE001 - handed to the test
            out = RuntimeError(f"rank {rank}: {e!r}\n{traceback.format_exc()}")
        results.put((rank, out))
    torch.distributed.destroy_process_group()


class World:
    """n spawned ranks in one gloo process group."""

    def __init__(self, n: int):
        ctx = mp.get_context("spawn")
        self.n = n
        port = _free_port()
        self._jobs = [ctx.Queue() for _ in range(n)]
        self._results = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, n, port, self._jobs[r], self._results))
                       for r in range(n)]
        for p in self._procs:
            p.start()

    def run(self, name: str, *args, timeout: float = JOB_TIMEOUT_S):
        """Every rank's result of job `name`, by rank. A rank's exception
        is raised here."""
        for q in self._jobs:
            q.put((name, args))
        out = {}
        for _ in range(self.n):
            try:
                rank, res = self._results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"job {name}: ranks {sorted(set(range(self.n)) - set(out))} "
                                   f"did not answer in {timeout} s") from None
            out[rank] = res
        for rank, res in sorted(out.items()):
            if isinstance(res, BaseException):
                raise res
        return [out[r] for r in range(self.n)]

    def close(self) -> None:
        for q in self._jobs:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()


# -- jobs (run on every rank) -----------------------------------------------------------


def engine_tokens(model_dir: str, mesh, prompts, kw):
    """Greedy tokens of the port's engine on `mesh`."""
    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine

    eng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", dtype="float32",
                              mesh_shape=tuple(mesh) if mesh else None, **kw))
    eng.prepare()
    return [o.token_ids for o in eng.generate_sync(prompts)]


def engine_refuses(model_dir: str, mesh, kw) -> str:
    """The ValueError of an engine that refuses its mesh, as text."""
    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine

    try:
        GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", dtype="float32",
                            mesh_shape=tuple(mesh), **kw)).prepare()
    except ValueError as e:
        return str(e)
    return ""


def _params(np_params, cfg_json):
    """(config, model namespace, full params on the CPU) of the JAX params
    as numpy arrays."""
    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import get_model
    from tinygpt_tpu_torch.models.causal_lm import params_from_numpy

    cfg = parse_model_config(cfg_json)
    return cfg, get_model(cfg.model_type), params_from_numpy(np_params, device="cpu")


def forward_logits(np_params, cfg_json, mesh, ids, positions, valid, cache_len: int):
    """fp32 logits [B, S, V] of the port's forward with this rank's shard
    on a (dp, sp, tp) mesh (dp must be 1: the batch is not cut here); None
    on a rank outside a smaller mesh."""
    from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
    from tinygpt_tpu_torch.parallel.sharding import make_mesh, shard_model

    cfg, model, params = _params(np_params, cfg_json)
    dp, sp, tp = mesh
    m = make_mesh(n_devices=dp * sp * tp, dp=dp, sp=sp, tp=tp)
    if m.coords is None:
        return None
    local, lcfg = shard_model(params, cfg, m)
    cache = create_kv_cache(lcfg, ids.shape[0], cache_len, dtype=torch.float32, device="cpu")
    logits, cache = model.forward(local, lcfg, torch.from_numpy(ids), cache,
                                  torch.from_numpy(positions), torch.from_numpy(valid),
                                  attn_impl="plain")
    return logits.numpy()


def decode_logits(np_params, cfg_json, mesh, quant, ids, steps: int):
    """The port's prefill and `steps` frozen-cache greedy decode steps
    (decode_steps: the fused int4 route for int4 params) with this rank's
    shard: (the last-position logits of each step [steps + 1, B, V], the
    tokens [steps, B])."""
    from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
    from tinygpt_tpu_torch.ops.quant import quantize_params
    from tinygpt_tpu_torch.parallel.sharding import make_mesh, shard_model

    cfg, model, params = _params(np_params, cfg_json)
    if quant:
        params = quantize_params(params, bits=quant[0], group_size=quant[1])
    dp, sp, tp = mesh
    m = make_mesh(n_devices=dp * sp * tp, dp=dp, sp=sp, tp=tp)
    local, lcfg = shard_model(params, cfg, m)
    B, S = ids.shape
    cache = create_kv_cache(lcfg, B, S + steps + 1, dtype=torch.float32, device="cpu")
    pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S).contiguous()
    logits, cache = model.forward(local, lcfg, torch.from_numpy(ids), cache, pos,
                                  torch.ones((B, S), dtype=torch.bool), last_only=True,
                                  attn_impl="plain")
    seen = [logits[:, -1]]

    def sample(lg):
        seen.append(lg)
        return lg.argmax(dim=-1).to(torch.int32)

    tok = sample(logits[:, -1])
    seen.pop()
    toks, cache = model.decode_steps(local, lcfg, tok, cache,
                                     torch.full((B, 1), S, dtype=torch.int32), steps,
                                     sample, attn_impl="plain")
    return torch.stack(seen).numpy(), np.concatenate([tok[None].numpy(), toks.numpy()])


def pipeline_logits(np_params, cfg_json, dp_pp_tp, n_micro, ids, positions, valid, T):
    """The port's pipelined forward on a ("dp", "pp", "tp") mesh: this dp
    shard's prefill logits [B / dp, V], one greedy decode step's, and the
    shard's index; None on a rank outside the mesh."""
    from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
    from tinygpt_tpu_torch.parallel import pipeline as pl

    cfg, model, params = _params(np_params, cfg_json)
    dp, pp, tp = dp_pp_tp
    mesh = pl.make_pipeline_mesh(dp=dp, pp=pp, tp=tp)
    if mesh.coords is None:
        return None
    staged = dict(params, layers=pl.stage_layers(params["layers"], pp))
    local, scfg = pl.shard_staged(staged, mesh, cfg)
    B = ids.shape[0] // dp
    rows = slice(mesh.index("dp") * B, (mesh.index("dp") + 1) * B)
    cache = create_kv_cache(scfg, B, T, dtype=torch.float32, device="cpu")
    fwd = pl.make_pipelined_forward(mesh, cfg, n_micro, attn_impl="plain", stage_cfg=scfg)
    out, cache = fwd(local, torch.from_numpy(ids[rows]), cache,
                     torch.from_numpy(positions[rows]), torch.from_numpy(valid[rows]))
    tok = out.argmax(dim=-1).to(torch.int32)[:, None]
    S = ids.shape[1]
    out2, _ = fwd(local, tok, cache, torch.full((B, 1), S, dtype=torch.int32),
                  torch.ones((B, 1), dtype=torch.bool))
    return out.numpy(), out2.numpy(), mesh.index("dp")


def batcher_streams(np_params, cfg_json, mesh, prompts, max_new, kw, samplers=None):
    """The port's continuous batcher on `mesh` (None: one device): each
    request's tokens, and the batcher's speculative counters."""
    from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, Request, SchedulerConfig
    from tinygpt_tpu_torch.ops.sampling import SamplerConfig

    cfg, model, params = _params(np_params, cfg_json)
    b = ContinuousBatcher(model, cfg, params, eos_ids=set(), config=SchedulerConfig(
        block_size=16, n_blocks=64, max_blocks_per_seq=8, prefill_bucket=16,
        dtype="float32", attn_impl="plain", mesh_shape=tuple(mesh) if mesh else None,
        **kw))
    for i, p in enumerate(prompts):
        s = SamplerConfig(**samplers[i]) if samplers and samplers[i] else SamplerConfig()
        b.add_request(Request(request_id=i, prompt_ids=list(p), max_new_tokens=max_new,
                              sampler=s))
    got = {i: [] for i in range(len(prompts))}
    steps = 0
    while b.has_work and steps < 400:
        for ev in b.step():
            if ev.token_id is not None:
                got[ev.request_id].append(ev.token_id)
        steps += 1
    return [got[i] for i in range(len(prompts))], b.spec_verifies


def served_text(model_dir: str, mesh, prompt: str, max_tokens: int) -> str:
    """One /v1/completions answer of the port's HTTP server, the batcher
    on `mesh`: rank 0 serves and asks, the other ranks follow."""
    import json
    import threading
    import urllib.request

    from tinygpt_tpu_torch.parallel.distributed import barrier, broadcast_object, world
    from tinygpt_tpu_torch.server.http import ServerConfig, TinyGPTServer

    port = broadcast_object(_free_port() if world()[0] == 0 else None)
    server = TinyGPTServer(ServerConfig(
        model_dir=model_dir, host="127.0.0.1", port=port, dtype="float32",
        max_tokens=max_tokens, device="cpu", batch_capacity=2, kv_block_size=16,
        kv_n_blocks=32, mesh_shape=tuple(mesh)))
    server.prepare()
    if world()[0] != 0:
        server.serve_forever()  # follows rank 0's plans until it stops
        barrier()
        return ""
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    body = json.dumps({"prompt": prompt, "max_tokens": max_tokens, "temperature": 0}).encode()
    for _ in range(100):
        try:
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/completions", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                text = json.loads(r.read())["choices"][0]["text"]
            break
        except OSError:
            import time

            time.sleep(0.1)
    server.shutdown()
    barrier()
    return text
