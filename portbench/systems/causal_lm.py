"""The system under test for the llama-family configurations:
tinygpt_tpu_torch's ContinuousBatcher over models.causal_lm, driven in
process as server/api.BatchedInferenceWorker drives it (add_request,
step).

The batcher takes its model as an argument, so the benchmark hands it a
namespace of its own around causal_lm's entries: it counts admissions
(one dense forward each), decode quanta, their steps, their live rows and
the K/V slots their attention reads, and opens the host spans
`admission` and `decode_quantum` around them. Nothing of the program is
edited or patched.
"""

from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np

from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, Request, SchedulerConfig
from tinygpt_tpu_torch.hf.config import parse_model_config
from tinygpt_tpu_torch.models import causal_lm
from tinygpt_tpu_torch.ops.quant import QuantizedTensor

HF_KEYS = ("model_type", "vocab_size", "hidden_size", "num_hidden_layers",
           "num_attention_heads", "num_key_value_heads", "intermediate_size",
           "max_position_embeddings", "rope_theta", "rms_norm_eps", "sliding_window",
           "tie_word_embeddings", "num_local_experts", "num_experts_per_tok", "head_dim")


def model_config(cfg: dict):
    """The program's ModelConfig of a configuration file's HF keys."""
    return parse_model_config({k: cfg[k] for k in HF_KEYS if k in cfg})


def program_params(cfg: dict, w: dict, device) -> dict:
    """The program's params dict over the benchmark's weights (the same
    tensors, no copy); the rope tables are the program's own."""
    mc = model_config(cfg)
    g = w["group"]

    def qt(pair, in_dim):
        return QuantizedTensor(pair[0], pair[1], 4, g, in_dim)

    H, I = cfg["hidden_size"], cfg["intermediate_size"]
    layers = {"input_ln": w["input_ln"], "post_ln": w["post_ln"],
              "qkv_w": qt(w["qkv"], H), "o_w": qt(w["o"], mc.num_attention_heads * mc.head_dim)}
    if "router" in w:
        layers.update(router_w=w["router"], moe_gate_up_w=qt(w["moe_gate_up"], H),
                      moe_down_w=qt(w["moe_down"], I))
    else:
        layers.update(gate_up_w=qt(w["gate_up"], H), down_w=qt(w["down"], I))
    cos, sin = causal_lm._rope_tables(mc, device)
    return {"embed": w["embed"], "layers": layers, "final_ln": w["final_ln"],
            "lm_head": qt(w["head"], H), "rope_cos": cos, "rope_sin": sin}


def scheduler_config(workload: dict, seed: int) -> SchedulerConfig:
    """The cell's scheduler, with a pool that holds every row at the
    traffic's longest request (no request ends for want of blocks)."""
    s = dict(workload["scheduler"])
    t = workload["traffic"]
    bs = s["block_size"]
    longest = t["prompt"]["max"] + t["output"]["max"]
    s.setdefault("max_blocks_per_seq", math.ceil(longest / bs))
    s.setdefault("n_blocks", s["batch_capacity"] * s["max_blocks_per_seq"] + 1)
    return SchedulerConfig(seed=int(seed) % (2 ** 31), **s)


class System:
    """The batcher on the benchmark's weights, behind the counting
    namespace. `counts` holds the running totals the harness reads between
    steps: admissions, quanta, steps, row_steps, kv_slots. `span(name)` is
    the harness's host span. `fault` breaks the timed path for the
    harness's own tests: "token" alters the tokens of one step of every
    quantum where they are produced."""

    def __init__(self, cfg: dict, workload: dict, weights: dict, seed: int, device,
                 span, kv_cache_dtype=None, fault=None):
        self.cfg = cfg
        self.mc = model_config(cfg)
        self.params = program_params(cfg, weights, device)
        self.counts = dict(admissions=0, quanta=0, steps=0, row_steps=0, kv_slots=0)
        self.span = span
        self.fault = fault
        # while a trace runs: each quantum's (steps, [(request id, decode steps
        # the request had before it)] of its live rows)
        self.quantum_rows = None
        self._decoded = {}  # request id -> decode steps issued for it
        sc = scheduler_config(workload, seed)
        if kv_cache_dtype is not None:
            sc.kv_cache_dtype = kv_cache_dtype
        self.batcher = ContinuousBatcher(self._namespace(), self.mc, self.params,
                                         eos_ids=set(), config=sc)

    def _namespace(self):
        counts, span = self.counts, self.span

        def forward(*args, **kw):
            counts["admissions"] += 1
            with span("admission"):
                return causal_lm.forward(*args, **kw)

        def decode_paged_steps(params, cfg, tok0, state, n_steps, sample_fn,
                               attn_impl="kernel"):
            b = self.batcher
            rows = list(b.running)
            n = len(rows)
            counts["quanta"] += 1
            ids = [b.running[r].request_id for r in rows]
            if self.quantum_rows is not None:
                self.quantum_rows.append((n_steps, [(i, self._decoded.get(i, 0)) for i in ids]))
            for i in ids:
                self._decoded[i] = self._decoded.get(i, 0) + n_steps
            counts["steps"] += n_steps
            counts["row_steps"] += n * n_steps
            # step t of a row at pool length l attends over l + t + 1 slots
            counts["kv_slots"] += (n_steps * int(np.sum(b._lengths[rows]))
                                   + n * n_steps * (n_steps + 1) // 2)
            with span("decode_quantum"):
                toks = causal_lm.decode_paged_steps(params, cfg, tok0, state, n_steps,
                                                    sample_fn, attn_impl=attn_impl)
                if self.fault == "token":
                    t = n_steps // 2
                    toks[t] = (toks[t] + 1) % cfg.vocab_size
            return toks

        return SimpleNamespace(forward=forward, decode_paged_steps=decode_paged_steps)

    def request(self, rid: int, prompt_ids, max_new: int) -> Request:
        return Request(request_id=rid, prompt_ids=list(prompt_ids), max_new_tokens=max_new)

    def close(self) -> None:
        """Drops the batcher, its pools and the program's params."""
        self.batcher = None
        self.params = None
