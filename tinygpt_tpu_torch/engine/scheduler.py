"""Continuous batching scheduler over the paged KV pool.

Counterpart of tinygpt_tpu/engine/scheduler.py (single device): requests
join and leave one fixed-capacity decode quantum mid-flight.

  * decode runs at a fixed row capacity B_max; a row is a live sequence or
    masked; the per-row sampler knobs are tensors, sampled in one call;
  * admission prefills one request at a time through the dense forward
    (whole prompt, or chunk by chunk with prefill_chunk_tokens > 0) over a
    dense cache seeded from the pool, then scatters its K/V into pool
    blocks; its first token is sampled from the prefill logits;
  * block tables grow on the host (the allocator is plain Python) and are
    re-uploaded as small int32 tensors when they change.

Scheduling policy: admit first (prefill preempts decode while free rows
and blocks exist — favours TTFT), then one decode quantum for all live
rows. Rows finish on EOS / stop ids / max_tokens / pool exhaustion
(reported as a "length" finish) and their blocks return to the pool.

With speculative="ngram" the decode quantum becomes rounds of n-gram
drafting and (gamma + 1)-position verification per row
(causal_lm.decode_paged_spec_steps, attention through K10): greedy rows
accept the matched prefix of the argmax, sampled rows by exact rejection
sampling. The auto-off policy falls back to plain quanta while the
measured acceptance does not pay for the wider verify, and re-probes.
The pools may be fp8 (kv_cache_dtype="fp8").

The decode quantum is the frozen one (_decode_quantum_frozen over the
model's decode_paged_steps, attention through K8) for every family that
has it, GPT-2 included; a model namespace without it runs the stepwise
quantum (_decode_quantum: n_steps whole forward_paged steps, each layer
writing its K/V into the pool before attention through K9), as the JAX
batcher selects them.

The JAX package's jitted programs are plain functions here
(_admit_program, _admit_chunk_program, _decode_quantum_frozen,
_decode_quantum, _decode_quantum_spec), run eagerly.
Two rules keep the host from waiting on the card between quanta: every
upload is a fresh pinned copy sent with non_blocking (a blocking copy
from pageable memory would synchronise the stream, and a pinned buffer
that the host mutates afterwards could be read after the mutation), and
a quantum's tokens come back through a pinned buffer and an event, so
that reading quantum k does not wait for quantum k+1, already issued.

Spans and counters: with utils/profiler's spans on, each step records
`tg.step`, and inside it `tg.drain` (a quantum read before an admission),
`tg.admit` with `tg.admit.prefill` and `tg.admit.readback` (the host
waiting for the first token), `tg.decode.issue` (the host enqueuing a
quantum, attribute `q` its sequence number), `tg.decode.readback` (the
host waiting for quantum `q`'s tokens) and, for a plain quantum,
`tg.decode.emit` (their bookkeeping and events); none per token. `stats`
counts, always, the prefill forwards this rank ran (one an admission or a
chunk), the plain quanta, their decode steps, their live row-steps and the
K/V slots their attention reads (step t of a row at pool length l reads
l + t + 1).

Sharded serving (mesh_shape = (dp, sp, tp) or (dp, tp)) runs the batcher
as one rank of an SPMD world (parallel/), as the JAX batcher lays it out:

  * every rank runs the SAME deterministic host loop on the SAME requests
    (the multi-host contract): the host mirrors, the allocators and the
    prefix indexes are global and identical on every rank;
  * rows, pools and allocators are PARTITIONED over dp: shard d owns rows
    [d * B/dp, (d + 1) * B/dp) and a pool of n_blocks/dp blocks with its
    own allocator (local block ids, local null block 0), so prefix reuse
    stays within a shard. A rank holds only its shard's rows and pool; a
    quantum runs on them, and its tokens are all-gathered over dp so that
    every host loop sees every row. An admission runs on the owning
    shard's ranks, which broadcast its first token over dp;
  * params are cut over tp (parallel/sharding.py), the pools' KV heads
    with them where tp divides them; the admission prefill's sequence is
    cut over sp (a MoE model's experts instead); decode quanta run the
    same kernels (K8, K9, K10) on each rank's pool shard;
  * every rank of a dp shard samples the same tokens (one generator,
    seeded with the seed plus the shard, on the same gathered logits).
"""

from __future__ import annotations

import functools
import hashlib
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from tinygpt_tpu_torch.engine.engine import _FP8_NAMES
from tinygpt_tpu_torch.engine.kv_cache import KVCache, create_kv_cache
from tinygpt_tpu_torch.engine.native_pool import create_pool_index
from tinygpt_tpu_torch.engine.paged_kv import (
    PagedKVState,
    blocks_needed,
    create_paged_state,
)
from tinygpt_tpu_torch.hf.config import ModelConfig
from tinygpt_tpu_torch.hf.loader import resolve_dtype
from tinygpt_tpu_torch.models import params_device
from tinygpt_tpu_torch.ops.attention_kernels import check_kernel_shapes
from tinygpt_tpu_torch.ops.sampling import SamplerConfig, sample_batched
from tinygpt_tpu_torch.parallel.distributed import all_gather, broadcast, world
from tinygpt_tpu_torch.parallel.sharding import (
    check_world,
    local_config,
    make_mesh,
    mesh_dims,
    shard_model,
)
from tinygpt_tpu_torch.utils.logging import get_logger
from tinygpt_tpu_torch.utils.profiler import note, span

log = get_logger("engine.scheduler")


def _round_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class SchedulerConfig:
    batch_capacity: int = 8
    block_size: int = 64
    n_blocks: int = 512
    max_blocks_per_seq: int = 64
    prefill_bucket: int = 64
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "auto"  # "auto" | "fp8" | explicit dtype name
    attn_impl: str = "kernel"  # "kernel" | "plain"
    seed: int = 0
    # decode steps per quantum. Admissions wait at most one quantum. Rows
    # that finish mid-quantum run out the quantum in their own blocks and
    # the host discards the surplus tokens.
    decode_quantum: int = 8
    # prefix caching: completed whole blocks of a prompt are content-
    # addressed (hash chain over block-size token chunks); admissions
    # reuse matching blocks read-only (refcounted) and prefill only the
    # suffix. Idle cached blocks are reclaimed LRU under pool pressure.
    enable_prefix_cache: bool = True
    # chunked prefill: 0 admits a whole prompt in one step; > 0 prefills
    # at most this many tokens per scheduler step, running a decode
    # quantum for live rows between chunks. Rounded up to
    # lcm(prefill_bucket, block_size).
    prefill_chunk_tokens: int = 0
    # sharded serving: (dp, sp, tp) or (dp, tp), one process a rank (see
    # the module docstring); batch_capacity and n_blocks must divide by dp
    mesh_shape: Optional[tuple] = None
    # speculative decoding in the batcher: None | "ngram". A quantum runs
    # decode_quantum // (spec_draft_len + 1) rounds of device-resident
    # n-gram drafting (the last spec_ngram tokens looked up in the row's
    # context of at most spec_ctx tokens) and (spec_draft_len + 1)-token
    # verification per row; each row's throughput multiplies by (1 + its
    # mean accepted drafts). Greedy rows verify by argmax prefix, sampled
    # rows by exact rejection sampling.
    speculative: Optional[str] = None
    spec_draft_len: int = 4
    spec_ngram: int = 3
    spec_ctx: int = 2048
    # auto-off: when the mean accepted drafts per verify over spec_window
    # verifies falls below spec_min_acceptance (two consecutive low windows
    # from a cold start, one when the window is a re-probe), plain quanta
    # take over, and every spec_probe_every plain quanta one speculative
    # window probes again
    spec_auto_off: bool = True
    spec_min_acceptance: float = 0.25
    spec_window: int = 32
    spec_probe_every: int = 64
    # issue quantum k+1 (chaining the last token on the device) BEFORE
    # reading quantum k's tokens on the host, so the host's work on one
    # overlaps the card's on the other. EOS is noticed one quantum late
    # (surplus tokens discarded, as for mid-quantum finishes); admissions
    # drain the pipeline first.
    pipeline_quanta: bool = True


@dataclass
class Request:
    request_id: int
    prompt_ids: List[int]
    max_new_tokens: int
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    stop_token_ids: Set[int] = field(default_factory=set)
    # filled by the scheduler
    row: int = -1
    blocks: List[int] = field(default_factory=list)
    generated: List[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: str = ""
    # first token from the prefill, a device [1] tensor read after the
    # whole admission burst
    _pending_token: Optional[torch.Tensor] = None
    # chunked-admission progress (tokens already in the pool) + hashes
    _chunk_pos: int = 0
    _hashes: List[int] = field(default_factory=list)


@dataclass
class TokenEvent:
    request_id: int
    token_id: Optional[int]  # None on the finish event
    finished: bool
    finish_reason: str = ""


def _sampler_row(s: SamplerConfig):
    """(temperature, top_k, top_p, min_p) of one request, disabled knobs
    at their neutral values."""
    return (s.temperature or 0.0, s.top_k or 0,
            s.top_p if s.top_p is not None else 1.0, s.min_p or 0.0)


class ContinuousBatcher:
    def __init__(
        self,
        model,
        model_config: ModelConfig,
        params,
        eos_ids: Set[int],
        config: Optional[SchedulerConfig] = None,
    ):
        self.model = model
        self.cfg = model_config
        self.params = params
        self.eos_ids = set(eos_ids)
        self.sc = config or SchedulerConfig()
        sc = self.sc
        if sc.speculative not in (None, "ngram"):
            raise ValueError(f"unknown speculative mode {sc.speculative!r}")
        # the frozen quantum where the model has one, else the stepwise one
        if getattr(model, "decode_paged_steps", None) is not None:
            self._decode_fn = functools.partial(_decode_quantum_frozen,
                                                model.decode_paged_steps)
        elif getattr(model, "forward_paged", None) is not None:
            self._decode_fn = functools.partial(_decode_quantum, model.forward_paged)
        else:
            raise ValueError(f"{model_config.model_type}: the batcher needs the "
                             f"model's decode_paged_steps or forward_paged")
        self.dtype = resolve_dtype(sc.dtype)
        if sc.kv_cache_dtype in ("auto", None):
            self.kv_dtype = self.dtype
        elif sc.kv_cache_dtype in _FP8_NAMES:
            self.kv_dtype = torch.float8_e4m3fn
        else:
            self.kv_dtype = resolve_dtype(sc.kv_cache_dtype)
        self.device = params_device(params)
        # the model config the kernels see: this rank's shard under a mesh
        self._run_cfg = model_config
        self._mesh = None
        self._dp, self._dp_index, self._dp_group, self._sp = 1, 0, None, 1
        if sc.mesh_shape is not None:
            self._shard(sc.mesh_shape)
        check_kernel_shapes(self._run_cfg, self.device)
        self._rows_per_shard = sc.batch_capacity // self._dp
        self.state: PagedKVState = create_paged_state(
            self._run_cfg, sc.n_blocks // self._dp, sc.block_size, self._rows_per_shard,
            sc.max_blocks_per_seq, dtype=self.kv_dtype, device=self.device,
        )
        # block bookkeeping + prefix index, one a dp shard over its local ids
        self.allocators = [create_pool_index(sc.n_blocks // self._dp)
                           for _ in range(self._dp)]
        self.allocator = self.allocators[0]
        self.waiting: List[Request] = []
        self._admitting: Optional[Request] = None  # chunked prefill
        self.running: Dict[int, Request] = {}  # row -> Request
        self.free_rows = list(range(sc.batch_capacity - 1, -1, -1))
        # pipelined decode: the issued-but-unread quantum and the device-
        # resident chained input tokens for the next one
        self._inflight = None
        self._tokens_dev: Optional[torch.Tensor] = None
        self._gen = torch.Generator(device=self.device).manual_seed(
            sc.seed + self._dp_index)
        # sampler params and pool metadata are re-uploaded only when they
        # changed
        self._meta_dirty = True
        self._sampler_dirty = True
        self._sampler_dev = None
        # speculative quanta run when asked for and the model has them
        self._spec = (sc.speculative == "ngram"
                      and getattr(model, "decode_paged_spec_steps", None) is not None)
        # speculative telemetry: emitted tokens against verify forwards (mean
        # accepted drafts per verify = emitted / verifies - 1)
        self.spec_emitted = 0
        self.spec_verifies = 0
        # the counters of the module docstring, and the sequence number of
        # the last quantum issued (plain or speculative), spans' `q`
        self.stats = dict(admissions=0, quanta=0, decode_steps=0, row_steps=0,
                          kv_slots=0)
        self._q = 0
        # auto-off policy state (SchedulerConfig.spec_auto_off)
        self._spec_disabled = False
        self._spec_win_emitted = 0
        self._spec_win_verifies = 0
        self._spec_low_windows = 0
        self._plain_since_probe = 0
        # True while the current window was opened by a re-probe: a low probe
        # window disables after ONE window (its draft context is warm)
        self._spec_probing = False
        # host mirrors of device state
        self._tables = np.zeros((sc.batch_capacity, sc.max_blocks_per_seq),
                                np.int32)
        self._lengths = np.zeros(sc.batch_capacity, np.int32)
        self._starts = np.zeros(sc.batch_capacity, np.int32)
        self._active = np.zeros(sc.batch_capacity, bool)
        self._tokens = np.zeros(sc.batch_capacity, np.int32)
        self._temps = np.zeros(sc.batch_capacity, np.float32)
        self._topks = np.zeros(sc.batch_capacity, np.int32)
        self._topps = np.ones(sc.batch_capacity, np.float32)
        self._minps = np.zeros(sc.batch_capacity, np.float32)

    def _shard(self, mesh_shape) -> None:
        """Keep this rank's shard of the params on the mesh (module
        docstring)."""
        sc = self.sc
        shape = tuple(mesh_shape)
        if len(shape) == 2:  # (dp, tp)
            shape = (shape[0], 1, shape[1])
        check_world(shape)
        dp, sp, pp, tp = mesh_dims(shape)
        if pp != 1:
            raise ValueError("the batcher takes a (dp, sp, tp) mesh: no pipeline stages")
        if dp > 1:
            if sc.batch_capacity % dp:
                raise ValueError("batch_capacity must divide by dp")
            if sc.n_blocks % dp:
                raise ValueError("n_blocks must divide by dp")
            if getattr(self.model, "decode_paged_steps", None) is None:
                raise ValueError("dp serving needs the frozen-quantum model path "
                                 "(decode_paged_steps)")
        self._mesh = make_mesh(n_devices=dp * sp * tp, dp=dp, sp=sp, tp=tp)
        if "shard" in self.params:
            # already this rank's shard (an engine's, prepared on the same mesh)
            self._run_cfg = local_config(self.cfg, self.params["shard"])
        else:
            self.params, self._run_cfg = shard_model(self.params, self.cfg, self._mesh)
        self._dp, self._sp = dp, sp
        self._dp_index = self._mesh.index("dp")
        self._dp_group = self._mesh.group("dp")
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        log.info("batcher rank %d of mesh dp=%d sp=%d tp=%d", world()[0], dp, sp, tp)

    def _shard_of(self, row: int) -> int:
        return row // self._rows_per_shard

    def _alloc_of(self, row: int):
        return self.allocators[self._shard_of(row)]

    def _owns(self, row: int) -> bool:
        """Whether this rank holds `row` (its dp shard's)."""
        return self._shard_of(row) == self._dp_index

    def _rows(self, x: np.ndarray) -> np.ndarray:
        """This rank's dp shard of a row-major host mirror."""
        n = self._rows_per_shard
        return x[self._dp_index * n : (self._dp_index + 1) * n]

    def _all_rows(self, t: torch.Tensor) -> torch.Tensor:
        """[..., B/dp] of this shard's rows -> [..., B] (the dp all-gather)."""
        return all_gather(t, self._dp_group, dim=-1)

    def _owner_token(self, row: int, tok: Optional[torch.Tensor]) -> torch.Tensor:
        """An admission's first token [1] int32 on every rank: the owning
        shard sampled it; the others receive it over dp."""
        if self._dp == 1:
            return tok
        if tok is None:
            tok = torch.zeros(1, dtype=torch.int32, device=self.device)
        return broadcast(tok.to(torch.int32), self._mesh.src(dp=self._shard_of(row)),
                         self._dp_group)

    # -- host <-> device ----------------------------------------------------

    def _put(self, x) -> torch.Tensor:
        """A FRESH copy of host data on the device. On a card it goes
        through its own pinned buffer with non_blocking, so the upload
        neither waits for the queued work nor reads host memory that is
        mutated later (the host mirrors change right after a dispatch)."""
        t = torch.from_numpy(np.array(x, copy=True))
        if self.device.type != "cuda":
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _start_fetch(self, t: torch.Tensor):
        """Queue a device -> host copy of `t` behind the work issued so
        far; _finish_fetch waits for that copy alone, not for the work
        issued after it."""
        if self.device.type != "cuda":
            return t, None
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return buf, ev

    @staticmethod
    def _finish_fetch(handle) -> np.ndarray:
        buf, ev = handle
        if ev is not None:
            ev.synchronize()
        return buf.numpy()

    # -- public API -------------------------------------------------------

    def add_request(self, req: Request) -> None:
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running
                    or self._admitting is not None
                    or self._inflight is not None)

    @property
    def n_running(self) -> int:
        return len(self.running)

    def step(self) -> List[TokenEvent]:
        """Admit (prefill — whole or one chunk) if possible, then decode."""
        with span("tg.step"):
            return self._step()

    def _step(self) -> List[TokenEvent]:
        events: List[TokenEvent] = []
        if (self._admitting is not None or self.waiting
                or not self.running):
            # admissions (and idle wrap-up) need host state in sync; a
            # drain may also free rows/blocks the admission needs
            events.extend(self._drain_inflight())
        if self._admitting is not None:
            events.extend(self._continue_admission())
            if self.running:
                events.extend(self._decode())
            return events
        if self.waiting and self.free_rows:
            req = self.waiting[0]
            if self.sc.prefill_chunk_tokens > 0:
                if self._start_admission(req):
                    self.waiting.pop(0)
                    events.extend(self._continue_admission())
                elif req.finished:
                    self.waiting.pop(0)
                    events.append(TokenEvent(
                        req.request_id, None, True, req.finish_reason
                    ))
                if self.running:
                    events.extend(self._decode())
                return events
            admitted: List[Request] = []
            while self.waiting and self.free_rows:
                req = self.waiting[0]
                if self._try_admit(req):
                    self.waiting.pop(0)
                    admitted.append(req)
                    continue
                if req.finished:  # rejected outright (too long)
                    self.waiting.pop(0)
                    events.append(TokenEvent(
                        req.request_id, None, True, req.finish_reason
                    ))
                    continue
                break  # no memory yet — stay queued
            if admitted:
                # one read-back for the whole admission burst
                for req in admitted:
                    with span("tg.admit.readback", rid=req.request_id):
                        tok = int(req._pending_token.cpu()[0])
                    req._pending_token = None
                    if req.row >= 0:
                        self._tokens[req.row] = tok
                    events.extend(self._emit(req, tok))
                return events
        if self.running:
            events.extend(self._decode())
        return events

    def release(self, req: Request) -> None:
        if req.row >= 0:
            # blocks registered in the prefix cache survive as idle-cached
            # (reclaimed LRU when the pool runs dry)
            alloc = self._alloc_of(req.row)
            keep = [b for b in req.blocks if alloc.is_registered(b)]
            alloc.release(req.blocks, keep_cached=keep)
            req.blocks = []
            self._active[req.row] = False
            # an empty pool range: K8 reads nothing for the inactive row, and
            # no stale length past the context reaches the RoPE gather
            self._lengths[req.row] = 0
            self._starts[req.row] = 0
            self._meta_dirty = True  # device must stop writing this row
            self.running.pop(req.row, None)
            self.free_rows.append(req.row)
            req.row = -1

    def cancel(self, request_id: int) -> None:
        self._drain_inflight()
        self.waiting = [r for r in self.waiting
                        if r.request_id != request_id]
        if (self._admitting is not None
                and self._admitting.request_id == request_id):
            req = self._admitting
            self._admitting = None
            req.finished = True
            req.finish_reason = "abort"
            alloc = self._alloc_of(req.row)
            keep = [b for b in req.blocks if alloc.is_registered(b)]
            alloc.release(req.blocks, keep_cached=keep)
            req.blocks = []
            if req.row >= 0:
                self.free_rows.append(req.row)
                req.row = -1
        for row, req in list(self.running.items()):
            if req.request_id == request_id:
                req.finished = True
                req.finish_reason = "abort"
                self.release(req)
        self._meta_dirty = True

    # -- admission / prefill ----------------------------------------------

    def _block_hashes(self, prompt_ids: List[int]) -> List[int]:
        """Chain hashes for each COMPLETE block of the prompt: h_j commits
        to every token in blocks 0..j (content addressing). SHA-256
        truncated to 128 bits, the JAX package's digests exactly — not
        Python's hash(), which is trivially collidable: a crafted
        collision would alias another prompt's K/V block."""
        bs = self.sc.block_size
        out: List[int] = []
        h = b"\x00" * 16
        for j in range(len(prompt_ids) // bs):
            chunk = np.asarray(
                prompt_ids[j * bs : (j + 1) * bs], np.int64
            ).tobytes()
            h = hashlib.sha256(h + chunk).digest()[:16]
            out.append(int.from_bytes(h, "little"))
        return out

    def _sampler_inputs(self, s: SamplerConfig):
        temp, topk, topp, minp = _sampler_row(s)
        return (self._put(np.asarray([temp], np.float32)),
                self._put(np.asarray([topk], np.int32)),
                self._put(np.asarray([topp], np.float32)),
                self._put(np.asarray([minp], np.float32)))

    def _set_row(self, row: int, req: Request) -> None:
        """Host bookkeeping of a row whose prompt is now in the pool:
        trailing padding, so starts = 0 and length = the prompt's."""
        self._tables[row] = 0
        self._tables[row, : len(req.blocks)] = req.blocks
        self._lengths[row] = len(req.prompt_ids)
        self._starts[row] = 0
        self._active[row] = True
        self._tokens_dev = None  # host mirrors are authoritative again
        (self._temps[row], self._topks[row], self._topps[row],
         self._minps[row]) = _sampler_row(req.sampler)
        self._sampler_dirty = True
        self._sync_state_meta()

    def _prompt_inputs(self, tokens: List[int], pos0: int, S_in: int):
        """Trailing-padded ids, positions and validity [1, S_in] of
        `tokens` starting at logical position pos0 (slot == position)."""
        n = len(tokens)
        ids = np.zeros((1, S_in), np.int32)  # S_in: a multiple of sp
        ids[0, :n] = tokens
        valid = np.zeros((1, S_in), bool)
        valid[0, :n] = True
        positions = np.zeros((1, S_in), np.int32)
        positions[0, :n] = pos0 + np.arange(n)
        return self._put(ids), self._put(positions), self._put(valid)

    def _try_admit(self, req: Request) -> bool:
        """Admit one request: reuse any cached prefix blocks (read-only,
        refcounted), prefill ONLY the suffix into a trailing-padded dense
        cache seeded with the prefix K/V, scatter the new whole blocks
        into the pool, and register them in the prefix cache.

        Prompts are trailing-padded (slot == logical position for every
        row), which is what makes block contents pad-independent and
        therefore shareable across prompts of different lengths."""
        with span("tg.admit", rid=req.request_id, prompt=len(req.prompt_ids)):
            return self._admit(req)

    def _admit(self, req: Request) -> bool:
        sc = self.sc
        bs = sc.block_size
        S = len(req.prompt_ids)
        if blocks_needed(S + req.max_new_tokens, bs) > sc.max_blocks_per_seq:
            req.finished = True
            req.finish_reason = "length"
            return False

        hashes = self._block_hashes(req.prompt_ids)
        n_shareable = min(len(hashes), (S - 1) // bs)
        # under dp, rows and blocks live in per-shard partitions: try one
        # free row of each shard (pop order) until a shard can hold the
        # prompt (prefix reuse is shard-local); same-shard rows share an
        # allocator, so retrying them would repeat the same lookups
        seen, cands = set(), []
        for cand in reversed(self.free_rows):
            if self._shard_of(cand) not in seen:
                seen.add(self._shard_of(cand))
                cands.append(cand)
        row = None
        for cand in cands:
            alloc = self._alloc_of(cand)
            # longest cached block prefix, leaving >= 1 token to prefill.
            # share() PINS the looked-up blocks at once: alloc()'s LRU
            # reclaim could otherwise evict an idle-cached prefix block just
            # found and hand it back as this request's private suffix block
            # (the same physical block twice in the table).
            shared: List[int] = []
            if sc.enable_prefix_cache:
                for j in range(n_shareable):
                    b = alloc.lookup_prefix(hashes[j])
                    if b is None:
                        break
                    shared.append(b)
            alloc.share(shared)
            p_len = len(shared) * bs
            suffix = req.prompt_ids[p_len:]
            S_suf = len(suffix)
            private = alloc.alloc(blocks_needed(S_suf, bs))
            if private is not None:
                row = cand
                break
            # no memory in this shard: unpin the prefix back to the
            # idle-cached tier so it stays reclaimable
            keep = [b for b in shared if alloc.is_registered(b)]
            alloc.release(shared, keep_cached=keep)
        if row is None:
            return False
        self.free_rows.remove(row)
        req.row = row
        req.blocks = shared + private
        self.running[row] = req
        note(prefix=p_len)

        unit = math.lcm(sc.prefill_bucket, bs, self._sp)
        S_in = max(unit, _round_to(S_suf, unit))  # padded suffix input
        tok_dev = None
        if self._owns(row):
            ids, positions, valid = self._prompt_inputs(suffix, p_len, S_in)
            self.stats["admissions"] += 1
            with span("tg.admit.prefill", rid=req.request_id):
                tok_dev = _admit_program(
                    self.model.forward, self.params, self._run_cfg, self.state,
                    self._put(np.asarray(shared, np.int64)),
                    self._put(np.asarray(private, np.int64)),
                    ids, positions, valid, self._put(np.asarray([S_suf - 1], np.int64)),
                    self._sampler_inputs(req.sampler), self._gen,
                    attn_impl=sc.attn_impl, block_size=bs,
                )
        tok_dev = self._owner_token(row, tok_dev)
        # register newly completed whole blocks for future reuse
        if sc.enable_prefix_cache:
            for j in range(len(shared), len(hashes)):
                alloc.register_prefix(hashes[j], req.blocks[j])
        self._set_row(row, req)
        req._pending_token = tok_dev  # read in step() after the burst
        return True

    # -- chunked admission --------------------------------------------------

    def _start_admission(self, req: Request) -> bool:
        """Begin chunked admission: upfront feasibility + prefix lookup.
        Returns True when `req` became the in-flight admission."""
        sc = self.sc
        bs = sc.block_size
        S = len(req.prompt_ids)
        need = blocks_needed(S + req.max_new_tokens, bs)
        # capacity is per shard under dp (n_blocks/dp local blocks with
        # their null block): a global check would admit a request no shard
        # can ever hold
        if need > sc.max_blocks_per_seq or need > sc.n_blocks // self._dp - 1:
            req.finished = True
            req.finish_reason = "length"
            return False
        hashes = self._block_hashes(req.prompt_ids)
        n_shareable = min(len(hashes), (S - 1) // bs)
        # the row fixes the shard, whose allocator serves every chunk:
        # prefer a shard that can hold the whole request, else the one with
        # the most reclaimable space
        def capacity(r):
            a = self._alloc_of(r)
            return a.n_free + a.n_idle_cached

        row = self.free_rows[-1]
        if self._dp > 1:
            row = max(reversed(self.free_rows), key=capacity)
            for cand in reversed(self.free_rows):
                if capacity(cand) >= need:
                    row = cand
                    break
        self.free_rows.remove(row)
        req.row = row
        alloc = self._alloc_of(row)
        shared: List[int] = []
        if sc.enable_prefix_cache:
            for j in range(n_shareable):
                b = alloc.lookup_prefix(hashes[j])
                if b is None:
                    break
                shared.append(b)
        alloc.share(shared)
        req.blocks = list(shared)
        req._chunk_pos = len(shared) * bs  # tokens already in the pool
        req._hashes = hashes
        self._admitting = req
        return True

    def _continue_admission(self) -> List[TokenEvent]:
        """Prefill ONE chunk of the in-flight admission; finalize on the
        last chunk. Chunks start block-aligned (sizes are lcm multiples);
        the chunk program gathers the request's blocks so far into a
        fixed-size dense workspace."""
        req = self._admitting
        with span("tg.admit", rid=req.request_id, prompt=len(req.prompt_ids),
                  prefix=req._chunk_pos):
            return self._admit_chunk(req)

    def _admit_chunk(self, req: Request) -> List[TokenEvent]:
        sc = self.sc
        bs = sc.block_size
        S = len(req.prompt_ids)
        unit = math.lcm(sc.prefill_bucket, bs, self._sp)
        chunk_cap = max(unit, _round_to(sc.prefill_chunk_tokens, unit))
        pos0 = req._chunk_pos
        n_tok = min(chunk_cap, S - pos0)
        final = pos0 + n_tok >= S

        alloc = self._alloc_of(req.row)
        private = alloc.alloc(blocks_needed(n_tok, bs))
        if private is None:
            return []  # pool pressure: stay admitting, decode continues
        req.blocks.extend(private)

        S_in = max(unit, _round_to(n_tok, unit))
        tok_dev = None
        if self._owns(req.row):
            ids, positions, valid = self._prompt_inputs(
                req.prompt_ids[pos0 : pos0 + n_tok], pos0, S_in)
            table = np.zeros(sc.max_blocks_per_seq, np.int64)
            table[: len(req.blocks)] = req.blocks
            self.stats["admissions"] += 1
            with span("tg.admit.prefill", rid=req.request_id):
                tok_dev = _admit_chunk_program(
                    self.model.forward, self.params, self._run_cfg, self.state,
                    self._put(table), pos0, self._put(np.asarray(private, np.int64)),
                    ids, positions, valid, self._put(np.asarray([n_tok - 1], np.int64)),
                    self._sampler_inputs(req.sampler), self._gen,
                    attn_impl=sc.attn_impl, block_size=bs,
                )
        tok_dev = self._owner_token(req.row, tok_dev)
        req._chunk_pos = pos0 + n_tok
        if not final:
            return []

        # finalize: row bookkeeping, registration, first-token event
        self._admitting = None
        if sc.enable_prefix_cache:
            for j in range(len(req._hashes)):
                alloc.register_prefix(req._hashes[j], req.blocks[j])
        with span("tg.admit.readback", rid=req.request_id):
            tok = int(tok_dev.cpu()[0])
        row = req.row  # reserved at _start_admission
        self.running[row] = req
        self._set_row(row, req)
        self._tokens[row] = tok
        return self._emit(req, tok)

    # -- decode ------------------------------------------------------------

    def _ensure_blocks(self, n_steps: int) -> Dict[int, int]:
        """Reserve blocks covering the next n_steps slots per active row.
        Returns row -> safe step count (how many of the quantum's steps
        have owned storage)."""
        sc = self.sc
        safe: Dict[int, int] = {}
        for row, req in list(self.running.items()):
            length = int(self._lengths[row])
            first_blk = length // sc.block_size
            last_blk = (length + n_steps - 1) // sc.block_size
            covered_until = length  # exclusive slot bound with owned blocks
            for blk_idx in range(first_blk, last_blk + 1):
                if blk_idx >= sc.max_blocks_per_seq:
                    break
                if blk_idx >= len(req.blocks):
                    got = self._alloc_of(row).alloc(1)
                    if got is None:
                        break
                    req.blocks.extend(got)
                    self._tables[row, blk_idx] = got[0]
                    self._meta_dirty = True
                covered_until = (blk_idx + 1) * sc.block_size
            safe[row] = min(n_steps, covered_until - length)
        return safe

    def _sampler_params_dev(self):
        """Device copies of the per-row sampler params, re-uploaded only
        when an admission changed them."""
        if self._sampler_dirty or self._sampler_dev is None:
            self._sampler_dev = tuple(self._put(self._rows(a)) for a in (
                self._temps, self._topks, self._topps, self._minps))
            self._sampler_dirty = False
        return self._sampler_dev

    def _spec_eligible(self) -> bool:
        """Whether this quantum speculates: speculation is on and rows are
        live, unless the auto-off policy has fallen back to plain quanta;
        then every spec_probe_every-th call re-opens one probe window."""
        if not self._spec or not self.running:
            return False
        if self._spec_disabled:
            self._plain_since_probe += 1
            if self._plain_since_probe >= max(1, self.sc.spec_probe_every):
                self._spec_disabled = False
                self._plain_since_probe = 0
                self._spec_win_emitted = 0
                self._spec_win_verifies = 0
                self._spec_probing = True
                log.info("speculation re-probe after %d plain quanta",
                         self.sc.spec_probe_every)
                return True
            return False
        return True

    def _spec_policy_update(self, emitted: int, verifies: int) -> None:
        """Feeds one quantum's telemetry into the auto-off window. A cold
        start needs two consecutive low windows to disable (the first has
        the least context to draft from); a re-probe window needs one."""
        if not self.sc.spec_auto_off:
            return
        self._spec_win_emitted += emitted
        self._spec_win_verifies += verifies
        if self._spec_win_verifies < max(1, self.sc.spec_window):
            return
        accept = self._spec_win_emitted / self._spec_win_verifies - 1.0
        self._spec_win_emitted = 0
        self._spec_win_verifies = 0
        probing, self._spec_probing = self._spec_probing, False
        if accept < self.sc.spec_min_acceptance:
            self._spec_low_windows += 1
            if self._spec_low_windows < 2 and not probing:
                return
            self._spec_disabled = True
            self._spec_low_windows = 0
            self._plain_since_probe = 0
            log.info("speculation auto-off: acceptance %.2f < %.2f over %d verifies "
                     "(re-probe every %d quanta)", accept, self.sc.spec_min_acceptance,
                     self.sc.spec_window, self.sc.spec_probe_every)
        else:
            self._spec_low_windows = 0

    def _all_greedy(self) -> bool:
        rows = list(self.running.keys())
        return bool(np.all(self._temps[rows] == 0.0))

    @property
    def spec_acceptance(self) -> float:
        """Mean accepted drafts per verify forward (0 before any); a
        verify reads the weights once, so a row's speedup is about
        1 + spec_acceptance."""
        if not self.spec_verifies:
            return 0.0
        return self.spec_emitted / self.spec_verifies - 1.0

    def _decode_spec(self) -> List[TokenEvent]:
        """One speculative quantum: R rounds of (gamma + 1)-token verify
        (causal_lm.decode_paged_spec_steps). A row may write R * (gamma + 1)
        slots; a row without that much owned storage emits up to its safe
        count and finishes by length, as in the plain quantum. The quantum's
        tokens, counts and next inputs come back in one fetch."""
        events: List[TokenEvent] = []
        sc = self.sc
        gamma = max(1, sc.spec_draft_len)
        S = gamma + 1
        n_rounds = max(1, sc.decode_quantum // S)
        worst = n_rounds * S
        safe = self._ensure_blocks(worst)
        for row, m in list(safe.items()):
            if m <= 0:
                req = self.running[row]
                req.finished = True
                req.finish_reason = "length"
                events.append(TokenEvent(req.request_id, None, True, "length"))
                self.release(req)
                safe.pop(row)
        if not self.running:
            return events
        self._sync_state_meta()
        # each row's draft context: prompt + generated, the current input last
        C = max(sc.spec_ctx, 2 * worst + sc.spec_ngram + 2)
        B = sc.batch_capacity
        ctx = np.zeros((B, C), np.int32)
        clen = np.zeros(B, np.int32)
        for row, req in self.running.items():
            toks = (req.prompt_ids + req.generated)[-C:]
            ctx[row, : len(toks)] = toks
            clen[row] = len(toks)
        sampler = None if self._all_greedy() else self._sampler_params_dev()
        self._q += 1
        with span("tg.decode.issue", q=self._q, rows=len(safe), steps=n_rounds):
            packed = _decode_quantum_spec(
                self.model.decode_paged_spec_steps, self.params, self._run_cfg, self.state,
                self._put(self._rows(self._tokens)), self._put(self._rows(ctx)),
                self._put(self._rows(clen)), sampler, self._gen,
                n_rounds=n_rounds, gamma=gamma, ngram=max(1, sc.spec_ngram),
                attn_impl=sc.attn_impl)
        # every dp shard's packed rows, shard by shard
        fetch = self._start_fetch(all_gather(packed, self._dp_group))
        with span("tg.decode.readback", q=self._q):
            flat = self._finish_fetch(fetch).reshape(self._dp, -1)
        Bl = B // self._dp
        n_tok = n_rounds * Bl * S
        toks_h = np.concatenate([f[:n_tok].reshape(n_rounds, Bl, S) for f in flat], axis=1)
        counts_h = np.concatenate(
            [f[n_tok : n_tok + n_rounds * Bl].reshape(n_rounds, Bl) for f in flat], axis=1)
        cur_h = np.concatenate([f[n_tok + n_rounds * Bl :] for f in flat])
        for row, req in list(self.running.items()):
            budget = safe.get(row, 0)
            emitted = 0
            for r in range(n_rounds):
                if req.finished:
                    break
                for i in range(int(counts_h[r, row])):
                    if req.finished:
                        break
                    if emitted >= budget:
                        # the device wrote past this row's owned blocks (the
                        # scatter clamps to the table's last entry): finish it
                        req.finished = True
                        req.finish_reason = "length"
                        events.append(TokenEvent(req.request_id, None, True, "length"))
                        self.release(req)
                        break
                    tok = int(toks_h[r, row, i])
                    self._tokens[row] = tok
                    events.extend(self._emit(req, tok))
                    emitted += 1
            if not req.finished:
                self._lengths[row] += int(counts_h[:, row].sum())
                self._tokens[row] = int(cur_h[row])
        n_emitted, n_verifies = int(counts_h.sum()), n_rounds * len(safe)
        self.spec_emitted += n_emitted
        self.spec_verifies += n_verifies
        self._spec_policy_update(n_emitted, n_verifies)
        # host lengths re-derived from the device counts: re-upload next time
        self._meta_dirty = True
        return events

    def _decode(self) -> List[TokenEvent]:
        if self._spec_eligible():
            # the pipelined plain quantum is read first: the spec quantum
            # drafts from the host's view of every row's context
            events = self._drain_inflight()
            if not self.running:
                return events
            events.extend(self._decode_spec())
            self._tokens_dev = None
            return events
        events: List[TokenEvent] = []
        n_steps = max(1, self.sc.decode_quantum)
        safe = self._ensure_blocks(n_steps)
        if any(m <= 0 for m in safe.values()):
            # pool exhausted for some rows: their pending tokens must be
            # delivered before finishing them (and drains may free blocks)
            events.extend(self._drain_inflight())
            safe = self._ensure_blocks(n_steps)
            for row, m in list(safe.items()):
                if m <= 0 and row in self.running:
                    req = self.running[row]
                    req.finished = True
                    req.finish_reason = "length"
                    events.append(TokenEvent(req.request_id, None, True,
                                             "length"))
                    self.release(req)
                    safe.pop(row)
        if not self.running:
            events.extend(self._drain_inflight())
            return events
        if self._meta_dirty:
            # the quantum advances state.lengths exactly as the host mirror
            # does (lengths0 + n_steps * active) and leaves tables, starts
            # and active alone, so an unchanged-membership quantum needs no
            # re-upload of the metadata
            self._sync_state_meta()
        rows_live = list(self.running.keys())
        all_greedy = bool(np.all(self._temps[rows_live] == 0.0))
        # chained input tokens stay ON THE DEVICE between pipelined quanta
        tok_in = (self._tokens_dev if self._tokens_dev is not None
                  else self._put(self._rows(self._tokens)))
        n_rows = len(rows_live)
        st = self.stats
        st["quanta"] += 1
        st["decode_steps"] += n_steps
        st["row_steps"] += n_rows * n_steps
        st["kv_slots"] += (n_steps * int(np.sum(self._lengths[rows_live]))
                           + n_rows * n_steps * (n_steps + 1) // 2)
        self._q += 1
        with span("tg.decode.issue", q=self._q, rows=n_rows, steps=n_steps):
            toks_seq = self._decode_fn(
                self.params, self._run_cfg, self.state, tok_in, self._sampler_params_dev(),
                self._gen, n_steps=n_steps, all_greedy=all_greedy,
                attn_impl=self.sc.attn_impl,
            )
        self._lengths[self._active] += n_steps
        snapshot = {row: (self.running[row], safe.get(row, 0))
                    for row in rows_live}
        prev, self._inflight = self._inflight, (
            self._start_fetch(self._all_rows(toks_seq)), n_steps, snapshot, self._q)
        self._tokens_dev = toks_seq[-1]  # this shard's rows
        if prev is not None:
            # read the PREVIOUS quantum while this one executes
            events.extend(self._process_quantum(prev))
        if not self.sc.pipeline_quanta:
            events.extend(self._drain_inflight())
        return events

    def _drain_inflight(self) -> List[TokenEvent]:
        if self._inflight is None:
            return []
        prev, self._inflight = self._inflight, None
        with span("tg.drain", q=prev[3]):
            return self._process_quantum(prev)

    def _process_quantum(self, inflight) -> List[TokenEvent]:
        """Read one issued quantum's tokens and emit its events. Rows
        released here may have been written by an ALREADY-ISSUED next
        quantum — harmless: the stream is ordered, so a later admission's
        prefill overwrites those slots after the stale writes, and
        registered prefix blocks are never written by decode (slots past
        the prompt land in later blocks)."""
        fetch, n_steps, snapshot, q = inflight
        events: List[TokenEvent] = []
        with span("tg.decode.readback", q=q):
            toks_host = self._finish_fetch(fetch)  # [n_steps, B]
        with span("tg.decode.emit", q=q):
            for row, (req, m) in snapshot.items():
                for step in range(n_steps):
                    if req.finished:
                        break
                    if step >= m:
                        # ran out of owned storage mid-quantum: pool exhausted
                        req.finished = True
                        req.finish_reason = "length"
                        events.append(TokenEvent(req.request_id, None, True,
                                                 "length"))
                        self.release(req)
                        break
                    tok = int(toks_host[step, row])
                    self._tokens[row] = tok
                    events.extend(self._emit(req, tok))
        return events

    def _emit(self, req: Request, tok: Optional[int]) -> List[TokenEvent]:
        """Process one sampled token for a request into events."""
        if tok is None:
            return []
        stops = self.eos_ids | req.stop_token_ids
        if tok in stops:
            req.finished = True
            req.finish_reason = "stop"
            self.release(req)
            return [TokenEvent(req.request_id, None, True, "stop")]
        req.generated.append(tok)
        if len(req.generated) >= req.max_new_tokens:
            req.finished = True
            req.finish_reason = "length"
            self.release(req)
            return [TokenEvent(req.request_id, tok, True, "length")]
        return [TokenEvent(req.request_id, tok, False)]

    def _sync_state_meta(self) -> None:
        """Upload the small host-side metadata arrays, each as a fresh
        tensor (see _put): the host mirrors are mutated right after the
        dispatch, and an upload that aliased them would let a queued
        quantum read the later values."""
        self.state.block_tables = self._put(self._rows(self._tables))
        self.state.lengths = self._put(self._rows(self._lengths))
        self.state.starts = self._put(self._rows(self._starts))
        self.state.active = self._put(self._rows(self._active))
        self._meta_dirty = False


# -- the device programs ------------------------------------------------------


def _admit_program(forward, params, cfg, state: PagedKVState, shared, private,
                   ids, positions, valid, last_pos, sampler, generator, *,
                   attn_impl: str, block_size: int) -> torch.Tensor:
    """The whole admission: gather the shared prefix blocks into a fresh
    dense cache, prefill the suffix, scatter its K/V into the private
    blocks, sample the first token. Returns it as a device [1] tensor."""
    bs = block_size
    p_len = shared.shape[0] * bs
    n_private = private.shape[0]
    cache = create_kv_cache(cfg, 1, p_len + ids.shape[1],
                            dtype=state.k_pool.dtype, device=state.k_pool.device)
    if p_len:
        _seed_dense_from_pool(cache, state, shared, bs)
    logits, cache = forward(params, cfg, ids, cache, positions, valid,
                            last_only=True, attn_impl=attn_impl,
                            last_pos=last_pos)
    end = p_len + n_private * bs
    _scatter_prefill(state, cache.k[:, 0, :, p_len:end],
                     cache.v[:, 0, :, p_len:end], private, bs)
    return sample_batched(logits[:, -1, :], *sampler, generator)


def _admit_chunk_program(forward, params, cfg, state: PagedKVState, table,
                         p_len: int, private, ids, positions, valid, last_pos,
                         sampler, generator, *, attn_impl: str,
                         block_size: int) -> torch.Tensor:
    """One CHUNK of an admission. The request's full (padded) block table
    is gathered into a dense workspace of max_blocks*bs + S_in slots, of
    which the first p_len (the tokens already in the pool) are valid; the
    chunk is prefilled at slot p_len and its blocks scattered. Returns
    the token sampled after the chunk's last token."""
    bs = block_size
    MB = table.shape[0]
    T_dense = MB * bs + ids.shape[1]
    dev = state.k_pool.device
    cache = create_kv_cache(cfg, 1, T_dense, dtype=state.k_pool.dtype, device=dev)
    k_g, v_g = _gather_table(state, table)  # [L, Nk, MB*bs, D]
    cache.k[:, 0, :, : MB * bs] = k_g
    cache.v[:, 0, :, : MB * bs] = v_g
    idx = torch.arange(T_dense, dtype=torch.int32, device=dev)[None, :]
    cache.kv_pos.copy_(idx)
    cache.valid.copy_(idx < p_len)
    cache.length = p_len
    logits, cache = forward(params, cfg, ids, cache, positions, valid,
                            last_only=True, attn_impl=attn_impl,
                            last_pos=last_pos)
    end = p_len + private.shape[0] * bs
    _scatter_prefill(state, cache.k[:, 0, :, p_len:end],
                     cache.v[:, 0, :, p_len:end], private, bs)
    return sample_batched(logits[:, -1, :], *sampler, generator)


def _gather_table(state: PagedKVState, table: torch.Tensor):
    """Pool blocks by (padded) table -> dense [L, Nk, n*bs, D] K and V."""
    def g(pool):
        x = pool[:, table]  # [L, n, Nk, bs, D]
        L, n, Nk, bs, D = x.shape
        return x.permute(0, 2, 1, 3, 4).reshape(L, Nk, n * bs, D)

    return g(state.k_pool), g(state.v_pool)


def _seed_dense_from_pool(cache: KVCache, state: PagedKVState,
                          blocks: torch.Tensor, block_size: int) -> None:
    """Gather shared prefix blocks from the pool into the head of a dense
    cache, in place (the inverse of _scatter_prefill): slots
    [0, n_blk*block_size) get the prefix K/V, with slot == position."""
    p_len = blocks.shape[0] * block_size
    k, v = _gather_table(state, blocks)
    cache.k[:, 0, :, :p_len] = k
    cache.v[:, 0, :, :p_len] = v
    cache.kv_pos[:, :p_len] = torch.arange(p_len, dtype=torch.int32,
                                           device=blocks.device)
    cache.valid[:, :p_len] = True
    cache.length = p_len


def _scatter_prefill(state: PagedKVState, k_dense: torch.Tensor,
                     v_dense: torch.Tensor, blocks: torch.Tensor,
                     block_size: int) -> None:
    """Copy dense prefill K/V [L, Nk, n*bs, D] into pool blocks, in place."""
    L, Nk, _, D = k_dense.shape
    n_blk = blocks.shape[0]

    def to_blocks(x):
        return (x.reshape(L, Nk, n_blk, block_size, D)
                .permute(0, 2, 1, 3, 4).to(state.k_pool.dtype))

    state.k_pool[:, blocks] = to_blocks(k_dense)
    state.v_pool[:, blocks] = to_blocks(v_dense)


def _sample_fn(all_greedy: bool, sampler, generator):
    """logits [B, V] -> tokens [B] int32: all-greedy quanta sample by
    argmax alone (the per-row sampler sorts [B, V] each step)."""
    if all_greedy:
        return lambda lg: torch.argmax(lg, dim=-1).to(torch.int32)
    return lambda lg: sample_batched(lg, *sampler, generator)


def _decode_quantum_frozen(decode_paged_steps, params, cfg, state: PagedKVState,
                           tokens: torch.Tensor, sampler, generator, *, n_steps: int,
                           all_greedy: bool, attn_impl: str) -> torch.Tensor:
    """One frozen-pool decode quantum (the model's decode_paged_steps: the
    pools stay frozen, one scatter at the end). Returns the tokens
    [n_steps, B] on the device."""
    return decode_paged_steps(params, cfg, tokens, state, n_steps,
                              _sample_fn(all_greedy, sampler, generator),
                              attn_impl=attn_impl)


def _decode_quantum(forward_paged, params, cfg, state: PagedKVState,
                    tokens: torch.Tensor, sampler, generator, *, n_steps: int,
                    all_greedy: bool, attn_impl: str) -> torch.Tensor:
    """n_steps whole decode steps through the model's forward_paged (each
    layer writes the step's K/V into the pool before attention, K9), for a
    model without decode_paged_steps. Advances `state` exactly as the
    frozen quantum does. Returns the tokens [n_steps, B] on the device."""
    sample_fn = _sample_fn(all_greedy, sampler, generator)
    toks = torch.empty((n_steps, tokens.shape[0]), dtype=torch.int32,
                       device=tokens.device)
    tok = tokens.to(torch.int32)
    for step in range(n_steps):
        logits, state = forward_paged(params, cfg, tok, state, attn_impl=attn_impl)
        tok = sample_fn(logits)
        toks[step] = tok
    return toks


def _decode_quantum_spec(decode_paged_spec_steps, params, cfg, state: PagedKVState,
                         tokens: torch.Tensor, ctx: torch.Tensor, clen: torch.Tensor,
                         sampler, generator, *, n_rounds: int, gamma: int, ngram: int,
                         attn_impl: str) -> torch.Tensor:
    """One speculative quantum (causal_lm.decode_paged_spec_steps): greedy
    prefix acceptance when `sampler` is None (every row greedy), exact
    rejection sampling per row otherwise. Its tokens [R, B, S], counts
    [R, B] and next inputs [B] are packed into one int32 tensor, so that
    the host reads them with a single fetch."""
    toks, counts, cur = decode_paged_spec_steps(
        params, cfg, tokens, state, ctx, clen, n_rounds, gamma, ngram,
        attn_impl=attn_impl, sampler=sampler, generator=generator)
    return torch.cat([toks.reshape(-1), counts.reshape(-1), cur.reshape(-1)]).to(torch.int32)
