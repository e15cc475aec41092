"""GPTEngine: load → encode → prefill → decode → detokenize.

Counterpart of tinygpt_tpu/engine/engine.py: prepare() (model-dir load,
EOS collection from generation_config falling back to the tokenizer,
generation-config sampler defaults unless use_generation_defaults=False),
reconfigure(), left-pad/truncate batch encoding into length buckets,
generate_sync (a batch) and generate_async (one prompt, streamed to a
callback in UTF-8-safe text chunks, with EOS stop and abort).

Both run one loop: a prefill, then chunks of `decode_chunk` (generate_sync)
or `stream_chunk` (generate_async) frozen-cache decode steps
(causal_lm.decode_steps, attention through K2), or at a chunk of 1 the
per-token route (decode_step, each token written straight into the cache,
attention through K13). Chunk k + 1 is launched from the device-resident
last token of chunk k before chunk k is read, up to two chunks ahead.
Each chunk's tokens go to the host through a pinned buffer and an event,
and the launching thread itself hands them to the callback between two
launched steps, once the event has passed: one thread, so the callbacks
never contend with the launches for the interpreter lock, and neither the
read nor the stream's pacing (stream_pace: the JAX engine's min-gap rule)
delays a launch (_HostTokens). A callback that returns False (EOS, abort)
stops the stream at once: nothing is emitted after it, and the chunks
already launched are dropped.

Every family of the registry runs, GPT-2 included. On the card every
attention call goes through the Hopper kernels (ops/attention_kernels.py;
prepare() refuses at once a model whose attention shape they do not take,
ops/attention_kernels.check_kernel_shapes), and with quantization="int8"
or "int4" every
weight matmul through the dequant-matmul kernels (ops/quant_kernels.py);
given device="cpu" the same calls run their plain PyTorch versions.
quantization="int4" runs AWQ by default, as the JAX engine does: prepare()
calibrates on `awq_calib_tokens` tokens of `awq_calib_path` (or the
built-in corpus), folds the scales into the float weights and quantizes
them (ops/awq.py). kv_cache_dtype="fp8" stores the KV cache in e4m3.

speculative="ngram" decodes a single prompt by n-gram speculation: each
round drafts spec_draft_len tokens by prompt lookup on the device and
verifies them in one (spec_draft_len + 1)-token forward over the dense
cache (K1 at the round's first slot); a batch takes the chunked loop, as
the JAX engine does.

mesh_shape=(dp, sp, tp) or (dp, sp, pp, tp) runs the engine as one rank of
an SPMD world (parallel/): one process a rank, each holding its shard of
the weights and of the KV cache and running the same kernels on its local
shapes, with the collectives at the layer boundaries (models/causal_lm.py).
dp cuts the batch (every rank all-gathers the sampled tokens over dp, so
that each host loop sees every row), tp the heads, the MLP and the vocab,
sp the prefill's sequence (and a MoE model's experts); pp > 1 runs
microbatched pipeline stages (parallel/pipeline.py; float llama-family
weights, without sp or speculation). Every rank of a dp shard samples the
same tokens: the same seeded generator on the same gathered logits.
Speculation runs in a single process only; under a mesh a prompt takes
the chunked loop. The mesh must span the whole process group (a mesh
without one raises ValueError), and a rank runs on cuda:{LOCAL_RANK}
unless `device` names an index.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Callable, List, Optional, Sequence, Set

import numpy as np
import torch

from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
from tinygpt_tpu_torch.hf.config import load_model_config
from tinygpt_tpu_torch.hf.loader import GPTContext, load_model_dir, resolve_dtype
from tinygpt_tpu_torch.ops.attention_kernels import check_kernel_shapes
from tinygpt_tpu_torch.ops.awq import (
    awq_policy,
    awq_quantize_params,
    default_calib_ids,
)
from tinygpt_tpu_torch.ops.quant import quantize_params
from tinygpt_tpu_torch.ops.sampling import SamplerConfig, sample
from tinygpt_tpu_torch.parallel.distributed import all_gather, local_rank, world
from tinygpt_tpu_torch.parallel.sharding import (
    check_world,
    make_mesh,
    mesh_dims,
    shard_model,
)
from tinygpt_tpu_torch.utils.logging import get_logger
from tinygpt_tpu_torch.utils.timer import timed

log = get_logger("engine")


class FinishReason(Enum):
    NONE = "none"
    LENGTH = "length"
    STOP = "stop"
    ABORT = "abort"


@dataclass
class GPTConfig:
    """Engine configuration: the JAX GPTConfig's fields, and the device."""

    model_dir: str
    dtype: str = "bfloat16"
    max_tokens: int = 512
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    extra_stop_token_ids: tuple = ()
    seed: int = 0
    # prompt lengths are bucketed to these multiples
    prefill_bucket: int = 64
    max_context: Optional[int] = None  # default: model context size
    # decode steps per chunk; EOS is checked on the host between chunks.
    # 1 = the per-token route (decode_step, attention through K13)
    decode_chunk: int = 32
    # decode steps per chunk on the STREAMING path (generate_async): small,
    # so a client sees near-per-token cadence instead of decode_chunk-sized
    # bursts; 1 = the per-token route
    stream_chunk: int = 8
    # pace the emission of a chunk's tokens at the measured per-step
    # interval (the JAX engine's min-gap rule) while the next chunk runs;
    # the last chunk bursts (nothing runs behind it). Off = a burst of
    # stream_chunk tokens per chunk. Never at a chunk of 1
    stream_pace: bool = True
    device: Any = "cuda"
    # weight-only quantization: None | "int8" | "int4"
    quantization: Optional[str] = None
    # None = auto (resolve_quant_group): 64 for int4 (128 for MoE), 128 for int8
    quant_group_size: Optional[int] = None
    # AWQ activation-aware scaling before quantization (ops/awq.py). None =
    # auto: on for int4, off for int8; False forces plain round-to-nearest
    awq: Optional[bool] = None
    # calibration text file for AWQ; None = the built-in sample corpus
    awq_calib_path: Optional[str] = None
    awq_calib_tokens: int = 2048  # total calibration tokens (batched)
    # KV cache storage dtype: "auto" (= compute dtype) | "fp8" | a dtype name
    kv_cache_dtype: str = "auto"
    # speculative decoding of a single prompt: None | "ngram" (prompt-lookup
    # drafts of spec_draft_len tokens, matched on the last spec_ngram
    # tokens; greedy requests accept by argmax prefix, sampled ones by exact
    # rejection sampling). A batch takes the chunked loop.
    speculative: Optional[str] = None
    spec_draft_len: int = 4
    spec_ngram: int = 3
    # multi-device execution: (dp, sp, tp) or (dp, sp, pp, tp), one process
    # a rank (module docstring), or None for a single device. pp excludes
    # sp, quantization, speculative decoding and gpt2
    mesh_shape: Optional[tuple] = None
    pp_microbatches: int = 4  # upper bound; actual = largest divisor of B
    # adopt generation_config.json sampling defaults (do_sample +
    # temperature/top_k/top_p/min_p) when no sampler knob was set here
    use_generation_defaults: bool = True


# callback(chunk_text, finished) -> keep_going
GenerateCallback = Callable[[str, bool], bool]

# chunks the decode loop may launch ahead of the one being read (the JAX
# engine's run-ahead depth)
RUN_AHEAD = 2


@dataclass
class GPTOutput:
    """Per-sequence result."""

    token_ids: List[int]
    text: str
    finish_reason: FinishReason = FinishReason.NONE


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_FP8_NAMES = ("fp8", "float8_e4m3", "e4m3")


def resolve_quant_group(bits: int, group: Optional[int], moe: bool = False) -> int:
    """Default quant group size, as the JAX engine chooses it: an explicit
    group wins; int4 takes 64 for a dense-MLP model and 128 for a MoE one
    (the JAX package's perplexity gates chose both), int8 128."""
    if group is not None:
        return group
    return 64 if bits == 4 and not moe else 128


def ngram_draft(context: Sequence[int], n: int, k: int) -> List[int]:
    """Prompt-lookup drafting on the host: the most recent EARLIER
    occurrence of the context's final n-gram gives up to k continuation
    tokens ([] when none). causal_lm.ngram_draft_batched is its device
    form, padded with the current token."""
    L = len(context)
    if L < n + 1 or k <= 0:
        return []
    tail = list(context[-n:])
    for start in range(L - n - 1, -1, -1):
        if list(context[start : start + n]) == tail:
            cont = list(context[start + n : start + n + k])
            if cont:
                return cont
    return []


def _check_config(cfg: GPTConfig) -> None:
    if cfg.quantization not in (None, "int4", "int8"):
        raise ValueError(f"unknown quantization {cfg.quantization!r}")
    if cfg.speculative not in (None, "ngram"):
        raise ValueError(f"unknown speculative mode {cfg.speculative!r}")
    if cfg.mesh_shape is not None:
        check_world(cfg.mesh_shape)


def quantize_loaded(ctx: GPTContext, quantization: str,
                    group_size: Optional[int] = None, awq: Optional[bool] = None,
                    calib_path: Optional[str] = None,
                    calib_tokens: int = 2048) -> dict:
    """Weight-only quantization of a loaded model's params, as the JAX
    engine's prepare() does it: AWQ (calibrate on `calib_tokens` tokens of
    `calib_path` or the built-in corpus, fold, quantize) where awq_policy
    says so, else round-to-nearest. Shared with the evaluator."""
    bits = {"int8": 8, "int4": 4}[quantization]
    group = resolve_quant_group(bits, group_size,
                                moe="moe_gate_up_w" in ctx.params["layers"])
    awq_on, awq_layout = awq_policy(awq, bits, ctx.params["layers"])
    if awq_on and awq_layout:
        calib = default_calib_ids(ctx.tokenizer, calib_tokens, path=calib_path)
        with timed() as t:
            params = awq_quantize_params(ctx.params, ctx.model_config, calib,
                                         bits=bits, group_size=group)
        log.info("AWQ-quantized weights to %s (group %d, %d calib tokens) in %.1fs",
                 quantization, group, calib.size, t())
        return params
    if awq_on and awq:
        log.warning("awq requested but %s has no causal_lm layer layout; "
                    "plain quantization", ctx.model_config.model_type)
    elif bits == 4 and not awq_on:
        log.warning("plain int4 (awq off) missed the ppl gate's relative bar "
                    "on the gate model (PPL_GATE.json)")
    log.info("quantizing weights to %s (group %d)", quantization, group)
    return quantize_params(ctx.params, bits=bits, group_size=group)


def _to_host(toks: torch.Tensor):
    """Starts the copy of a chunk's tokens to the host: on the card into a
    fresh pinned buffer, without blocking, with an event recorded after it
    (a blocking copy would wait for every chunk launched behind this one).
    Returns (the event or None, the host tensor)."""
    if toks.device.type != "cuda":
        return None, toks
    buf = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
    buf.copy_(toks, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record()
    return ev, buf


class _HostTokens:
    """The host side of the decode loop, run by the launching thread
    itself: the chunks launched but not yet emitted, oldest first, each
    with a pinned copy of its tokens and an event. advance() hands the
    tokens of the chunks the device finished to on_token(step, toks [B]),
    one position at a time; it is called after every launched decode step
    (in sample_fn) and, with `keep`, before each chunk's launch, where it
    waits for the device while more than `keep` chunks wait.

    Pacing (JAX's min-gap rule) gives each token of a decode chunk a slot
    t0 + i * step, step = min(1.15 gap / chunk, 0.98 gap / (chunk - 1),
    0.25 s) from the smallest gap seen between two chunks' arrivals; a
    token is emitted at the first advance() after its slot, or at once
    when the next chunk has arrived. The loop sleeps for a slot only where
    it waits for the device anyway, so pacing never delays a launch. The
    first chunk of decode steps and the last chunk burst; a chunk of 1 is
    never paced. The first False from on_token stops emission for good."""

    def __init__(self, on_token, chunk: int, pace: bool):
        self.on_token = on_token
        self.chunk = chunk
        self.pace = pace and chunk > 1
        self.stopped = False
        self._chunks: deque = deque()
        # the chunk emitting: (step, tokens [n, B] numpy, arrival, slot),
        # and its next position
        self._cur, self._next = None, 0
        self._last_sync, self._min_gap, self._step_dt = None, float("inf"), 0.0

    def put(self, step: int, toks: torch.Tensor, decode: bool, last: bool) -> None:
        """Queues the tokens [n, B] of positions step.. (decode: a decode
        chunk's, whose arrival times set the pace; last: nothing follows)."""
        self._chunks.append((step, *_to_host(toks), decode, last))

    def _waiting(self) -> int:
        return len(self._chunks) + (self._cur is not None)

    def _ready(self) -> bool:
        ev = self._chunks[0][1]
        return ev is None or ev.query()

    def _start(self) -> None:
        step, ev, host, decode, last = self._chunks.popleft()
        if ev is not None:
            ev.synchronize()
        now = time.perf_counter()
        if decode:
            if self._last_sync is not None:
                self._min_gap = min(self._min_gap, now - self._last_sync)
                self._step_dt = min(1.15 * self._min_gap / self.chunk,
                                    0.98 * self._min_gap / max(1, self.chunk - 1), 0.25)
            self._last_sync = now
        slot = self._step_dt if self.pace and decode and not last else 0.0
        self._cur, self._next = (step, host.numpy(), now, slot), 0

    def advance(self, keep: Optional[int] = None) -> None:
        """Emits what is due without waiting; with `keep`, also waits for
        the device (and for paced slots) while more than `keep` chunks
        wait to be emitted."""
        while not self.stopped and self._waiting():
            block = keep is not None and self._waiting() > keep
            if self._cur is None:
                if not (block or self._ready()):
                    return
                self._start()
            step, toks, t0, slot = self._cur
            while self._next < len(toks):
                i = self._next
                wait = t0 + i * slot - time.perf_counter() if slot and i else 0.0
                if wait > 0 and not (self._chunks and self._ready()):
                    if not block:
                        return
                    time.sleep(wait)
                self._next += 1
                if not self.on_token(step + i, toks[i]):
                    self.stopped = True
                    return
            self._cur = None


class GPTEngine:
    def __init__(self, config: GPTConfig):
        self.config = config
        self.ctx: Optional[GPTContext] = None
        self._eos_ids: Set[int] = set()
        self._generator: Optional[torch.Generator] = None

    # -- lifecycle -----------------------------------------------------

    def prepare(self) -> None:
        """Load the model dir onto the device and collect EOS ids; under a
        mesh, keep this rank's shard."""
        cfg = self.config
        _check_config(cfg)
        self._device = torch.device(cfg.device)
        if cfg.mesh_shape is not None and self._device.type == "cuda" \
                and self._device.index is None:
            self._device = torch.device("cuda", local_rank())
        mc = load_model_config(cfg.model_dir)
        if cfg.mesh_shape is not None:
            self._check_pipeline(mc)
        # a shape the kernels do not take fails here, before any weight loads
        check_kernel_shapes(mc, self._device)
        self.ctx = load_model_dir(cfg.model_dir, dtype=cfg.dtype,
                                  device=self._device)
        if cfg.quantization:
            self.ctx.params = quantize_loaded(
                self.ctx, cfg.quantization, cfg.quant_group_size, cfg.awq,
                cfg.awq_calib_path, cfg.awq_calib_tokens)
        self.shard(cfg.mesh_shape)
        self._collect_eos_ids()
        gen = self.ctx.generation_config
        # generation_config.json's sampling defaults apply when asked for
        # and no sampler knob was set here
        if (cfg.use_generation_defaults and gen is not None and gen.do_sample
                and cfg.sampler == SamplerConfig()):
            cfg.sampler = SamplerConfig(
                temperature=gen.temperature, top_k=gen.top_k,
                top_p=gen.top_p, min_p=gen.min_p,
            )
            log.info("sampler defaults from generation_config: %s",
                     cfg.sampler)
        self._max_context = cfg.max_context or mc.context_size
        # the attention route the continuous batcher takes (server/api.py)
        self._attn_impl = "kernel" if self._device.type == "cuda" else "plain"
        log.info(
            "engine ready: %s, %d layers, context %d, eos=%s, device %s",
            mc.model_type, mc.num_hidden_layers, self._max_context,
            sorted(self._eos_ids), self._device,
        )

    def _check_pipeline(self, mc) -> None:
        """The JAX engine's refusals of a pipelined mesh."""
        dp, sp, pp, tp = mesh_dims(self.config.mesh_shape)
        if pp == 1:
            return
        if sp > 1:
            raise ValueError("pp and sp are mutually exclusive (for now)")
        if self.config.quantization:
            raise ValueError("pp + quantization not supported yet")
        if self.config.speculative:
            raise ValueError("pp + speculative decoding not supported")
        if mc.model_type == "gpt2":
            raise ValueError("pipeline stages cover the llama family only")

    def shard(self, mesh_shape) -> None:
        """Keep this rank's shard of the loaded (and quantized) params on
        `mesh_shape` (None: the single-device layout), set the sampling
        generator (seeded with the seed plus the dp shard, the same on every
        rank of a shard) and the model config the kernels see. prepare()
        calls it; a caller that built ctx itself (random params at full
        width) calls it directly."""
        mc = self.ctx.model_config
        self._run_cfg = mc
        self._mesh = None
        self._dp, self._dp_index, self._dp_group, self._sp = 1, 0, None, 1
        self._pp_forward = None
        if mesh_shape is not None:
            check_world(mesh_shape)
            dp, sp, pp, tp = mesh_dims(mesh_shape)
            self._dp, self._sp = dp, sp
            if pp > 1:
                # imported here: parallel.pipeline imports the models package,
                # which imports this one's
                from tinygpt_tpu_torch.parallel.pipeline import (
                    make_pipeline_mesh, shard_staged, stage_layers)

                self._mesh = make_pipeline_mesh(dp=dp, pp=pp, tp=tp)
                staged = dict(self.ctx.params, layers=stage_layers(self.ctx.params["layers"], pp))
                self.ctx.params, self._run_cfg = shard_staged(staged, self._mesh, mc)
            else:
                self._mesh = make_mesh(n_devices=dp * sp * tp, dp=dp, sp=sp, tp=tp)
                self.ctx.params, self._run_cfg = shard_model(self.ctx.params, mc, self._mesh)
            self._dp_index = self._mesh.index("dp")
            self._dp_group = self._mesh.group("dp")
            if self._device.type == "cuda":
                torch.cuda.empty_cache()
            # the kernels take this rank's local shapes
            check_kernel_shapes(self._run_cfg, self._device)
            log.info("engine rank %d of mesh %s", world()[0], dict(self._mesh.shape))
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(self.config.seed + self._dp_index)

    def _forward(self, params, ids, cache, positions, valid):
        """The prefill (and the pipeline's decode step): last-position fp32
        logits [B, 1, V]."""
        if self._pp_stages():
            from tinygpt_tpu_torch.parallel.pipeline import make_pipelined_forward

            B = ids.shape[0]
            max_micro = max(1, self.config.pp_microbatches)
            n_micro = max(d for d in range(1, min(B, max_micro) + 1) if B % d == 0)
            fwd = make_pipelined_forward(self._mesh, self.ctx.model_config, n_micro,
                                         stage_cfg=self._run_cfg)
            logits, cache = fwd(params, ids, cache, positions, valid)
            return logits[:, None], cache
        return self.ctx.model.forward(params, self._run_cfg, ids, cache, positions, valid,
                                      last_only=True)

    def _rows(self, x: np.ndarray) -> np.ndarray:
        """This dp shard's rows of a batch-major host array."""
        n = x.shape[0] // self._dp
        return x[self._dp_index * n : (self._dp_index + 1) * n]

    def _all_rows(self, toks: torch.Tensor) -> torch.Tensor:
        """Tokens [n, B / dp] of this dp shard -> [n, B] of the whole
        batch (the dp all-gather), so that every host loop sees every row."""
        return all_gather(toks, self._dp_group, dim=-1)

    def _collect_eos_ids(self) -> None:
        """EOS priority: generation_config list, else model config, else
        tokenizer eos, plus extra stop ids from reconfigure."""
        assert self.ctx is not None
        ids: Set[int] = set()
        gen = self.ctx.generation_config
        if gen is not None:
            ids.update(gen.eos_token_ids)
        ids.update(self.ctx.model_config.eos_token_id)
        tok_eos = self.ctx.tokenizer.eos_token_id
        if not ids and tok_eos is not None:
            ids.add(tok_eos)
        ids.update(self.config.extra_stop_token_ids)
        self._eos_ids = ids

    def reconfigure(
        self,
        sampler: Optional[SamplerConfig] = None,
        max_tokens: Optional[int] = None,
        extra_stop_token_ids: Optional[Sequence[int]] = None,
    ) -> None:
        """Swap sampling knobs between requests. Each generate call builds
        a fresh cache, so nothing else needs a reset."""
        if sampler is not None:
            self.config.sampler = sampler
        if max_tokens is not None:
            self.config.max_tokens = max_tokens
        if extra_stop_token_ids is not None:
            self.config.extra_stop_token_ids = tuple(extra_stop_token_ids)
        self._collect_eos_ids()

    def _kv_dtype(self) -> torch.dtype:
        """KV storage dtype: "auto" (= compute dtype), fp8 (e4m3: half the
        KV bytes of bf16) or a named 16/32-bit type."""
        kd = self.config.kv_cache_dtype
        if kd in ("auto", None):
            return resolve_dtype(self.config.dtype)
        if kd in _FP8_NAMES:
            return torch.float8_e4m3fn
        return resolve_dtype(kd)

    def apply_chat_template(self, messages, add_generation_prompt=True) -> str:
        assert self.ctx is not None
        return self.ctx.tokenizer.apply_chat_template(
            messages, add_generation_prompt=add_generation_prompt
        )

    # -- encoding --------------------------------------------------------

    def _encode_batch(self, texts: Sequence[str]):
        """Encode, left-truncate to context budget, left-pad to a bucketed
        common length. Returns (ids [B,S], positions [B,S], valid [B,S],
        prompt_lens [B], prompt_token_lists) as numpy arrays."""
        assert self.ctx is not None
        tok = self.ctx.tokenizer
        max_new = self.config.max_tokens
        budget = max(1, self._max_context - max_new)
        encoded = [tok.encode(t) for t in texts]
        encoded = [e[-budget:] if len(e) > budget else e for e in encoded]
        max_len = max(1, max(len(e) for e in encoded))
        S = min(_round_up(max_len, self.config.prefill_bucket),
                max(budget, 1))
        # sequence parallelism cuts the prompt into sp equal slices
        S = _round_up(max(S, max_len), getattr(self, "_sp", 1))
        B = len(encoded)
        pad_id = tok.pad_token_id or 0
        ids = np.full((B, S), pad_id, dtype=np.int32)
        valid = np.zeros((B, S), dtype=bool)
        positions = np.zeros((B, S), dtype=np.int32)
        lens = np.zeros((B,), dtype=np.int32)
        for b, e in enumerate(encoded):
            n = len(e)
            if n:
                ids[b, S - n:] = e
                valid[b, S - n:] = True
                positions[b, S - n:] = np.arange(n)
            lens[b] = n
        return ids, positions, valid, lens, encoded

    # -- generation ------------------------------------------------------

    def _prefill_and_loop(self, texts: Sequence[str], max_tokens: int, on_token,
                          decode_chunk: Optional[int] = None,
                          pace: bool = False) -> List[List[int]]:
        """Prefill, then decode `decode_chunk` steps at a time (default
        config.decode_chunk; 1 takes the per-token route, decode_step),
        calling on_token(step, toks [B]) for every generated position,
        between launches, until it returns False or max_tokens positions
        were produced. `pace` paces the emission of each chunk but the
        first and the last (_HostTokens). One prompt with
        speculative="ngram" takes the speculative loop instead."""
        assert self.ctx is not None, "call prepare() first"
        if (self.config.speculative == "ngram" and len(texts) == 1
                and self._mesh is None):
            return self._spec_prefill_and_loop(texts, max_tokens, on_token)
        mc = self._run_cfg
        model = self.ctx.model
        params = self.ctx.params
        dev = self._device
        sampler_cfg = self.config.sampler
        chunk = max(1, min(decode_chunk or self.config.decode_chunk, max_tokens))
        ids, positions, valid, lens, encoded = self._encode_batch(texts)
        if len(texts) % self._dp:
            raise ValueError(f"batch {len(texts)} not divisible by dp={self._dp}")
        # this dp shard's rows
        ids, positions, valid, lens = (self._rows(a) for a in (ids, positions, valid, lens))
        B, S = ids.shape
        # tokens 1 .. max_tokens - 1 come from decode steps; a chunk writes
        # all its slots
        n_chunks = -(-(max_tokens - 1) // chunk)
        cache = create_kv_cache(mc, B, S + n_chunks * chunk,
                                dtype=self._kv_dtype(),
                                device=dev)
        logits, cache = self._forward(
            params, torch.from_numpy(ids).to(dev), cache,
            torch.from_numpy(positions).to(dev), torch.from_numpy(valid).to(dev))
        tok = sample(logits[:, -1, :], sampler_cfg, self._generator)  # [B]
        host = _HostTokens(on_token, chunk, pace)
        host.put(0, self._all_rows(tok[None]), decode=False, last=max_tokens <= 1)

        def sample_fn(lg):
            nxt = sample(lg, sampler_cfg, self._generator)
            host.advance()  # between two launched steps: emit what is due
            return nxt

        lens_dev = torch.from_numpy(lens).to(dev)
        step = 1
        while step < max_tokens:
            # at most RUN_AHEAD chunks launched beyond the one being read
            host.advance(keep=RUN_AHEAD)
            if host.stopped:
                return encoded
            # the chunk's first input (token `step - 1`) sits at logical
            # position len + step - 1
            pos0 = (lens_dev + (step - 1))[:, None]
            if self._pp_stages():
                toks, cache = self._pp_decode(params, tok, cache, pos0, chunk, sample_fn)
            elif chunk == 1:
                logits, cache = model.decode_step(params, mc, tok, cache, pos0)
                toks = sample_fn(logits[:, -1, :]).to(torch.int32)[None]
            else:
                toks, cache = model.decode_steps(params, mc, tok, cache, pos0, chunk,
                                                 sample_fn)
            tok = toks[-1]  # the next chunk starts from the device's token
            n = min(chunk, max_tokens - step)
            host.put(step, self._all_rows(toks[:n]), decode=True,
                     last=step + n >= max_tokens)
            step += n
        host.advance(keep=0)
        return encoded

    def _pp_stages(self) -> bool:
        return self._mesh is not None and "pp" in self._mesh.shape

    def _pp_decode(self, params, tok, cache, pos0, n_steps, sample_fn):
        """n_steps one-token steps through the pipeline stages (each a
        pipelined forward at S = 1, attention through K13), as the JAX
        engine's per-step body under a mesh. Returns (toks [n_steps, B],
        the cache)."""
        B = tok.shape[0]
        ones = torch.ones((B, 1), dtype=torch.bool, device=tok.device)
        toks = torch.empty((n_steps, B), dtype=torch.int32, device=tok.device)
        pos = pos0.to(torch.int32)
        for i in range(n_steps):
            logits, cache = self._forward(params, tok.to(torch.int32)[:, None], cache, pos,
                                          ones)
            tok = sample_fn(logits[:, -1, :]).to(torch.int32)
            toks[i] = tok
            pos = pos + 1
        return toks, cache

    def _spec_prefill_and_loop(self, texts: Sequence[str], max_tokens: int,
                               on_token) -> List[List[int]]:
        """One prompt decoded by n-gram speculation: a prefill, then rounds
        of a device prompt-lookup draft, a (gamma + 1)-token verify forward
        over the dense cache at the round's first slot (K1 on the card),
        and the acceptance (causal_lm.spec_accept); each round emits the
        current token and its m accepted drafts. Validity of the generated
        region is `slot < slots`, so a rejected slot is overwritten by the
        next round's writes. K1 takes the round's first slot as a host int,
        so the loop reads each round's accepted count and tokens on the
        host: one device-to-host read a round."""
        # imported here: the models package imports this one's
        from tinygpt_tpu_torch.models.causal_lm import ngram_draft_batched, spec_accept

        mc = self.ctx.model_config
        model = self.ctx.model
        params = self.ctx.params
        dev = self._device
        scfg = self.config.sampler
        gamma = max(1, self.config.spec_draft_len)
        n = max(1, self.config.spec_ngram)
        S_v = gamma + 1
        ids, positions, valid, lens, encoded = self._encode_batch(texts)
        S = ids.shape[1]
        # a round writes S_v slots from `slots`, which stays below S + max_tokens
        cache = create_kv_cache(mc, 1, S + max_tokens + S_v, dtype=self._kv_dtype(),
                                device=dev)
        logits, cache = model.forward(
            params, mc, torch.from_numpy(ids).to(dev), cache,
            torch.from_numpy(positions).to(dev), torch.from_numpy(valid).to(dev),
            last_only=True)
        cur = sample(logits[:, -1, :], scfg, self._generator)              # [1]
        L = int(lens[0])
        # the draft context: the prompt's real tokens, then the generated
        # ones with the current input last
        ctx = torch.zeros((1, S + max_tokens + S_v), dtype=torch.int32, device=dev)
        ctx[0, :L] = torch.tensor(encoded[0], dtype=torch.int32, device=dev)
        ctx[0, L] = cur[0]
        clen, slots, gen_pos = L + 1, S, L
        sampler = None
        if not scfg.is_greedy:
            sampler = (
                torch.tensor([scfg.temperature or 0.0], device=dev),
                torch.tensor([scfg.top_k or 0], dtype=torch.int32, device=dev),
                torch.tensor([scfg.top_p if scfg.top_p is not None else 1.0], device=dev),
                torch.tensor([scfg.min_p or 0.0], device=dev))
        no_greedy = torch.zeros(1, dtype=torch.bool, device=dev)
        ones = torch.ones((1, S_v), dtype=torch.bool, device=dev)
        emitted = 0
        while emitted < max_tokens:
            draft = ngram_draft_batched(ctx, torch.tensor([clen], device=dev), cur, n,
                                        gamma)                             # [1, gamma]
            toks = torch.cat([cur[:, None], draft], dim=1)                 # [1, S_v]
            pos = torch.arange(gen_pos, gen_pos + S_v, dtype=torch.int32, device=dev)[None]
            cache.valid[:, slots:] = False  # rejected slots of the last round
            cache.length = slots
            logits, cache = model.forward(params, mc, toks, cache, pos, ones)
            m, nxt, _ = spec_accept(logits, draft, sampler, self._generator, no_greedy)
            # the round's one read on the host: its tokens and accepted count
            host = torch.cat([toks[0], m]).cpu().tolist()
            m_h = host[-1]
            ctx[0, clen : clen + m_h] = draft[0, :m_h]
            ctx[0, clen + m_h] = nxt[0]
            clen, slots, gen_pos, cur = clen + m_h + 1, slots + m_h + 1, gen_pos + m_h + 1, nxt
            for tok in host[: m_h + 1]:
                if emitted >= max_tokens or not on_token(emitted, np.asarray([tok])):
                    return encoded
                emitted += 1
        return encoded

    @torch.inference_mode()
    def generate_sync(self, texts: Sequence[str]) -> List[GPTOutput]:
        """Batch generation: rows finish individually (EOS or max_tokens)
        and the loop stops once every row is done."""
        assert self.ctx is not None, "call prepare() first"
        B = len(texts)
        max_tokens = self.config.max_tokens
        out_ids: List[List[int]] = [[] for _ in range(B)]
        finished = np.zeros(B, dtype=bool)
        reasons = [FinishReason.LENGTH] * B

        def on_token(step, toks):
            for b in range(B):
                if finished[b]:
                    continue
                t = int(toks[b])
                if t in self._eos_ids:
                    finished[b] = True
                    reasons[b] = FinishReason.STOP
                else:
                    out_ids[b].append(t)
                    if len(out_ids[b]) >= max_tokens:
                        finished[b] = True
            return not finished.all()

        self._prefill_and_loop(texts, max_tokens, on_token)
        tok = self.ctx.tokenizer
        texts_out = tok.decode_batch(out_ids, skip_special_tokens=True)
        return [
            GPTOutput(token_ids=out_ids[b], text=texts_out[b],
                      finish_reason=reasons[b])
            for b in range(B)
        ]

    @torch.inference_mode()
    def generate_async(self, text: str, callback: GenerateCallback) -> GPTOutput:
        """Streaming generation of one prompt: callback(chunk, finished)
        gets UTF-8-safe text chunks as tokens arrive, then the final flush
        (finished=True), on the calling thread. EOS ends the stream with
        FinishReason.STOP; a callback that returns False aborts it
        (FinishReason.ABORT, no final flush). Decodes `stream_chunk` steps
        a chunk (1: the per-token route), paced by `stream_pace`;
        speculative="ngram" takes the speculative loop."""
        assert self.ctx is not None, "call prepare() first"
        tok = self.ctx.tokenizer
        stream = tok.decode_stream(skip_special_tokens=True)
        out_tokens: List[int] = []
        state = {"reason": FinishReason.LENGTH, "aborted": False}

        def on_token(step, toks):
            t = int(toks[0])
            if t in self._eos_ids:
                state["reason"] = FinishReason.STOP
                return False
            out_tokens.append(t)
            chunk = stream.step(t)
            if chunk and not callback(chunk, False):
                state["reason"] = FinishReason.ABORT
                state["aborted"] = True
                return False
            return True

        self._prefill_and_loop([text], self.config.max_tokens, on_token,
                               decode_chunk=self.config.stream_chunk,
                               pace=self.config.stream_pace)
        tail = stream.flush()
        if not state["aborted"]:
            callback(tail, True)
        return GPTOutput(token_ids=out_tokens,
                         text=tok.decode(out_tokens, skip_special_tokens=True),
                         finish_reason=state["reason"])
