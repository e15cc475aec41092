"""GPTEngine: load → encode → prefill → decode → detokenize.

Counterpart of tinygpt_tpu/engine/engine.py for batch inference:
prepare() (model-dir load, EOS collection from generation_config falling
back to the tokenizer, generation-config sampler defaults unless
use_generation_defaults=False), reconfigure(),
left-pad/truncate batch encoding into length buckets, and generate_sync:
one prefill, then chunks of `decode_chunk` frozen-cache decode steps
(causal_lm.decode_steps) with the EOS check on the host between chunks —
the only point where the loop waits for the device.

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

Not ported yet, each raising NotImplementedError when asked for: device
meshes and streaming (generate_async).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, List, Optional, Sequence, Set

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
    """Engine configuration: the JAX GPTConfig's fields, except those of
    streaming (stream_chunk, stream_pace; ROADMAP.md queue 1, item 5) and
    of pipeline parallelism (pp_microbatches, item 13), not ported yet.
    mesh_shape must keep its default (item 13)."""

    model_dir: str
    dtype: str = "bfloat16"
    max_tokens: int = 512
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    extra_stop_token_ids: tuple = ()
    seed: int = 0
    # prompt lengths are bucketed to these multiples
    prefill_bucket: int = 64
    max_context: Optional[int] = None  # default: model context size
    # decode steps per chunk; EOS is checked on the host between chunks
    decode_chunk: int = 32
    device: Any = "cuda"
    # weight-only quantization: None | "int8" | "int4"
    quantization: Optional[str] = None
    # None = auto (resolve_quant_group): 64 for int4, 128 for int8
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
    # not ported yet (ROADMAP.md queue 1, item 13): must stay None
    mesh_shape: Optional[tuple] = None
    # adopt generation_config.json sampling defaults (do_sample +
    # temperature/top_k/top_p/min_p) when no sampler knob was set here
    use_generation_defaults: bool = True


@dataclass
class GPTOutput:
    """Per-sequence result."""

    token_ids: List[int]
    text: str
    finish_reason: FinishReason = FinishReason.NONE


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_FP8_NAMES = ("fp8", "float8_e4m3", "e4m3")


def resolve_quant_group(bits: int, group: Optional[int]) -> int:
    """Default quant group size, as the JAX engine chooses it for dense
    models: an explicit group wins; int4 takes 64, int8 128."""
    if group is not None:
        return group
    return 64 if bits == 4 else 128


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


def _check_ported(cfg: GPTConfig) -> None:
    if cfg.quantization not in (None, "int4", "int8"):
        raise ValueError(f"unknown quantization {cfg.quantization!r}")
    if cfg.speculative not in (None, "ngram"):
        raise ValueError(f"unknown speculative mode {cfg.speculative!r}")
    if cfg.mesh_shape is not None:
        raise NotImplementedError(
            "GPTConfig.mesh_shape is not ported to tinygpt_tpu_torch yet "
            "(ROADMAP.md queue 1, item 13)")


def quantize_loaded(ctx: GPTContext, quantization: str,
                    group_size: Optional[int] = None, awq: Optional[bool] = None,
                    calib_path: Optional[str] = None,
                    calib_tokens: int = 2048) -> dict:
    """Weight-only quantization of a loaded model's params, as the JAX
    engine's prepare() does it: AWQ (calibrate on `calib_tokens` tokens of
    `calib_path` or the built-in corpus, fold, quantize) where awq_policy
    says so, else round-to-nearest. Shared with the evaluator."""
    bits = {"int8": 8, "int4": 4}[quantization]
    group = resolve_quant_group(bits, group_size)
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


class GPTEngine:
    def __init__(self, config: GPTConfig):
        self.config = config
        self.ctx: Optional[GPTContext] = None
        self._eos_ids: Set[int] = set()
        self._generator: Optional[torch.Generator] = None

    # -- lifecycle -----------------------------------------------------

    def prepare(self) -> None:
        """Load the model dir onto the device and collect EOS ids."""
        cfg = self.config
        _check_ported(cfg)
        self._device = torch.device(cfg.device)
        # a shape the kernels do not take fails here, before any weight loads
        check_kernel_shapes(load_model_config(cfg.model_dir), self._device)
        self.ctx = load_model_dir(cfg.model_dir, dtype=cfg.dtype,
                                  device=self._device)
        if cfg.quantization:
            self.ctx.params = quantize_loaded(
                self.ctx, cfg.quantization, cfg.quant_group_size, cfg.awq,
                cfg.awq_calib_path, cfg.awq_calib_tokens)
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(cfg.seed)
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
        mc = self.ctx.model_config
        self._max_context = cfg.max_context or mc.context_size
        # the attention route the continuous batcher takes (server/api.py)
        self._attn_impl = "kernel" if self._device.type == "cuda" else "plain"
        log.info(
            "engine ready: %s, %d layers, context %d, eos=%s, device %s",
            mc.model_type, mc.num_hidden_layers, self._max_context,
            sorted(self._eos_ids), self._device,
        )

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
        S = max(S, max_len)
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

    def _prefill_and_loop(self, texts: Sequence[str], max_tokens: int,
                          on_token) -> List[List[int]]:
        """Prefill, then chunked decode, calling on_token(step, toks [B])
        for every generated position until it returns False or
        max_tokens positions were produced."""
        assert self.ctx is not None, "call prepare() first"
        if self.config.speculative == "ngram" and len(texts) == 1:
            return self._spec_prefill_and_loop(texts, max_tokens, on_token)
        mc = self.ctx.model_config
        model = self.ctx.model
        params = self.ctx.params
        dev = self._device
        sampler_cfg = self.config.sampler
        chunk = max(1, min(self.config.decode_chunk, max_tokens))
        ids, positions, valid, lens, encoded = self._encode_batch(texts)
        B, S = ids.shape
        n_chunks = -(-(max_tokens - 1) // chunk)
        cache = create_kv_cache(mc, B, S + n_chunks * chunk,
                                dtype=self._kv_dtype(),
                                device=dev)
        logits, cache = model.forward(
            params, mc, torch.from_numpy(ids).to(dev), cache,
            torch.from_numpy(positions).to(dev),
            torch.from_numpy(valid).to(dev), last_only=True,
        )
        tok = sample(logits[:, -1, :], sampler_cfg, self._generator)  # [B]

        def sample_fn(lg):
            return sample(lg, sampler_cfg, self._generator)

        if not on_token(0, tok.cpu().numpy()):
            return encoded
        lens_dev = torch.from_numpy(lens).to(dev)
        step = 1
        while step < max_tokens:
            # the chunk's first input (token `step - 1`) sits at logical
            # position len + step - 1
            pos0 = (lens_dev + (step - 1))[:, None]
            toks, cache = model.decode_steps(params, mc, tok, cache, pos0,
                                             chunk, sample_fn)
            host = toks.cpu().numpy()  # [chunk, B] — the one sync per chunk
            for i in range(min(chunk, max_tokens - step)):
                if not on_token(step, host[i]):
                    return encoded
                step += 1
            tok = toks[-1]
        return encoded

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

    def generate_async(self, text: str, callback) -> GPTOutput:
        """Streaming generation is not ported yet."""
        raise NotImplementedError(
            "generate_async (streaming) is not ported to tinygpt_tpu_torch "
            "yet (ROADMAP.md queue 1, item 5)")
