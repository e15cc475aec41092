#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tinygpt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order:
  env      the card's name and power limit, torch and nvcc versions;
  build    compiles the CUDA kernels from the checkout's sources (nvcc,
           one process per source, all at once) and, beside them, the two
           host cores (g++: the KV-pool index and the tokenizer); prints the registers,
           spills and shared memory of the redesigned kernels at the main
           path (every instantiation of K10's tensor-core split) and checks
           their machine code for wgmma and TMA (K1, the prefill kernel),
           cluster barriers (K13, K2, K8, K9, K10, K12, the GEMV), cp.async
           (the GEMV, K8, K9, K10, K11, K12) and mma.sync from ldmatrix (K10,
           K12);
  kernels  holds each attention kernel against its plain PyTorch version
           on the card (bf16 and fp32, head dims 128 and 64, and an e4m3
           cache beside bf16 queries) and times kernel, plain version and
           torch's scaled_dot_product_attention beside the kernel's bound
           (K1 also at the batcher's admission shape and GPT-2's heads);
  int4     the same for the int4 dequant-matmul kernels (K4, K5b, K6, K7)
           at the int4 path's shapes, with torch._weight_int4pack_mm as
           the library yardstick where it computes the same function;
  paged    holds the paged frozen-pool decode kernel (K8) against its
           plain version on the card (bf16, fp32 and e4m3 pools, head dims
           128 and 64, 4 and 1 query heads per KV head, ragged rows, dead
           table entries, inactive rows, a window) and times it beside its
           bound and scaled_dot_product_attention on the same rows gathered
           dense, sweeping its split; then the same for the single-layer
           paged decode (K9) at the GPT-2 serving shape (12/12 heads, D 64,
           rows up to 1,023 slots, inactive rows, starts > 0; bf16, fp16,
           fp32 and e4m3 pools), the Mistral-7B shape with windows 8 and 24
           and the mixtral_serve stepwise quantum's rows, each timed case by
           CUDA events (K9 and SDPA) with a sweep of K9's split beside its
           plan; then K2, K8 and K9 at 16 query heads per KV head
           (Llama-3.1-405B's 128/8) and K10 at 72 and 80 verify rows per
           KV head (K9 and K10 beside their plain versions, SDPA and their
           split sweeps);
  spec_kernels  the same for the speculative-verify kernel (K10) at the
           serving shape (16 rows, 5 verify positions, bf16, fp32 and e4m3
           pools, a binding window), with SDPA on the gathered K/V and an
           explicit mask as the yardstick (both by CUDA events) and a sweep
           of K10's split beside its plan at each timed case; and the
           card's e4m3 cast against the CPU's bytes;
  model    full-width Mistral-7B shape (32 layers, bf16, random weights):
           prefill of 4 left-padded prompts, then two greedy decode chunks
           of 32 steps, through the kernels and through the plain
           versions, compared; the launch counts show each kernel's use;
  awq      AWQ at full width on the model phase's bf16 params: statistics,
           search and fold timed, the fold identity (fp32 at 4 layers, bf16
           at 32), then int4 at group 64 through K5b, K4, K6 and K7 against
           the plain route, exact launch counts;
  model_fp8  the model phase's bf16 params over an fp8 (e4m3) KV cache: K1
           and K2 on e4m3, kernel route against plain route, exact launch
           counts, the decode step's device time under the profiler;
  model4   the same shape quantized to int4 (group 64) on the card: first
           4 layers in fp32, then all 32 in bf16, kernel route against
           plain route, exact launch counts per prefill and decode step;
  serve    the continuous batcher on model4's int4 params, on the native
           pool index (the host us of one admission's index work on the
           native and the Python index logged first): 16
           staggered requests of 512 random tokens, 256 new each (the JAX
           package's serving leg, benches/flagship_bench.py), with TTFT,
           whole-run and steady tok/s, exact launch counts per decode step
           and per admission, a torch.profiler trace of one quantum, and
           kernel route against plain route (4 layers fp32: identical
           greedy streams; 32 layers bf16: one quantum's logits);
  spec_serve  the same batcher with n-gram speculation (K10 in every verify
           layer) on traffic whose prompts repeat a 64-token span, against
           the same traffic with speculation off: tok/s, TTFT, acceptance,
           verifies, exact launch counts, one speculative quantum under the
           profiler, and identical streams at 4 layers in fp32;
  int8     the int4 phase's checks and timings for the int8 dequant-matmul
           kernels (K3, K5a) at the int8 path's shapes (decode and
           prefill) and at contraction dims of 896 and 64, with cuBLAS on
           the bf16-dequantized weight as the library yardstick;
  model8   the same shape in int8 (group 128): K5a and K3 in the prefill
           and in every decode step (the unfused route), the same checks;
  gpt2     GPT-2 124M at full width (12 layers, 12 heads of 64, vocab
           50,257, random weights): the model phase's batch and chunks
           through K1 and K2, kernel route against plain route in fp32 and
           bf16, then int8 (group 128, K5a) and int4 (group 64, K5b);
  gpt2_serve  the continuous batcher on those bf16 params under the serve
           phase's traffic, once with the frozen quantum (K8) and once with
           the stepwise one (forward_paged, K9): tok/s, TTFT, a quantum's
           wall and device time, exact launch counts, and the two runs'
           streams (identical at 12 layers in fp32);
  engine   writes a 2-layer Mistral-width model dir with a generated
           Metaspace-BPE tokenizer and runs GPTEngine.generate_sync on it,
           in bf16, with quantization="int4", awq=False, with "int8", with
           "int4" and AWQ by default, with kv_cache_dtype="fp8", and with
           speculative="ngram" on one prompt; then the batcher on fp8 pools;
           one bf16 generate_sync runs inside utils/profiler.trace, whose
           file must hold its annotation span and K1 or K2 launches;
  evaluate python -m tinygpt_tpu_torch.evaluate on that dir, bf16, int8 and
           an fp8 KV cache, kernel route against plain route;
  server   serves that model dir over HTTP in-process (TinyGPTServer on
           127.0.0.1): four concurrent clients, completions plain and SSE,
           chat completions and /health; the tokenizer must run on its
           native encoder, with the Python pipeline's ids on the prompts
           sent, and the batcher on the native pool index;
  gpt2_engine, gpt2_server  the engine (generate_sync, batch-1
           speculation) and the server on a 2-layer GPT-2 dir with the
           generated tokenizer;
  moe_kernels  holds the gathered-expert kernels (K12 bf16, K11a int8,
           K11b int4) against their plain versions at the Mixtral-8x7B
           matrices (2-layer stacks, called at layer 1; 8, 32 and 160 rows;
           bf16 and fp32 activations) and times each beside its bound (the
           distinct routed experts' bytes), the plain version and torch.bmm
           on the gathered weights; sweeps each kernel's split at every row
           count and over an uneven draw; times the gathered MLP of 4 and
           16 tokens on each stack and, beside K12, the dense moe_mlp;
  mixtral4 Mixtral-8x7B at full width and depth in int4 (group 128), built
           layer by layer on the card: fp32 at 2 layers, then the model
           phase's batch and chunks (K1, K5b, K4 in the prefill; K2, K5b,
           K11b, K4 every step), kernel route against plain route, exact
           launch counts, the profiled step and its bound from the run's
           routing;
  mixtral_serve  the continuous batcher on those params: 8 requests of 512
           tokens, 64 new each, on the frozen (K8) and the stepwise (K9)
           quantum, K11b in every step;
  mixtral8, mixtral_bf16  the same in int8 (K11a; cut to 16 layers, group
           128) and in bf16 (K12; cut to 8 layers, and fp32 at 2 layers);
  qwen3    the JAX package's other bench shapes (BENCH_SHAPES), at full
           width and depth on the model phase's batch and chunks, each
           weight format's kernel route held to its plain route on forced
           tokens over SHAPE_CHECK_CHUNKS chunks (SHAPE_LOGIT_TOL), exact
           launch counts, the profiled step (busy, wall, launches) and the
           prefill; the int4 format first holds K6 (qkv with its bias / qk-norm
           and RoPE epilogue, o, the tied head), K7, K4, K5b, K1 and K2 at the
           shape against their plain versions. qwen3: Qwen3-1.7B (28 layers,
           16/8 heads of 128, qk-norm, tied head over a vocab of 151,936),
           fp32 at 4 layers (float and int4 weights), then bf16, int8 and
           int4;
  qwen3_serve  the serve phase's traffic and scheduler on its int4 params
           (frozen quantum, K8);
  qwen25   Qwen2.5-0.5B (24 layers, 14/2 heads of 64, qkv bias, tied head;
           int4 rows of 896 padded to 1,024) in bf16 and int4, then the
           batcher on the int4 params, mixtral_serve's traffic, on the
           frozen (K8) and the stepwise (K9) quantum;
  llama32  Llama-3.2-1B (16 layers, 32/8 heads of 64) in bf16 and int4 and
           Llama-3.2-3B (28 layers, 24/8 heads of 128) in int4, both tied;
  moe_8x1b the JAX bench's 8-expert MoE (16 layers, hidden 2,048, experts of
           4,096, 32/8 heads of 64) in int4 as the mixtral phases (K11b);
  mixtral_engine, mixtral_server  GPTEngine (bf16; int4 with AWQ by
           default, group 128), the evaluator (int4, kernel against plain
           route) and the server on a 2-layer Mixtral-width dir with the
           generated tokenizer;
  qwen3_engine, qwen3_server, qwen25_engine, qwen25_server  GPTEngine
           (bf16; int4 with AWQ by default, on the qk norms or the qkv bias)
           and the server on 2-layer Qwen3-1.7B- and Qwen2.5-0.5B-width dirs
           with tied heads (no lm_head.weight) and the generated tokenizer
           over the whole vocab;
  server_sequential  the server phase once more with scheduler="sequential"
           (one request at a time through GPTEngine.generate_async);
  k13      holds the one-layer decode kernel (K13, flash_decode) against its
           plain version on the card at the model phase's per-token shape
           (batch 4, 32/8 heads of 128, 576 slots; bf16 and e4m3), and in
           fp32, fp16, head dim 64, 1 to 16 query heads per KV head, windows
           and a row that sees no slot; timed beside its bound, the plain
           version and scaled_dot_product_attention; at the stream's batch 1
           beside K2 over the same visible slots (in turns), and over the
           same visible slots in caches of 108 to 576 slots;
  stream   writes a full-width Mistral-7B dir (32 layers, 14.5 GB of random
           bf16 weights) and streams one prompt through
           GPTEngine.generate_async at batch 1, in bf16 and in int4 (the
           engine's AWQ default): stream_chunk 1 (the per-token route,
           decode_step, K13) and 8 (K2), paced and not, beside generate_sync
           at the same chunk: time to the first text, inter-callback p50 and
           p95, wall times, exact launch counts (32 K13 launches a token),
           the device's busy share and launches a token under the profiler,
           the per-token route held to the chunked one (logits, near-ties)
           and, in bf16, the model phase's batch through the per-token
           route against the plain route (K13's main-path launches);
  mesh     the multi-device layouts (parallel/) with 2 ranks sharing the
           card over gloo (NCCL refuses two ranks on one device), after
           the kernels at tp = 2's local shapes in this process (K6 for
           qkv on 16 + 2 x 4 heads and for o with the residual off, K7 at
           I / 2 with and without it, K2 and K1 at 16 over 4 KV heads,
           K11b on 4 of Mixtral's 8 experts with rows routed away) against
           their plain versions: the Mistral-7B shape in int4 at tp = 2 through the
           engine's sharding (16 layers, cut from 32: logits against one rank's on the
           same params, tokens the same on both ranks, exact launch
           counts a rank, each rank's busy ms a step), the batcher at
           tp = 2 (a frozen quantum, K8, and a stepwise one, K9), the
           engine at dp = 2 and in pipeline stages (1, 1, 2, 1), Mixtral
           int4 with its experts over sp (K11b on each rank's experts),
           and the CLI with --mesh 1,1,2 as two processes. A rank that
           fails or outlives MESH_TIMEOUT_S fails the phase.

Every phase must pass; the script exits non-zero at the first failure.
Its last lines are the seconds each phase took, the card's name and power
limit, the kernel table as JSON and the result line
{"ok": true, "device": {...}}. It needs a CUDA device and the rest of the
repository beside it; without either it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, FLOP/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}

# kernel-vs-plain tolerances (max abs error). Both sides compute scores,
# softmax and the weighted sum in fp32 from the same inputs, in another
# order; bf16 outputs are then rounded once (one bf16 ulp is 2^-8 relative,
# outputs here stay below ~2 in magnitude).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# the main path's shapes (model phase): Mistral-7B widths, batch 4
MISTRAL_7B = {
    "model_type": "mistral",
    "vocab_size": 32768,
    "hidden_size": 4096,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "intermediate_size": 14336,
    "max_position_embeddings": 4096,
    "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-5,
}
PROMPT_LENS = (512, 400, 300, 128)   # left-padded to one bucket of 512
# the AWQ fold at 32 layers in bf16 (awq phase), max abs error of the
# logits: folding re-rounds every layer weight and norm to bf16 (each by up
# to half an ulp), where the kernel and plain routes differ only in
# attention's summation order; the random stack amplifies either, so the
# limit is twice MODEL_LOGIT_TOL's bf16 one (the fp32 fold at 4 layers is
# the sharp check of the identity)
AWQ_FOLD_TOL_BF16 = 1.2
# kernel route vs plain route at full width (model phase), max abs error
# of the logits (std ~1.3) at every sampled position, both routes fed the
# same tokens. Both routes run the same matmuls; attention differs only in
# summation order and, in bf16, in which elements round up or down
# (kernels phase: at most one bf16 ulp per output). fp32 at 4 layers: that
# order alone, ~1e-6 per layer. bf16 at 32 layers: the random stack
# amplifies one-ulp differences layer after layer (0.27 at the prefill's
# last position on an H100), so only a coarse bound holds.
MODEL_LOGIT_TOL = {"float32": 1e-3, "bfloat16": 0.6}
# the same measure for GPT-2 124M's routes in bf16 (gpt2 phase): its tied
# head's logits have a std of about 0.55 (wte ~ N(0, 0.02^2) over 768
# unit-variance features), so the Mistral limit would be a typical logit.
# An H100 read 0.031 (bf16), 0.039 (int8) and 0.031 (int4), the same in two
# runs; the limit leaves 2.5x room over the largest
GPT2_LOGIT_TOL_BF16 = 0.1
# int4 and int8 kernels against their plain versions, max abs error
# relative to the largest output: both dequantize the same bytes exactly in
# fp32 and sum in fp32 in another order (the tensor-core paths split fp32
# activations into two bf16 parts, exact to about 2^-17), then round once:
# 1e-4 in fp32, one bf16 ulp (2^-7 of the magnitude, at most) in bf16
QUANT_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -7}
INT4_GROUP = 64  # the JAX engine's int4 default for dense models
INT8_GROUP = 128  # its int8 default
LIB_LAYERS = 4  # bf16 layers the cuBLAS yardstick walks (> the 50 MB L2)
# rows of x at which the prefill regime (M > 32) of K5a and K5b is checked
# and timed beside the 4 x 512 prefill: a speculative verify round (16 rows
# x 5) and one admitted 512-token request
PREFILL_ROWS = (80, 512)
DECODE_CHUNK = 32
N_CHUNKS = 2
PROFILE_STEPS = 8  # decode steps traced by torch.profiler (model phase)
REPLACES = {
    "flash_prefill": "tinygpt_tpu/ops/attention_kernels.py:179",
    "flash_decode_frozen": "tinygpt_tpu/ops/attention_kernels.py:431",
    "flash_decode": "tinygpt_tpu/ops/attention_kernels.py:470",
    "matmul_dequant_int4": "tinygpt_tpu/ops/quant_kernels.py:327",
    "matmul_dequant_int4_stacked": "tinygpt_tpu/ops/quant_kernels.py:636",
    "matmul_dequant_int4_stacked_fused": "tinygpt_tpu/ops/quant_kernels.py:984",
    "mlp_fused_int4_stacked": "tinygpt_tpu/ops/quant_kernels.py:1304",
    "paged_decode_frozen": "tinygpt_tpu/ops/paged_attention.py:436",
    "paged_decode_spec": "tinygpt_tpu/ops/paged_attention.py:681",
    "paged_decode": "tinygpt_tpu/ops/paged_attention.py:192",
    "matmul_dequant_int8": "tinygpt_tpu/ops/quant_kernels.py:208",
    "matmul_dequant_int8_stacked": "tinygpt_tpu/ops/quant_kernels.py:481",
    "moe_gather_matmul": "tinygpt_tpu/ops/moe_kernels.py:98",
    "moe_gather_matmul_int8": "tinygpt_tpu/ops/moe_kernels.py:229",
    "moe_gather_matmul_int4": "tinygpt_tpu/ops/moe_kernels.py:313",
}
SOURCES = {
    "flash_prefill": "tinygpt_tpu_torch/csrc/flash_prefill.cu",
    "flash_decode_frozen": "tinygpt_tpu_torch/csrc/flash_decode_frozen.cu",
    "flash_decode": "tinygpt_tpu_torch/csrc/flash_decode.cu",
    "matmul_dequant_int4": "tinygpt_tpu_torch/csrc/int4_matmul.cu",
    "matmul_dequant_int4_stacked": "tinygpt_tpu_torch/csrc/int4_matmul.cu",
    "matmul_dequant_int4_stacked_fused": "tinygpt_tpu_torch/csrc/int4_fused.cu",
    "mlp_fused_int4_stacked": "tinygpt_tpu_torch/csrc/int4_mlp.cu",
    "paged_decode_frozen": "tinygpt_tpu_torch/csrc/paged_decode_frozen.cu",
    "matmul_dequant_int8": "tinygpt_tpu_torch/csrc/int8_matmul.cu",
    "matmul_dequant_int8_stacked": "tinygpt_tpu_torch/csrc/int8_matmul.cu",
    "paged_decode_spec": "tinygpt_tpu_torch/csrc/paged_decode_spec.cu",
    "paged_decode": "tinygpt_tpu_torch/csrc/paged_decode.cu",
    "moe_gather_matmul": "tinygpt_tpu_torch/csrc/moe_gather_matmul.cu",
    "moe_gather_matmul_int8": "tinygpt_tpu_torch/csrc/moe_gather_matmul.cu",
    "moe_gather_matmul_int4": "tinygpt_tpu_torch/csrc/moe_gather_matmul.cu",
}
# the serving phase: the JAX package's serving leg
# (benches/flagship_bench.py:396-535) at the Mistral-7B shape in int4
SERVE = dict(n_requests=16, prompt_len=512, max_new=256, gap_s=0.25, capacity=16,
             block=64, n_blocks=16 * 16 + 1, max_blocks=16, bucket=64, quantum=8,
             warm_new=32, profile_new=64)
# the speculative serving phase: the serving leg's scheduler and arrivals
# with n-gram speculation (the batcher's defaults: 4 drafts, 3-grams), on
# prompts that repeat one random span of SPEC_SPAN tokens
SPEC = dict(span=64, draft_len=4, ngram=3, fp32_new=64)
# GPT-2 124M (the reference's own model, SURVEY.md), not cut
GPT2_124M = {
    "model_type": "gpt2",
    "vocab_size": 50257,
    "n_embd": 768,
    "n_layer": 12,
    "n_head": 12,
    "n_positions": 1024,
}
# the gpt2_serve phase's fp32 check: requests, new tokens each
GPT2_FP32_SERVE = dict(n_requests=6, max_new=32)
# Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1, config.json): Mistral's attention
# (32/8 heads of 128, no sliding window), 8 experts of MLP 14336, 2 a token,
# an untied head. Random weights from a seed; depth cut as MIXTRAL_LAYERS says
MIXTRAL_8X7B = {
    "model_type": "mixtral",
    "vocab_size": 32000,
    "hidden_size": 4096,
    "num_hidden_layers": 32,
    "num_attention_heads": 32,
    "num_key_value_heads": 8,
    "intermediate_size": 14336,
    "num_local_experts": 8,
    "num_experts_per_tok": 2,
    "max_position_embeddings": 32768,
    "rope_theta": 1000000.0,
    "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False,
}
# layers of each mixtral phase: the experts are 1.41 B parameters a layer, so
# bf16 (90 GB at 32 layers) runs cut to 8 layers (24 GB); int4 (about 25 GB)
# runs all 32; int8 (about 48 GB at 32) is cut to 16 layers to keep the run
# inside its time (it runs the same kernels as at 32, K11a in every layer)
MIXTRAL_LAYERS = {4: 32, 8: 16, None: 8}
MOE_GROUP = 128  # the JAX engine's group of int4 and int8 MoE models
# kernel route vs plain route at full width (mixtral phases), max abs error of
# the logits (std 1.28) at every sampled position on forced tokens, the plain
# route's routing replayed in the kernel route (_Routing), by the phase's
# weights: fp32 at 2 layers as MODEL_LOGIT_TOL; in bf16 an H100 read 0.828
# (int4, 32 layers), 0.911 (int8, 32 layers) and 0.169 (bf16, 8 layers); the
# limits leave 2.2x to 3x room
MIXTRAL_LOGIT_TOL = {4: 2.0, 8: 2.0, None: 0.5}
# the moe_kernels phase: rows of a call (4 tokens x 2 experts, 16 serving
# rows x 2, a verify of 16 rows x 5 positions x 2), the stacks' layers
MOE_ROWS = (8, 32, 160)
MOE_SWEEP_SPLITS = (1, 2, 4, 6, 8, 12, 16)  # K12's cluster sizes swept against its plan
MOE_STACK_LAYERS = 2
# the mixtral4 phase's serving leg: the serve phase's scheduler, 8 requests
MIXTRAL_SERVE = dict(n_requests=8, prompt_len=512, max_new=64, gap_s=0.25)
# The JAX package's five other bench shapes (benches/flagship_bench.py:37-78,
# SHAPES), copied: that file imports JAX. Each is its published model's
# config.json (Qwen/Qwen2.5-0.5B, meta-llama/Llama-3.2-1B, meta-llama/Llama-3.2-3B,
# Qwen/Qwen3-1.7B) as the JAX bench writes it; moe_8x1b is the JAX bench's own
# Mixtral-architecture MoE (8 experts of 4,096, 2 a token), no published
# checkpoint. Weights random from a seed; widths and depths not cut
BENCH_SHAPES = {
    "qwen25_05b": {  # Qwen2.5-0.5B (qkv bias, tied embeddings)
        "model_type": "qwen2", "vocab_size": 151936, "hidden_size": 896,
        "num_hidden_layers": 24, "num_attention_heads": 14,
        "num_key_value_heads": 2, "intermediate_size": 4864,
        "max_position_embeddings": 32768, "rope_theta": 1000000.0,
        "rms_norm_eps": 1e-6, "tie_word_embeddings": True,
    },
    "llama32_1b": {  # Llama-3.2-1B (GQA, tied)
        "model_type": "llama", "vocab_size": 128256, "hidden_size": 2048,
        "num_hidden_layers": 16, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 64,
        "intermediate_size": 8192, "max_position_embeddings": 32768,
        "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": True,
    },
    "llama32_3b": {  # Llama-3.2-3B
        "model_type": "llama", "vocab_size": 128256, "hidden_size": 3072,
        "num_hidden_layers": 28, "num_attention_heads": 24,
        "num_key_value_heads": 8, "head_dim": 128,
        "intermediate_size": 8192, "max_position_embeddings": 32768,
        "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": True,
    },
    "qwen3_17b": {  # Qwen3-1.7B (qk-norm, tied)
        "model_type": "qwen3", "vocab_size": 151936, "hidden_size": 2048,
        "num_hidden_layers": 28, "num_attention_heads": 16,
        "num_key_value_heads": 8, "head_dim": 128,
        "intermediate_size": 6144, "max_position_embeddings": 32768,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": True,
    },
    "moe_8x1b": {  # Mixtral-architecture 8-expert MoE
        "model_type": "mixtral", "vocab_size": 32768, "hidden_size": 2048,
        "num_hidden_layers": 16, "num_attention_heads": 32,
        "num_key_value_heads": 8, "head_dim": 64,
        "intermediate_size": 4096, "num_local_experts": 8,
        "num_experts_per_tok": 2, "max_position_embeddings": 32768,
        "rope_theta": 1000000.0, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False,
    },
}
# kernel route vs plain route at full width and depth (the bench-shape
# phases), max abs error of the logits at every sampled position on forced
# tokens, by shape and weight format (moe_8x1b with the plain route's
# routing replayed): both routes run the same weights, attention and the
# int4 / int8 matmuls differ in summation order and rounding only, which the
# random stack amplifies layer after layer (logits std 0.6 for Qwen2.5-0.5B,
# 0.91 for Qwen3-1.7B, Llama-3.2-1B and moe_8x1b, 1.12 for Llama-3.2-3B).
# An H100 read, over two chunks of 32 steps, the value in each comment; the
# limits leave 2.3x to 2.6x room. fp32 legs keep MODEL_LOGIT_TOL["float32"]
SHAPE_LOGIT_TOL = {
    ("qwen3_17b", "bf16"): 0.4,     # 0.1562
    ("qwen3_17b", "int8"): 0.5,     # 0.2148
    ("qwen3_17b", "int4"): 0.5,     # 0.2148
    ("qwen25_05b", "bf16"): 0.15,   # 0.06348
    ("qwen25_05b", "int4"): 0.2,    # 0.07812
    ("llama32_1b", "bf16"): 0.3,    # 0.1172
    ("llama32_1b", "int4"): 0.4,    # 0.168
    ("llama32_3b", "int4"): 0.75,   # 0.3081
    ("moe_8x1b", "int4"): 0.3,      # 0.1172
}
# decode chunks of DECODE_CHUNK steps over which the bench-shape phases hold
# the kernel route to the plain route (the main path's run keeps N_CHUNKS):
# the plain route's int4 / int8 steps dequantize every weight (40 to 120 ms a
# step), and the prefill's last position alone read 82 % to 100 % of each
# reading above
SHAPE_CHECK_CHUNKS = 1
# the stream phase: GPTEngine.generate_async on a full-width Mistral-7B dir
# at batch 1 (bf16, then int4 with AWQ by default), max_tokens tokens at
# stream_chunk 1 (the per-token route, K13) and 8 (K2)
STREAM = dict(max_tokens=1 + N_CHUNKS * DECODE_CHUNK, chunks=(1, 8), rounds=4)
STREAM_PROMPT = ("The printing press changed how knowledge moved through Europe. Before it, "
                 "a book was copied by hand, one page at a time, and a library of a few "
                 "hundred volumes was a fortune. Within fifty years of the first presses, "
                 "millions of books were in print, and")


DEVICE = "cuda"
E4M3 = None  # torch.float8_e4m3fn, set by main() (torch is imported there)
CARD = "not measured"  # nvidia-smi's name and power limit, set by phase_env


class PhaseError(RuntimeError):
    pass




def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one fn() call: the device time of every kernel,
    copy and fill that `iters` back-to-back calls ran, from torch.profiler,
    over `iters` (after `warmup` calls). Gaps between launches do not
    count: the host's launch overhead of a small kernel exceeds its device
    time, so CUDA events around a loop of calls would time the host. A
    profiler session that comes back without device events (it happens,
    rarely) is repeated; after three such, CUDA events time the loop."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us:
            return us / iters / 1e3
    log("[time] torch.profiler saw no device time three times: CUDA events instead")
    return _events_ms(fn, iters, warmup=0)


def _events_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms of one fn() call between CUDA events around `iters`
    back-to-back calls (after `warmup` calls): gaps between launches
    count."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def graph_ms(fn, calls: int, reps: int = 5, warmup: int = 3) -> list:
    """`reps` readings of the mean device ms of one fn(i) call, each over a
    CUDA graph of fn(0) .. fn(calls - 1) launched back to back, between
    CUDA events around one replay: no host gap between the launches, and
    every kernel of the graph counted (torch.profiler's device time has
    come back below the bytes' bound for back-to-back GEMVs). Graph kernel
    launches add well under a microsecond each. Returns the readings in
    the order taken."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        out.append(start.elapsed_time(stop) / calls)
    del graph
    return out


def _spread(xs) -> str:
    """A list of readings as 'median (min-max of n)'."""
    return f"{statistics.median(xs):.4f} ({min(xs):.4f}-{max(xs):.4f} of {len(xs)})"


def events_ms(fn, L: int, calls: int = 0) -> float:
    """Median device ms of one fn(l) call walking the L layers (l = i % L:
    cold K/V, as a step reads its layers in turn), by CUDA events around a
    CUDA graph of the calls (graph_ms; 4 * L calls unless `calls`): a
    single cluster launch reads 20 % to 30 % low under torch.profiler."""
    return statistics.median(graph_ms(lambda i: fn(i % L), calls or 4 * L))


def split_sweep(tag: str, name: str, label: str, call, L: int, plan: int, note=""):
    """`name` through its C entry point at every cluster size C = 1 .. 8
    (call(l, C) launches it at layer l), each timed by events_ms over the L
    layers, logged beside the plan's pick. A split the kernel refuses fails
    the phase. Returns {C: ms}."""
    times = {}
    for C in range(1, 9):
        try:
            times[C] = events_ms(lambda l: call(l, C), L)
        except RuntimeError as e:
            raise PhaseError(f"{name} split sweep {label}: C={C} refused ({e})") from e
    best = min(times, key=times.get)
    log(f"{tag} {name} split sweep {label}{note}: "
        + ", ".join(f"C={c} {t:.4f}" for c, t in times.items())
        + f" ms (CUDA events); the plan's C={plan} {times[plan]:.4f}, the fastest C={best} "
        f"({times[plan] / times[best]:.3f}x)")
    return times


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# -- env / build ---------------------------------------------------------------


def phase_env() -> dict:
    import torch

    from tinygpt_tpu_torch.ops import cuda_build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    global CARD
    CARD = smi
    log(f"[env] python {sys.version.split()[0]}  torch {torch.__version__} "
        f"(cuda {torch.version.cuda})  nvcc: {nvcc}")
    log(f"[env] devices: {torch.cuda.device_count()}  "
        f"name: {torch.cuda.get_device_name(0)}")
    return {"smi": smi}


def phase_build() -> None:
    import threading

    from tinygpt_tpu_torch.ops import cuda_build, host_build

    # the host cores (g++) build beside the kernels (nvcc)
    host = {}

    def build_host():
        try:
            host["seconds"] = host_build.build_all()
        except RuntimeError as e:
            host["error"] = e

    t0 = time.perf_counter()
    thread = threading.Thread(target=build_host)
    thread.start()
    try:
        built = cuda_build.build_all()
    finally:
        thread.join()
    log(f"[build] {len(built)} libraries in {time.perf_counter() - t0:.1f} s "
        f"(parallel nvcc): {json.dumps({k: round(v, 1) for k, v in built.items()})}")
    if "error" in host:
        raise PhaseError(f"host libraries: {host['error']}")
    log(f"[build] host libraries (g++, beside nvcc): "
        f"{json.dumps({k: round(v, 2) for k, v in host['seconds'].items()})} s")
    for src in host_build.SOURCES:
        if host_build.load(src) is None:
            raise PhaseError(f"host library of {src} does not load")
    for src in cuda_build.SOURCES:
        text = cuda_build.build_log(src)
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", text)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores", text)]
        if not regs:
            raise PhaseError(f"no ptxas report for {src} in its build log")
        log(f"[build] {src}: {len(regs)} instantiations, {min(regs)}-{max(regs)} "
            f"registers a thread, {sum(s > 0 for s in spills)} with spills "
            f"(at most {max(spills)} bytes)")
    _attention_reports()


def _ptxas_entries(text: str) -> dict:
    """{mangled kernel name: (registers, spill store bytes, static shared
    memory bytes)} from a ptxas -v report."""
    entries, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            entries[name] = [0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            entries[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entries[name][0] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            entries[name][2] = int(m.group(1)) if m else 0
    return {k: tuple(v) for k, v in entries.items()}


def _demangle(names) -> dict:
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True,
                             text=True, check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        return {n: n for n in names}
    return dict(zip(names, (o.replace("(anonymous namespace)::", "").split("(")[0]
                            for o in out)))


def _attention_reports() -> None:
    """The redesigned kernels' instantiations at the main path's types (K1,
    K13, K2, the int8 GEMV of K3/K5a, the prefill kernel of K5a/K5b, K8,
    K9, K12's bf16 body and K11a's and K11b's at 8 and 32 rows a pass, bf16
    x; every instantiation of K10's tensor-core split): registers, spills
    and static shared memory
    (ptxas -v; their shared-memory rings are dynamic, sized at launch as
    the sources' head notes give them); and the Hopper instructions in
    their machine code (cuobjdump -sass): wgmma (HGMMA) and TMA loads
    (UTMALDG) in K1 and the prefill kernel, cluster barriers (UCGABAR) in
    K13, K2, K8, K9, K10, K12, the GEMV and the prefill kernel's split,
    cp.async copies (LDGSTS) in the GEMV, K8, K9, K10, K12 and K11, and
    mma.sync (HMMA) from ldmatrix (LDSM) in K10 and K12."""
    from tinygpt_tpu_torch.ops import cuda_build

    wanted = {
        "flash_prefill.cu": ("flash_prefill_tc<__nv_bfloat16, __nv_bfloat16, 128>",
                             "flash_prefill_tc<__nv_bfloat16, __nv_fp8_e4m3, 128>",
                             "flash_prefill_tc<__nv_bfloat16, __nv_bfloat16, 64>"),
        "flash_decode.cu": ("split_decode_kernel<__nv_bfloat16, __nv_bfloat16, 128, 4, false>",
                            "split_decode_kernel<__nv_bfloat16, __nv_fp8_e4m3, 128, 4, false>"),
        "flash_decode_frozen.cu": (
            "split_decode_kernel<__nv_bfloat16, __nv_bfloat16, 128, 4, true>",
            "split_decode_kernel<__nv_bfloat16, __nv_fp8_e4m3, 128, 4, true>"),
        "int8_matmul.cu": ("int8_gemv_kernel<__nv_bfloat16, 4, true>",
                           "int8_gemv_kernel<__nv_bfloat16, 8, true>",
                           "int8_gemv_kernel<float, 4, true>",
                           "dequant_mm_tc<tg::dqmm::Int8, 256>",
                           "dequant_mm_tc<tg::dqmm::Int8, 128>"),
        "int4_matmul.cu": ("dequant_mm_tc<tg::dqmm::Int4, 256>",
                           "dequant_mm_tc<tg::dqmm::Int4, 128>"),
        "paged_decode_frozen.cu": (
            "paged_split_kernel<__nv_bfloat16, __nv_bfloat16, 128, 4, true>",
            "paged_split_kernel<__nv_bfloat16, __nv_fp8_e4m3, 128, 4, true>",
            "paged_split_kernel<__nv_bfloat16, __nv_bfloat16, 64, 1, true>"),
        "paged_decode.cu": ("paged_split_kernel<__nv_bfloat16, __nv_bfloat16, 64, 1, false>",
                            "paged_split_kernel<__nv_bfloat16, __nv_fp8_e4m3, 64, 1, false>",
                            "paged_split_kernel<__nv_bfloat16, __nv_bfloat16, 128, 4, false>"),
        "paged_decode_spec.cu": (
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_bfloat16, 128, 2>",
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_fp8_e4m3, 128, 2>",
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_bfloat16, 128, 1>",
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_bfloat16, 64, 1>",
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_bfloat16, 64, 2>",
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_bfloat16, 64, 4>",
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_fp8_e4m3, 128, 1>",
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_fp8_e4m3, 64, 1>",
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_fp8_e4m3, 64, 2>",
            "paged_spec_tc_kernel<__nv_bfloat16, __nv_fp8_e4m3, 64, 4>",
            "paged_spec_tc_kernel<__half, __half, 128, 1>",
            "paged_spec_tc_kernel<__half, __half, 128, 2>",
            "paged_spec_tc_kernel<__half, __half, 64, 1>",
            "paged_spec_tc_kernel<__half, __half, 64, 2>",
            "paged_spec_tc_kernel<__half, __half, 64, 4>"),
        "moe_gather_matmul.cu": ("moe_gather_tc_kernel<__nv_bfloat16, 1, 1>",
                                 "moe_gather_tc_kernel<__nv_bfloat16, 4, 1>",
                                 "moe_gather_tc_kernel<__nv_bfloat16, 8, 1>",
                                 "moe_gather_q_kernel<__nv_bfloat16, 1, 1, 1>",
                                 "moe_gather_q_kernel<__nv_bfloat16, 1, 4, 1>",
                                 "moe_gather_q_kernel<__nv_bfloat16, 2, 1, 1>",
                                 "moe_gather_q_kernel<__nv_bfloat16, 2, 4, 1>"),
    }
    ops = {"flash_prefill.cu": ("HGMMA", "UTMALDG"), "flash_decode.cu": ("UCGABAR",),
           "flash_decode_frozen.cu": ("UCGABAR",),
           "int8_matmul.cu": ("UCGABAR", "LDGSTS", "HGMMA", "UTMALDG"),
           "int4_matmul.cu": ("HGMMA", "UTMALDG", "UCGABAR"),
           "paged_decode_frozen.cu": ("UCGABAR", "LDGSTS"),
           "paged_decode.cu": ("UCGABAR", "LDGSTS"),
           "paged_decode_spec.cu": ("HMMA", "LDSM", "LDGSTS", "UCGABAR"),
           "moe_gather_matmul.cu": ("HMMA", "LDSM", "LDGSTS", "UCGABAR")}
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    for src, kernels in wanted.items():
        entries = _ptxas_entries(cuda_build.build_log(src))
        names = _demangle(list(entries))
        for want in kernels:
            hits = [m for m, d in names.items() if d.endswith(want)]
            if not hits:
                raise PhaseError(f"{src}: no ptxas report for {want}")
            regs, spill, smem = entries[hits[0]]
            log(f"[build] {src} {want}: {regs} registers, {spill} bytes spilled, "
                f"{smem} bytes of static shared memory")
        sass = subprocess.run([cuobjdump, "-sass", str(cuda_build.library_path(src))],
                              capture_output=True, text=True).stdout
        counts = {op: len(re.findall(rf"\b{op}", sass)) for op in ops[src]}
        log(f"[build] {src} machine code: " + ", ".join(f"{n} {op}" for op, n in counts.items()))
        if not all(counts.values()):
            raise PhaseError(f"{src}: missing {counts} in its machine code")


# -- kernels -------------------------------------------------------------------


def _prefill_case(B, Nq, Nk, D, S, T, pads, q_slot, window, dtype, seed):
    """Inputs of one flash_prefill call on the card: row b holds pads[b]
    pad slots, then real tokens up to slot q_slot + S."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE
    q = torch.randn(B, Nq, S, D, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Nk, T, D, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Nk, T, D, generator=g, device=dev).to(dtype)
    slots = torch.arange(T, device=dev)[None, :]
    pad = torch.tensor(pads, device=dev)[:, None]
    valid = (slots >= pad) & (slots < q_slot + S)
    return q, k, v, valid.contiguous(), D ** -0.5, q_slot, window


def _prefill_cost(q, k, valid, q_slot, window):
    """(bytes, flops) that this call's data needs: q, the cache rows some
    query row sees (K and V, in the cache's dtype), the validity bytes and
    the output; 4*D operations per visible (query, slot) pair."""
    import torch

    B, Nq, S, D = q.shape
    Nk, T = k.shape[1], k.shape[2]
    rows = q_slot + torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    vis = cols <= rows
    if window:
        vis = vis & (cols > rows - window)
    vis = vis[None] & valid[:, None, :]                    # [B, S, T]
    pairs = int(vis.sum()) * Nq
    seen = int(vis.any(dim=1).sum()) * Nk                  # cache rows read
    isz = q.element_size()
    nbytes = 2 * q.numel() * isz + 2 * seen * D * k.element_size() + valid.numel()
    return nbytes, 4.0 * D * pairs


def _decode_case(L, B, Nq, Nk, D, T, N, pads, length, step, window, dtype, seed):
    """Inputs of one flash_decode_frozen call: row b's frozen cache holds
    pads[b] pad slots then real tokens up to slot `length`; the query is
    the chunk's token `step`."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE
    ks = torch.randn(L, B, Nk, T, D, generator=g, device=dev).to(dtype)
    vs = torch.randn(L, B, Nk, T, D, generator=g, device=dev).to(dtype)
    ki = torch.randn(B, Nk, N, D, generator=g, device=dev).to(dtype)
    vi = torch.randn(B, Nk, N, D, generator=g, device=dev).to(dtype)
    q = torch.randn(B, Nq, D, generator=g, device=dev).to(dtype)
    slots = torch.arange(T, device=dev)[None, :]
    pad = torch.tensor(pads, device=dev)[:, None]
    valid = (slots >= pad) & (slots < length)
    kv_pos = (slots - pad).clamp(min=0)
    pos = length - pad + step                               # [B, 1]
    mask = valid & (kv_pos <= pos)
    if window:
        mask = mask & (kv_pos > pos - window)
    return q, ks, vs, mask.contiguous(), ki, vi, step, window


def _decode_cost(q, mask, k_infl, step, window, kv_size=None):
    """(bytes, flops): q, the visible frozen slots' K and V (kv_size bytes
    an element, default q's) and in-flight slots', the mask, the output."""
    B, Nq, D = q.shape
    Nk, N = k_infl.shape[1], k_infl.shape[2]
    n_infl = min(step + 1, window) if window else step + 1
    isz = q.element_size()
    frozen = int(mask.sum()) * Nk * D * 2 * (kv_size or isz)
    nbytes = (2 * q.numel() * isz + frozen + 2 * B * n_infl * Nk * D * k_infl.element_size()
              + mask.numel())
    return nbytes, 4.0 * D * (int(mask.sum()) + B * n_infl) * Nq


def _sdpa(q, k, v, attn_mask, scale):
    """One scaled_dot_product_attention call with grouped KV heads (torch
    2.5 takes them as they are; older torch gets them repeated up front,
    outside the timed call)."""
    import torch
    import torch.nn.functional as F

    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, scale=scale, enable_gqa=True)
    G = q.shape[1] // k.shape[1]
    k, v = k.repeat_interleave(G, dim=1), v.repeat_interleave(G, dim=1)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask,
                                                  scale=scale)


def _sdpa_prefill(q, k, v, valid, scale, q_slot, window):
    """torch's fused attention on the same function (timing yardstick)."""
    import torch

    S, T = q.shape[2], k.shape[2]
    rows = q_slot + torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(T, device=q.device)[None, :]
    vis = cols <= rows
    if window:
        vis = vis & (cols > rows - window)
    attn_mask = (vis[None] & valid[:, None, :])[:, None]   # [B, 1, S, T]
    return _sdpa(q, k, v, attn_mask, scale)


def _sdpa_decode(q, ks, vs, mask, ki, vi, l, step, scale, window):
    import torch

    B, Nq, D = q.shape
    N = ki.shape[2]
    k = torch.cat([ks[l], ki], dim=2)
    v = torch.cat([vs[l], vi], dim=2)
    j = torch.arange(N, device=q.device)
    vis_i = (j <= step) & ((step - j) < window if window else True)
    attn_mask = torch.cat([mask, vis_i.expand(B, N)], dim=1)[:, None, None, :]
    return _sdpa(q[:, :, None, :], k, v, attn_mask, scale)


def phase_kernels(main_path: dict) -> dict:
    """Kernel vs plain version on the card; returns the kernel table rows
    at the main path's shapes (filled with launches by the model phase)."""
    import torch

    from tinygpt_tpu_torch.ops import attention_kernels as ak

    table = {}
    worst = {}
    B, Nq, Nk = 4, 32, 8
    # (label, D, S, T, pads, q_slot, window, dtype, is_main_path)
    mp = main_path["prefill"]
    prefill_cases = [
        ("main path", 128, mp["S"], mp["T"], mp["pads"], 0, None, torch.bfloat16, True),
        # the batcher's admission of one 512-token prompt; GPT-2's prefill
        ("admission B=1 S512/T512", 128, 512, 512, (0,), 0, None, torch.bfloat16, False),
        ("GPT-2 12/12 heads", 64, mp["S"], mp["T"], mp["pads"], 0, None, torch.bfloat16,
         False),
        ("S512/T1024 q_slot256 w256", 128, 512, 1024, (0, 100, 300, 500), 256, 256,
         torch.bfloat16, False),
        ("S512/T1024 q_slot256 w256", 128, 512, 1024, (0, 100, 300, 500), 256, 256,
         torch.float32, False),
        ("S512/T1024 q_slot256", 64, 512, 1024, (0, 100, 300, 500), 256, None,
         torch.bfloat16, False),
        ("S200/T300 q_slot37 w50", 64, 200, 300, (0, 13, 90, 230), 37, 50,
         torch.float32, False),
    ]
    for i, (label, D, S, T, pads, q_slot, window, dtype, main) in enumerate(prefill_cases):
        heads = (12, 12) if label.startswith("GPT-2") else (Nq, Nk)
        args = _prefill_case(len(pads), *heads, D, S, T, pads, q_slot, window, dtype, seed=i)
        got = ak.flash_prefill(*args)
        want = ak.flash_prefill_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        dname = str(dtype).replace("torch.", "")
        ok = math.isfinite(err) and err <= TOL[dname]
        worst[("flash_prefill", dname)] = max(err, worst.get(("flash_prefill", dname), 0.0))
        t_k = cuda_time_ms(lambda: ak.flash_prefill(*args))
        t_p = cuda_time_ms(lambda: ak.flash_prefill_plain(*args), iters=5)
        t_l = cuda_time_ms(_sdpa_prefill(*args), iters=10)
        nbytes, flops = _prefill_cost(args[0], args[1], args[3], q_slot, window)
        b_ms, b_by = bound_ms(nbytes, flops, dname)
        log(f"[kernels] flash_prefill {label} D={D} {dname}: max_abs_err {err:.3g} "
            f"(tol {TOL[dname]}) kernel {t_k:.4f} ms plain {t_p:.4f} ms sdpa {t_l:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by}) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise PhaseError(f"flash_prefill {label} {dname}: error {err} > {TOL[dname]}")
        if main:
            table["flash_prefill"] = dict(
                name="flash_prefill", route="cuda", source=SOURCES["flash_prefill"],
                replaces=REPLACES["flash_prefill"], launches=0, max_abs_err=err,
                tol=TOL[dname], ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_l)

    # the e4m3 branch at the main path's shape: bf16 queries over an fp8 cache
    from tinygpt_tpu_torch.engine.kv_cache import kv_cast

    q, k, v, valid, scale, q_slot, window = _prefill_case(
        B, Nq, Nk, 128, mp["S"], mp["T"], mp["pads"], 0, None, torch.bfloat16, seed=0)
    args = (q, kv_cast(k, E4M3), kv_cast(v, E4M3), valid, scale, q_slot, window)
    _e4m3_row("flash_prefill", "[kernels]", "main path", lambda: ak.flash_prefill(*args),
              lambda: ak.flash_prefill_plain(*args), _prefill_cost(q, args[1], valid, 0, None),
              iters=(20, 5))

    _decode_frozen_cases(table, worst, main_path["decode"])
    for (name, dname), err in sorted(worst.items()):
        log(f"[kernels] {name} {dname}: worst max_abs_err over all cases {err:.3g} "
            f"(tol {TOL[dname]})")
    return table


def _decode_frozen_cases(table: dict, worst: dict, md: dict) -> None:
    """flash_decode_frozen (K2) against its plain version on the card: the
    model phase's decode shape (B = 4, 32/8 heads of 128, T = 576, N = 32,
    the chunk's last step), T1024/N32 with and without a window, fp32, head
    dim 64, and the e4m3 branch at the main path's shape; each timed over
    the stack's layers in turn beside its bound, the plain version and
    scaled_dot_product_attention. Fills K2's table row and `worst`."""
    import torch

    from tinygpt_tpu_torch.engine.kv_cache import kv_cast
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    B, Nq, Nk = 4, 32, 8
    # (label, L, D, T, N, pads, length, steps, window, dtype, is_main_path)
    decode_cases = [
        ("main path", 32, 128, md["T"], md["N"], md["pads"], md["length"], (md["step"],),
         None, torch.bfloat16, True),
        ("T1024/N32", 4, 128, 1024, 32, (0, 37, 211, 600), 900, (0, 5, 31), None,
         torch.bfloat16, False),
        ("T1024/N32 w300", 4, 128, 1024, 32, (0, 37, 211, 600), 900, (0, 17, 31), 300,
         torch.bfloat16, False),
        ("T1024/N32 w300", 4, 128, 1024, 32, (0, 37, 211, 600), 900, (3, 31), 300,
         torch.float32, False),
        ("T1024/N32", 4, 64, 1024, 32, (0, 37, 211, 600), 900, (0, 31), None,
         torch.bfloat16, False),
        ("T1024/N16 w20", 4, 64, 1024, 16, (0, 37, 211, 600), 900, (2, 15), 20,
         torch.float32, False),
    ]
    for i, (label, L, D, T, N, pads, length, steps, window, dtype, main) in enumerate(
            decode_cases):
        dname = str(dtype).replace("torch.", "")
        for step in steps:
            q, ks, vs, mask, ki, vi, _, _ = _decode_case(
                L, B, Nq, Nk, D, T, N, pads, length, step, window, dtype, seed=100 + i)
            for l in sorted({0, L // 2, L - 1}):
                args = (q, ks, vs, mask, ki, vi, l, step, D ** -0.5, window)
                got = ak.flash_decode_frozen(*args)
                want = ak.flash_decode_frozen_plain(*args)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                ok = math.isfinite(err) and err <= TOL[dname]
                key = ("flash_decode_frozen", dname)
                worst[key] = max(err, worst.get(key, 0.0))
                if not ok:
                    raise PhaseError(f"flash_decode_frozen {label} l={l} step={step} "
                                     f"{dname}: error {err} > {TOL[dname]}")
            # cycle through the layers, as a decode step does: the stacks
            # exceed the 50 MB L2 cache, so each call reads cold K/V; three
            # readings, the median kept
            def kern(i, q=q, ks=ks, vs=vs, mask=mask, ki=ki, vi=vi, L=L, step=step, D=D,
                     window=window):
                return ak.flash_decode_frozen(q, ks, vs, mask, ki, vi, i % L, step, D ** -0.5,
                                              window)

            calls = iter(range(10 ** 9))
            r_k = [cuda_time_ms(lambda: kern(next(calls)), iters=4 * L) for _ in range(3)]
            t_k = statistics.median(r_k)
            l = L - 1
            args = (q, ks, vs, mask, ki, vi, l, step, D ** -0.5, window)
            t_p = cuda_time_ms(lambda: ak.flash_decode_frozen_plain(*args), iters=10)
            t_l = cuda_time_ms(_sdpa_decode(*args), iters=20)
            nbytes, flops = _decode_cost(q, mask, ki, step, window)
            b_ms, b_by = bound_ms(nbytes, flops, dname)
            host = f" host {host_us(kern):.1f} us a call" if main else ""
            log(f"[kernels] flash_decode_frozen {label} D={D} step={step} {dname}: "
                f"max_abs_err {err:.3g} (tol {TOL[dname]}) kernel {_spread(r_k)} ms "
                f"plain {t_p:.4f} ms sdpa {t_l:.4f} ms bound {b_ms:.4f} ms ({b_by}){host} ok")
            if main:
                table["flash_decode_frozen"] = dict(
                    name="flash_decode_frozen", route="cuda",
                    source=SOURCES["flash_decode_frozen"],
                    replaces=REPLACES["flash_decode_frozen"], launches=0,
                    max_abs_err=err, tol=TOL[dname], ms=t_k, plain_ms=t_p,
                    bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
    # the e4m3 branch at the main path's decode shape (in-flight K/V bf16)
    q, ks, vs, mask, ki, vi, step, window = _decode_case(
        32, B, Nq, Nk, 128, md["T"], md["N"], md["pads"], md["length"], md["step"], None,
        torch.bfloat16, seed=100)
    ks8, vs8 = kv_cast(ks, E4M3), kv_cast(vs, E4M3)
    del ks, vs
    layers = iter(range(10 ** 9))
    _e4m3_row("flash_decode_frozen", "[kernels]", "main path",
              lambda: ak.flash_decode_frozen(q, ks8, vs8, mask, ki, vi, next(layers) % 32,
                                             step, 128 ** -0.5),
              lambda: ak.flash_decode_frozen_plain(q, ks8, vs8, mask, ki, vi, 31, step,
                                                   128 ** -0.5),
              _decode_cost(q, mask, ki, step, None, kv_size=1), iters=(4 * 32, 10),
              check=lambda: (ak.flash_decode_frozen(q, ks8, vs8, mask, ki, vi, 31, step,
                                                    128 ** -0.5),
                             ak.flash_decode_frozen_plain(q, ks8, vs8, mask, ki, vi, 31,
                                                          step, 128 ** -0.5)))
    del ks8, vs8
    torch.cuda.empty_cache()


E4M3_ROWS = {}  # kernel -> its e4m3 branch's numbers at the main path's shape


def _e4m3_row(name, tag, label, kern, plain, cost, iters, check=None, tol=None):
    """Checks a kernel's e4m3 branch against its plain version (bf16
    queries and output: one bf16 ulp, as the bf16 cases) and times both
    beside the bound with the cache's bytes at one byte an element."""
    import torch

    got, want = check() if check else (kern(), plain())
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    tol = tol if tol is not None else TOL["bfloat16"]   # a number, or one per output
    share = (err / tol).max().item()
    err = err.max().item()
    if not (math.isfinite(err) and share <= 1):
        raise PhaseError(f"{name} e4m3 {label}: error {err}, {share:.3g} of its bound")
    t_k = cuda_time_ms(kern, iters=iters[0])
    t_p = cuda_time_ms(plain, iters=iters[1])
    b_ms, b_by = bound_ms(*cost, "bfloat16")
    E4M3_ROWS[name] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms, max_abs_err=err)
    log(f"{tag} {name} e4m3 {label} (bf16 q): max_abs_err {err:.3g} ({share:.3g} of its "
        f"bound) "
        f"kernel {t_k:.4f} ms plain {t_p:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
        f"{cost[0] / 1e6:.2f} MB)")


# -- int4 kernels --------------------------------------------------------------


def _int4_stack(g, L, IN, OUT, group, dev=None):
    """Random packed int4 bytes [L, IN/2, OUT] and fp32 scales
    [L, IN/group, OUT] on the card (every byte is a valid nibble pair)."""
    import torch

    dev = dev or DEVICE
    data = torch.randint(-128, 128, (L, IN // 2, OUT), generator=g, device=dev,
                         dtype=torch.int8)
    scales = torch.rand((L, IN // group, OUT), generator=g, device=dev) * 0.01 + 1e-3
    return data, scales


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _int4pack_library(x, data, scales, group):
    """torch._weight_int4pack_mm on the same function (timing yardstick):
    the half-split biased nibbles repacked to its [OUT, IN/2] k-pairs and
    the scales to bf16 [IN/group, OUT, 2] with zero points 0, outside the
    timed call. Returns (the call, None) or (None, the reason)."""
    import torch

    if x.dtype != torch.bfloat16:
        return None, "takes bf16 activations only"
    if not hasattr(torch, "_weight_int4pack_mm"):
        return None, "this torch has no _weight_int4pack_mm"
    u = data.view(torch.uint8)
    full = torch.cat([u & 0x0F, u >> 4], dim=0).t().contiguous()   # [OUT, IN] u
    w = ((full[:, 0::2] << 4) | full[:, 1::2]).contiguous()
    try:
        packed = torch._convert_weight_to_int4pack(w, 8)
        sz = torch.stack([scales, torch.zeros_like(scales)], dim=-1).to(torch.bfloat16)
        call = (lambda: torch._weight_int4pack_mm(x, packed, group, sz))
        call()
    except RuntimeError as e:  # the yardstick only: the port never calls it
        return None, f"torch._weight_int4pack_mm refused: {str(e).splitlines()[0][:120]}"
    return call, None


def _dequant_weight(data, scales, group, l):
    """Layer l of an int8 [L, IN, OUT] or packed int4 [L, IN/2, OUT] stack,
    dequantized to bf16 (the cuBLAS yardstick's weight)."""
    import torch

    from tinygpt_tpu_torch.ops import quant_kernels as qk

    q = data[l] if data.shape[1] == scales.shape[1] * group else qk.unpack_int4(data[l])
    return qk.dequant_fp32(q, scales[l], group).to(torch.bfloat16)


def _time_dequant_mm(tag, name, key, M, data, scales, group, weight, check, library=None,
                     one_layer=False):
    """A dequant matmul (`name`: K5a or K5b, or with one_layer K3 or K4 on
    layer l of the stack) at M rows of x over the stack (data, scales):
    held against its plain version in bf16 and fp32 at the first and last
    layer (check(name, label, dtype, got, want) -> (err, tol)), then timed
    in bf16 by graph_ms (at least 30 calls walking the stack's layers)
    beside cuBLAS on the weight dequantized to bf16 beforehand (walking
    LIB_LAYERS layers) and, where given, library(x, l) -> (call, why);
    beside them the host's microseconds a decode-shaped call. Each median
    reading is held against its own bound: a time below the least time
    the card could take is a fault of the timing. Returns the kernel
    table's row (weight, ms, plain, bound, bound_by, library ms, err, tol)
    with the cuBLAS ms last, the bf16 x and the case's label."""
    import torch

    from tinygpt_tpu_torch.ops import quant_kernels as qk

    kern, plain = getattr(qk, name), getattr(qk, name + "_plain")
    if one_layer:
        kern, plain = ((lambda x, d, s, l, g, f=f: f(x, d[l], s[l], g)) for f in (kern, plain))
    Ls, rows, OUT = data.shape
    IN = scales.shape[1] * group
    label = f"{key} M={M} {IN}->{OUT}"
    xs = {}
    for dt in (torch.float32, torch.bfloat16):
        gx = torch.Generator(device=DEVICE).manual_seed(1000 + M)
        xs[dt] = torch.randn((M, IN), generator=gx, device=DEVICE).to(dt)
        for l in sorted({0, Ls - 1}):
            err, tol = check(name, label, dt, kern(xs[dt], data, scales, l, group),
                             plain(xs[dt], data, scales, l, group))
    xb = xs[torch.bfloat16]
    n_calls = max(30, 3 * Ls)
    r_k = graph_ms(lambda i: kern(xb, data, scales, i % Ls, group), n_calls)
    t_p = cuda_time_ms(lambda: plain(xb, data, scales, Ls - 1, group), iters=3, warmup=1)
    nl = min(Ls, LIB_LAYERS)
    ws = [_dequant_weight(data, scales, group, l) for l in range(nl)]
    r_cub = graph_ms(lambda i: torch.matmul(xb, ws[i % nl]), max(30, 3 * nl))
    cub_b = bound_ms(_nbytes(xb, ws[0]) + M * OUT * 2, 2.0 * M * IN * OUT, "bfloat16")[0]
    del ws
    b_ms, b_by = bound_ms(_nbytes(xb, data[0], scales[0]) + M * OUT * 2, 2.0 * M * IN * OUT,
                          "bfloat16")
    t_k, t_cub = statistics.median(r_k), statistics.median(r_cub)
    for what, t, b in (("kernel", t_k, b_ms), ("cuBLAS", t_cub, cub_b)):
        if t < b:
            raise PhaseError(f"{name} {label}: the {what}'s reading {t:.4f} ms is below its "
                             f"bound {b:.4f} ms")
    t_lib, why = None, ""
    if library is not None:
        call, why = library(xb, Ls - 1)
        if call is not None:
            t_lib = statistics.median(graph_ms(lambda i: call(), 30, reps=3))
            why = f"{t_lib:.4f} ms"
        why = f" _weight_int4pack_mm {why}"
    if M > qk.MAX_DECODE_ROWS:
        extra = f" plan (tile, split) {qk.dequant_mm_plan(M, IN, OUT, 8 if rows == IN else 4)}"
    else:
        extra = f" host {host_us(lambda i: kern(xb, data, scales, i % Ls, group)):.1f} us a call"
    log(f"[{tag}] {name} {label}: max_abs_err {err:.3g} (tol {tol:.3g}) kernel "
        f"{_spread(r_k)} ms over {n_calls} calls plain {t_p:.4f} ms bound {b_ms:.4f} ms "
        f"({b_by}) cuBLAS on the bf16-dequantized weight {_spread(r_cub)} ms (its own bound "
        f"{cub_b:.4f} ms; kernel/cuBLAS {t_k / t_cub:.3f}){why}{extra}")
    row = (weight, t_k, t_p, b_ms, b_by, t_lib if library is not None else t_cub, err, tol,
           t_cub)
    return row, xb, label


def _check_dequant_mm(name, key, M, data, scales, group, check) -> None:
    """K5a or K5b at M rows of x held against its plain version, bf16 and
    fp32, at the stack's first and last layer (no timing): the prefill
    regime's smallest row count on the main path's shapes."""
    import torch

    from tinygpt_tpu_torch.ops import quant_kernels as qk

    kern, plain = getattr(qk, name), getattr(qk, name + "_plain")
    Ls, _, OUT = data.shape
    IN = scales.shape[1] * group
    gx = torch.Generator(device=DEVICE).manual_seed(1000 + M)
    x32 = torch.randn((M, IN), generator=gx, device=DEVICE)
    for dt in (torch.float32, torch.bfloat16):
        for l in sorted({0, Ls - 1}):
            check(name, f"{key} M={M} {IN}->{OUT}", dt, kern(x32.to(dt), data, scales, l, group),
                  plain(x32.to(dt), data, scales, l, group))


def _regime_rows(tag, name, rs, decode_m, prefill_m) -> None:
    """The kernel's two regimes (PERF.md's per-regime rows of the kernel
    table): the mean over the layer's four matmuls of its per-shape rows
    `rs` ((row, M) pairs, the row as _time_dequant_mm returns it) at the
    decode step's rows (M <= 32) and at the prefill's (M > 32)."""
    for regime, m in (("M <= 32", decode_m), ("M > 32", prefill_m)):
        sel = [r for r, mm in rs if mm == m]
        mean = [statistics.fmean(r[i] for r in sel) for i in (1, 2, 3, 8)]
        log(f"[{tag}] {name} {regime} (M = {m}): mean over {len(sel)} shapes: kernel "
            f"{mean[0]:.4f} ms plain {mean[1]:.4f} ms bound {mean[2]:.4f} ms cuBLAS "
            f"{mean[3]:.4f} ms")


def _int4_split_sweep(label, x, data, scales, group) -> None:
    """The int4 GEMV (M <= 32) through its C entry point at every cluster
    size its plan picks from (quant_kernels._I4_SPLITS), walking the
    stack's layers, beside the plan's own pick (one bf16 part): the check
    on int4_gemv_split. A size whose blocks cannot hold their activations
    is refused by the kernel and skipped."""
    import torch

    from tinygpt_tpu_torch.ops import cuda_build
    from tinygpt_tpu_torch.ops import quant_kernels as qk
    from tinygpt_tpu_torch.ops.attention_kernels import _ptr, _sm_count

    fn = cuda_build.function("int4_matmul.cu", "tg_int4_matmul", qk._MATMUL_ARGS)
    M, IN = x.shape
    L, _, OUT = data.shape
    out = torch.empty(M, OUT, dtype=x.dtype, device=x.device)

    def call(l, C):
        err = fn(_ptr(x), _ptr(data), _ptr(scales), _ptr(out), M, IN, OUT, group, l,
                 qk._DTYPE_CODE[x.dtype], C, 0, qk._stream(x.device))
        cuda_build.check("int4_matmul.cu", err, "tg_int4_matmul")

    times = {}
    for C in qk._I4_SPLITS:
        if C <= IN // 32 and qk.int4_gemv_plan(M, IN, C, 1)[0]:
            times[C] = statistics.median(graph_ms(lambda i: call(i % L, C), max(30, 3 * L),
                                                  reps=3))
    plan = qk.int4_gemv_split(M, IN, OUT, 1, _sm_count(x.device.index or 0))
    best = min(times, key=times.get)
    log(f"[int4] split sweep {label}: " + ", ".join(f"C={c} {t:.4f}" for c, t in times.items())
        + f" ms; the plan's C={plan} {times[plan]:.4f}, the fastest C={best} "
        f"({times[plan] / times[best]:.3f}x)")


def _int4_yardsticks(mats, Ls):
    """The library calls beside an int4 GEMV reading: for each (x, data,
    scales, group) of `mats` (K7: gate_up, then down on an activation of
    its width), torch._weight_int4pack_mm where it takes the shape and
    cuBLAS on the weight dequantized to bf16 beforehand (LIB_LAYERS layers
    walked), both by graph_ms; the sums over `mats`. Returns (int4pack ms
    or None, its note, cuBLAS ms, cuBLAS's own bound)."""
    import torch

    t_pack, why, t_cub, cub_b = 0.0, "", 0.0, 0.0
    for x, data, scales, group in mats:
        call, no = _int4pack_library(x, data[Ls - 1], scales[Ls - 1], group)
        if call is None or t_pack is None:
            t_pack, why = None, no or why
        else:
            t_pack += statistics.median(graph_ms(lambda i: call(), 30, reps=3))
        nl = min(Ls, LIB_LAYERS)
        ws = [_dequant_weight(data, scales, group, l) for l in range(nl)]
        t_cub += statistics.median(graph_ms(lambda i: torch.matmul(x, ws[i % nl]),
                                            max(30, 3 * nl), reps=3))
        cub_b += bound_ms(_nbytes(x, ws[0]) + x.shape[0] * ws[0].shape[1] * 2,
                          2.0 * x.shape[0] * ws[0].numel(), "bfloat16")[0]
        del ws
    return t_pack, why, t_cub, cub_b


def phase_int4_kernels(table: dict) -> None:
    """K4, K5b, K6 and K7 against their plain versions on the card, at the
    int4 main path's shapes (Mistral-7B widths, group 64): bf16 and fp32,
    every K6 variant the path uses (and the silu + res one of the two-call
    MLP), at the decode batch (M = 4) and the serving quantum's 16 rows.
    Every bf16 call is timed by graph_ms (at least 30 calls walking the
    stack's layers, five readings, the median held against its bound)
    beside its bound, the plain version, torch._weight_int4pack_mm where it
    takes the shape and cuBLAS on the bf16-dequantized weight (which moves
    about 3.6x the bytes). K5b is also checked and timed at the prefill's
    M = 2048 and at PREFILL_ROWS (_time_dequant_mm), and the int4 GEMV's
    split plan is swept (_int4_split_sweep) at M = 4 and 16. A table row's
    numbers are means per launch over the path's mix of shapes at
    M = 4 (K5b: one layer's four prefill matmuls; K6: a decode step's 32
    qkv, 32 o and one head call), so that ms x launches is the kernel's
    time per prefill or step; the M = 16 readings are logged beside."""
    import torch

    from tinygpt_tpu_torch.ops import quant_kernels as qk

    c = MISTRAL_7B
    H, I, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
    Nq, Nk = c["num_attention_heads"], c["num_key_value_heads"]
    D, G = H // Nq, INT4_GROUP
    B = len(PROMPT_LENS)
    M_pre = B * max(PROMPT_LENS)
    g = torch.Generator(device=DEVICE).manual_seed(7)
    stacks = {
        "qkv": _int4_stack(g, L, H, (Nq + 2 * Nk) * D, G),
        "o": _int4_stack(g, L, Nq * D, H, G),
        "gate_up": _int4_stack(g, L, H, 2 * I, G),
        "down": _int4_stack(g, L, I, H, G),
        "head": _int4_stack(g, 1, H, V, G),
    }
    ln = {dt: (1 + 0.1 * torch.randn((L, H), generator=g, device=DEVICE)).to(dt)
          for dt in (torch.bfloat16, torch.float32)}
    worst = {}
    rows = {}   # name -> list of (weight in the mix, ms, plain, bound, library, err)

    def check(name, label, dt, got, want):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        dname = str(dt).replace("torch.", "")
        tol = QUANT_TOL[dname] * want.float().abs().max().item()
        key = (name, dname)
        worst[key] = max(worst.get(key, 0.0), err / max(tol, 1e-30))
        if not (math.isfinite(err) and err <= tol):
            raise PhaseError(f"{name} {label} {dname}: max_abs_err {err} > {tol}")
        return err, tol

    def run(name, label, weight, make, kern, plain, nbytes, flops, Ls, mats):
        """Checks kern against plain in bf16 and fp32 (make(dt, l) gives the
        arguments of layer l), then times the bf16 call beside its
        yardsticks (_int4_yardsticks(mats(args)))."""
        for dt in (torch.float32, torch.bfloat16):
            for l in sorted({0, Ls - 1}):
                args = make(dt, l)
                err, tol = check(name, label, dt, kern(*args), plain(*args))
        argl = [make(torch.bfloat16, l) for l in range(Ls)]
        r_k = graph_ms(lambda i: kern(*argl[i % Ls]), max(30, 3 * Ls))
        t_k = statistics.median(r_k)
        args = argl[Ls - 1]
        t_p = cuda_time_ms(lambda: plain(*args), iters=3, warmup=1)
        b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
        if t_k < b_ms:
            raise PhaseError(f"{name} {label}: the kernel's reading {t_k:.4f} ms is below "
                             f"its bound {b_ms:.4f} ms")
        t_pack, why, t_cub, cub_b = _int4_yardsticks(mats(args), Ls)
        pack = f"{t_pack:.4f} ms" if t_pack is not None else f"- [{why}]"
        log(f"[int4] {name} {label}: max_abs_err {err:.3g} (tol {tol:.3g}) kernel "
            f"{_spread(r_k)} ms plain {t_p:.4f} ms bound {b_ms:.4f} ms ({b_by}; kernel/bound "
            f"{t_k / b_ms:.2f}) _weight_int4pack_mm {pack} cuBLAS on the bf16-dequantized "
            f"weight {t_cub:.4f} ms (its own bound {cub_b:.4f} ms)"
            + (f" kernel/int4pack {t_k / t_pack:.3f}" if t_pack else ""))
        # the table's library call computes the same function: only K4 has one
        lib = t_pack if name == "matmul_dequant_int4" else None
        rows.setdefault(name, []).append((weight, t_k, t_p, b_ms, b_by, lib, err, tol))

    def x_of(dt, M, n, seed):
        gx = torch.Generator(device=DEVICE).manual_seed(seed)
        return torch.randn((M, n), generator=gx, device=DEVICE).to(dt)

    # K5b: the prefill's four layer matmuls at M = 4 x 512 (the mix), and
    # at PREFILL_ROWS and the decode and serving row blocks (M = 4, 16: the
    # int4 GEMV, its split swept)
    k5b_rows = []
    for key, (IN, OUT) in (("qkv", (H, (Nq + 2 * Nk) * D)), ("o", (Nq * D, H)),
                           ("gate_up", (H, 2 * I)), ("down", (I, H))):
        data, scales = stacks[key]
        for M in (B, 16) + PREFILL_ROWS + (M_pre,):
            row, xb, label = _time_dequant_mm(
                "int4", "matmul_dequant_int4_stacked", key, M, data, scales, G,
                1 if M == M_pre else 0, check,
                library=lambda x, l, d=data, s=scales: _int4pack_library(x, d[l], s[l], G))
            k5b_rows.append((row, M))
            if M in PREFILL_ROWS:
                _dequant_mm_split_sweep("int4", label, 4, xb, data, scales, G)
            elif M <= qk.MAX_DECODE_ROWS:
                _int4_split_sweep(label, xb, data, scales, G)
        _check_dequant_mm("matmul_dequant_int4_stacked", key, 33, data, scales, G, check)
    rows["matmul_dequant_int4_stacked"] = [r[:-1] for r, _ in k5b_rows]
    _regime_rows("int4", "matmul_dequant_int4_stacked", k5b_rows, B, M_pre)
    for M in (B, 16):
        sel = [r for r, mm in k5b_rows if mm == M]
        log(f"[int4] matmul_dequant_int4_stacked M = {M}: mean over the four matmuls: kernel "
            f"{statistics.fmean(r[1] for r in sel):.4f} ms bound "
            f"{statistics.fmean(r[3] for r in sel):.4f} ms _weight_int4pack_mm "
            + (f"{statistics.fmean(r[5] for r in sel):.4f} ms" if all(r[5] for r in sel)
               else "-"))

    hd, hs = stacks["head"]
    qd, qs = stacks["qkv"]
    od, os_ = stacks["o"]
    dd, ds = stacks["down"]
    gd, gs = stacks["gate_up"]
    OQ = (Nq + 2 * Nk) * D
    fln = {dt: ln[dt][:1] for dt in ln}
    for M in (B, 16):
        w = 1 if M == B else 0  # the decode step's mix is at M = 4
        sd = 100 * M
        xs = {dt: x_of(dt, M, H, sd + 12) for dt in (torch.float32, torch.bfloat16)}
        xh = xs[torch.bfloat16]
        # K4: the prefill's lm_head
        run("matmul_dequant_int4", f"head M={M} {H}->{V}", w,
            lambda dt, l: (xs[dt], hd[0], hs[0], G),
            qk.matmul_dequant_int4, qk.matmul_dequant_int4_plain,
            _nbytes(xh, hd, hs) + M * V * 2, 2.0 * M * H * V, 1,
            lambda a: [(a[0], hd, hs, G)])
        if M == B:
            _int4_split_sweep(f"head M={M} {H}->{V}", xh, hd, hs, G)
        # K6: qkv (norm prologue, RoPE), o (+ res), head (final norm)
        inv = torch.rand((M, 1), generator=g, device=DEVICE) + 0.5
        ang = torch.rand((M, D // 2), generator=g, device=DEVICE) * 6.3
        cos, sin = torch.cat([ang.cos()] * 2, -1), torch.cat([ang.sin()] * 2, -1)
        run("matmul_dequant_int4_stacked_fused", f"qkv ln+rope M={M} {H}->{OQ}", L * w,
            lambda dt, l: (xs[dt], qd, qs, l, G, ln[dt], inv, None, None, False, cos, sin,
                           Nq + Nk, D),
            qk.matmul_dequant_int4_stacked_fused, qk.matmul_dequant_int4_stacked_fused_plain,
            _nbytes(xh, qd[0], qs[0], ln[torch.bfloat16][0], inv, cos, sin) + M * OQ * 2,
            2.0 * M * H * OQ, L, lambda a: [(a[0], qd, qs, G)])
        res = {dt: x_of(dt, M, H, sd + 14) for dt in (torch.float32, torch.bfloat16)}
        xo = {dt: x_of(dt, M, Nq * D, sd + 15) for dt in (torch.float32, torch.bfloat16)}
        run("matmul_dequant_int4_stacked_fused", f"o res M={M} {Nq * D}->{H}", L * w,
            lambda dt, l: (xo[dt], od, os_, l, G, None, None, res[dt]),
            qk.matmul_dequant_int4_stacked_fused, qk.matmul_dequant_int4_stacked_fused_plain,
            _nbytes(xo[torch.bfloat16], od[0], os_[0], res[torch.bfloat16]) + M * H * 2,
            2.0 * M * Nq * D * H, L, lambda a: [(a[0], od, os_, G)])
        run("matmul_dequant_int4_stacked_fused", f"head ln M={M} {H}->{V}", w,
            lambda dt, l: (xs[dt], hd, hs, 0, G, fln[dt], inv),
            qk.matmul_dequant_int4_stacked_fused, qk.matmul_dequant_int4_stacked_fused_plain,
            _nbytes(xh, hd, hs, fln[torch.bfloat16], inv) + M * V * 2,
            2.0 * M * H * V, 1, lambda a: [(a[0], hd, hs, G)])
        if M == B:  # the two-call MLP's second call (silu * up, + res): off the main path
            xg = {dt: x_of(dt, M, 2 * I, sd + 16) for dt in (torch.float32, torch.bfloat16)}
            run("matmul_dequant_int4_stacked_fused", f"down silu+res M={M} {I}->{H} "
                f"(off the main path)", 0,
                lambda dt, l: (xg[dt], dd, ds, l, G, None, None, res[dt], None, True),
                qk.matmul_dequant_int4_stacked_fused,
                qk.matmul_dequant_int4_stacked_fused_plain,
                _nbytes(xg[torch.bfloat16], dd[0], ds[0], res[torch.bfloat16]) + M * H * 2,
                2.0 * M * I * H, L, lambda a: [(a[0][:, :I].contiguous(), dd, ds, G)])
        # K7
        xm = {dt: x_of(dt, M, H, sd + 17) for dt in (torch.float32, torch.bfloat16)}
        run("mlp_fused_int4_stacked", f"mlp M={M} {H}->{2 * I}->{H}", w,
            lambda dt, l: (xm[dt], gd, gs, dd, ds, ln[dt], inv, l, G),
            qk.mlp_fused_int4_stacked, qk.mlp_fused_int4_stacked_plain,
            _nbytes(xm[torch.bfloat16], gd[0], gs[0], dd[0], ds[0], ln[torch.bfloat16][0],
                    inv) + M * H * 2, 2.0 * M * (H * 2 * I + I * H), L,
            lambda a: [(a[0], gd, gs, G), (x_of(torch.bfloat16, M, I, sd + 18), dd, ds, G)])

    for (name, dname), r in sorted(worst.items()):
        log(f"[int4] {name} {dname}: worst max_abs_err over all cases {r:.3g} of its "
            f"tolerance")
    _mix_rows(table, rows)
    del stacks
    torch.cuda.empty_cache()


def _mix_rows(table: dict, rows: dict) -> None:
    """Kernel table rows from per-shape measurements: rows[name] is a list
    of (weight, ms, plain ms, bound ms, bound_by, library ms or None,
    max_abs_err, tol), the weight being the shape's launches in the main
    path's mix. Times are launch-weighted means, so that ms x launches is
    the kernel's time in the run; bound_by is the bound of most of the
    weighted bound time."""
    for name, rs in rows.items():
        wts = [r[0] for r in rs]
        n = sum(wts)
        mean = [sum(w * r[i] for w, r in zip(wts, rs)) / n for i in (1, 2, 3)]
        libs = [r[5] for w, r in zip(wts, rs) if w]
        lib = (sum(w * r[5] for w, r in zip(wts, rs) if w) / n
               if all(x is not None for x in libs) else None)
        t_bytes = sum(w * r[3] for w, r in zip(wts, rs) if r[4] == "bytes")
        by = "bytes" if 2 * t_bytes >= sum(w * r[3] for w, r in zip(wts, rs)) else "operations"
        table[name] = dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=0, max_abs_err=max(r[6] for r in rs), tol=max(r[7] for r in rs),
            ms=mean[0], plain_ms=mean[1], bound_ms=mean[2], bound_by=by, library_ms=lib)


# -- int8 kernels --------------------------------------------------------------


def _int8_stack(g, L, IN, OUT, group, dev=None):
    """Random int8 bytes [L, IN, OUT] and fp32 scales [L, IN/group, OUT]."""
    import torch

    dev = dev or DEVICE
    data = torch.randint(-128, 128, (L, IN, OUT), generator=g, device=dev,
                         dtype=torch.int8)
    scales = torch.rand((L, IN // group, OUT), generator=g, device=dev) * 0.01 + 1e-3
    return data, scales


def phase_int8_kernels(table: dict) -> None:
    """K3 and K5a against their plain versions on the card, bf16 and fp32:
    at the int8 main path's shapes (Mistral-7B widths, group 128; K5a's
    four layer matmuls at M = 4, a decode step, and M = 2048, the prefill,
    and beside them at PREFILL_ROWS; K3 the head at M = 4), and beside them
    at IN = 896 (7 groups) and 64,
    M = 1, 4, 32, 33 and 2048. Times the bf16 calls beside their bound,
    the plain version and the library call: cuBLAS (torch.matmul) on the
    weight dequantized to bf16 beforehand, outside the timed call. Kernel
    and cuBLAS take the same timing (graph_ms): at least 30 calls that walk
    a stack larger than the 50 MB L2 cache (K5a its 32 layers, K3 three
    copies of the head, 402 MB; cuBLAS LIB_LAYERS dequantized layers, or
    the three heads), five readings, their median kept and their spread
    printed, each median held against its own bound; beside it the host's
    microseconds a decode-shaped call. The table rows are launch-weighted
    means over the main path's mix (64 decode steps to one prefill); the
    two regimes (M = 4 and M = 2048) are logged apart."""
    import torch

    from tinygpt_tpu_torch.ops import quant_kernels as qk

    c = MISTRAL_7B
    H, I, V, L = c["hidden_size"], c["intermediate_size"], c["vocab_size"], c["num_hidden_layers"]
    Nq, Nk = c["num_attention_heads"], c["num_key_value_heads"]
    D, G = H // Nq, INT8_GROUP
    B = len(PROMPT_LENS)
    M_pre = B * max(PROMPT_LENS)
    steps = N_CHUNKS * DECODE_CHUNK
    g = torch.Generator(device=DEVICE).manual_seed(8)
    dts = (torch.float32, torch.bfloat16)
    rows, worst = {}, {}

    def x_of(dt, M, n, seed):
        gx = torch.Generator(device=DEVICE).manual_seed(seed)
        return torch.randn((M, n), generator=gx, device=DEVICE).to(dt)

    def check(name, label, dt, got, want):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        dname = str(dt).replace("torch.", "")
        tol = QUANT_TOL[dname] * want.float().abs().max().item()
        worst[(name, dname)] = max(worst.get((name, dname), 0.0), err / max(tol, 1e-30))
        if not (math.isfinite(err) and err <= tol):
            raise PhaseError(f"{name} {label} {dname}: max_abs_err {err} > {tol}")
        return err, tol

    # the main path's shapes
    stacks = {
        "qkv": _int8_stack(g, L, H, (Nq + 2 * Nk) * D, G),
        "o": _int8_stack(g, L, Nq * D, H, G),
        "gate_up": _int8_stack(g, L, H, 2 * I, G),
        "down": _int8_stack(g, L, I, H, G),
        "head": _int8_stack(g, 3, H, V, G),   # three copies: K3 takes one a call
    }
    regimes = []   # (row, M) of K5a's cases
    for key in ("qkv", "o", "gate_up", "down"):
        data, scales = stacks[key]
        for M, w in ((B, steps),) + tuple((m, 0) for m in PREFILL_ROWS) + ((M_pre, 1),):
            row, xb, label = _time_dequant_mm("int8", "matmul_dequant_int8_stacked", key, M,
                                              data, scales, G, L * w, check)
            rows.setdefault("matmul_dequant_int8_stacked", []).append(row[:-1])
            regimes.append((row, M))
            if M == B:
                _gemv_split_sweep(label, xb, data, scales, G)
            if M in PREFILL_ROWS:
                _dequant_mm_split_sweep("int8", label, 8, xb, data, scales, G)
        _check_dequant_mm("matmul_dequant_int8_stacked", key, 33, data, scales, G, check)
    # K3: the head, a one-layer stack; three copies walked (402 MB, past the L2)
    data, scales = stacks["head"]
    row, xb, label = _time_dequant_mm("int8", "matmul_dequant_int8", "head", B, data, scales,
                                      G, 1 + steps, check, one_layer=True)
    rows["matmul_dequant_int8"] = [row[:-1]]
    _gemv_split_sweep(label, xb, data, scales, G)
    del stacks
    torch.cuda.empty_cache()
    _regime_rows("int8", "matmul_dequant_int8_stacked", regimes, B, M_pre)

    # beside the main path: contraction dims the GEMV splits unevenly over
    # its 8 blocks (896 = 7 groups of 128; 64, one group of 64), and every
    # row regime of both kernels
    for IN, OUT, gs in ((896, 4864, 128), (64, 256, 64)):
        data, scales = _int8_stack(g, 2, IN, OUT, gs)
        for M in (1, 4, 32, 33, 2048):
            for dt in dts:
                x = x_of(dt, M, IN, 100 + M)
                check("matmul_dequant_int8_stacked", f"IN={IN} M={M}", dt,
                      qk.matmul_dequant_int8_stacked(x, data, scales, 1, gs),
                      qk.matmul_dequant_int8_stacked_plain(x, data, scales, 1, gs))
                check("matmul_dequant_int8", f"IN={IN} M={M}", dt,
                      qk.matmul_dequant_int8(x, data[0], scales[0], gs),
                      qk.matmul_dequant_int8_plain(x, data[0], scales[0], gs))
        log(f"[int8] IN={IN}, group {gs}: K3 and K5a at M = 1, 4, 32, 33 "
            f"and 2048, bf16 and fp32, within tolerance")
    for (name, dname), r in sorted(worst.items()):
        log(f"[int8] {name} {dname}: worst max_abs_err over all cases {r:.3g} of its "
            f"tolerance")
    _mix_rows(table, rows)
    torch.cuda.empty_cache()


def _gemv_split_sweep(label, x, data, scales, group) -> None:
    """The int8 GEMV through its C entry point at every cluster size its
    plan picks from (quant_kernels._GEMV_SPLITS), walking the stack's
    layers, beside the plan's own pick: the check on gemv_split. A size
    whose shared memory the kernel refuses is skipped."""
    import torch

    from tinygpt_tpu_torch.ops import cuda_build
    from tinygpt_tpu_torch.ops import quant_kernels as qk
    from tinygpt_tpu_torch.ops.attention_kernels import _ptr, _sm_count

    fn = cuda_build.function("int8_matmul.cu", "tg_int8_matmul", qk._MATMUL_ARGS)
    M = x.shape[0]
    L, IN, OUT = data.shape
    out = torch.empty(M, OUT, dtype=x.dtype, device=x.device)

    def call(l, C):
        err = fn(_ptr(x), _ptr(data), _ptr(scales), _ptr(out), M, IN, OUT, group, l,
                 qk._DTYPE_CODE[x.dtype], C, 0, qk._stream(x.device))
        cuda_build.check("int8_matmul.cu", err, "tg_int8_matmul")

    times, refused = {}, []
    for C in qk._GEMV_SPLITS:
        if C > IN // 16:
            continue
        try:
            call(0, C)
        except RuntimeError:  # the block's activation rows exceed its shared memory
            refused.append(C)
            continue
        times[C] = statistics.median(graph_ms(lambda i: call(i % L, C), max(30, 3 * L), reps=3))
    plan = qk.gemv_split(M, IN, OUT, _sm_count(x.device.index or 0))
    if plan not in times:
        raise PhaseError(f"int8 split sweep {label}: the plan's C={plan} was refused")
    best = min(times, key=times.get)
    log(f"[int8] split sweep {label}: " + ", ".join(f"C={c} {t:.4f}" for c, t in times.items())
        + f" ms; the plan's C={plan} {times[plan]:.4f}, the fastest C={best} "
        f"({times[plan] / times[best]:.3f}x)"
        + (f"; refused (shared memory): C={refused}" if refused else ""))


def _dequant_mm_split_sweep(tag, label, bits, x, data, scales, group) -> None:
    """The prefill regime (M > 32, bf16) through its C entry point at the
    plan's tile and every split from 1 to 8 (the kernel's limit), walking
    the stack's layers, beside the plan's own pick: the check on
    quant_kernels.dequant_mm_plan."""
    import torch

    from tinygpt_tpu_torch.ops import cuda_build
    from tinygpt_tpu_torch.ops import quant_kernels as qk
    from tinygpt_tpu_torch.ops.attention_kernels import _ptr, _sm_count

    source, symbol = qk._MATMUL_LIBS[bits]
    fn = cuda_build.function(source, symbol, qk._MATMUL_ARGS)
    M, IN = x.shape
    L, _, OUT = data.shape
    tile, plan = qk.dequant_mm_plan(M, IN, OUT, bits, _sm_count(x.device.index or 0))
    out = torch.empty(M, OUT, dtype=x.dtype, device=x.device)

    def call(l, C):
        err = fn(_ptr(x), _ptr(data), _ptr(scales), _ptr(out), M, IN, OUT, group, l,
                 qk._DTYPE_CODE[x.dtype], C, tile, qk._stream(x.device))
        cuda_build.check(source, err, symbol)

    times = {C: statistics.median(graph_ms(lambda i: call(i % L, C), 30, reps=3))
             for C in range(1, 9)}
    best = min(times, key=times.get)
    log(f"[{tag}] split sweep {label} (tile {tile}): "
        + ", ".join(f"C={c} {t:.4f}" for c, t in times.items())
        + f" ms; the plan's C={plan} {times[plan]:.4f}, the fastest C={best} "
        f"({times[plan] / times[best]:.3f}x)")


# -- paged frozen-pool decode kernel (K8) ------------------------------------------

# the serve phase's K8 shape: 16 rows, Mistral-7B heads, block 64, 16 blocks
# a row, the serving pool of 257 blocks, a quantum of 8 steps
PAGED = dict(B=16, Nq=32, Nk=8, D=128, bs=64, MB=16, n_blocks=257, N=8)
PAGED_LENGTHS = tuple(512 + 17 * i for i in range(16))   # ragged, 512..767


def _paged_case(L, Nq, Nk, D, lengths, inactive, dtype, seed):
    """Inputs of one paged_decode_frozen call at the serve shape: row b owns
    ceil(lengths[b] / bs) distinct random blocks and its later table
    entries are dead (0); inactive rows keep their length (stale, or 0 as
    the batcher's release leaves it) over a zero table; block 0 holds
    values like any block (an inactive row's scatter may have landed
    there)."""
    import torch

    p = PAGED
    bs, MB, n_blocks, N = p["bs"], p["MB"], p["n_blocks"], p["N"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B = len(lengths)
    kp = torch.randn(L, n_blocks, Nk, bs, D, generator=g, device=DEVICE).to(dtype)
    vp = torch.randn(L, n_blocks, Nk, bs, D, generator=g, device=DEVICE).to(dtype)
    q = torch.randn(B, Nq, D, generator=g, device=DEVICE).to(dtype)
    ki = torch.randn(B, Nk, N, D, generator=g, device=DEVICE).to(dtype)
    vi = torch.randn(B, Nk, N, D, generator=g, device=DEVICE).to(dtype)
    ids = (torch.randperm(n_blocks - 1, generator=torch.Generator().manual_seed(seed))
           + 1).tolist()
    tables = torch.zeros(B, MB, dtype=torch.int32)
    for b, n in enumerate(lengths):
        if b not in inactive:
            nb = -(-n // bs)
            tables[b, :nb] = torch.tensor(ids[:nb], dtype=torch.int32)
            ids = ids[nb:]
    i32 = dict(dtype=torch.int32, device=DEVICE)
    return (q, kp, vp, tables.to(DEVICE), torch.tensor(lengths, **i32),
            torch.zeros(B, **i32), ki, vi)


def _paged_visible(lengths, step, window):
    """(pool slots, in-flight slots) that one call sees, summed over rows."""
    cap = PAGED["MB"] * PAGED["bs"]
    pool = 0
    for n in lengths:
        lo = n + step - window + 1 if window else 0
        pool += max(min(n, cap) - max(lo, 0), 0)
    n_infl = min(step + 1, window) if window else step + 1
    return pool, len(lengths) * n_infl


def _paged_cost(q, Nk, lengths, step, window, pool_size=None):
    """(bytes, flops) this call's data needs: the visible slots' K and V
    rows (pool, pool_size bytes an element, default q's; in flight, q's)
    read once, q, the table, lengths and starts, and the output; 4*D
    operations per visible (query head, slot) pair."""
    B, Nq, D = q.shape
    pool, infl = _paged_visible(lengths, step, window)
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + 2 * (pool * (pool_size or isz) + infl * isz) * Nk * D
              + 4 * B * (PAGED["MB"] + 2))
    return nbytes, 4.0 * D * Nq * (pool + infl)


def _sdpa_paged(q, kp, vp, tables, lens, starts, ki, vi, l, step, scale, window):
    """scaled_dot_product_attention on the same rows with K/V gathered
    dense OUTSIDE the timed call (timing yardstick only)."""
    import torch

    from tinygpt_tpu_torch.ops import paged_attention as pa

    B, N = q.shape[0], ki.shape[2]
    k = torch.cat([pa.paged_gather_dense(kp[l], tables), ki], dim=2)
    v = torch.cat([pa.paged_gather_dense(vp[l], tables), vi], dim=2)
    t = torch.arange(tables.shape[1] * kp.shape[3], device=q.device)[None, :]
    mask_f = (t < lens[:, None]) & (t >= starts[:, None])
    j = torch.arange(N, device=q.device)
    mask_i = j <= step
    if window:
        mask_f = mask_f & (t > lens[:, None] + step - window)
        mask_i = mask_i & (step - j < window)
    attn_mask = torch.cat([mask_f, mask_i.expand(B, N)], dim=1)[:, None, None, :]
    return _sdpa(q[:, :, None, :], k, v, attn_mask, scale)


def _ulp(x, dname):
    """One ulp of the dtype named `dname` at each element of x (the least
    normal number's ulp below it)."""
    import torch

    dtype = getattr(torch, dname)
    bits = {"float32": 23, "float16": 10, "bfloat16": 7}[dname]
    _, e = torch.frexp(x.float().abs().clamp(min=torch.finfo(dtype).tiny))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 1 - bits)


def _paged_tol(dname, want):
    """A paged kernel's limit against its plain version, output by output:
    both round one fp32 result to the output dtype, so they differ by at
    most one ulp of an output. In bf16 that is 2^-7 of the largest output
    (under 4e-3 at the serve shape, whose outputs stay below 0.5), capped
    at TOL, in fp16 2^-10 of it, 1e-4 in fp32; and never less than one ulp
    of the output's own plain value, which in bf16 passes the cap from
    outputs of 4 on (tools/paged_rounding.py counts the outputs that round
    apart against fp64)."""
    import torch

    big = want.float().abs().max().item()
    capped = {"bfloat16": min(TOL["bfloat16"], 2.0 ** -7 * big),
              "float16": 2.0 ** -10 * big}.get(dname, TOL["float32"])
    return torch.clamp(_ulp(want, dname), min=capped)


def _paged_err(got, want, dname):
    """(max_abs_err, the largest share of its bound that an output's error
    takes): the kernel agrees when the share is at most 1."""
    err = (got.float() - want.float()).abs()
    return err.max().item(), (err / _paged_tol(dname, want)).max().item()


def phase_paged_kernels(table: dict) -> None:
    """K8 against its plain version on the card at the serve phase's shape
    (ragged rows of 512 to 767 slots, dead table entries) and beside it:
    fp32, inactive rows (one at length 0, as the batcher releases a row,
    and stale lengths up to one past the table, which the kernel still
    walks over block 0), a window, head dim 64 with one query head per KV
    head; the first and the last step of a quantum, the first and the last
    layer. Times kernel, plain version and SDPA beside the bound; the
    main-path row is bf16 at the last step, all 16 rows live, the call
    walking all 32 layers of a 257-block pool."""
    import torch

    from tinygpt_tpu_torch.ops import paged_attention as pa

    p = PAGED
    Nq, Nk, D, N = p["Nq"], p["Nk"], p["D"], p["N"]
    L = MISTRAL_7B["num_hidden_layers"]
    lens = PAGED_LENGTHS
    # (label, L, Nq, Nk, D, {inactive row: its length}, window, dtype,
    #  is_main_path)
    cases = [
        ("main path", L, Nq, Nk, D, {}, None, torch.bfloat16, True),
        ("inactive rows at 0 and 32768", 4, Nq, Nk, D, {3: 0, 9: 32768}, None,
         torch.float32, False),
        ("w300, 1 inactive row", 4, Nq, Nk, D, {5: lens[5]}, 300, torch.bfloat16, False),
        ("D64 G1", 4, 8, 8, 64, {}, None, torch.bfloat16, False),
        ("D64 G1 w100, 1 inactive row", 4, 8, 8, 64, {2: lens[2]}, 100, torch.float32,
         False),
        ("GPT-2 serve shape", GPT2_124M["n_layer"], 12, 12, 64, {}, None, torch.bfloat16,
         False),
        ("G16", 4, 128, 8, 128, {}, None, torch.bfloat16, False),
    ]
    worst = {}
    for i, (label, Lc, nq, nk, d, inactive, window, dtype, main) in enumerate(cases):
        dname = str(dtype).replace("torch.", "")
        lens_c = [inactive.get(b, n) for b, n in enumerate(lens)]
        q, kp, vp, tables, lengths, starts, ki, vi = _paged_case(
            Lc, nq, nk, d, lens_c, inactive, dtype, seed=200 + i)
        for step in (0, N - 1):
            for l in sorted({0, Lc - 1}):
                args = (q, kp, vp, tables, lengths, starts, ki, vi, l, step, d ** -0.5,
                        window)
                got = pa.paged_decode_frozen(*args)
                want = pa.paged_decode_frozen_plain(*args)
                torch.cuda.synchronize()
                err, share = _paged_err(got, want, dname)
                worst[dname] = max(err, worst.get(dname, 0.0))
                if not (math.isfinite(err) and share <= 1):
                    raise PhaseError(f"paged_decode_frozen {label} l={l} step={step} "
                                     f"{dname}: error {err}, {share:.3g} of its bound")
        step = N - 1
        layers = iter(range(10 ** 9))   # walk the layers: cold K/V, as a step reads
        t_k = cuda_time_ms(lambda: pa.paged_decode_frozen(
            q, kp, vp, tables, lengths, starts, ki, vi, next(layers) % Lc, step,
            d ** -0.5, window), iters=4 * Lc)
        args = (q, kp, vp, tables, lengths, starts, ki, vi, Lc - 1, step, d ** -0.5,
                window)
        t_p = cuda_time_ms(lambda: pa.paged_decode_frozen_plain(*args), iters=10)
        t_l = cuda_time_ms(_sdpa_paged(*args), iters=20)
        live = [n for b, n in enumerate(lens) if b not in inactive]
        nbytes, flops = _paged_cost(q, nk, live + [0] * len(inactive), step, window)
        b_ms, b_by = bound_ms(nbytes, flops, dname)
        log(f"[paged] paged_decode_frozen {label} D={d} G={nq // nk} step={step} "
            f"{dname}: max_abs_err {err:.3g} ({share:.3g} of its bound) kernel {t_k:.4f} ms "
            f"plain {t_p:.4f} ms sdpa (K/V gathered dense beforehand) {t_l:.4f} ms "
            f"bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
        if main:
            table["paged_decode_frozen"] = dict(
                name="paged_decode_frozen", route="cuda",
                source=SOURCES["paged_decode_frozen"],
                replaces=REPLACES["paged_decode_frozen"], launches=0, max_abs_err=err,
                tol_share=share, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by,
                library_ms=t_l)
        del q, kp, vp, ki, vi
        torch.cuda.empty_cache()
    # the e4m3 branch at the main path's shape: e4m3 pools, bf16 q and in flight
    from tinygpt_tpu_torch.engine.kv_cache import kv_cast

    q, kp, vp, tables, lengths, starts, ki, vi = _paged_case(
        L, Nq, Nk, D, lens, {}, torch.bfloat16, seed=200)
    kp, vp = kv_cast(kp, E4M3), kv_cast(vp, E4M3)
    step = N - 1
    args = (q, kp, vp, tables, lengths, starts, ki, vi, L - 1, step, D ** -0.5, None)
    want = pa.paged_decode_frozen_plain(*args)
    layers = iter(range(10 ** 9))
    _e4m3_row("paged_decode_frozen", "[paged]", "main path",
              lambda: pa.paged_decode_frozen(q, kp, vp, tables, lengths, starts, ki, vi,
                                             next(layers) % L, step, D ** -0.5),
              lambda: pa.paged_decode_frozen_plain(*args),
              _paged_cost(q, Nk, list(lens), step, None, pool_size=1), iters=(4 * L, 10),
              check=lambda: (pa.paged_decode_frozen(*args), want),
              tol=_paged_tol("bfloat16", want))
    del q, kp, vp, ki, vi
    torch.cuda.empty_cache()
    for dname, err in sorted(worst.items()):
        log(f"[paged] paged_decode_frozen {dname}: worst max_abs_err over all cases "
            f"{err:.3g} (bound at most {TOL[dname]}, or one ulp of the output where that is "
            f"more; bf16: 2^-7 of the largest output)")
    _paged_split_sweep("serve shape", L, Nq, Nk, D)
    _paged_split_sweep("GPT-2 serve shape", GPT2_124M["n_layer"], 12, 12, 64)
    _paged_split_sweep("G16", 4, 128, 8, 128)
    _paged_decode_k9(table)
    _wide_groups()


def _paged_split_sweep(label, L, Nq, Nk, D) -> None:
    """K8 through its C entry point at every cluster size (split_sweep), at
    `label`'s heads over the serve phase's rows and pool (bf16, step N - 1,
    the calls walking the L layers), beside the plan's pick
    (attention_kernels.paged_decode_split): the check on the plan."""
    import ctypes

    import torch

    from tinygpt_tpu_torch.ops import cuda_build
    from tinygpt_tpu_torch.ops import paged_attention as pa
    from tinygpt_tpu_torch.ops.attention_kernels import (
        _DTYPE_CODE,
        _ptr,
        _sm_count,
        paged_decode_split,
    )

    p = PAGED
    q, kp, vp, tables, lengths, starts, ki, vi = _paged_case(
        L, Nq, Nk, D, PAGED_LENGTHS, {}, torch.bfloat16, seed=210)
    fn = cuda_build.function("paged_decode_frozen.cu", "tg_paged_decode_frozen",
                             pa._FROZEN_ARGS)
    B, N, code = q.shape[0], p["N"], _DTYPE_CODE[torch.bfloat16]
    out = torch.empty_like(q)

    def call(l, C):
        err = fn(_ptr(q), _ptr(kp), _ptr(vp), _ptr(tables), _ptr(lengths), _ptr(starts),
                 _ptr(ki), _ptr(vi), _ptr(out), B, Nq, Nk, p["n_blocks"], p["bs"], p["MB"], N,
                 D, code, code, l, N - 1, D ** -0.5, 0, C,
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cuda_build.check("paged_decode_frozen.cu", err, "tg_paged_decode_frozen")

    dev = q.device.index or 0
    per_sm = pa._paged_per_sm(Nq, Nk, p["MB"], D, code, code, dev)
    plan = paged_decode_split(B, Nk, Nq // Nk, p["MB"] * p["bs"] + N, per_sm, _sm_count(dev))
    split_sweep("[paged]", "paged_decode_frozen", label, call, L, plan,
                note=f" (B={B} Nk={Nk} G={Nq // Nk} D={D}; blocks an SM at C = 1..8: {per_sm})")
    del q, kp, vp, ki, vi
    torch.cuda.empty_cache()


# -- speculative-verify kernel (K10) -------------------------------------------------

# the spec serve phase's K10 shape: 16 rows, Mistral-7B heads, the serving
# pool; S = 5 verify positions (4 drafts), one round a quantum (quantum 8)
SPEC_S = 5
SPEC_LENGTHS = tuple(64 + 56 * i for i in range(16))   # 64 .. 904 slots


def _spec_kernel_case(L, Nq, Nk, D, lengths, inactive, dtype, e4m3, rnd, seed, S=SPEC_S):
    """Inputs of one paged_decode_spec call at round `rnd` of rnd + 1: the
    K8 case's pools and tables (e4m3 pools beside bf16 in-flight K/V),
    q [B, S, Nq, D], earlier rounds' slots accepted at random, each row's
    verify slots after its accepted ones. Returns (args, base, q_slots,
    infl_slots)."""
    import torch

    from tinygpt_tpu_torch.engine.kv_cache import kv_cast

    N = (rnd + 1) * S
    q1, kp, vp, tables, lens, starts, _, _ = _paged_case(L, Nq, Nk, D, lengths, inactive,
                                                         dtype, seed)
    del q1
    if e4m3:
        kp, vp = kv_cast(kp, E4M3), kv_cast(vp, E4M3)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 1)
    B = len(lengths)
    infl_dt = torch.bfloat16 if e4m3 else dtype
    q = torch.randn(B, S, Nq, D, generator=g, device=DEVICE).to(dtype)
    ki = torch.randn(B, Nk, N, D, generator=g, device=DEVICE).to(infl_dt)
    vi = torch.randn(B, Nk, N, D, generator=g, device=DEVICE).to(infl_dt)
    gh = torch.Generator().manual_seed(seed + 2)
    acc = torch.zeros(B, dtype=torch.int32)
    valid = torch.zeros(B, N, dtype=torch.bool)
    infl_slots = torch.zeros(B, N, dtype=torch.int32)
    lens_h = torch.tensor(lengths, dtype=torch.int32)
    for r in range(rnd):
        m = torch.randint(0, S, (B,), generator=gh).to(torch.int32)
        for b in range(B):
            for i in range(int(m[b]) + 1):
                valid[b, r * S + i] = True
                infl_slots[b, r * S + i] = lens_h[b] + acc[b] + i
        acc += m + 1
    q_slots = lens_h[:, None] + acc[:, None] + torch.arange(S, dtype=torch.int32)[None, :]
    return ((q, kp, vp, tables, lens, starts, ki, vi, valid.to(DEVICE)), rnd * S,
            q_slots.to(DEVICE), infl_slots.to(DEVICE))


def _spec_cost(args, base, q_slots, infl_slots, window):
    """(bytes, flops) one K10 call's data needs: every K/V slot some verify
    position sees, read once (pool slots at the pool's element size), q,
    the output, tables, lengths, starts and validity; 4*D operations per
    visible (verify position, query head, slot)."""
    import torch

    q, kp, _, tables, lens, starts, ki, _, valid = args
    B, S, Nq, D = q.shape
    Nk, bs = kp.shape[2], kp.shape[3]
    N = ki.shape[2]
    cap = tables.shape[1] * bs
    lens, starts = lens.cpu()[:, None], starts.cpu()[:, None]
    qs = q_slots.cpu()
    t = torch.arange(cap)[None, None, :]
    pool = (t < lens[:, :, None].clamp(max=cap)) & (t >= starts[:, :, None])
    pool = pool.expand(B, S, cap)
    j = torch.arange(N)[None, None, :]
    s_idx = torch.arange(S)[None, :, None]
    infl = valid.cpu()[:, None, :] | ((j >= base) & (j <= base + s_idx))
    if window:
        pool = pool & (t > qs[:, :, None] - window)
        jj = torch.arange(N)[None, :]
        own = qs.gather(1, (jj - base).clamp(0, S - 1).expand(B, N))
        slot_j = torch.where(jj >= base, own, infl_slots.cpu())
        infl = infl & (slot_j[:, None, :] > qs[:, :, None] - window)
    n_pool, n_infl = int(pool.any(1).sum()), int(infl.any(1).sum())
    pairs = int(pool.sum()) + int(infl.sum())
    isz = q.element_size()
    nbytes = (2 * q.numel() * isz + 2 * Nk * D * (n_pool * kp.element_size()
                                                    + n_infl * ki.element_size())
              + tables.numel() * 4 + B * 8 + valid.numel())
    return nbytes, 4.0 * D * Nq * pairs


def _sdpa_spec(args, l, base, scale, window, q_slots, infl_slots):
    """scaled_dot_product_attention on the same function: K/V gathered dense
    and the in-flight slots appended, with an explicit boolean mask
    [B, 1, S, T + N], both built OUTSIDE the timed call (yardstick only)."""
    import torch

    from tinygpt_tpu_torch.ops import paged_attention as pa

    q, kp, vp, tables, lens, starts, ki, vi, valid = args
    B, S, Nq, D = q.shape
    N = ki.shape[2]
    k = torch.cat([pa.paged_gather_dense(kp[l], tables).to(q.dtype), ki.to(q.dtype)], dim=2)
    v = torch.cat([pa.paged_gather_dense(vp[l], tables).to(q.dtype), vi.to(q.dtype)], dim=2)
    T = k.shape[2] - N
    t = torch.arange(T, device=q.device)[None, None, :]
    mask_f = ((t < lens[:, None, None]) & (t >= starts[:, None, None])).expand(B, S, T)
    j = torch.arange(N, device=q.device)[None, None, :]
    s_idx = torch.arange(S, device=q.device)[None, :, None]
    mask_i = valid[:, None, :] | ((j >= base) & (j <= base + s_idx))
    if window:
        qs = q_slots[:, :, None]
        mask_f = mask_f & (t > qs - window)
        jj = torch.arange(N, device=q.device)[None, :]
        own = q_slots.gather(1, (jj - base).clamp(0, S - 1).expand(B, N))
        slot_j = torch.where(jj >= base, own, infl_slots)
        mask_i = mask_i & (slot_j[:, None, :] > qs - window)
    mask = torch.cat([mask_f, mask_i], dim=2)[:, None]          # [B, 1, S, T+N]
    return _sdpa(q.transpose(1, 2).contiguous(), k, v, mask, scale)


def _k10_times(args, base, q_slots, infl_slots, scale, window, L):
    """(kernel, plain, SDPA) ms of one K10 call: the kernel walking the L
    layers and SDPA on the gathered K/V by CUDA events (events_ms), the
    plain version by torch.profiler."""
    from tinygpt_tpu_torch.ops import paged_attention as pa

    t_k = events_ms(lambda l: pa.paged_decode_spec(*args, l, base, scale, window, q_slots,
                                                   infl_slots), L)
    call = (*args, L - 1, base, scale, window, q_slots, infl_slots)
    t_p = cuda_time_ms(lambda: pa.paged_decode_spec_plain(*call), iters=5)
    sdpa = _sdpa_spec(args, L - 1, base, scale, window, q_slots, infl_slots)
    return t_k, t_p, events_ms(lambda _: sdpa(), 1, calls=20)


def _k10_sweep(label, args, base, q_slots, infl_slots, scale, window, L):
    """K10 through its C entry point at every split (split_sweep) beside the
    wrapper's plan (attention_kernels.paged_spec_split over the library's
    tg_paged_decode_spec_plan)."""
    import ctypes

    import torch

    from tinygpt_tpu_torch.ops import cuda_build
    from tinygpt_tpu_torch.ops import paged_attention as pa
    from tinygpt_tpu_torch.ops.attention_kernels import (
        _DTYPE_CODE,
        _ptr,
        _sm_count,
        kv_operands,
        paged_spec_split,
    )

    q, kp, vp, tables, lens, starts, ki, vi, valid = args
    fn = cuda_build.function("paged_decode_spec.cu", "tg_paged_decode_spec", pa._SPEC_ARGS)
    B, S, Nq, D = q.shape
    _, n_blocks, Nk, bs, _ = kp.shape
    MB, N = tables.shape[1], ki.shape[2]
    code, (kv_code, _) = _DTYPE_CODE[q.dtype], kv_operands("paged_decode_spec", q, kp)
    out = torch.empty_like(q)
    null = ctypes.c_void_p(None)

    def call(l, C):
        err = fn(_ptr(q), _ptr(kp), _ptr(vp), _ptr(tables), _ptr(lens), _ptr(starts), _ptr(ki),
                 _ptr(vi), _ptr(valid), _ptr(q_slots) if window else null,
                 _ptr(infl_slots) if window else null, _ptr(out), B, S, Nq, Nk, n_blocks, bs,
                 MB, N, D, code, kv_code, l, base, scale, window or 0, C,
                 ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cuda_build.check("paged_decode_spec.cu", err, "tg_paged_decode_spec")

    dev = q.device.index or 0
    per_sm, n_rg = pa._spec_plan(Nq, Nk, S, MB, D, code, kv_code, dev)
    plan = paged_spec_split(B, Nk, n_rg, MB * bs + N, per_sm, _sm_count(dev))
    split_sweep("[spec]", "paged_decode_spec", label, call, L, plan,
                note=f" (S*G={S * Nq // Nk}, {n_rg} row groups; blocks an SM at C = 1..8: "
                     f"{per_sm})")


def phase_spec_kernels(table: dict) -> None:
    """K10 against its plain version on the card at the spec serve phase's
    shape (16 rows of 64 to 904 slots, two of them inactive at length 0 as
    the batcher releases them, S = 5) and beside it: fp32 at a later round
    (accepted slots of earlier rounds), e4m3 pools, a binding window, head
    dim 64 with one query head per KV head; the first and the last layer.
    Times kernel, plain version and SDPA (with an explicit mask) beside the
    bound; the main-path row is bf16 at round 0, the call walking all 32
    layers of a 257-block pool. Then the card's e4m3 cast against the
    CPU's bytes."""
    import torch

    from tinygpt_tpu_torch.engine.kv_cache import kv_cast
    from tinygpt_tpu_torch.ops import paged_attention as pa

    p = PAGED
    Nq, Nk, D = p["Nq"], p["Nk"], p["D"]
    L = MISTRAL_7B["num_hidden_layers"]
    lens = SPEC_LENGTHS
    # (label, L, Nq, Nk, D, {inactive row: its length}, dtype, e4m3, round,
    #  window, is_main_path, timed)
    cases = [
        ("main path", L, Nq, Nk, D, {3: 0, 9: 0}, torch.bfloat16, False, 0, None, True, True),
        ("main path e4m3", L, Nq, Nk, D, {3: 0, 9: 0}, torch.bfloat16, True, 0, None, False,
         True),
        ("fp32 round 1", 4, Nq, Nk, D, {5: 0}, torch.float32, False, 1, None, False, False),
        ("w300 round 1", 4, Nq, Nk, D, {}, torch.bfloat16, False, 1, 300, False, True),
        ("D64 G1 e4m3 fp32 w100 round 2", 4, 8, 8, 64, {2: 0}, torch.float32, True, 2, 100,
         False, False),
    ]
    worst = 0.0
    for i, (label, Lc, nq, nk, d, inactive, dtype, e4m3, rnd, window, main, timed) in \
            enumerate(cases):
        dname = str(dtype).replace("torch.", "")
        lens_c = [inactive.get(b, n) for b, n in enumerate(lens)]
        args, base, q_slots, infl_slots = _spec_kernel_case(
            Lc, nq, nk, d, lens_c, inactive, dtype, e4m3, rnd, seed=300 + i)
        for l in sorted({0, Lc - 1}):
            call = (*args, l, base, d ** -0.5, window, q_slots, infl_slots)
            got = pa.paged_decode_spec(*call)
            want = pa.paged_decode_spec_plain(*call)
            torch.cuda.synchronize()
            err, share = _paged_err(got, want, dname)
            worst = max(worst, share)
            if not (math.isfinite(err) and share <= 1):
                raise PhaseError(f"paged_decode_spec {label} l={l} {dname}: error {err}, "
                                 f"{share:.3g} of its bound")
        nbytes, flops = _spec_cost(args, base, q_slots, infl_slots, window)
        b_ms, b_by = bound_ms(nbytes, flops, dname)
        if not timed:
            log(f"[spec] paged_decode_spec {label} D={d} G={nq // nk} S={SPEC_S} {dname}: "
                f"max_abs_err {err:.3g} ({share:.3g} of its bound) ok")
            continue
        t_k, t_p, t_l = _k10_times(args, base, q_slots, infl_slots, d ** -0.5, window, Lc)
        log(f"[spec] paged_decode_spec {label} D={d} G={nq // nk} S={SPEC_S} {dname}"
            f"{' e4m3 pools' if e4m3 else ''}: max_abs_err {err:.3g} ({share:.3g} of its "
            f"bound) kernel "
            f"{t_k:.4f} ms (CUDA events) plain {t_p:.4f} ms sdpa (K/V gathered, mask built "
            f"beforehand, CUDA events) {t_l:.4f} ms bound {b_ms:.4f} ms ({b_by}, "
            f"{nbytes / 1e6:.2f} MB)")
        _k10_sweep(f"{label} {dname}", args, base, q_slots, infl_slots, d ** -0.5, window, Lc)
        if main:
            table["paged_decode_spec"] = dict(
                name="paged_decode_spec", route="cuda", source=SOURCES["paged_decode_spec"],
                replaces=REPLACES["paged_decode_spec"], launches=0, max_abs_err=err,
                tol_share=share,
                ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        elif e4m3:
            E4M3_ROWS["paged_decode_spec"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                                  max_abs_err=err)
        del args
        torch.cuda.empty_cache()
    log(f"[spec] paged_decode_spec: worst max_abs_err over all cases {worst:.3g} of its "
        f"bound (output by output: one ulp of the largest output in bf16, 1e-4 in fp32, "
        f"or one ulp of the output where that is more)")

    # the e4m3 cast: the card's bytes against the CPU's, overflow included
    g = torch.Generator().manual_seed(9)
    x = torch.cat([torch.randn(1 << 16, generator=g) * 200, torch.randn(4096, generator=g)
                   * 1e-3, torch.tensor([448.0, -448.0, 464.0, 470.0, 480.0, 500.0, -1000.0,
                                         float("inf"), float("-inf"), float("nan")])])
    for dt in (torch.float32, torch.bfloat16):
        cpu = kv_cast(x.to(dt), E4M3).view(torch.uint8)
        card = kv_cast(x.to(dt).to(DEVICE), E4M3).view(torch.uint8).cpu()
        raw = (x.to(dt).to(DEVICE).to(E4M3).view(torch.uint8).cpu()
               == x.to(dt).to(E4M3).view(torch.uint8))
        n_over = int((x.abs() > 448).sum())
        log(f"[spec] e4m3 cast of {x.numel()} {str(dt)[6:]} values ({n_over} past 448): "
            f"kv_cast card bytes {'equal' if torch.equal(card, cpu) else 'DIFFER from'} the "
            f"CPU's; torch's own cast agrees on {int(raw.sum())} of {x.numel()}")
        if not torch.equal(card, cpu):
            raise PhaseError(f"e4m3 cast: the card's bytes differ from the CPU's ({dt})")


# -- the single-layer paged decode (K9) and wider head groups ---------------------

# the gpt2_serve phase's K9 shape: 16 rows of GPT-2 124M's heads (12 of 64)
# over the serving pool (block 64, 16 blocks a row, 257 blocks); rows of
# mixed lengths up to 1,023 slots, two inactive (one released at length 0,
# one with a stale length over a zero table), two starting past slot 0
K9_LENGTHS = (1023, 1, 64, 0, 65, 512, 700, 333, 1000, 900, 128, 257, 768, 40, 999, 600)
K9_INACTIVE = {3: 0, 9: 900}
K9_STARTS = {4: 5, 7: 17}


def _k9_case(L, Nq, Nk, D, dtype, seed, lengths=K9_LENGTHS, inactive=None, starts=None):
    """Inputs of one paged_decode call (the stacked pools, of which a call
    takes layer l): K8's case at `lengths` (K9_LENGTHS, with K9_INACTIVE
    and K9_STARTS unless given)."""
    import torch

    inactive = K9_INACTIVE if inactive is None else inactive
    lens = [inactive.get(b, n) for b, n in enumerate(lengths)]
    q, kp, vp, tables, lengths, starts_t, _, _ = _paged_case(L, Nq, Nk, D, lens, inactive,
                                                             dtype, seed)
    for b, st in (K9_STARTS if starts is None else starts).items():
        starts_t[b] = st
    return q, kp, vp, tables, lengths, starts_t.to(torch.int32)


def _k9_entry(q, kp, vp, tables, lens, starts, scale, window):
    """(call(l, C): K9 through its C entry point at layer l of the stacked
    pools and split C, the wrapper's plan for this shape)."""
    import ctypes

    import torch

    from tinygpt_tpu_torch.ops import cuda_build
    from tinygpt_tpu_torch.ops import paged_attention as pa
    from tinygpt_tpu_torch.ops.attention_kernels import (
        _DTYPE_CODE,
        _ptr,
        _sm_count,
        kv_operands,
        paged_decode_split,
    )

    fn = cuda_build.function("paged_decode.cu", "tg_paged_decode", pa._DECODE_ARGS)
    B, Nq, D = q.shape
    _, n_blocks, Nk, bs, _ = kp.shape
    MB = tables.shape[1]
    code, (kv_code, _) = _DTYPE_CODE[q.dtype], kv_operands("paged_decode", q, kp)
    out = torch.empty_like(q)

    def call(l, C):
        err = fn(_ptr(q), _ptr(kp[l]), _ptr(vp[l]), _ptr(tables), _ptr(lens), _ptr(starts),
                 _ptr(out), B, Nq, Nk, n_blocks, bs, MB, D, code, kv_code, scale, window or 0,
                 C, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        cuda_build.check("paged_decode.cu", err, "tg_paged_decode")

    dev = q.device.index or 0
    per_sm = pa._paged_per_sm(Nq, Nk, MB, D, code, kv_code, dev, "paged_decode.cu")
    return call, paged_decode_split(B, Nk, Nq // Nk, MB * bs, per_sm, _sm_count(dev)), per_sm


def _k9_cost(q, Nk, tables, lengths, starts, window, pool_size):
    """(bytes, flops) one K9 call's data needs: K and V, at the pool's
    element size, of each distinct pool slot (block, offset) that a row
    sees (starts <= t < lengths, within the table and the window), read
    once: an inactive row's stale length over its zero table sees block
    0's slots again, so they count once; q, the output, tables, lengths
    and starts; 4*D operations per visible (row, query head, slot)."""
    B, Nq, D = q.shape
    bs = PAGED["bs"]
    cap = tables.shape[1] * bs
    pool_slots, seen = set(), 0
    for row, n, st in zip(tables.tolist(), lengths.tolist(), starts.tolist()):
        lo = max(st, n - window) if window else st
        ts = range(max(lo, 0), min(n, cap))
        pool_slots.update((row[t // bs], t % bs) for t in ts)
        seen += len(ts)
    nbytes = (2 * q.numel() * q.element_size() + 2 * len(pool_slots) * Nk * D * pool_size
              + 4 * B * (tables.shape[1] + 2))
    return nbytes, 4.0 * D * Nq * seen


def _sdpa_k9(q, kp, vp, tables, lens, starts, scale, window):
    """scaled_dot_product_attention on the same rows, K/V gathered dense
    and the mask built OUTSIDE the timed call (timing yardstick only)."""
    import torch

    from tinygpt_tpu_torch.ops import paged_attention as pa

    k = pa.paged_gather_dense(kp, tables).to(q.dtype)
    v = pa.paged_gather_dense(vp, tables).to(q.dtype)
    t = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = (t < lens[:, None]) & (t >= starts[:, None])
    if window:
        mask = mask & (t > lens[:, None] - 1 - window)
    return _sdpa(q[:, :, None, :], k, v, mask[:, None, None, :], scale)


# the mixtral_serve phase's stepwise quantum: 16 live rows of 512-token
# prompts a few tokens into their answers, Mixtral-8x7B's 32/8 heads of 128
MIXTRAL_K9_LENGTHS = tuple(513 + 4 * i for i in range(16))


def _paged_decode_k9(table: dict) -> None:
    """K9 against its plain version on the card: the GPT-2 serving shape
    (bf16 main-path row, walking all 12 layers of a 257-block pool; fp16,
    fp32, and e4m3 pools beside bf16 queries), the Mistral-7B shape (32/8
    heads, D 128) with windows 8 and 24, and the mixtral_serve stepwise
    quantum's rows; the first and last layer. Times kernel (CUDA events
    around a graph of calls walking the layers), plain version and SDPA
    (K/V gathered beforehand) beside the bound, and sweeps the split of
    every timed case beside the plan's pick."""
    import torch

    from tinygpt_tpu_torch.engine.kv_cache import kv_cast
    from tinygpt_tpu_torch.ops import paged_attention as pa

    L2, H = GPT2_124M["n_layer"], GPT2_124M["n_head"]
    D2 = GPT2_124M["n_embd"] // H
    bf16 = torch.bfloat16
    mix = dict(lengths=MIXTRAL_K9_LENGTHS, inactive={}, starts={})
    # (label, L, Nq, Nk, D, window, dtype, e4m3 pools, is_main_path, timed, rows)
    cases = [
        ("GPT-2 serving shape", L2, H, H, D2, None, bf16, False, True, True, {}),
        ("GPT-2 serving shape", L2, H, H, D2, None, bf16, True, False, True, {}),
        ("GPT-2 serving shape", 2, H, H, D2, None, torch.float16, False, False, False, {}),
        ("GPT-2 serving shape", 2, H, H, D2, None, torch.float32, False, False, True, {}),
        ("Mistral-7B shape w8", 2, 32, 8, 128, 8, bf16, False, False, False, {}),
        ("Mistral-7B shape w24", 2, 32, 8, 128, 24, torch.float32, False, False, False, {}),
        ("Mistral-7B shape w24", 4, 32, 8, 128, 24, bf16, True, False, False, {}),
        ("Mistral-7B shape", 4, 32, 8, 128, None, bf16, False, False, True, {}),
        ("mixtral_serve stepwise shape", 4, 32, 8, 128, None, bf16, False, False, True, mix),
    ]
    worst = 0.0
    for i, (label, Lc, nq, nk, d, window, dtype, e4m3, main, timed, rows) in enumerate(cases):
        dname = str(dtype).replace("torch.", "")
        q, kp, vp, tables, lens, starts = _k9_case(Lc, nq, nk, d, dtype, seed=400 + i, **rows)
        if e4m3:
            kp, vp = kv_cast(kp, E4M3), kv_cast(vp, E4M3)
        for l in sorted({0, Lc - 1}):
            args = (q, kp[l], vp[l], tables, lens, starts, d ** -0.5, window)
            got = pa.paged_decode(*args)
            want = pa.paged_decode_plain(*args)
            torch.cuda.synchronize()
            err, share = _paged_err(got, want, dname)
            worst = max(worst, share)
            if not (math.isfinite(err) and share <= 1):
                raise PhaseError(f"paged_decode {label} l={l} {dname}"
                                 f"{' e4m3' if e4m3 else ''}: error {err}, {share:.3g} "
                                 f"of its bound")
        nbytes, flops = _k9_cost(q, nk, tables, lens, starts, window,
                                 1 if e4m3 else q.element_size())
        b_ms, b_by = bound_ms(nbytes, flops, dname)
        what = (f"[paged] paged_decode {label} D={d} G={nq // nk} {dname}"
                f"{' e4m3 pools' if e4m3 else ''}")
        if not timed:
            log(f"{what}: max_abs_err {err:.3g} ({share:.3g} of its bound) ok")
            continue
        t_k = events_ms(lambda lw: pa.paged_decode(q, kp[lw], vp[lw], tables, lens, starts,
                                                   d ** -0.5, window), Lc)
        t_p = cuda_time_ms(lambda: pa.paged_decode_plain(*args), iters=10)
        sdpa = _sdpa_k9(*args)
        t_l = events_ms(lambda _: sdpa(), 1, calls=20)
        log(f"{what}: max_abs_err {err:.3g} ({share:.3g} of its bound) kernel {t_k:.4f} ms "
            f"(CUDA events) "
            f"plain {t_p:.4f} ms sdpa (K/V gathered dense beforehand, CUDA events) "
            f"{t_l:.4f} ms bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
        call, plan, per_sm = _k9_entry(q, kp, vp, tables, lens, starts, d ** -0.5, window)
        split_sweep("[paged]", "paged_decode", f"{label} {dname}{' e4m3' if e4m3 else ''}",
                    call, Lc, plan, note=f" (blocks an SM at C = 1..8: {per_sm})")
        if main:
            table["paged_decode"] = dict(
                name="paged_decode", route="cuda", source=SOURCES["paged_decode"],
                replaces=REPLACES["paged_decode"], launches=0, max_abs_err=err, tol_share=share,
                ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
        elif e4m3:
            E4M3_ROWS["paged_decode"] = dict(ms=t_k, plain_ms=t_p, bound_ms=b_ms,
                                             max_abs_err=err)
        del q, kp, vp
        torch.cuda.empty_cache()
    log(f"[paged] paged_decode: worst max_abs_err over all cases {worst:.3g} of its "
        f"bound (output by output: one ulp of the largest output in bf16 and fp16, 1e-4 "
        f"in fp32, or one ulp of the output where that is more)")


def _wide_groups() -> None:
    """Wide head groups, checked against their plain versions and timed
    beside their bounds: K2, K8 and K9 at 16 query heads per KV head
    (Llama-3.1-405B's 128 over 8, D 128; two group tiles of 8 heads per KV
    head), K10 at 72 (G 8, 9 verify positions) and 80 (G 16, 5 positions)
    query rows per KV head (three row groups of 32); K9 and K10 beside the
    plain version and SDPA, with their split sweeps."""
    import torch

    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops import paged_attention as pa

    bf16 = torch.bfloat16
    Nq, Nk, D, Lc = 128, 8, 128, 4
    scale = D ** -0.5
    # K2 at the model phase's cache shape (4 left-padded rows, T 1024)
    q, ks, vs, mask, ki, vi, step, _ = _decode_case(Lc, 4, Nq, Nk, D, 1024, 32,
                                                     (0, 37, 211, 600), 900, 31, None, bf16,
                                                     seed=500)
    for l in (0, Lc - 1):
        args = (q, ks, vs, mask, ki, vi, l, step, scale, None)
        got, want = ak.flash_decode_frozen(*args), ak.flash_decode_frozen_plain(*args)
        torch.cuda.synchronize()
        err, share = _paged_err(got, want, "bfloat16")
        if not (math.isfinite(err) and share <= 1):
            raise PhaseError(f"flash_decode_frozen G=16 l={l}: error {err}, {share:.3g} of "
                             f"its bound")
    layers = iter(range(10 ** 9))
    t_k = cuda_time_ms(lambda: ak.flash_decode_frozen(q, ks, vs, mask, ki, vi,
                                                      next(layers) % Lc, step, scale),
                       iters=4 * Lc)
    b_ms, b_by = bound_ms(*_decode_cost(q, mask, ki, step, None), "bfloat16")
    log(f"[paged] flash_decode_frozen G=16 (128/8 heads, D 128, T 1024, 4 rows) bf16: "
        f"max_abs_err {err:.3g} ({share:.3g} of its bound) kernel {t_k:.4f} ms bound "
        f"{b_ms:.4f} ms "
        f"({b_by})")
    del q, ks, vs, ki, vi
    # K8 and K9 on the serve phase's pool at 16 query heads per KV head
    lens = list(PAGED_LENGTHS)
    q, kp, vp, tables, lengths, starts, ki, vi = _paged_case(Lc, Nq, Nk, D, lens, {}, bf16,
                                                             seed=501)
    step = PAGED["N"] - 1
    for name, kern, plain, call, cost in (
            ("paged_decode_frozen", pa.paged_decode_frozen, pa.paged_decode_frozen_plain,
             lambda l: (q, kp, vp, tables, lengths, starts, ki, vi, l, step, scale, None),
             _paged_cost(q, Nk, lens, step, None)),
            ("paged_decode", pa.paged_decode, pa.paged_decode_plain,
             lambda l: (q, kp[l], vp[l], tables, lengths, starts, scale, None),
             _k9_cost(q, Nk, tables, lengths, starts, None, 2))):
        for l in (0, Lc - 1):
            got, want = kern(*call(l)), plain(*call(l))
            torch.cuda.synchronize()
            err, share = _paged_err(got, want, "bfloat16")
            if not (math.isfinite(err) and share <= 1):
                raise PhaseError(f"{name} G=16 l={l}: error {err}, {share:.3g} of its bound")
        b_ms, b_by = bound_ms(*cost, "bfloat16")
        what = (f"[paged] {name} G=16 (128/8 heads, D 128, the serve phase's 16 rows) bf16: "
                f"max_abs_err {err:.3g} ({share:.3g} of its bound)")
        if name == "paged_decode_frozen":
            layers = iter(range(10 ** 9))
            t_k = cuda_time_ms(lambda: kern(*call(next(layers) % Lc)), iters=4 * Lc)
            log(f"{what} kernel {t_k:.4f} ms bound {b_ms:.4f} ms ({b_by})")
            continue
        t_k = events_ms(lambda l: kern(*call(l)), Lc)
        t_p = cuda_time_ms(lambda: plain(*call(Lc - 1)), iters=10)
        sdpa = _sdpa_k9(*call(Lc - 1))
        t_l = events_ms(lambda _: sdpa(), 1, calls=20)
        log(f"{what} kernel {t_k:.4f} ms (CUDA events) plain {t_p:.4f} ms sdpa (K/V gathered "
            f"dense beforehand, CUDA events) {t_l:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        k9, plan, per_sm = _k9_entry(q, kp, vp, tables, lengths, starts, scale, None)
        split_sweep("[paged]", "paged_decode", "G16 bf16", k9, Lc, plan,
                    note=f" (blocks an SM at C = 1..8: {per_sm})")
    del q, kp, vp, ki, vi
    torch.cuda.empty_cache()
    # K10 past 64 rows per KV head
    for nq, S in ((64, 9), (128, 5)):
        lens_c = [0 if b == 3 else n for b, n in enumerate(SPEC_LENGTHS)]
        args, base, q_slots, infl_slots = _spec_kernel_case(
            Lc, nq, Nk, D, lens_c, {3: 0}, bf16, False, 0, seed=502 + nq, S=S)
        for l in (0, Lc - 1):
            call = (*args, l, base, scale, None, q_slots, infl_slots)
            got, want = pa.paged_decode_spec(*call), pa.paged_decode_spec_plain(*call)
            torch.cuda.synchronize()
            err, share = _paged_err(got, want, "bfloat16")
            if not (math.isfinite(err) and share <= 1):
                raise PhaseError(f"paged_decode_spec S*G={S * nq // Nk} l={l}: error {err}, "
                                 f"{share:.3g} of its bound")
        t_k, t_p, t_l = _k10_times(args, base, q_slots, infl_slots, scale, None, Lc)
        b_ms, b_by = bound_ms(*_spec_cost(args, base, q_slots, infl_slots, None), "bfloat16")
        log(f"[paged] paged_decode_spec S*G={S * nq // Nk} (G {nq // Nk}, S {S}, D 128, 16 "
            f"rows) bf16: max_abs_err {err:.3g} ({share:.3g} of its bound) kernel {t_k:.4f} ms "
            f"(CUDA "
            f"events) plain {t_p:.4f} ms sdpa (K/V gathered, mask built beforehand, CUDA "
            f"events) {t_l:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        _k10_sweep(f"S*G={S * nq // Nk} bf16", args, base, q_slots, infl_slots, scale, None, Lc)
        del args
        torch.cuda.empty_cache()


def main_path_shapes() -> dict:
    """Shapes the model phase gives each kernel (the engine's cache length
    rule: the bucketed prompt plus every decode chunk)."""
    S = max(PROMPT_LENS)
    T = S + N_CHUNKS * DECODE_CHUNK
    pads = tuple(S - n for n in PROMPT_LENS)
    return {
        "prefill": {"S": S, "T": T, "pads": pads},
        "decode": {"T": T, "N": DECODE_CHUNK, "pads": pads, "length": S + DECODE_CHUNK,
                   "step": DECODE_CHUNK - 1},
    }


# -- model / engine ------------------------------------------------------------


def _left_padded_batch(S, lens, vocab, seed):
    """Token ids, positions and validity of a left-padded batch, as the
    engine builds them (row b: S - lens[b] pads, then lens[b] tokens)."""
    import torch

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    B = len(lens)
    ids = torch.randint(3, vocab, (B, S), generator=g, device=DEVICE)
    slots = torch.arange(S, device=DEVICE)[None, :]
    pad = torch.tensor([S - n for n in lens], device=DEVICE)[:, None]
    valid = slots >= pad
    positions = torch.where(valid, slots - pad, 0).to(torch.int32)
    ids = torch.where(valid, ids, 0)
    return ids, positions, valid


def _run_route(params, cfg, batch, T, attn_impl, force=None, n_chunks=N_CHUNKS,
               kv_dtype=None, model=None, per_token=False, chunk=None):
    """Prefill + n_chunks greedy decode chunks of `chunk` steps (default
    DECODE_CHUNK) on one attention route, the KV cache in kv_dtype (default: the params' dtype);
    with per_token the same steps one decode_step each (the streaming
    engine's per-token route, attention through K13) instead of
    decode_steps chunks.

    With `force` (the tokens [1 + n_chunks*chunk, B] of another run) every step
    is fed force's token instead of its own argmax, so two routes see the
    same inputs at every position. `model` is the family's module (default
    models.causal_lm). Returns (the logits of every sampled position
    [1 + n_chunks*chunk, B, V], the tokens fed on [1 + n_chunks*chunk, B],
    prefill ms, decode ms/step)."""
    import torch

    from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
    from tinygpt_tpu_torch.models import causal_lm, params_dtype

    model = model or causal_lm
    chunk = chunk or DECODE_CHUNK

    ids, positions, valid = batch
    B = ids.shape[0]
    lens = valid.sum(dim=1).to(torch.int32)
    seen, fed = [], []

    def pick(lg):
        seen.append(lg)
        tok = lg.argmax(dim=-1) if force is None else force[len(seen) - 1]
        fed.append(tok.to(torch.int32))
        return fed[-1]

    cache = create_kv_cache(cfg, B, T, dtype=kv_dtype or params_dtype(params),
                            device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.forward(params, cfg, ids, cache, positions, valid,
                                  last_only=True, attn_impl=attn_impl)
    tok = pick(logits[:, -1])
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    for c in range(n_chunks):
        pos0 = (lens + c * chunk)[:, None]
        if per_token:
            for i in range(chunk):
                logits, cache = model.decode_step(params, cfg, tok, cache, pos0 + i,
                                                  attn_impl)
                tok = pick(logits[:, -1])
            continue
        toks, cache = model.decode_steps(params, cfg, tok, cache, pos0, chunk, pick,
                                         attn_impl)
        tok = toks[-1]
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    return (torch.stack(seen), torch.stack(fed), t_prefill * 1e3,
            t_decode * 1e3 / (n_chunks * chunk))


def host_us(fn, n: int = 100, rounds: int = 5) -> float:
    """Wall microseconds the host spends on one fn(i) call: the median of
    `rounds` rounds of n calls back to back, each round timed without
    waiting for the device (the launch queue takes the calls) and followed
    by a synchronize. The host's cores are shared, so one round spreads."""
    import torch

    out = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn(i)
        out.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def host_launch_us(n: int = 2000) -> float:
    """Wall microseconds a tiny kernel launch costs the host (n in-place
    adds on a 16-element tensor, then one synchronize): the rate that
    bounds a host-bound decode step."""
    import torch

    x = torch.zeros(16, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        x.add_(1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def _profile_decode(params, cfg, batch, T, label: str = "bf16", kv_dtype=None,
                    model=None, tag: str = "[profile]", per_token: bool = False) -> dict:
    """Device time by kernel over PROFILE_STEPS decode steps of the kernel
    route (torch.profiler), against their wall time: where a step's time
    goes, and how much of it the device sits idle. The profiler's own cost
    lengthens the wall time, so the idle share is an upper bound. With
    per_token the steps are decode_step calls (K13), else one decode_steps
    chunk. Returns wall and busy ms a step and device launches a step
    (empty when the profiler saw no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
    from tinygpt_tpu_torch.models import causal_lm, params_dtype

    model = model or causal_lm
    ids, positions, valid = batch
    lens = valid.sum(dim=1).to(torch.int32)
    cache = create_kv_cache(cfg, ids.shape[0], T, dtype=kv_dtype or params_dtype(params),
                            device=DEVICE)
    logits, cache = model.forward(params, cfg, ids, cache, positions, valid,
                                  last_only=True)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    n = PROFILE_STEPS

    def steps(start):
        """n decode steps from position lens + start, then a synchronize."""
        if per_token:
            t, c = tok, cache
            for i in range(n):
                logits, c = model.decode_step(params, cfg, t, c, lens[:, None] + start + i)
                t = logits[:, -1].argmax(-1).to(torch.int32)
        else:
            model.decode_steps(params, cfg, tok, cache, lens[:, None] + start, n,
                               lambda lg: lg.argmax(-1))
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(0)
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only (kernels, memcpy/memset); the CPU-side ops
    # that launched them report the same time again, as do the
    # process-group calls ("nccl:all_reduce", "gloo:..."), whose device
    # time is their kernels' or copies'
    kernels = [(e.self_device_time_total, e.count, e.key)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
               and not e.key.startswith(("nccl:", "gloo:"))]
    busy_us = sum(us for us, _, _ in kernels)
    if not busy_us:
        log(f"{tag} decode steps: device time not measured (the profiler saw "
            f"no device activity)")
        return {}
    groups = {"flash_decode_frozen": 0.0, "flash_decode (K13)": 0.0,
              "gathered experts (K12, K11a, K11b)": 0.0,
              "int4 (K4-K7)": 0.0, "int8 (K5a, K3)": 0.0, "GEMM (cuBLAS)": 0.0, "other": 0.0}
    for us, _, key in kernels:
        if key.startswith("ncclDevKernel"):
            # a collective's kernel waits on its peers: its time is not work
            groups.setdefault("collectives (NCCL, with their waits)", 0.0)
            groups["collectives (NCCL, with their waits)"] += us
        elif "split_decode_kernel" in key:  # K2 and K13: one template, INFL true for K2
            k2 = re.search(r",\s*(true|\(bool\)1)>", key)
            groups["flash_decode_frozen" if k2 else "flash_decode (K13)"] += us
        elif "moe_gather" in key:
            groups["gathered experts (K12, K11a, K11b)"] += us
        elif "int4" in key.lower():  # the prefill kernel's converter is dqmm::Int4
            groups["int4 (K4-K7)"] += us
        elif "int8" in key.lower():
            groups["int8 (K5a, K3)"] += us
        elif any(w in key.lower() for w in ("gemm", "nvjet", "cutlass", "gemv")):
            groups["GEMM (cuBLAS)"] += us
        else:
            groups["other"] += us
    launches = sum(c for _, c, _ in kernels)
    log(f"{tag} {label}: {n} decode steps under the profiler: wall {wall_us / n / 1e3:.3f} "
        f"ms/step, device busy {busy_us / n / 1e3:.3f} ms/step "
        f"({100 * busy_us / wall_us:.1f}% busy, {100 - 100 * busy_us / wall_us:.1f}% "
        f"idle), {launches // n} device launches/step; by group (ms/step): "
        + ", ".join(f"{k} {v / n / 1e3:.3f}" for k, v in groups.items()))
    for us, count, key in sorted(kernels, reverse=True)[:8]:
        log(f"{tag}   {us / n / 1e3:8.4f} ms/step  {count // n:4d} launches/step  "
            f"{key[:90]}")
    # the host's side of the same steps: the CUDA runtime's calls (their CPU
    # time, under the profiler), then the Python functions (cProfile, over n
    # more steps)
    api = sorted(((e.self_cpu_time_total, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU and e.key.startswith("cuda")),
                 reverse=True)
    log(f"{tag} {label}: host, CUDA runtime calls a step (us a call): "
        + ", ".join(f"{key} {count // n} ({us / count:.2f})" for us, count, key in api[:5]))
    _host_functions(lambda: steps(n), n, f"{tag} {label}")
    return {"wall_ms": wall_us / n / 1e3, "busy_ms": busy_us / n / 1e3,
            "launches": launches / n,
            "collective_ms": groups.get("collectives (NCCL, with their waits)", 0.0) / n / 1e3}


def _host_functions(run, n: int, tag: str) -> None:
    """Where the host's time goes in run() (n decode steps): the wall ms a
    step under cProfile, the kernel wrappers' (the functions that count
    launches) calls a step and us a call with what they call, and the eight
    functions of most self time, us a step. cProfile's cost lengthens every
    Python call, about alike in any tree, so compare two trees with it, not
    with the wall of an unprofiled step."""
    import cProfile
    import pstats

    from tinygpt_tpu_torch.ops.attention_kernels import LAUNCHES

    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    run()
    pr.disable()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    stats = pstats.Stats(pr).stats  # (file, line, name) -> (cc, calls, self s, cum s, callers)
    wrappers = sorted((cum / calls * 1e6, calls // n, fn[2]) for fn, (_, calls, _, cum, _)
                      in stats.items() if fn[2] in LAUNCHES and calls >= n)
    top = sorted(((own / n * 1e6, fn[2]) for fn, (_, _, own, _, _) in stats.items()),
                 reverse=True)[:8]
    log(f"{tag}: host under cProfile {wall_ms:.3f} ms a step; kernel wrappers (calls a "
        f"step, us a call): " + ", ".join(f"{name} {c} ({us:.1f})" for us, c, name in wrappers)
        + "; most self time (us a step): " + ", ".join(f"{name} {us:.0f}" for us, name in top))


def _check_routes(label, kern, plain, tol, tag="[model]"):
    """Kernel route (fed the plain route's greedy tokens) vs plain route:
    the logits of every sampled position within `tol` (max abs), and the
    greedy choice equal at every position but a near-tie, where the plain
    route's top-2 logit gap is below 2 * tol (two logits that may each
    move by tol can swap there)."""
    lg_k, lg_p = kern[0], plain[0]                         # [n_tok, B, V]
    n_tok, B = lg_p.shape[:2]
    err_all = (lg_k - lg_p).abs().amax(dim=-1)             # [n_tok, B]
    err = err_all.max().item()
    rel = ((lg_k[0] - lg_p[0]).norm() / lg_p[0].norm()).item()
    log(f"{tag} {label}: logits kernel vs plain (same inputs at every position), "
        f"max_abs_err {err:.4g} over {n_tok} positions x {B} rows (tol {tol}); "
        f"prefill last position {err_all[0].max().item():.4g}, relative L2 {rel:.3g}, "
        f"logits std {lg_p[0].std().item():.3g}")
    if not math.isfinite(err) or err > tol:
        raise PhaseError(f"{label}: logits differ by {err} > {tol}")
    top2 = lg_p.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]                      # [n_tok, B]
    differ = lg_k.argmax(dim=-1) != lg_p.argmax(dim=-1)
    near_tie = 2 * tol
    bad = differ & (gap >= near_tie)
    log(f"{tag} {label}: greedy choice differs at {int(differ.sum())} of "
        f"{n_tok * B} positions, {int(bad.sum())} of them outside a near-tie "
        f"(top-2 gap < {near_tie}, found at {int((gap < near_tie).sum())} positions)")
    if bad.any():
        i, b = (int(x) for x in bad.nonzero()[0])
        raise PhaseError(f"{label}: greedy choice differs at position {i} of row {b} "
                         f"with top-2 gap {gap[i, b].item()} >= {near_tie}")


def phase_model(table: dict):
    """Full-width Mistral-7B shape, random weights, kernel route against
    plain-attention route on the same params: first in fp32 at 4 layers
    (where the two may differ only by summation order), then the main
    path itself, bf16 at all 32 layers. Returns the 32-layer bf16 params
    (the awq phase folds them)."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    mp = main_path_shapes()
    S, T = mp["prefill"]["S"], mp["prefill"]["T"]
    with torch.inference_mode():
        cfg32 = parse_model_config(dict(MISTRAL_7B, num_hidden_layers=4))
        params = causal_lm.init_params(cfg32, seed=0, dtype=torch.float32,
                                       device=DEVICE)
        batch = _left_padded_batch(S, PROMPT_LENS, cfg32.vocab_size, seed=1)
        plain = _run_route(params, cfg32, batch, T, "plain")
        kern = _run_route(params, cfg32, batch, T, "kernel", force=plain[1])
        _check_routes("fp32, 4 layers", kern, plain, MODEL_LOGIT_TOL["float32"])
        if not torch.equal(_run_route(params, cfg32, batch, T, "kernel")[1], plain[1]):
            raise PhaseError("fp32, 4 layers: free-running greedy tokens of the "
                             "kernel route differ from the plain route's")
        log("[model] fp32, 4 layers: free-running greedy tokens identical on both "
            "routes")
        del params

        cfg = parse_model_config(MISTRAL_7B)
        L = cfg.num_hidden_layers
        t0 = time.perf_counter()
        params = causal_lm.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                       device=DEVICE)
        torch.cuda.synchronize()
        n_bytes = sum(t.numel() * t.element_size() for t in
                      [params["embed"], params["lm_head"], *params["layers"].values()])
        log(f"[model] Mistral-7B shape, {L} layers, bf16 params {n_bytes / 1e9:.2f} GB "
            f"initialised in {time.perf_counter() - t0:.1f} s")
        # bytes a decode step must read: every layer's weights, the lm_head
        # and the whole K/V cache (embedding rows are negligible)
        step_bytes = (n_bytes - params["embed"].numel() * 2
                      + 2 * L * len(PROMPT_LENS) * cfg.num_kv_heads * T
                      * cfg.head_dim * 2)
        # operations a prefill must do: the layers' matmuls for every real
        # prompt token, the lm_head for the last one (attention adds <3%)
        layer_params = sum(t.numel() for t in params["layers"].values())
        prefill_flops = 2 * (layer_params * sum(PROMPT_LENS)
                             + cfg.hidden_size * cfg.vocab_size * len(PROMPT_LENS))
        prefill_bound_ms = max(n_bytes / HBM_BYTES_PER_S,
                               prefill_flops / PEAK_FLOPS["bfloat16"]) * 1e3
        _run_route(params, cfg, batch, T, "kernel")       # warm-up
        plain = _run_route(params, cfg, batch, T, "plain")
        forced = _run_route(params, cfg, batch, T, "kernel", force=plain[1])
        ak.reset_launches()                                # the main path's run
        kern = _run_route(params, cfg, batch, T, "kernel")
        launches = dict(ak.LAUNCHES)
        _profile_decode(params, cfg, batch, T)
    torch.cuda.empty_cache()

    want = _dense_want("bf16", L, N_CHUNKS * DECODE_CHUNK)
    log(f"[model] launches {launches} (want {want}: L per prefill, L per decode step)")
    if launches != want:
        raise PhaseError(f"kernel launches {launches} != {want}")
    for name in want:
        table[name]["launches"] = launches[name]
    _check_routes(f"bf16, {L} layers", forced, plain, MODEL_LOGIT_TOL["bfloat16"])
    same = int((kern[1] == plain[1]).all(dim=0).sum())
    log(f"[model] bf16, {L} layers: free-running greedy tokens of the two routes "
        f"identical over all {kern[1].shape[0]} positions in {same} of "
        f"{kern[1].shape[1]} rows (after a near-tie a row takes another path)")
    pre_ms, dec_ms = kern[2:]
    pre_ms_p, dec_ms_p = plain[2:]
    B = len(PROMPT_LENS)
    log(f"[model] kernel route: prefill {pre_ms:.2f} ms ({B}x{S} tokens), decode "
        f"{dec_ms:.3f} ms/step, {B * 1e3 / dec_ms:.1f} tok/s at batch {B} (host: "
        f"{host_launch_us():.2f} us a tiny launch); plain "
        f"route: prefill {pre_ms_p:.2f} ms, decode {dec_ms_p:.3f} ms/step; "
        f"bound of a step (weights + K/V cache read once, {step_bytes / 1e9:.2f} GB) "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; bound of the prefill "
        f"({prefill_flops / 1e12:.2f} TFLOP for {sum(PROMPT_LENS)} real tokens) "
        f"{prefill_bound_ms:.3f} ms")
    return params


def phase_model_fp8(params) -> None:
    """The model phase's bf16 params (Mistral-7B shape, 32 layers, batch 4)
    over an fp8 (e4m3) KV cache: the prefill through K1 and the decode
    through K2, both on e4m3 (in-flight K/V bf16), the kernel route against
    the plain route on the same fp8 cache with forced tokens, exact launch
    counts, the decode step under the profiler, and the logits beside the
    bf16 cache's on the same tokens."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    mp = main_path_shapes()
    S, T = mp["prefill"]["S"], mp["prefill"]["T"]
    cfg = parse_model_config(MISTRAL_7B)
    L, B = cfg.num_hidden_layers, len(PROMPT_LENS)
    batch = _left_padded_batch(S, PROMPT_LENS, cfg.vocab_size, seed=1)
    with torch.inference_mode():
        _run_route(params, cfg, batch, T, "kernel", kv_dtype=E4M3)        # warm-up
        plain = _run_route(params, cfg, batch, T, "plain", kv_dtype=E4M3)
        forced = _run_route(params, cfg, batch, T, "kernel", force=plain[1], kv_dtype=E4M3)
        ak.reset_launches()                                                # the main path's run
        kern = _run_route(params, cfg, batch, T, "kernel", kv_dtype=E4M3)
        launches = dict(ak.LAUNCHES)
        bf16 = _run_route(params, cfg, batch, T, "kernel", force=kern[1])
        _profile_decode(params, cfg, batch, T, label="bf16 weights, fp8 KV", kv_dtype=E4M3)
    torch.cuda.empty_cache()
    want = _dense_want("bf16", L, N_CHUNKS * DECODE_CHUNK)
    log(f"[model_fp8] launches {launches} (want {want}: L per prefill, L per decode step)")
    if launches != want:
        raise PhaseError(f"fp8 KV: kernel launches {launches} != {want}")
    _check_routes("fp8 KV, bf16, 32 layers", forced, plain, MODEL_LOGIT_TOL["bfloat16"])
    diff = (kern[0] - bf16[0]).abs().amax(dim=-1)
    agree = (kern[0].argmax(-1) == bf16[0].argmax(-1)).float().mean().item()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  [params["lm_head"], *params["layers"].values()])
    kv_bytes = 2 * L * B * cfg.num_kv_heads * T * cfg.head_dim   # one byte an element
    step_bytes = n_bytes + kv_bytes
    pre_ms, dec_ms = kern[2:]
    log(f"[model_fp8] fp8 KV against the bf16 cache on the same tokens (kernel route): "
        f"logits max_abs_diff {diff.max().item():.4g}, greedy choice equal at "
        f"{100 * agree:.1f}% of {diff.numel()} positions")
    log(f"[model_fp8] kernel route: prefill {pre_ms:.2f} ms ({B}x{S} tokens), decode "
        f"{dec_ms:.3f} ms/step, {B * 1e3 / dec_ms:.1f} tok/s at batch {B} (host: "
        f"{host_launch_us():.2f} us a tiny launch); plain route: prefill {plain[2]:.2f} ms, "
        f"decode {plain[3]:.3f} ms/step; bound of a step (weights + the fp8 K/V cache "
        f"read once, {step_bytes / 1e9:.3f} GB, the K/V {kv_bytes / 1e9:.3f} of it) "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")


def phase_model_quant(table: dict, bits: int):
    """The Mistral-7B shape quantized on the card (int4: group 64; int8:
    group 128), the kernel route against the plain route on the same
    params: first at 4 layers in fp32, then at all 32 layers in bf16 with
    forced tokens, with exact launch counts. int4 runs K5b, K4 and K1 in
    the prefill and K6, K7 and K2 in every decode step (the fused route);
    int8 runs K5a, K3 and K1 in the prefill and K5a, K3 and K2 in every
    decode step (the unfused route). Returns the 32-layer params (the
    serve phase runs on the int4 ones)."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops.quant import QuantizedTensor, quantize_params

    tag, group = (f"[model{bits}]", INT4_GROUP if bits == 4 else INT8_GROUP)
    mp = main_path_shapes()
    S, T = mp["prefill"]["S"], mp["prefill"]["T"]
    B = len(PROMPT_LENS)
    with torch.inference_mode():
        cfg32 = parse_model_config(dict(MISTRAL_7B, num_hidden_layers=4))
        params = quantize_params(causal_lm.init_params(cfg32, seed=0, dtype=torch.float32,
                                                       device=DEVICE),
                                 bits=bits, group_size=group)
        batch = _left_padded_batch(S, PROMPT_LENS, cfg32.vocab_size, seed=1)
        plain = _run_route(params, cfg32, batch, T, "plain")
        kern = _run_route(params, cfg32, batch, T, "kernel", force=plain[1])
        _check_routes(f"int{bits}, fp32, 4 layers", kern, plain, MODEL_LOGIT_TOL["float32"])
        if not torch.equal(_run_route(params, cfg32, batch, T, "kernel")[1], plain[1]):
            raise PhaseError(f"int{bits}, fp32, 4 layers: free-running greedy tokens of "
                             f"the kernel route differ from the plain route's")
        log(f"{tag} int{bits}, fp32, 4 layers: free-running greedy tokens identical on "
            f"both routes")
        del params

        cfg = parse_model_config(MISTRAL_7B)
        L = cfg.num_hidden_layers
        t0 = time.perf_counter()
        params = causal_lm.init_params(cfg, seed=0, dtype=torch.bfloat16, device=DEVICE)
        params = quantize_params(params, bits=bits, group_size=group)  # frees bf16 stacks
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        quant = [params["lm_head"], *(v for v in params["layers"].values()
                                      if isinstance(v, QuantizedTensor))]
        q_bytes = sum(_nbytes(q.data, q.scales) for q in quant)
        norms = sum(_nbytes(v) for v in params["layers"].values()
                    if not isinstance(v, QuantizedTensor)) + _nbytes(params["final_ln"])
        kv_bytes = 2 * L * B * cfg.num_kv_heads * T * cfg.head_dim * 2
        step_bytes = q_bytes + norms + kv_bytes
        layer_weights = sum(q.data.shape[0] * q.in_dim * q.out_dim for q in quant[1:])
        prefill_flops = 2 * (layer_weights * sum(PROMPT_LENS)
                             + cfg.hidden_size * cfg.vocab_size * B)
        prefill_bound_ms = max((q_bytes + norms) / HBM_BYTES_PER_S,
                               prefill_flops / PEAK_FLOPS["bfloat16"]) * 1e3
        log(f"{tag} Mistral-7B shape, {L} layers, quantized to int{bits} group {group} "
            f"on the card in {time.perf_counter() - t0:.1f} s: weights and scales "
            f"{q_bytes / 1e9:.3f} GB (layers and head), a decode step reads "
            f"{step_bytes / 1e9:.3f} GB (with the norms and the {kv_bytes / 1e9:.3f} GB "
            f"K/V cache)")
        _run_route(params, cfg, batch, T, "kernel")       # warm-up
        plain = _run_route(params, cfg, batch, T, "plain")
        forced = _run_route(params, cfg, batch, T, "kernel", force=plain[1])
        ak.reset_launches()                                # the main path's run
        kern = _run_route(params, cfg, batch, T, "kernel")
        launches = dict(ak.LAUNCHES)
        _profile_decode(params, cfg, batch, T, label=f"int{bits}")
    torch.cuda.empty_cache()

    want = _dense_want(f"int{bits}", L, N_CHUNKS * DECODE_CHUNK)
    if bits == 4:
        rule = f"per prefill K5b {4 * L}, K4 1, K1 {L}; per decode step K6 {2 * L + 1}, " \
               f"K7 {L}, K2 {L}"
    else:
        rule = f"per prefill K1 {L}, K5a {4 * L}, K3 1; per decode step K5a {4 * L}, " \
               f"K3 1, K2 {L}"
    log(f"{tag} launches {launches} (want {want}: {rule})")
    if launches != want:
        raise PhaseError(f"int{bits} kernel launches {launches} != {want}")
    for name in want:
        if "dequant" in name or "mlp" in name:
            table[name]["launches"] = launches[name]
    _check_routes(f"int{bits}, bf16, {L} layers", forced, plain, MODEL_LOGIT_TOL["bfloat16"])
    same = int((kern[1] == plain[1]).all(dim=0).sum())
    log(f"{tag} int{bits}, bf16, {L} layers: free-running greedy tokens of the two routes "
        f"identical over all {kern[1].shape[0]} positions in {same} of "
        f"{kern[1].shape[1]} rows")
    pre_ms, dec_ms = kern[2:]
    pre_ms_p, dec_ms_p = plain[2:]
    log(f"{tag} kernel route: prefill {pre_ms:.2f} ms ({B}x{S} tokens), decode "
        f"{dec_ms:.3f} ms/step, {B * 1e3 / dec_ms:.1f} tok/s at batch {B} (host: "
        f"{host_launch_us():.2f} us a tiny launch); plain "
        f"route: prefill {pre_ms_p:.2f} ms, decode {dec_ms_p:.3f} ms/step; "
        f"bound of a step ({step_bytes / 1e9:.3f} GB read once) "
        f"{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms; bound of the prefill "
        f"({prefill_flops / 1e12:.2f} TFLOP for {sum(PROMPT_LENS)} real tokens) "
        f"{prefill_bound_ms:.3f} ms")
    return params


AWQ_CALIB = (4, 512)  # full-width calibration batch: random tokens, numpy seed 0


def _max_logit_err(a, b) -> float:
    return (a[0] - b[0]).abs().max().item()


def phase_awq(params) -> None:
    """AWQ at full width on the model phase's bf16 params (Mistral-7B shape,
    32 layers): calibration statistics over 4 x 512 random tokens, the
    alpha search and the fold, timed; the fold identity (the folded float
    params against the unfolded on the same tokens: fp32 at 4 layers, bf16
    at 32); then int4 quantization at group 64 and one prefill and one
    decode chunk through K1, K5b, K4, K2, K6 and K7 against the plain
    route, with exact launch counts."""
    import numpy as np
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops import awq
    from tinygpt_tpu_torch.ops.quant import quantize_params

    mp = main_path_shapes()
    S, T = mp["prefill"]["S"], mp["prefill"]["T"]
    cfg = parse_model_config(MISTRAL_7B)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    calib = np.random.default_rng(0).integers(3, V, AWQ_CALIB).astype(np.int32)
    batch = _left_padded_batch(S, PROMPT_LENS, V, seed=1)
    with torch.inference_mode():
        cfg4 = parse_model_config(dict(MISTRAL_7B, num_hidden_layers=4))
        p4 = causal_lm.init_params(cfg4, seed=0, dtype=torch.float32, device=DEVICE)
        f4 = awq.apply_awq(p4, cfg4, awq.collect_act_stats(p4, cfg4, calib), bits=4,
                           group_size=INT4_GROUP)
        ref = _run_route(p4, cfg4, batch, T, "kernel", n_chunks=1)
        err = _max_logit_err(_run_route(f4, cfg4, batch, T, "kernel", force=ref[1],
                                        n_chunks=1), ref)
        tol = MODEL_LOGIT_TOL["float32"]
        log(f"[awq] fold identity, fp32, 4 layers: logits of the folded params against "
            f"the unfolded, max_abs_err {err:.4g} over {ref[0].shape[0]} positions "
            f"(tol {tol})")
        if not (math.isfinite(err) and err <= tol):
            raise PhaseError(f"awq: fp32 fold changes the logits by {err} > {tol}")
        del p4, f4

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = awq.collect_act_stats(params, cfg, calib)
        torch.cuda.synchronize()
        t_stats = time.perf_counter() - t0
        t0 = time.perf_counter()
        folded = awq.apply_awq(params, cfg, stats, bits=4, group_size=INT4_GROUP)
        torch.cuda.synchronize()
        t_fold = time.perf_counter() - t0
        del stats
        ref = _run_route(params, cfg, batch, T, "kernel", n_chunks=1)
        got = _run_route(folded, cfg, batch, T, "kernel", force=ref[1], n_chunks=1)
        err = _max_logit_err(got, ref)
        rel = ((got[0] - ref[0]).norm() / ref[0].norm()).item()
        tol = AWQ_FOLD_TOL_BF16
        log(f"[awq] fold identity, bf16, {L} layers: max_abs_err {err:.4g} over "
            f"{ref[0].shape[0]} positions (tol {tol}), relative L2 {rel:.3g}, logits std "
            f"{ref[0][0].std().item():.3g}")
        if not (math.isfinite(err) and err <= tol):
            raise PhaseError(f"awq: bf16 fold changes the logits by {err} > {tol}")
        t0 = time.perf_counter()
        q = quantize_params(folded, bits=4, group_size=INT4_GROUP)
        torch.cuda.synchronize()
        t_quant = time.perf_counter() - t0
        del folded
        torch.cuda.empty_cache()
        log(f"[awq] Mistral-7B shape, {L} layers, on the card: statistics over "
            f"{calib.size} calibration tokens {t_stats:.2f} s, alpha search and fold "
            f"{t_fold:.2f} s, int4 quantization {t_quant:.2f} s; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        plain = _run_route(q, cfg, batch, T, "plain", n_chunks=1)
        ak.reset_launches()                                # AWQ's int4 route
        kern = _run_route(q, cfg, batch, T, "kernel", force=plain[1], n_chunks=1)
        launches = dict(ak.LAUNCHES)
        del q
    torch.cuda.empty_cache()
    want = _dense_want("int4", L, DECODE_CHUNK)
    log(f"[awq] launches {launches} (want {want})")
    if launches != want:
        raise PhaseError(f"awq: launches {launches} != {want}")
    _check_routes(f"AWQ int4, bf16, {L} layers", kern, plain, MODEL_LOGIT_TOL["bfloat16"])


# -- serving -------------------------------------------------------------------


def _serving_model(counts, model=None, stepwise=False):
    """The model entry the batcher drives (`model`: the family's module,
    default models.causal_lm), counting admissions (one dense forward
    each), decode steps and speculative verify rounds. With `stepwise` the
    namespace has forward_paged and no decode_paged_steps: the batcher then
    runs its stepwise quantum (K9)."""
    from types import SimpleNamespace

    from tinygpt_tpu_torch.models import causal_lm

    model = model or causal_lm

    def forward(*args, **kw):
        counts["admissions"] += 1
        return model.forward(*args, **kw)

    def forward_paged(*args, **kw):
        counts["steps"] += 1
        return model.forward_paged(*args, **kw)

    def decode_paged_steps(params, cfg, tok0, state, n_steps, sample_fn,
                           attn_impl="kernel"):
        counts["steps"] += n_steps
        return model.decode_paged_steps(params, cfg, tok0, state, n_steps,
                                        sample_fn, attn_impl=attn_impl)

    def decode_paged_spec_steps(params, cfg, tok0, state, ctx, clen, n_rounds, *args,
                                **kw):
        counts["rounds"] += n_rounds
        return model.decode_paged_spec_steps(params, cfg, tok0, state, ctx, clen,
                                             n_rounds, *args, **kw)

    if stepwise:
        return SimpleNamespace(forward=forward, forward_paged=forward_paged)
    ns = SimpleNamespace(forward=forward, decode_paged_steps=decode_paged_steps)
    if hasattr(model, "decode_paged_spec_steps"):
        ns.decode_paged_spec_steps = decode_paged_spec_steps
    return ns


def _serving_batcher(params, cfg, counts, dtype="bfloat16", attn_impl="kernel", model=None,
                     stepwise=False, **kw):
    """The serving leg's scheduler: capacity 16, block 64, 257 blocks, 16
    blocks a row, bucket 64, whole-prompt admission, prefix cache on,
    quantum 8, pipelined; `kw` adds SchedulerConfig fields (speculation)."""
    from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, SchedulerConfig

    s = SERVE
    return ContinuousBatcher(
        _serving_model(counts, model, stepwise), cfg, params, eos_ids=set(),
        config=SchedulerConfig(
            batch_capacity=s["capacity"], block_size=s["block"],
            n_blocks=s["n_blocks"], max_blocks_per_seq=s["max_blocks"],
            prefill_bucket=s["bucket"], dtype=dtype, attn_impl=attn_impl,
            decode_quantum=s["quantum"], pipeline_quanta=True,
            enable_prefix_cache=True, prefill_chunk_tokens=0, **kw))


def _drive(batcher, prompts, max_new, gap_s=None):
    """The serving leg's loop (benches/flagship_bench.py:496-515): request
    i joins at i * gap_s seconds, between scheduler steps; with gap_s None
    it joins at scheduler step i (the same interleaving on every route)."""
    from tinygpt_tpu_torch.engine.scheduler import Request

    submit, first, streams = {}, {}, {}
    toks, tok_times, nxt, n_steps = 0, [], 0, 0
    t0 = time.perf_counter()
    while nxt < len(prompts) or batcher.has_work:
        now = time.perf_counter()
        while nxt < len(prompts) and (n_steps >= nxt if gap_s is None
                                      else now - t0 >= nxt * gap_s):
            batcher.add_request(Request(request_id=nxt, prompt_ids=prompts[nxt],
                                        max_new_tokens=max_new))
            submit[nxt] = now
            nxt += 1
        if not batcher.has_work:
            time.sleep(0.001)
            continue
        for ev in batcher.step():
            if ev.token_id is not None:
                toks += 1
                streams.setdefault(ev.request_id, []).append(ev.token_id)
                first.setdefault(ev.request_id, time.perf_counter())
        n_steps += 1
        tok_times.append((time.perf_counter(), toks))
    return dict(submit=submit, first=first, streams=streams, toks=toks,
                tok_times=tok_times, t0=t0, wall=time.perf_counter() - t0)


def _serving_metrics(run) -> dict:
    """TTFT percentiles, whole-run and steady tok/s (the middle half of the
    wall time, flagship_bench.py:516-525)."""
    import numpy as np

    wall, t0 = run["wall"], run["t0"]
    ttfts = [run["first"][i] - run["submit"][i] for i in sorted(run["first"])]
    lo, hi = t0 + 0.25 * wall, t0 + 0.75 * wall
    win = [(t, n) for t, n in run["tok_times"] if lo <= t <= hi]
    if len(win) >= 2 and win[-1][0] > win[0][0]:
        steady = (win[-1][1] - win[0][1]) / (win[-1][0] - win[0][0])
    else:
        steady = run["toks"] / wall
    return dict(ttft_p50_s=float(np.percentile(ttfts, 50)),
                ttft_p95_s=float(np.percentile(ttfts, 95)),
                tok_s=run["toks"] / wall, steady_tok_s=float(steady), wall_s=wall)


def _admission_index_us(batcher, prompt) -> None:
    """Logs the host us of one admission's pool-index work at the serve
    shape, on a fresh native and a fresh Python index of the batcher's
    size: the lookups of the prompt's whole blocks (as the batcher makes
    them, up to the first miss), share, alloc of the rest of the request's
    blocks, registration of the blocks not found, and the release at the
    request's end. "hit": the prompt's shareable blocks are all cached
    (a repeated system prompt); "miss": every call a new prompt, so that
    the idle-cached tier fills and alloc evicts, as under varied traffic."""
    import numpy as np

    from tinygpt_tpu_torch.engine import native_pool
    from tinygpt_tpu_torch.engine.paged_kv import blocks_needed

    sc = batcher.sc
    bs = sc.block_size
    hashes = batcher._block_hashes(prompt)
    shareable = (len(prompt) - 1) // bs
    need = blocks_needed(len(prompt) + SERVE["max_new"], bs)
    rng = np.random.default_rng(1)
    fresh = [[int.from_bytes(rng.bytes(16), "little") for _ in hashes] for _ in range(2000)]

    def admission(idx, hs):
        shared = []
        for h in hs[:shareable]:
            b = idx.lookup_prefix(h)
            if b is None:
                break
            shared.append(b)
        idx.share(shared)
        blocks = shared + idx.alloc(need - len(shared))
        for j in range(len(shared), len(hs)):
            idx.register_prefix(hs[j], blocks[j])
        idx.release(blocks, keep_cached=[b for b in blocks if idx.is_registered(b)])
        return len(shared)

    t_hash = host_us(lambda _: batcher._block_hashes(prompt), n=200)
    us = {}
    for kind in ("native", "python"):
        lib = native_pool._load()
        idx = (native_pool.NativePoolIndex(sc.n_blocks, lib) if kind == "native"
               else native_pool.PythonPoolIndex(sc.n_blocks))
        admission(idx, hashes)
        if admission(idx, hashes) != shareable:
            raise PhaseError(f"serve: the {kind} index found no cached prefix")
        us[kind, "hit"] = host_us(lambda _: admission(idx, hashes), n=200)
        calls = iter(fresh)
        us[kind, "miss"] = host_us(lambda _: admission(idx, next(calls)), n=200, rounds=5)
    log(f"[serve] host_us of one admission's pool-index work ({len(prompt)}-token prompt, "
        f"{len(hashes)} whole blocks of {bs}, {need} blocks a request, pool of "
        f"{sc.n_blocks}): all {shareable} shareable blocks cached: native "
        f"{us['native', 'hit']:.2f} us, python {us['python', 'hit']:.2f} us; a new prompt "
        f"each call (evicting once the pool fills): native {us['native', 'miss']:.2f} us, "
        f"python {us['python', 'miss']:.2f} us; the prompt's chain hashes (either index) "
        f"{t_hash:.2f} us; card {CARD}")


def phase_serve(table: dict, params) -> None:
    """The continuous batcher on the card, at the Mistral-7B shape in int4
    (model4's params), under the JAX package's serving traffic: the main
    path of this phase, with exact launch counts; then one quantum under
    torch.profiler; then kernel route against plain route."""
    from collections import Counter

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinygpt_tpu_torch.engine.scheduler import Request
    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops.quant import QuantizedTensor, quantize_params

    s = SERVE
    cfg = parse_model_config(MISTRAL_7B)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    Nk, D = cfg.num_kv_heads, cfg.head_dim
    rng = np.random.default_rng(0)

    def prompt(n):
        return [int(x) for x in rng.integers(3, V, n)]

    with torch.inference_mode():
        counts = Counter()
        batcher = _serving_batcher(params, cfg, counts)
        if batcher.allocator.kind != "native":
            raise PhaseError(f"serve: the batcher's pool index is "
                             f"{batcher.allocator.kind}, not the native one")
        _admission_index_us(batcher, prompt(s["prompt_len"]))
        t0 = time.perf_counter()
        _drive(batcher, [prompt(s["prompt_len"])], s["warm_new"])
        torch.cuda.synchronize()
        log(f"[serve] warm-up: one request of {s['prompt_len']} tokens, {s['warm_new']} "
            f"new, in {time.perf_counter() - t0:.2f} s")
        prompts = [prompt(s["prompt_len"]) for _ in range(s["n_requests"])]
        counts.clear()
        ak.reset_launches()                                   # the main path's run
        run = _drive(batcher, prompts, s["max_new"], s["gap_s"])
        torch.cuda.synchronize()
        launches = dict(ak.LAUNCHES)
        steps, admissions = counts["steps"], counts["admissions"]
        m = _serving_metrics(run)
        n_out = sorted(len(v) for v in run["streams"].values())
        log(f"[serve] {s['n_requests']} requests of {s['prompt_len']} random tokens, "
            f"{s['max_new']} new each, one every {s['gap_s']} s, capacity "
            f"{s['capacity']}, quantum {s['quantum']}: TTFT p50 {m['ttft_p50_s']:.4f} s "
            f"p95 {m['ttft_p95_s']:.4f} s; {run['toks']} tokens in {m['wall_s']:.3f} s = "
            f"{m['tok_s']:.2f} tok/s whole run, {m['steady_tok_s']:.2f} tok/s steady "
            f"(middle half of the wall time); {steps} decode steps, {admissions} "
            f"admissions; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        if n_out != [s["max_new"]] * s["n_requests"]:
            raise PhaseError(f"serve: tokens per request {n_out}, want {s['max_new']} each")
        want = _dense_want("int4", L, steps, prefills=admissions, attn="paged_decode_frozen")
        log(f"[serve] launches {launches} (want {want}: per decode step K8 {L}, K6 "
            f"{2 * L + 1}, K7 {L}; per admission K1 {L}, K5b {4 * L}, K4 1)")
        if admissions != s["n_requests"] or launches != want:
            raise PhaseError(f"serve: launches {launches} != {want} "
                             f"({admissions} admissions)")
        table["paged_decode_frozen"]["launches"] = launches["paged_decode_frozen"]

        # one quantum under the profiler, all rows live: fill the rows, then
        # run decode_paged_steps on the batcher's state as the batcher would
        for i in range(s["capacity"]):
            batcher.add_request(Request(request_id=1000 + i, prompt_ids=prompt(
                s["prompt_len"]), max_new_tokens=s["profile_new"]))
        while batcher.waiting or batcher.n_running < s["capacity"]:
            batcher.step()
        batcher._drain_inflight()
        Q = s["quantum"]
        batcher._ensure_blocks(Q)
        batcher._sync_state_meta()
        state = batcher.state
        tok = torch.tensor(batcher._tokens, device=DEVICE)
        lens = batcher._lengths[batcher._active].astype(np.int64)
        names = ("k_pool", "v_pool", "block_tables", "lengths", "starts", "active")
        snap = {k: getattr(state, k).clone() for k in names}

        def restore():
            for k in names:
                if k in ("k_pool", "v_pool"):
                    getattr(state, k).copy_(snap[k])
                else:
                    setattr(state, k, snap[k].clone())

        argmax = lambda lg: lg.argmax(-1).to(torch.int32)  # noqa: E731
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            causal_lm.decode_paged_steps(params, cfg, tok, state, Q, argmax)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy_us = sum(us for us, _, _ in kernels)
        k8_us = sum(us for us, _, key in kernels if _paged_kernel(key) == "paged_decode_frozen")
        quant = [params["lm_head"], *(v for v in params["layers"].values()
                                      if isinstance(v, QuantizedTensor))]
        w_bytes = (sum(_nbytes(q.data, q.scales) for q in quant)
                   + sum(_nbytes(v) for v in params["layers"].values()
                         if not isinstance(v, QuantizedTensor)) + _nbytes(params["final_ln"]))
        # K/V slots a step reads, averaged over the quantum (pool + in flight)
        kv_slots = float(np.mean([(lens + t + 1).sum() for t in range(Q)]))
        kv_bytes = 2 * L * Nk * D * 2 * kv_slots
        step_bound = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
        if busy_us:
            log(f"[serve] one quantum of {Q} steps at {s['capacity']} live rows under the "
                f"profiler: wall {wall_us / Q / 1e3:.3f} ms/step, device busy "
                f"{busy_us / Q / 1e3:.3f} ms/step ({100 * busy_us / wall_us:.1f}% busy), "
                f"{sum(c for _, c, _ in kernels) // Q} device launches/step, K8 "
                f"{k8_us / Q / 1e3:.3f} ms/step ({100 * k8_us / busy_us:.1f}% of busy); a "
                f"step reads {(w_bytes + kv_bytes) / 1e9:.3f} GB (weights "
                f"{w_bytes / 1e9:.3f}, K/V {kv_bytes / 1e9:.3f}): bound {step_bound:.3f} ms")
            for us, count, key in sorted(kernels, reverse=True)[:8]:
                log(f"[serve]   {us / Q / 1e3:8.4f} ms/step  {count // Q:4d} launches/step  "
                    f"{key[:90]}")
        else:
            log("[serve] one quantum: device time not measured (the profiler saw no "
                "device activity)")

        # kernel route against plain route on one quantum at full width, bf16,
        # the same state and forced tokens
        forced = torch.randint(3, V, (Q, s["capacity"]), dtype=torch.int32, device=DEVICE,
                               generator=torch.Generator(device=DEVICE).manual_seed(5))

        def quantum_logits(impl):
            restore()
            seen = []

            def pick(lg):
                seen.append(lg.float())
                return forced[len(seen) - 1]

            causal_lm.decode_paged_steps(params, cfg, tok, state, Q, pick, attn_impl=impl)
            return torch.stack(seen)

        lg_k, lg_p = quantum_logits("kernel"), quantum_logits("plain")
        err = (lg_k - lg_p).abs().max().item()
        tol = MODEL_LOGIT_TOL["bfloat16"]
        log(f"[serve] int4, bf16, {L} layers: one quantum on forced tokens, logits kernel "
            f"vs plain route max_abs_err {err:.4g} (tol {tol}), logits std "
            f"{lg_p.std().item():.3g}")
        if not (math.isfinite(err) and err <= tol):
            raise PhaseError(f"serve: quantum logits differ by {err} > {tol}")
        del batcher, state, snap
        torch.cuda.empty_cache()

        # 4 layers in fp32: identical greedy streams of the two routes for 6
        # staggered requests, two sharing a 128-token prefix (2 blocks)
        cfg4 = parse_model_config(dict(MISTRAL_7B, num_hidden_layers=4))
        p4 = quantize_params(causal_lm.init_params(cfg4, seed=0, dtype=torch.float32,
                                                   device=DEVICE),
                             bits=4, group_size=INT4_GROUP)
        shared = prompt(2 * s["block"])
        prompts6 = [shared + prompt(40), prompt(300), shared + prompt(100), prompt(9),
                    prompt(200), prompt(64)]
        streams = {}
        for impl in ("kernel", "plain"):
            b = _serving_batcher(p4, cfg4, Counter(), dtype="float32", attn_impl=impl)
            streams[impl] = _drive(b, prompts6, 24)["streams"]
            idle = b.allocator.n_idle_cached
        same = streams["kernel"] == streams["plain"]
        log(f"[serve] int4, fp32, 4 layers: greedy streams of 6 staggered requests (two "
            f"sharing a {len(shared)}-token prefix; {idle} blocks idle-cached at the end) "
            f"{'identical' if same else 'DIFFER'} on the kernel and plain routes")
        if not same or sorted(map(len, streams["kernel"].values())) != [24] * 6:
            raise PhaseError(f"serve: fp32 streams differ: {streams}")
        del p4
    torch.cuda.empty_cache()


def _spec_prompts(V: int):
    """The spec serve phase's prompts (numpy seed 0): each repeats its own
    random span of SPEC["span"] tokens up to the serving prompt length."""
    import numpy as np

    rng = np.random.default_rng(0)
    reps = SERVE["prompt_len"] // SPEC["span"]
    return [[int(x) for x in rng.integers(3, V, SPEC["span"])] * reps
            for _ in range(SERVE["n_requests"] + 1)]


def _spec_kw():
    return dict(speculative="ngram", spec_draft_len=SPEC["draft_len"],
                spec_ngram=SPEC["ngram"])


def phase_spec_serve(table: dict, params) -> None:
    """The continuous batcher with n-gram speculation on the card, at the
    Mistral-7B shape in int4 (model4's params): the serving leg's scheduler
    and arrivals (16 requests, one every 0.25 s, 256 greedy new tokens) on
    prompts that repeat a 64-token span, with exact launch counts; the same
    traffic with speculation off; one speculative quantum at 16 live rows
    under the profiler; and at 4 layers in fp32, the streams of both."""
    from collections import Counter

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinygpt_tpu_torch.engine.scheduler import Request
    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops.quant import quantize_params

    s = SERVE
    cfg = parse_model_config(MISTRAL_7B)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    prompts = _spec_prompts(V)
    warm, prompts = prompts[-1], prompts[:-1]
    runs, streams = {}, {}
    with torch.inference_mode():
        for mode in ("spec", "plain"):
            counts = Counter()
            batcher = _serving_batcher(params, cfg, counts,
                                       **(_spec_kw() if mode == "spec" else {}))
            _drive(batcher, [warm], s["warm_new"])
            torch.cuda.synchronize()
            counts.clear()
            batcher.spec_emitted = batcher.spec_verifies = 0
            ak.reset_launches()                               # the main path's run
            run = _drive(batcher, prompts, s["max_new"], s["gap_s"])
            torch.cuda.synchronize()
            runs[mode] = (run, _serving_metrics(run), dict(ak.LAUNCHES), dict(counts),
                          batcher.spec_acceptance, batcher.spec_verifies)
            streams[mode] = run["streams"]
            if mode == "spec":
                spec_batcher = batcher
        for mode, (run, m, launches, counts, acc, verifies) in runs.items():
            n_out = sorted(len(v) for v in run["streams"].values())
            log(f"[spec_serve] {mode}: {s['n_requests']} requests of {s['prompt_len']} tokens "
                f"(a {SPEC['span']}-token span repeated), {s['max_new']} new each, one every "
                f"{s['gap_s']} s: TTFT p50 {m['ttft_p50_s']:.4f} s p95 {m['ttft_p95_s']:.4f} s; "
                f"{run['toks']} tokens in {m['wall_s']:.3f} s = {m['tok_s']:.2f} tok/s whole "
                f"run, {m['steady_tok_s']:.2f} tok/s steady; {counts.get('rounds', 0)} verify "
                f"rounds, {counts.get('steps', 0)} plain decode steps, "
                f"{counts.get('admissions', 0)} admissions; acceptance {acc:.3f} accepted "
                f"drafts a verify over {verifies} row verifies")
            if n_out != [s["max_new"]] * s["n_requests"]:
                raise PhaseError(f"spec_serve {mode}: tokens per request {n_out}")
        launches, counts = runs["spec"][2], runs["spec"][3]
        rounds, steps, adm = counts.get("rounds", 0), counts.get("steps", 0), \
            counts.get("admissions", 0)
        want = {"paged_decode_spec": L * rounds,
                "paged_decode_frozen": L * steps,
                "matmul_dequant_int4_stacked_fused": (2 * L + 1) * steps,
                "mlp_fused_int4_stacked": L * steps,
                "flash_prefill": L * adm,
                "matmul_dequant_int4_stacked": 4 * L * (adm + rounds),
                "matmul_dequant_int4": adm + rounds}
        want = {k: v for k, v in want.items() if v}
        log(f"[spec_serve] launches {launches} (want {want}: per verify round K10 {L}, "
            f"K5b {4 * L} at {s['capacity']} x {SPEC['draft_len'] + 1} rows, K4 1; per plain "
            f"step K8 {L}, K6 {2 * L + 1}, K7 {L}; per admission K1 {L}, K5b {4 * L}, K4 1)")
        if adm != s["n_requests"] or not rounds or launches != want:
            raise PhaseError(f"spec_serve: launches {launches} != {want} ({adm} admissions, "
                             f"{rounds} rounds)")
        table["paged_decode_spec"]["launches"] = launches["paged_decode_spec"]
        same = sum(streams["spec"][i] == streams["plain"][i] for i in streams["plain"])
        log(f"[spec_serve] greedy streams identical with and without speculation in {same} "
            f"of {s['n_requests']} requests (bf16: the verify's K5b and the step's K6/K7 "
            f"sum in other orders, so a near-tie may part two streams)")

        # one speculative quantum at 16 live rows under the profiler
        b = spec_batcher
        b._spec_disabled = False
        for i in range(s["capacity"]):
            b.add_request(Request(request_id=1000 + i, prompt_ids=prompts[i],
                                  max_new_tokens=s["profile_new"]))
        while b.waiting or b.n_running < s["capacity"]:
            b.step()
        b._drain_inflight()
        b._spec_disabled = False
        b._spec_eligible = lambda: True
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            b._decode()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(us for us, _, _ in kernels)
        k10 = sum(us for us, _, k in kernels if _paged_kernel(k) == "paged_decode_spec")
        k5b = sum(us for us, _, k in kernels if "int4" in k.lower())
        if busy:
            log(f"[spec_serve] one speculative quantum (1 round of {SPEC['draft_len'] + 1} "
                f"verify positions) at {s['capacity']} live rows under the profiler: wall "
                f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
                f"({100 * busy / wall_us:.1f}% busy), {sum(c for _, c, _ in kernels)} device "
                f"launches; K10 {k10 / 1e3:.3f} ms ({100 * k10 / busy:.1f}% of busy), the "
                f"int4 matmuls (K5b, K4) {k5b / 1e3:.3f} ms ({100 * k5b / busy:.1f}%)")
            for us, count, key in sorted(kernels, reverse=True)[:8]:
                log(f"[spec_serve]   {us / 1e3:8.4f} ms  {count:4d} launches  {key[:90]}")
        else:
            log("[spec_serve] one speculative quantum: device time not measured (the "
                "profiler saw no device activity)")
        del b, spec_batcher
        torch.cuda.empty_cache()

        # 4 layers in fp32: the same prompts, arrivals by scheduler step
        cfg4 = parse_model_config(dict(MISTRAL_7B, num_hidden_layers=4))
        p4 = quantize_params(causal_lm.init_params(cfg4, seed=0, dtype=torch.float32,
                                                   device=DEVICE),
                             bits=4, group_size=INT4_GROUP)
        got = {}
        for mode in ("spec", "plain"):
            b = _serving_batcher(p4, cfg4, Counter(), dtype="float32",
                                 **(_spec_kw() if mode == "spec" else {}))
            got[mode] = _drive(b, prompts, SPEC["fp32_new"])["streams"]
            if mode == "spec":
                acc4 = b.spec_acceptance
        same = sum(got["spec"][i] == got["plain"][i] for i in got["plain"])
        log(f"[spec_serve] int4, fp32, 4 layers: greedy streams of the {s['n_requests']} "
            f"requests ({SPEC['fp32_new']} new each) identical with and without "
            f"speculation in {same} of {s['n_requests']} (acceptance {acc4:.3f})")
        if same != s["n_requests"]:
            raise PhaseError(f"spec_serve: fp32 streams differ in "
                             f"{s['n_requests'] - same} requests")
        del p4
    torch.cuda.empty_cache()


# -- GPT-2 ---------------------------------------------------------------------


def _gpt2_quant_kernels(qparams, bits, Ms) -> None:
    """K5a (int8) or K5b (int4) against its plain version on GPT-2 124M's
    own quantized layer stacks (qkv 768->2304, o 768->768, fc 768->3072,
    proj 3072->768) at the row counts Ms (a decode step's, the prefill's
    and the prefill regime's edges between), bf16 and fp32 activations,
    the first and the last layer;
    each within QUANT_TOL of its largest output, as in the int8 and int4
    phases."""
    import torch

    from tinygpt_tpu_torch.ops import quant_kernels as qk

    name = f"matmul_dequant_int{bits}_stacked"
    kern, plain = getattr(qk, name), getattr(qk, name + "_plain")
    worst = 0.0
    for key in ("qkv_w", "o_w", "fc_w", "proj_w"):
        w = qparams["layers"][key]
        L = w.data.shape[0]
        for M in Ms:
            gx = torch.Generator(device=DEVICE).manual_seed(M)
            x32 = torch.randn((M, w.in_dim), generator=gx, device=DEVICE)
            for dt in (torch.bfloat16, torch.float32):
                x, dname = x32.to(dt), str(dt).replace("torch.", "")
                for l in (0, L - 1):
                    got = kern(x, w.data, w.scales, l, w.group_size)
                    want = plain(x, w.data, w.scales, l, w.group_size)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    tol = QUANT_TOL[dname] * want.float().abs().max().item()
                    worst = max(worst, err / tol)
                    if not (math.isfinite(err) and err <= tol):
                        raise PhaseError(f"gpt2 {name} {key} M={M} {w.in_dim}->{w.out_dim} "
                                         f"l={l} {dname}: max_abs_err {err} > {tol}")
    log(f"[gpt2] {name} on GPT-2's qkv, o, fc and proj stacks (group {w.group_size}) at "
        f"M = {', '.join(map(str, Ms))}, bf16 and fp32, first and last layer: worst "
        f"max_abs_err {worst:.3g} of its tolerance (one bf16 ulp of the largest output, "
        f"1e-4 of it in fp32)")


def phase_gpt2(table: dict):
    """GPT-2 124M at full width (12 layers, 12 heads of 64, MLP 3,072, vocab
    50,257, n_positions 1,024, tied head; random weights, seed 0) on the
    model phase's batch (4 left-padded prompts of 512/400/300/128 tokens,
    two greedy chunks of 32): prefill through K1 and decode through K2,
    kernel route against plain route, first in fp32 (free-running greedy
    tokens identical), then in bf16 with exact launch counts, the decode
    step under the profiler; then int8 (group 128) and int4 (group 64)
    layer weights through K5a and K5b (the head stays a float matmul),
    each kernel first held against its plain version on GPT-2's own
    stacks.
    Returns the bf16 params (gpt2_serve serves them)."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import gpt2
    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops.quant import quantize_params

    mp = main_path_shapes()
    S, T = mp["prefill"]["S"], mp["prefill"]["T"]
    cfg = parse_model_config(GPT2_124M)
    L, B = cfg.num_hidden_layers, len(PROMPT_LENS)
    n = N_CHUNKS * DECODE_CHUNK
    batch = _left_padded_batch(S, PROMPT_LENS, cfg.vocab_size, seed=1)
    with torch.inference_mode():
        p32 = gpt2.init_params(cfg, seed=0, dtype=torch.float32, device=DEVICE)
        plain = _run_route(p32, cfg, batch, T, "plain", model=gpt2)
        kern = _run_route(p32, cfg, batch, T, "kernel", force=plain[1], model=gpt2)
        _check_routes(f"fp32, {L} layers", kern, plain, MODEL_LOGIT_TOL["float32"],
                      tag="[gpt2]")
        if not torch.equal(_run_route(p32, cfg, batch, T, "kernel", model=gpt2)[1], plain[1]):
            raise PhaseError("gpt2 fp32: free-running greedy tokens of the kernel route "
                             "differ from the plain route's")
        log(f"[gpt2] fp32, {L} layers: free-running greedy tokens identical on both routes")
        del p32

        params = gpt2.init_params(cfg, seed=0, dtype=torch.bfloat16, device=DEVICE)
        n_bytes = sum(_nbytes(t) for t in [params["wte"], params["wpe"],
                                           *params["layers"].values()])
        _run_route(params, cfg, batch, T, "kernel", model=gpt2)   # warm-up
        plain = _run_route(params, cfg, batch, T, "plain", model=gpt2)
        forced = _run_route(params, cfg, batch, T, "kernel", force=plain[1], model=gpt2)
        ak.reset_launches()                                       # the GPT-2 path's run
        kern = _run_route(params, cfg, batch, T, "kernel", model=gpt2)
        launches = dict(ak.LAUNCHES)
        _profile_decode(params, cfg, batch, T, label=f"GPT-2 124M bf16, batch {B}",
                        model=gpt2, tag="[gpt2]")
    want = {"flash_prefill": L, "flash_decode_frozen": L * n}
    log(f"[gpt2] launches {launches} (want {want}: L per prefill, L per decode step)")
    if launches != want:
        raise PhaseError(f"gpt2: kernel launches {launches} != {want}")
    _check_routes(f"bf16, {L} layers", forced, plain, GPT2_LOGIT_TOL_BF16, tag="[gpt2]")
    # a decode step reads every layer's weights, the tied head (wte) and the
    # K/V cache; wpe rows are negligible
    step_bytes = (n_bytes - _nbytes(params["wpe"])
                  + 2 * L * B * cfg.num_kv_heads * T * cfg.head_dim * 2)
    log(f"[gpt2] GPT-2 124M bf16 ({n_bytes / 1e6:.1f} MB of params), kernel route: prefill "
        f"{kern[2]:.2f} ms ({B}x{S} tokens), decode {kern[3]:.3f} ms/step, "
        f"{B * 1e3 / kern[3]:.1f} tok/s at batch {B}; plain route: prefill {plain[2]:.2f} ms, "
        f"decode {plain[3]:.3f} ms/step; bound of a step ({step_bytes / 1e6:.1f} MB read "
        f"once) {step_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")

    for bits, group in ((8, INT8_GROUP), (4, INT4_GROUP)):
        name = f"matmul_dequant_int{bits}_stacked"
        with torch.inference_mode():
            q = quantize_params(params, bits=bits, group_size=group)
            _gpt2_quant_kernels(q, bits, (B, 33) + PREFILL_ROWS + (B * S,))
            plain = _run_route(q, cfg, batch, T, "plain", model=gpt2)
            _run_route(q, cfg, batch, T, "kernel", force=plain[1], model=gpt2)  # warm-up
            ak.reset_launches()
            kern = _run_route(q, cfg, batch, T, "kernel", force=plain[1], model=gpt2)
            launches = dict(ak.LAUNCHES)
            del q
        want = {"flash_prefill": L, "flash_decode_frozen": L * n, name: 4 * L * (1 + n)}
        log(f"[gpt2] int{bits} (group {group}) launches {launches} (want {want}: K5"
            f"{'a' if bits == 8 else 'b'} {4 * L} per prefill and per decode step)")
        if launches != want:
            raise PhaseError(f"gpt2 int{bits}: kernel launches {launches} != {want}")
        _check_routes(f"int{bits}, bf16, {L} layers", kern, plain, GPT2_LOGIT_TOL_BF16,
                      tag="[gpt2]")
        log(f"[gpt2] int{bits} kernel route: prefill {kern[2]:.2f} ms, decode "
            f"{kern[3]:.3f} ms/step; plain route: prefill {plain[2]:.2f} ms, decode "
            f"{plain[3]:.3f} ms/step")
    torch.cuda.empty_cache()
    return params


def _paged_kernel(key: str):
    """The paged kernel a profiler key names ("paged_decode_frozen" for K8,
    "paged_decode" for K9, "paged_decode_spec" for K10), or None. K8 and K9
    are one template, paged_split_kernel, with its last argument (INFL)
    true for K8; the names before it (paged_decode_frozen_kernel,
    paged_decode_kernel) are matched too, for runs over an older
    package."""
    if "paged_spec_tc_kernel" in key or "paged_decode_spec_kernel" in key:
        return "paged_decode_spec"
    if "paged_split_kernel" in key:
        return "paged_decode_frozen" if ", true>" in key else "paged_decode"
    if "paged_decode_frozen_kernel" in key:
        return "paged_decode_frozen"
    if "paged_decode_kernel" in key:
        return "paged_decode"
    return None


def _profile_quantum(batcher, params, cfg, prompt, tag, names):
    """Fills every row of `batcher` (requests of the serving prompt length),
    then runs one quantum of its selected kind (frozen or stepwise) on its
    state under torch.profiler: (wall ms/step, device busy ms/step, [ms/step
    of each of `names`: a paged kernel's name (_paged_kernel) or a part of a
    kernel's name], device launches/step), or None when the profiler saw no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tinygpt_tpu_torch.engine.scheduler import Request

    s = SERVE
    for i in range(s["capacity"]):
        batcher.add_request(Request(request_id=1000 + i, prompt_ids=prompt(s["prompt_len"]),
                                    max_new_tokens=s["profile_new"]))
    while batcher.waiting or batcher.n_running < s["capacity"]:
        batcher.step()
    batcher._drain_inflight()
    Q = s["quantum"]
    batcher._ensure_blocks(Q)
    batcher._sync_state_meta()
    tok = torch.tensor(batcher._tokens, device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        batcher._decode_fn(params, cfg, batcher.state, tok, batcher._sampler_params_dev(),
                           batcher._gen, n_steps=Q, all_greedy=True, attn_impl="kernel")
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(us for us, _, _ in kernels)
    if not busy:
        log(f"{tag} one quantum: device time not measured (the profiler saw no device "
            f"activity)")
        return None
    k_us = [sum(us for us, _, key in kernels
                if (_paged_kernel(key) == k if k.startswith("paged_decode") else k in key))
            for k in names]
    for us, count, key in sorted(kernels, reverse=True)[:6]:
        log(f"{tag}   {us / Q / 1e3:8.4f} ms/step  {count // Q:4d} launches/step  {key[:90]}")
    return (wall_us / Q / 1e3, busy / Q / 1e3, [us / Q / 1e3 for us in k_us],
            sum(c for _, c, _ in kernels) // Q)


def phase_gpt2_serve(table: dict, params) -> None:
    """The continuous batcher on GPT-2 124M's bf16 params under the serve
    phase's traffic (capacity 16, block 64, 257 blocks, quantum 8,
    pipelined, prefix cache on; 16 requests of 512 random tokens, 256
    greedy new tokens each, one every 0.25 s): once with the frozen quantum
    (decode_paged_steps, K8) and once with the stepwise one (the namespace
    without decode_paged_steps: forward_paged, K9, 12 launches a step),
    each with exact launch counts and one quantum at 16 live rows under the
    profiler. The two runs' greedy streams are counted equal (bf16: the two
    attention kernels sum in other orders, so a near-tie may part two
    streams); at 12 layers in fp32 they must be identical."""
    from collections import Counter

    import numpy as np
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import gpt2
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    s = SERVE
    cfg = parse_model_config(GPT2_124M)
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    rng = np.random.default_rng(0)

    def prompt(n):
        return [int(x) for x in rng.integers(3, V, n)]

    warm = prompt(s["prompt_len"])
    prompts = [prompt(s["prompt_len"]) for _ in range(s["n_requests"])]
    streams = {}
    with torch.inference_mode():
        for quantum, kname in (("frozen", "paged_decode_frozen"), ("stepwise", "paged_decode")):
            counts = Counter()
            b = _serving_batcher(params, cfg, counts, model=gpt2,
                                 stepwise=quantum == "stepwise")
            _drive(b, [warm], s["warm_new"])
            torch.cuda.synchronize()
            counts.clear()
            ak.reset_launches()                               # this quantum's run
            run = _drive(b, prompts, s["max_new"], s["gap_s"])
            torch.cuda.synchronize()
            launches = dict(ak.LAUNCHES)
            m = _serving_metrics(run)
            steps, adm = counts["steps"], counts["admissions"]
            n_out = sorted(len(v) for v in run["streams"].values())
            log(f"[gpt2_serve] {quantum} quantum: {s['n_requests']} requests of "
                f"{s['prompt_len']} random tokens, {s['max_new']} new each, one every "
                f"{s['gap_s']} s: TTFT p50 {m['ttft_p50_s']:.4f} s p95 {m['ttft_p95_s']:.4f} s; "
                f"{run['toks']} tokens in {m['wall_s']:.3f} s = {m['tok_s']:.2f} tok/s whole "
                f"run, {m['steady_tok_s']:.2f} tok/s steady; {steps} decode steps, {adm} "
                f"admissions")
            if n_out != [s["max_new"]] * s["n_requests"]:
                raise PhaseError(f"gpt2_serve {quantum}: tokens per request {n_out}")
            want = {kname: L * steps, "flash_prefill": L * adm}
            log(f"[gpt2_serve] {quantum} launches {launches} (want {want}: per decode step "
                f"{L} of {kname}; per admission K1 {L})")
            if adm != s["n_requests"] or launches != want:
                raise PhaseError(f"gpt2_serve {quantum}: launches {launches} != {want}")
            if quantum == "stepwise":
                table["paged_decode"]["launches"] = launches["paged_decode"]
            streams[quantum] = run["streams"]
            prof = _profile_quantum(b, params, cfg, prompt, "[gpt2_serve]", (kname,))
            if prof:
                wall, busy, (k_ms,), n_launch = prof
                log(f"[gpt2_serve] {quantum} quantum of {s['quantum']} steps at "
                    f"{s['capacity']} live rows under the profiler: wall {wall:.3f} ms/step, "
                    f"device busy {busy:.3f} ms/step ({100 * busy / wall:.1f}% busy), "
                    f"{n_launch} device launches/step, {kname} {k_ms:.4f} ms/step")
            del b
            torch.cuda.empty_cache()
        same = sum(streams["frozen"][i] == streams["stepwise"][i] for i in streams["frozen"])
        log(f"[gpt2_serve] bf16: greedy streams of the frozen and the stepwise quantum "
            f"identical in {same} of {s['n_requests']} requests (K8 and K9 sum in other "
            f"orders, so a near-tie may part two streams)")

        # 12 layers in fp32: the two quanta's streams must be identical
        p32 = gpt2.init_params(cfg, seed=0, dtype=torch.float32, device=DEVICE)
        f = GPT2_FP32_SERVE
        short = [prompt(s["prompt_len"] * k // 8) for k in (8, 5, 1, 3, 6, 2)][: f["n_requests"]]
        got = {}
        for quantum in ("frozen", "stepwise"):
            b = _serving_batcher(p32, cfg, Counter(), dtype="float32", model=gpt2,
                                 stepwise=quantum == "stepwise")
            got[quantum] = _drive(b, short, f["max_new"])["streams"]
            del b
        same = sum(got["frozen"][i] == got["stepwise"][i] for i in got["frozen"])
        log(f"[gpt2_serve] fp32, {L} layers: greedy streams of {len(short)} requests "
            f"({f['max_new']} new each) identical on the frozen and stepwise quanta in "
            f"{same} of {len(short)}")
        if same != len(short) or sorted(map(len, got["frozen"].values())) != [
                f["max_new"]] * len(short):
            raise PhaseError(f"gpt2_serve fp32: streams differ: {got}")
        del p32
    torch.cuda.empty_cache()


def _write_gpt2_dir(d: str) -> None:
    """A GPT-2 124M-width model dir, 2 layers, random bf16 weights under HF
    names and the generated Metaspace-BPE tokenizer (which covers the first
    36,858 ids; an id past it decodes to nothing)."""
    import torch

    from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

    write_random_model_dir(d, dict(GPT2_124M, n_layer=2), seed=3, dtype=torch.bfloat16,
                           device=DEVICE)


def phase_gpt2_engine(d: str) -> None:
    """GPTEngine on the GPT-2 dir `d` in bf16 (generate_sync of 4 prompts,
    K1 and K2), then batch-1 n-gram speculation against the chunked loop."""
    import torch

    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    max_tokens = 32
    prompts = ["The meaning of life is", "Once upon a time,",
               "In a shocking finding, scientists discovered",
               "The best way to learn programming is"]
    t0 = time.perf_counter()
    eng = GPTEngine(GPTConfig(model_dir=d, max_tokens=max_tokens, device=DEVICE))
    eng.prepare()
    t_load = time.perf_counter() - t0
    ak.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate_sync(prompts)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    launches = dict(ak.LAUNCHES)
    del eng
    n = [len(o.token_ids) for o in outs]
    log(f"[gpt2_engine] GPT-2 width, 2 layers, bf16: prepare() {t_load:.1f} s; generate_sync of "
        f"{len(prompts)} prompts: {sum(n)} tokens in {t_gen * 1e3:.0f} ms; launches {launches}")
    if n != [max_tokens] * len(prompts) or not (launches.get("flash_prefill")
                                                and launches.get("flash_decode_frozen")):
        raise PhaseError(f"gpt2 engine: {n} tokens, launches {launches}")
    _engine_spec(d)


# -- mixtral: the gathered-expert kernels (K12, K11a, K11b) and the MoE paths ---------


MOE_NAMES = {None: "moe_gather_matmul", 8: "moe_gather_matmul_int8",
             4: "moe_gather_matmul_int4"}


def _moe_stacks(bits, L, seed):
    """Random Mixtral-8x7B expert stacks on the card, L layers: gate_up [L,
    8, 4096, 28672] and down [L, 8, 14336, 4096] in bf16 (bits None), or
    quantized at MOE_GROUP (QuantizedTensor)."""
    import torch

    from tinygpt_tpu_torch.ops.quant import _quantize_moe_stacked

    c = MIXTRAL_8X7B
    H, I, E = c["hidden_size"], c["intermediate_size"], c["num_local_experts"]
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    out = {}
    for key, (IN, OUT) in (("gate_up", (H, 2 * I)), ("down", (I, H))):
        w = torch.empty((L, E, IN, OUT), dtype=torch.bfloat16, device=DEVICE)
        for l in range(L):
            for e in range(E):
                w[l, e] = torch.randn((IN, OUT), generator=g, device=DEVICE) * 0.02
        out[key] = w if bits is None else _quantize_moe_stacked(w, bits, MOE_GROUP)
        del w
    return out


def _moe_args(w):
    """The weight arguments of a gathered kernel for a stack: (w,) or
    (data, scales), and the trailing group argument."""
    if hasattr(w, "bits"):
        return (w.data, w.scales), (w.group_size,)
    return (w,), ()


def _moe_cost(w, l, idx, x, OUT):
    """(bytes, operations) of one gathered call: x read and out written
    once, and each DISTINCT expert that idx names read once (its data and
    scales of layer l)."""
    wargs, _ = _moe_args(w)
    per_expert = sum(t[l, 0].numel() * t.element_size() for t in wargs)
    n_e = len(set(idx.tolist()))
    R, IN = x.shape
    return (_nbytes(x) + R * OUT * x.element_size() + n_e * per_expert,
            2.0 * R * IN * OUT)


def _moe_library(x, w, l, idx, OUT):
    """torch.bmm over W[l][idx], gathered (and dequantized) to bf16 before
    the timed call: (ms, why). None where the gathered weights would take
    more than 16 GB."""
    import torch

    from tinygpt_tpu_torch.ops.quant import QuantizedTensor, dequantize

    R, IN = x.shape
    if R * IN * OUT * 2 > 16e9:
        return None, f"not measured: the gathered bf16 weights would take " \
                     f"{R * IN * OUT * 2 / 1e9:.1f} GB"
    ids = idx.long()
    if isinstance(w, QuantizedTensor):
        wg = dequantize(QuantizedTensor(w.data[l][ids], w.scales[l][ids], w.bits,
                                        w.group_size, w.in_dim), torch.bfloat16)
    else:
        wg = w[l][ids]
    xb = x[:, None, :]
    call = lambda: torch.bmm(xb, wg)[:, 0]  # noqa: E731
    t = cuda_time_ms(call, iters=5, warmup=1)
    b = bound_ms(_nbytes(wg, x) + R * OUT * 2, 2.0 * R * IN * OUT, "bfloat16")[0]
    why = "torch.bmm on the gathered bf16 weights"
    if t < b:   # the profiler can lose cuBLAS's time (PERF.md): CUDA events instead
        t = _events_ms(call, 5, warmup=1)
        why += " (CUDA events: the profiler's time was below its bf16 bound)"
    del wg
    return t, why


def _moe_split_sweep(key, x, w, l, idx) -> None:
    """A gathered kernel (K12 on a bf16 stack, K11a, K11b) through its C
    entry point at every split of MOE_SWEEP_SPLITS (the plan's powers of
    two, and 6 and 12 beside them) whose rows fit a block
    (tg_moe_gather_plan: its n-tiles of 8 rows a pass and, for K11, the
    blocks an SM, logged beside each time), beside the plan's pick
    (moe_gather_split on the library's plan): the check on the plan, with the passes the plan makes over the expert
    that most rows name. Timed by CUDA events around 10 calls: a call takes
    a tenth of a millisecond or more, far above a launch's host cost, and
    torch.profiler has read single splits 20 % to 30 % below their other
    readings here."""
    import ctypes

    import torch

    from tinygpt_tpu_torch.ops import cuda_build
    from tinygpt_tpu_torch.ops import moe_kernels as mk
    from tinygpt_tpu_torch.ops.attention_kernels import _DTYPE_CODE, _ptr, _sm_count

    src = "moe_gather_matmul.cu"
    bits = getattr(w, "bits", 16)
    plan_fn = cuda_build.function(src, "tg_moe_gather_plan", [ctypes.c_int] * 5 + [ctypes.c_void_p])
    R, in_x = x.shape
    data = w.data if bits != 16 else w
    _, E, rows, OUT = data.shape
    IN = 2 * rows if bits == 4 else rows
    out = torch.empty(R, OUT, dtype=x.dtype, device=x.device)
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    if bits == 16:
        symbol, argtypes = "tg_moe_gather_float", mk._FLOAT_ARGS
        args = lambda split: (_ptr(x), _ptr(w), _ptr(idx), _ptr(out), R, IN, OUT, E, l,  # noqa
                              _DTYPE_CODE[x.dtype], _DTYPE_CODE[w.dtype], split, stream())
    else:
        symbol = "tg_moe_gather_int8" if bits == 8 else "tg_moe_gather_int4"
        argtypes = mk._INT8_ARGS if bits == 8 else mk._INT4_ARGS
        dims = (R, IN) if bits == 8 else (R, in_x, IN)
        few = mk._q_splits(x, E, IN, OUT, bits)[1]   # the launch over experts of few rows
        args = lambda split: (_ptr(x), _ptr(w.data), _ptr(w.scales), _ptr(idx),  # noqa
                              _ptr(out), *dims, OUT, E, w.group_size, l,
                              _DTYPE_CODE[x.dtype], split, few, stream())
    fn = cuda_build.function(src, symbol, argtypes)

    def call(split):
        cuda_build.check(src, fn(*args(split)), symbol)

    def ntiles(split):
        got = (ctypes.c_int * 3)()
        cuda_build.check(src, plan_fn(R, IN, _DTYPE_CODE[x.dtype], bits, split, got),
                         "tg_moe_gather_plan")
        return got[0], got[2]

    times, nts, per_sm = {}, {}, {}
    for split in MOE_SWEEP_SPLITS:
        nt, per_sm[split] = ntiles(split) if split <= -(-rows // 16) else (0, 0)
        if nt:
            nts[split] = nt
            times[split] = _events_ms(lambda: call(split), 10)
    plan = mk.moe_gather_split(R, E, IN, OUT, 1, _sm_count(x.device.index or 0),
                               mk._library_plan, bits)
    best = min(times, key=times.get)
    most = int(torch.bincount(idx.long().clamp(0, E - 1)).max())
    log(f"[moe_kernels] {MOE_NAMES[None if bits == 16 else bits]} split sweep {key} R={R} "
        f"{IN}->{OUT} (at most {most} rows an expert): "
        + ", ".join(f"SK={c} (nt {nts[c]}" + (f", {per_sm[c]} an SM" if per_sm[c] else "")
                    + f") {t:.4f}" for c, t in times.items())
        + f" ms; the plan's SK={plan} {times[plan]:.4f} ({-(-most // (8 * nts[plan]))} "
        f"pass(es) over that expert), the fastest SK={best} ({times[plan] / times[best]:.3f}x)")


def phase_moe_kernels(table: dict) -> None:
    """K12, K11a and K11b against their plain versions on the card at the
    Mixtral-8x7B matrices (gate_up 4096 -> 28672, down 14336 -> 4096) of a
    2-layer stack, called at layer 1: R = 8 (4 tokens x 2 experts), 32 (16
    serving rows) and 160 (a verify of 16 rows x 5 positions) rows, expert
    ids from a seeded generator with repeats and one unused expert, bf16 and
    fp32 activations (QUANT_TOL). Times the bf16 calls (CUDA events) beside
    their bound
    (the bytes of the distinct experts the ids name, x and out), the plain
    version and torch.bmm on the gathered weights, and sweeps each kernel's
    split at every R (_moe_split_sweep), at R = 32 also over an uneven draw
    (12 of the rows on one expert: more than 8, so a pass of fewer than 32
    rows would read that expert twice); the gathered MLP at 4 and 16 tokens
    on each stack, and beside K12 the dense moe_mlp (every expert on every
    token). A table row is the mean of the main path's shape, R = 8
    (gate_up and down alike)."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops import moe_kernels as mk

    cfg = parse_model_config(dict(MIXTRAL_8X7B, num_hidden_layers=MOE_STACK_LAYERS))
    E, H = cfg.num_local_experts, cfg.hidden_size
    kernels = {None: (mk.moe_gather_matmul, mk.moe_gather_matmul_plain),
               8: (mk.moe_gather_matmul_int8, mk.moe_gather_matmul_int8_plain),
               4: (mk.moe_gather_matmul_int4, mk.moe_gather_matmul_int4_plain)}
    l = MOE_STACK_LAYERS - 1
    rows, worst = {}, {}
    for bits in (None, 8, 4):
        name = MOE_NAMES[bits]
        stacks = _moe_stacks(bits, MOE_STACK_LAYERS, seed=21)
        kern, plain = kernels[bits]
        for key, w in stacks.items():
            wargs, extra = _moe_args(w)
            OUT = wargs[0].shape[-1]
            for R in MOE_ROWS:
                g = torch.Generator().manual_seed(R)
                idx = torch.randint(0, E - 1, (R,), generator=g, dtype=torch.int32)
                idx = idx.to(DEVICE)           # expert E - 1 unused, repeats
                IN = wargs[0].shape[2] * (2 if bits == 4 else 1)
                xs = {dt: (torch.randn((R, IN), generator=g) * 0.5).to(dt).to(DEVICE)
                      for dt in (torch.float32, torch.bfloat16)}
                for dt, x in xs.items():
                    got = kern(x, *wargs, l, idx, *extra)
                    want = plain(x, *wargs, l, idx, *extra)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    dname = str(dt).replace("torch.", "")
                    tol = QUANT_TOL[dname] * want.float().abs().max().item()
                    worst[(name, dname)] = max(worst.get((name, dname), 0.0),
                                               err / max(tol, 1e-30))
                    if not (math.isfinite(err) and err <= tol):
                        raise PhaseError(f"{name} {key} R={R} {dname}: max_abs_err {err} "
                                         f"> {tol}")
                x = xs[torch.bfloat16]
                call = lambda: kern(x, *wargs, l, idx, *extra)  # noqa: E731
                # CUDA events around 10 calls: a call takes a tenth of a
                # millisecond or more, far above its host cost, and
                # torch.profiler reads calls on clusters of 8 low (PERF.md)
                t_k = _events_ms(call, 10)
                t_p = cuda_time_ms(lambda: plain(x, *wargs, l, idx, *extra), iters=2,
                                   warmup=1)
                nbytes, ops = _moe_cost(w, l, idx, x, OUT)
                b_ms, b_by = bound_ms(nbytes, ops, "bfloat16")
                t_lib, why = _moe_library(x, w, l, idx, OUT)
                n_e = len(set(idx.tolist()))
                log(f"[moe_kernels] {name} {key} R={R} {IN}->{OUT} ({n_e} distinct experts): "
                    f"max_abs_err {err:.3g} (tol {tol:.3g}) kernel {t_k:.4f} ms plain "
                    f"{t_p:.4f} ms bound {b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.1f} MB) "
                    f"library " + (f"{t_lib:.4f} ms" if t_lib is not None else "-")
                    + f" [{why}]")
                rows.setdefault(name, []).append(
                    (1 if R == MOE_ROWS[0] else 0, t_k, t_p, b_ms, b_by, t_lib, err, tol))
                _moe_split_sweep(key, x, w, l, idx)
                if R == MOE_ROWS[1]:  # uneven routing: 12 rows on expert 0
                    skew = torch.cat([torch.zeros(12, dtype=torch.int32), torch.randint(
                        1, E - 1, (R - 12,), generator=g, dtype=torch.int32)]).to(DEVICE)
                    got = kern(x, *wargs, l, skew, *extra)
                    want = plain(x, *wargs, l, skew, *extra)
                    err = (got.float() - want.float()).abs().max().item()
                    tol = QUANT_TOL["bfloat16"] * want.float().abs().max().item()
                    if not (math.isfinite(err) and err <= tol):
                        raise PhaseError(f"{name} {key} R={R} skewed: max_abs_err {err} > {tol}")
                    _moe_split_sweep(f"{key} skewed", x, w, l, skew)
        # the gathered MLP of 4 and 16 tokens; beside K12, the dense formulation
        gen = torch.Generator(device=DEVICE).manual_seed(3)
        router = (torch.randn((H, E), generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)
        for R in MOE_ROWS[:2]:
            h = torch.randn((R // 2, 1, H), generator=gen, device=DEVICE).to(torch.bfloat16)
            t_gath = cuda_time_ms(lambda: mk.moe_mlp_gathered(
                h, router, stacks["gate_up"], stacks["down"], l, cfg), iters=10)
            dense = ""
            if bits is None:
                lp = {"router_w": router, "moe_gate_up_w": stacks["gate_up"][l],
                      "moe_down_w": stacks["down"][l]}
                t_dense = cuda_time_ms(lambda: causal_lm.moe_mlp(h, lp, cfg, impl="dense"),
                                       iters=5)
                dense = f"dense moe_mlp (every expert on every token) {t_dense:.4f} ms, "
            log(f"[moe_kernels] {name} MLP of {R // 2} tokens (R = {R}): {dense}the gathered "
                f"MLP ({name} twice, routing and the slot sum) {t_gath:.4f} ms")
        del stacks
        torch.cuda.empty_cache()
    for (name, dname), r in sorted(worst.items()):
        log(f"[moe_kernels] {name} {dname}: worst max_abs_err over all cases {r:.3g} of "
            f"its tolerance")
    _mix_rows(table, rows)


def _mixtral_params(cfg, bits, seed=0):
    """Random Mixtral params on the card: bf16 through init_params (bits
    None), else built one layer (and one expert) at a time: each matrix is
    drawn in bf16 from a seeded generator and quantized at MOE_GROUP with
    the port's quantize_weight into preallocated stacks, so that the bf16
    stacks of a full-depth model (90 GB) never exist."""
    import torch

    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops.quant import QuantizedTensor, pad_head_out, quantize_weight

    if bits is None:
        return causal_lm.init_params(cfg, seed=seed, dtype=torch.bfloat16, device=DEVICE)
    L, E, V, H = (cfg.num_hidden_layers, cfg.num_local_experts, cfg.vocab_size,
                  cfg.hidden_size)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=DEVICE) * 0.02).to(torch.bfloat16)

    shapes = causal_lm._layer_shapes(cfg)
    layers = {k: torch.ones((L, *shapes[k]), dtype=torch.bfloat16, device=DEVICE)
              for k in ("input_ln", "post_ln")}
    layers["router_w"] = torch.empty((L, *shapes["router_w"]), dtype=torch.bfloat16,
                                     device=DEVICE)

    def put(key, at, lead, m):
        qt = quantize_weight(m, bits=bits, group_size=MOE_GROUP)
        if key not in layers:
            layers[key] = QuantizedTensor(
                torch.empty(lead + tuple(qt.data.shape), dtype=torch.int8, device=DEVICE),
                torch.empty(lead + tuple(qt.scales.shape), dtype=torch.float32,
                            device=DEVICE), qt.bits, qt.group_size, qt.in_dim)
        layers[key].data[at] = qt.data
        layers[key].scales[at] = qt.scales

    for l in range(L):
        for key in ("qkv_w", "o_w"):
            put(key, l, (L,), w(*shapes[key]))
        layers["router_w"][l] = w(*shapes["router_w"])
        for key in ("moe_gate_up_w", "moe_down_w"):
            for e in range(E):
                put(key, (l, e), (L, E), w(*shapes[key][1:]))
    cos, sin = causal_lm._rope_tables(cfg, DEVICE)
    return {"embed": w(V, H), "layers": layers,
            "final_ln": torch.ones((H,), dtype=torch.bfloat16, device=DEVICE),
            "lm_head": quantize_weight(pad_head_out(w(H, V)), bits=bits,
                                       group_size=MOE_GROUP),
            "rope_cos": cos, "rope_sin": sin}


def _mixtral_step_bytes(params, cfg, T, idx_seen):
    """Bytes a decode step must read, from the run's own routing: every
    weight but the experts' (the lm_head, qkv, o, router, norms), the
    distinct experts each layer's rows were routed to (idx_seen: the
    expert ids of every gathered MLP call, layer by layer, step by step),
    and the K/V cache. Returns (mean bytes a step, the experts' share, the
    mean distinct experts a layer)."""
    from tinygpt_tpu_torch.ops.quant import QuantizedTensor

    L = cfg.num_hidden_layers
    lay = params["layers"]
    moe = ("moe_gate_up_w", "moe_down_w")

    def size(v):
        if isinstance(v, QuantizedTensor):
            return _nbytes(v.data, v.scales)
        return _nbytes(v)

    other = sum(size(v) for k, v in lay.items() if k not in moe) + size(params["lm_head"])
    per_expert = sum(size(lay[k]) for k in moe) // (L * cfg.num_local_experts)
    distinct = [len(set(i.flatten().tolist())) for i in idx_seen]
    steps = len(distinct) // L
    expert_bytes = sum(distinct) * per_expert / steps
    B = idx_seen[0].shape[0]
    kv = 2 * L * B * cfg.num_kv_heads * T * cfg.head_dim * 2
    return other + expert_bytes + kv, expert_bytes, sum(distinct) / len(distinct)


class _Routing:
    """Scaffolding around the MoE routing of a run (ops/moe_kernels.moe_route,
    which the prefill's moe_mlp and every step's gathered MLP call, layer by
    layer): "record" keeps each call's expert ids; "replay" gives each call
    the ids recorded at the same place of another run, with its weights
    renormalized from this run's router probabilities, and counts the
    decisions of real tokens (`valid`: the prefill's [B * S] token
    validity; a pad row's attention differs between the routes by design)
    whose own top-k would have picked other experts. With
    the plain route's routing replayed, the kernel route differs from it
    only by the kernels' arithmetic: a decision that flips at a near-tie of
    the router (bf16 rounds the two routes' activations apart) would
    otherwise send a token through other experts and part the two routes."""

    def __init__(self, mode: str, recorded=None, valid=None):
        self.mode, self.seen, self.valid = mode, [], valid
        self.recorded, self.flips, self.decisions = recorded, 0, 0

    def __enter__(self):
        import torch

        from tinygpt_tpu_torch.models import causal_lm
        from tinygpt_tpu_torch.ops import moe_kernels as mk

        self.real = mk.moe_route

        def route(h2, router_w, k):
            w, idx = self.real(h2, router_w, k)
            if self.mode == "replay":
                want = self.recorded[len(self.seen)]
                same = (want.sort(dim=-1).values == idx.sort(dim=-1).values).all(dim=-1)
                real = (self.valid if same.shape == self.valid.shape
                        else torch.ones_like(same))
                self.flips += int((~same & real).sum())
                self.decisions += int(real.sum())
                probs = torch.softmax(h2.float() @ router_w.float(), dim=-1)
                w = probs.gather(-1, want)
                w, idx = w / w.sum(dim=-1, keepdim=True), want
            self.seen.append(idx)
            return w, idx

        self.patched = (mk, causal_lm)
        for m in self.patched:
            m.moe_route = route
        return self

    def __exit__(self, *exc):
        for m in self.patched:
            m.moe_route = self.real


def _mixtral_want(bits, L, n, prefills=1, attn="flash_decode_frozen"):
    """Launches of `prefills` prefills and n decode steps of a mixtral: K1
    in the prefill; per decode step the attention kernel and two gathered
    matmuls a layer; int4 / int8 add K5b / K5a for qkv and o (prefill and
    decode) and K4 / K3 for the head."""
    want = {"flash_prefill": L * prefills, attn: L * n, MOE_NAMES[bits]: 2 * L * n}
    if bits is not None:
        stacked = "matmul_dequant_int4_stacked" if bits == 4 else "matmul_dequant_int8_stacked"
        head = "matmul_dequant_int4" if bits == 4 else "matmul_dequant_int8"
        want.update({stacked: 2 * L * (prefills + n), head: prefills + n})
    return want


def phase_mixtral(table: dict, bits, key=None, n_check=N_CHUNKS):
    """Mixtral-8x7B at full width on the card, in int4 (bits 4: K11b),
    int8 (8: K11a) or bf16 (None: K12), MIXTRAL_LAYERS deep (with `key`, the
    bench shape BENCH_SHAPES[key] at its own depth, held to
    SHAPE_LOGIT_TOL over n_check chunks, its launches added to the
    table): first the same
    quantization in fp32 at 2 layers (int4, bf16), kernel route against
    plain route within MODEL_LOGIT_TOL["float32"] and identical
    free-running tokens; then the main path: a prefill of 4 left-padded
    prompts and two greedy chunks of 32 steps, the kernel route against the
    plain route on forced tokens with the plain route's routing replayed
    (MIXTRAL_LOGIT_TOL) and, not checked, with each route's own routing;
    exact launch counts, the decode step under the profiler, and the step's
    bound from the run's own routing. Returns the params (the int4 ones
    serve next)."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    label = "bf16" if bits is None else f"int{bits}"
    if key is None:
        tag, shape, name = f"[mixtral{'_bf16' if bits is None else bits}]", MIXTRAL_8X7B, \
            "Mixtral-8x7B"
        depth, tol = MIXTRAL_LAYERS[bits], MIXTRAL_LOGIT_TOL[bits]
    else:
        tag, shape, name = f"[{key}]", BENCH_SHAPES[key], key
        depth, tol = shape["num_hidden_layers"], SHAPE_LOGIT_TOL[key, label]
    mp = main_path_shapes()
    S, T = mp["prefill"]["S"], mp["prefill"]["T"]
    B = len(PROMPT_LENS)
    with torch.inference_mode():
        if bits != 8:
            cfg2 = parse_model_config(dict(shape, num_hidden_layers=2))
            p2 = _mixtral_params(cfg2, bits, seed=1)
            p2 = _to_fp32(p2)
            batch = _left_padded_batch(S, PROMPT_LENS, cfg2.vocab_size, seed=1)
            plain = _run_route(p2, cfg2, batch, T, "plain", n_chunks=1)
            kern = _run_route(p2, cfg2, batch, T, "kernel", force=plain[1], n_chunks=1)
            _check_routes(f"{label} weights, fp32, 2 layers", kern, plain,
                          MODEL_LOGIT_TOL["float32"], tag)
            if not torch.equal(_run_route(p2, cfg2, batch, T, "kernel", n_chunks=1)[1],
                               plain[1]):
                raise PhaseError(f"{tag} fp32, 2 layers: free-running greedy tokens of the "
                                 f"kernel route differ from the plain route's")
            log(f"{tag} {label} weights, fp32, 2 layers: free-running greedy tokens "
                f"identical on both routes")
            del p2
            torch.cuda.empty_cache()

        cfg = parse_model_config(dict(shape, num_hidden_layers=depth))
        L = cfg.num_hidden_layers
        t0 = time.perf_counter()
        params = _mixtral_params(cfg, bits, seed=0)
        torch.cuda.synchronize()
        log(f"{tag} {name}, {L} layers, {label}"
            + ("" if bits is None else f" (group {MOE_GROUP})")
            + f" built on the card in {time.perf_counter() - t0:.1f} s: "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated")
        batch = _left_padded_batch(S, PROMPT_LENS, cfg.vocab_size, seed=1)
        _run_route(params, cfg, batch, T, "kernel", n_chunks=1)      # warm-up
        with _Routing("record") as rec:
            plain = _run_route(params, cfg, batch, T, "plain", n_chunks=n_check)
        with _Routing("replay", rec.seen, valid=batch[2].reshape(-1)) as rep:
            forced = _run_route(params, cfg, batch, T, "kernel", force=plain[1],
                                n_chunks=n_check)
        free = _run_route(params, cfg, batch, T, "kernel", force=plain[1], n_chunks=n_check)
        ak.reset_launches()                                           # the main path's run
        kern = _run_route(params, cfg, batch, T, "kernel")
        launches = dict(ak.LAUNCHES)
        prof = _profile_decode(params, cfg, batch, T, label=label, tag=tag)
    n = N_CHUNKS * DECODE_CHUNK
    want = _mixtral_want(bits, L, n)
    log(f"{tag} launches {launches} (want {want})")
    if launches != want:
        raise PhaseError(f"{tag} kernel launches {launches} != {want}")
    if key is None:
        table[MOE_NAMES[bits]]["launches"] = launches[MOE_NAMES[bits]]
    else:
        _add_launches(table, launches)
    _check_routes(f"{label}, bf16, {L} layers, the plain route's routing replayed", forced,
                  plain, tol, tag)
    err = (free[0] - plain[0]).abs().max().item()
    rel = ((free[0] - plain[0]).norm() / plain[0].norm()).item()
    log(f"{tag} {label}, bf16, {L} layers, each route routing by its own top-k (forced "
        f"tokens): {rep.flips} of {rep.decisions} token decisions of the kernel route would "
        f"pick other experts than the plain route did; logits max_abs_err {err:.4g}, "
        f"relative L2 {rel:.3g} (not a check: a flipped decision changes a token's "
        f"experts)")
    n_tok = plain[1].shape[0]
    same = int((kern[1][:n_tok] == plain[1]).all(dim=0).sum())
    decode_ids = rep.seen[L:]                      # the prefill's L calls come first
    step_bytes, expert_bytes, distinct = _mixtral_step_bytes(params, cfg, T, decode_ids)
    pre_ms, dec_ms = kern[2:]
    log(f"{tag} {label}, {L} layers: free-running greedy tokens of the two routes identical "
        f"over the first {n_tok} positions in {same} of {B} rows")
    log(f"{tag} kernel route: prefill {pre_ms:.2f} ms ({B}x{S} tokens), decode "
        f"{dec_ms:.3f} ms/step, {B * 1e3 / dec_ms:.1f} tok/s at batch {B} (host: "
        f"{host_launch_us():.2f} us a tiny launch); plain route: prefill {plain[2]:.2f} ms, "
        f"decode {plain[3]:.3f} ms/step; {distinct:.2f} distinct experts a layer on this "
        f"run's routing: a step reads {step_bytes / 1e9:.3f} GB (experts "
        f"{expert_bytes / 1e9:.3f}), bound {step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    if prof:
        log(f"{tag} {label}, {L} layers, summary: prefill {pre_ms:.2f} ms, decode "
            f"{dec_ms:.3f} wall ms/step; profiled {prof['wall_ms']:.3f} wall ms/step, "
            f"{prof['busy_ms']:.3f} busy ms/step, {prof['launches']:.0f} launches/step; "
            f"card {CARD}")
    return params


def _to_fp32(params):
    """Float params in fp32 (quantized stacks as they are)."""
    import torch

    def conv(v):
        return v.float() if isinstance(v, torch.Tensor) and v.is_floating_point() else v

    out = {k: conv(v) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: conv(v) for k, v in params["layers"].items()}
    return out


def phase_mixtral_serve(table: dict, params) -> None:
    """The continuous batcher on the full-depth int4 Mixtral params:
    capacity 16, block 64, 257 blocks, quantum 8, pipelined, prefix cache
    on; 8 requests of 512 random tokens, 64 greedy new tokens each, one
    every 0.25 s; once on the frozen quantum (K8 and K11b every step) and
    once on the stepwise one (K9 and K11b): tok/s, TTFT, exact launch
    counts, and one quantum at 16 live rows under the profiler."""
    from collections import Counter

    import numpy as np
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    s, m = SERVE, MIXTRAL_SERVE
    cfg = parse_model_config(dict(MIXTRAL_8X7B, num_hidden_layers=MIXTRAL_LAYERS[4]))
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    rng = np.random.default_rng(0)

    def prompt(n):
        return [int(x) for x in rng.integers(3, V, n)]

    warm = prompt(m["prompt_len"])
    prompts = [prompt(m["prompt_len"]) for _ in range(m["n_requests"])]
    with torch.inference_mode():
        for quantum, kname in (("frozen", "paged_decode_frozen"), ("stepwise", "paged_decode")):
            counts = Counter()
            b = _serving_batcher(params, cfg, counts, stepwise=quantum == "stepwise")
            _drive(b, [warm], s["quantum"])
            torch.cuda.synchronize()
            counts.clear()
            ak.reset_launches()                               # this quantum's run
            run = _drive(b, prompts, m["max_new"], m["gap_s"])
            torch.cuda.synchronize()
            launches = dict(ak.LAUNCHES)
            met = _serving_metrics(run)
            steps, adm = counts["steps"], counts["admissions"]
            n_out = sorted(len(v) for v in run["streams"].values())
            log(f"[mixtral_serve] int4, {quantum} quantum: {m['n_requests']} requests of "
                f"{m['prompt_len']} random tokens, {m['max_new']} new each, one every "
                f"{m['gap_s']} s: TTFT p50 {met['ttft_p50_s']:.4f} s p95 "
                f"{met['ttft_p95_s']:.4f} s; {run['toks']} tokens in {met['wall_s']:.3f} s = "
                f"{met['tok_s']:.2f} tok/s whole run, {met['steady_tok_s']:.2f} tok/s steady; "
                f"{steps} decode steps, {adm} admissions")
            if n_out != [m["max_new"]] * m["n_requests"]:
                raise PhaseError(f"mixtral_serve {quantum}: tokens per request {n_out}")
            want = _mixtral_want(4, L, steps, prefills=adm, attn=kname)
            log(f"[mixtral_serve] {quantum} launches {launches} (want {want})")
            if adm != m["n_requests"] or launches != want:
                raise PhaseError(f"mixtral_serve {quantum}: launches {launches} != {want}")
            prof = _profile_quantum(b, params, cfg, prompt, "[mixtral_serve]",
                                    ("moe_gather", kname))
            if prof:
                wall, busy, (k_ms, a_ms), n_launch = prof
                log(f"[mixtral_serve] {quantum} quantum of {s['quantum']} steps at "
                    f"{s['capacity']} live rows under the profiler: wall {wall:.3f} ms/step, "
                    f"device busy {busy:.3f} ms/step ({100 * busy / wall:.1f}% busy), "
                    f"{n_launch} device launches/step, K11b {k_ms:.4f} ms/step, {kname} "
                    f"{a_ms:.4f} ms/step")
            del b
            torch.cuda.empty_cache()


def _write_mixtral_dir(d: str) -> None:
    """A Mixtral-8x7B-width model dir, 2 layers, random bf16 weights under
    HF names (block_sparse_moe) and the generated Metaspace-BPE tokenizer."""
    import torch

    from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

    t0 = time.perf_counter()
    write_random_model_dir(d, dict(MIXTRAL_8X7B, num_hidden_layers=2), seed=4,
                           dtype=torch.bfloat16, device=DEVICE)
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"[mixtral_engine] model dir {size / 1e9:.2f} GB written in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_mixtral_engine(d: str) -> None:
    """GPTEngine on the mixtral dir `d`: in bf16 (K12) and with
    quantization="int4", which runs AWQ by default (the MoE folds; group
    128) before quantizing (K5b, K4, K11b); then the evaluator with int4
    weights on the kernel route against the plain route."""
    import contextlib
    import io

    import torch

    from tinygpt_tpu_torch import evaluate
    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine, resolve_quant_group
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    max_tokens = 32
    prompts = ["The meaning of life is", "Once upon a time,",
               "In a shocking finding, scientists discovered",
               "The best way to learn programming is"]
    group = resolve_quant_group(4, None, moe=True)
    runs = {"bf16": ({}, ("flash_prefill", "flash_decode_frozen", "moe_gather_matmul")),
            "int4 (AWQ by default, group 128)": (
                dict(quantization="int4"),
                ("flash_prefill", "flash_decode_frozen", "matmul_dequant_int4",
                 "matmul_dequant_int4_stacked", "moe_gather_matmul_int4"))}
    for label, (kw, kernels) in runs.items():
        t0 = time.perf_counter()
        eng = GPTEngine(GPTConfig(model_dir=d, max_tokens=max_tokens, device=DEVICE, **kw))
        eng.prepare()
        t_load = time.perf_counter() - t0
        if kw:
            qt = eng.ctx.params["layers"]["moe_gate_up_w"]
            if (qt.bits, qt.group_size) != (4, group):
                raise PhaseError(f"mixtral engine {label}: experts int{qt.bits} group "
                                 f"{qt.group_size}")
        ak.reset_launches()
        t0 = time.perf_counter()
        outs = eng.generate_sync(prompts)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = dict(ak.LAUNCHES)
        del eng
        torch.cuda.empty_cache()
        n = [len(o.token_ids) for o in outs]
        log(f"[mixtral_engine] {label}: prepare() {t_load:.1f} s; generate_sync of "
            f"{len(prompts)} prompts: {sum(n)} tokens in {t_gen * 1e3:.0f} ms; launches "
            f"{launches}; first output {outs[0].text[:40]!r}")
        missing = [k for k in kernels if not launches.get(k)]
        if n != [max_tokens] * len(prompts) or missing:
            raise PhaseError(f"mixtral engine {label}: {n} tokens, {missing} never launched")

    path = os.path.join(d, "eval.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(EVAL_TEXT)
    ppl = {}
    for impl in ("kernel", "plain"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = evaluate.main(["--model", d, "--text", path, "--window", "512",
                                "--stride", "256", "--max-tokens", "1024", "--device",
                                DEVICE, "--quantization", "int4", "--no-awq", "--impl",
                                impl])
        mt = re.search(r"perplexity: ([0-9.]+) over (\d+) tokens", out.getvalue())
        if rc != 0 or mt is None:
            raise PhaseError(f"mixtral evaluate {impl}: rc {rc}, {out.getvalue()!r}")
        ppl[impl] = float(mt.group(1))
    rel = abs(ppl["kernel"] - ppl["plain"]) / ppl["plain"]
    log(f"[mixtral_engine] evaluator, int4: perplexity {ppl['kernel']:.4f} (kernel route), "
        f"{ppl['plain']:.4f} (plain), relative difference {rel:.3g} (tol {EVAL_PPL_RTOL})")
    if not rel <= EVAL_PPL_RTOL:
        raise PhaseError(f"mixtral evaluate: perplexities {ppl} differ by {rel}")


def _write_model_dir(d: str) -> None:
    """A model dir of Mistral-7B widths, 2 layers, random bf16 weights and
    the generated Metaspace-BPE tokenizer (the engine and server phases)."""
    import torch

    from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

    t0 = time.perf_counter()
    write_random_model_dir(d, dict(MISTRAL_7B, num_hidden_layers=2), seed=2,
                           dtype=torch.bfloat16, device=DEVICE)
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"[engine] model dir {size / 1e9:.2f} GB written in "
        f"{time.perf_counter() - t0:.1f} s")


def phase_engine(d: str) -> None:
    """GPTEngine on the model dir `d`: in bf16; quantized to int4 with
    awq=False; to int8; to int4 by default, which runs AWQ (calibrating on
    the built-in corpus through the dir's generated tokenizer) before
    quantizing; and over an fp8 KV cache. Then batch-1 n-gram speculation
    against the chunked loop on one prompt, and the batcher on fp8 pools."""
    import torch

    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    max_tokens = 32
    prompts = ["The meaning of life is", "Once upon a time,",
               "In a shocking finding, scientists discovered",
               "The best way to learn programming is"]
    int4 = ("flash_prefill", "flash_decode_frozen", "matmul_dequant_int4",
            "matmul_dequant_int4_stacked", "matmul_dequant_int4_stacked_fused",
            "mlp_fused_int4_stacked")
    runs = {"bf16": ({}, ("flash_prefill", "flash_decode_frozen")),
            "int4": (dict(quantization="int4", awq=False), int4),
            "int8": (dict(quantization="int8"),
                     ("flash_prefill", "flash_decode_frozen", "matmul_dequant_int8",
                      "matmul_dequant_int8_stacked")),
            "int4 (AWQ by default)": (dict(quantization="int4"), int4),
            "bf16, fp8 KV": (dict(kv_cache_dtype="fp8"),
                             ("flash_prefill", "flash_decode_frozen"))}
    for label, (kw, kernels) in runs.items():
        t0 = time.perf_counter()
        eng = GPTEngine(GPTConfig(model_dir=d, max_tokens=max_tokens, device=DEVICE,
                                  **kw))
        eng.prepare()
        t_load = time.perf_counter() - t0
        ak.reset_launches()
        t0 = time.perf_counter()
        outs = eng.generate_sync(prompts)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        launches = dict(ak.LAUNCHES)
        if label == "bf16":
            _engine_trace(eng, prompts)
        del eng
        torch.cuda.empty_cache()
        n = [len(o.token_ids) for o in outs]
        log(f"[engine] {label}: prepare() {t_load:.1f} s; generate_sync of "
            f"{len(prompts)} prompts: {sum(n)} tokens in {t_gen * 1e3:.0f} ms; "
            f"launches {launches}")
        log(f"[engine] {label}: first output: {outs[0].text[:60]!r}")
        if n != [max_tokens] * len(prompts):
            raise PhaseError(f"{label} engine produced {n} tokens, want "
                             f"{max_tokens} per prompt")
        missing = [k for k in kernels if not launches.get(k)]
        if missing:
            raise PhaseError(f"{label} engine run launched {launches}: {missing} "
                             f"never launched")
    _engine_spec(d)
    _engine_fp8_batcher(d)


def _engine_trace(eng, prompts) -> None:
    """One more generate_sync of `prompts` inside utils/profiler.trace, into
    a temporary directory under _build/: the trace file must hold the
    annotation span and launches of the port's kernels (K1, the prefill;
    K2, the decode chunks)."""
    from tinygpt_tpu_torch.ops import cuda_build
    from tinygpt_tpu_torch.utils import profiler

    d = tempfile.mkdtemp(prefix="smoke_trace_", dir=cuda_build.BUILD_DIR)
    try:
        t0 = time.perf_counter()
        with profiler.trace(d, annotate="engine.generate_sync") as t:
            eng.generate_sync(prompts)
        wall = time.perf_counter() - t0
        path = t.get("path")
        if not path or not os.path.exists(path):
            raise PhaseError(f"engine: profiler.trace wrote no file under {d}")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        names = [e.get("name", "") for e in events]
        kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
        k1 = sum("flash_prefill" in n for n in kernels)
        k2 = sum(bool(re.search(r"split_decode_kernel<.*,\s*(true|\(bool\)1)>", n))
                 for n in kernels)
        log(f"[engine] profiler.trace of one generate_sync ({wall:.2f} s with the trace "
            f"written): {os.path.getsize(path) / 1e6:.2f} MB, {len(events)} events, "
            f"{len(kernels)} kernel launches on the card: K1 {k1}, K2 {k2}; annotation "
            f"span {'present' if 'engine.generate_sync' in names else 'MISSING'}")
        if "engine.generate_sync" not in names or not (k1 or k2):
            raise PhaseError(f"engine: the trace lacks the annotation span or a port "
                             f"kernel (K1 {k1}, K2 {k2})")
    finally:
        shutil.rmtree(d, ignore_errors=True)


ENGINE_SPEC_PROMPT = ("def add(a, b):\n    return a + b\n\ndef sub(a, b):\n    return a - b\n"
                      "\ndef mul(a, b):\n    return a * b\n\ndef div(a, b):\n    return")


def _engine_spec(d: str) -> None:
    """Batch-1 speculative="ngram" on the model dir: its rounds (each a
    5-token verify through K1 at the round's first slot, and one read of
    the round's accepted count on the host), the tokens against the
    chunked loop's, and what a read costs: the device-to-host round trip
    of a few int32 on an idle card."""
    import torch

    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    max_tokens = 64
    outs, secs = {}, {}
    rounds = []
    real = causal_lm.spec_accept

    def counting(*a, **kw):
        rounds.append(1)
        return real(*a, **kw)

    causal_lm.spec_accept = counting
    try:
        for mode in ("ngram", None):
            eng = GPTEngine(GPTConfig(model_dir=d, max_tokens=max_tokens, device=DEVICE,
                                      speculative=mode))
            eng.prepare()
            eng.generate_sync([ENGINE_SPEC_PROMPT])             # warm-up
            rounds.clear()
            ak.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[mode] = eng.generate_sync([ENGINE_SPEC_PROMPT])[0].token_ids
            torch.cuda.synchronize()
            secs[mode] = time.perf_counter() - t0
            if mode:
                n_rounds, launches = len(rounds), dict(ak.LAUNCHES)
            del eng
    finally:
        causal_lm.spec_accept = real
    x = torch.zeros(6, dtype=torch.int32, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        x.cpu()
    read_ms = (time.perf_counter() - t0) / 200 * 1e3
    same = sum(a == b for a, b in zip(outs["ngram"], outs[None]))
    log(f"[engine] batch-1 speculative=ngram: {len(outs['ngram'])} tokens in {n_rounds} "
        f"verify rounds ({len(outs['ngram']) / max(n_rounds, 1):.2f} tokens a round), "
        f"{secs['ngram'] * 1e3:.0f} ms ({secs['ngram'] * 1e3 / max(n_rounds, 1):.3f} ms a "
        f"round, one host read each); the chunked loop {secs[None] * 1e3:.0f} ms "
        f"({secs[None] * 1e3 / max_tokens:.3f} ms a token); the read's device-to-host "
        f"round trip on an idle card {read_ms:.4f} ms; tokens equal to the chunked loop's "
        f"at {same} of {max_tokens} positions; launches {launches}")
    if len(outs["ngram"]) != max_tokens or launches.get("flash_prefill", 0) <= 1:
        raise PhaseError(f"speculative engine: {len(outs['ngram'])} tokens, launches "
                         f"{launches}")


def _engine_fp8_batcher(d: str) -> None:
    """The continuous batcher over fp8 (e4m3) pools on the model dir's bf16
    params: K1 on an e4m3 dense cache at each admission, K8 on e4m3 pools
    in every decode step."""
    import torch

    from tinygpt_tpu_torch.engine.scheduler import ContinuousBatcher, Request, SchedulerConfig
    from tinygpt_tpu_torch.hf.loader import load_model_dir
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    ctx = load_model_dir(d, dtype="bfloat16", device=DEVICE)
    b = ContinuousBatcher(ctx.model, ctx.model_config, ctx.params, eos_ids=set(),
                          config=SchedulerConfig(batch_capacity=4, n_blocks=64,
                                                 max_blocks_per_seq=16, kv_cache_dtype="fp8"))
    toks = [ctx.tokenizer.encode(p) for p in ("Once upon a time,", ENGINE_SPEC_PROMPT)]
    ak.reset_launches()
    for i, t in enumerate(toks * 3):
        b.add_request(Request(request_id=i, prompt_ids=t, max_new_tokens=24))
    got = {}
    while b.has_work:
        for ev in b.step():
            if ev.token_id is not None:
                got[ev.request_id] = got.get(ev.request_id, 0) + 1
    torch.cuda.synchronize()
    launches = dict(ak.LAUNCHES)
    log(f"[engine] batcher on fp8 pools ({b.state.k_pool.dtype}): {sum(got.values())} "
        f"tokens for {len(got)} requests; launches {launches}")
    if (b.state.k_pool.dtype != E4M3 or sorted(got.values()) != [24] * 6
            or not (launches.get("paged_decode_frozen") and launches.get("flash_prefill"))):
        raise PhaseError(f"fp8 batcher: {got}, launches {launches}")


# kernel route against plain route of the evaluator (relative, on the
# perplexity): both run the same bf16 model and differ only where a kernel
# sums in another order than its plain version (attention; the int8
# matmuls), which moves each token's log-probability by bf16 noise
EVAL_PPL_RTOL = 5e-3
# the fp8 KV cache against the bf16 one (relative, on the perplexity): e4m3
# keeps 3 mantissa bits of each K/V element, which moves each token's
# log-probability by far more than summation order does
EVAL_FP8_RTOL = 2e-2
EVAL_TEXT = " ".join(
    f"Line {i}: the {w} of {i * 7 % 101} reports went to {c} on day {i % 28 + 1}."
    for i, (w, c) in enumerate(zip(["review", "summary", "audit", "draft"] * 30,
                                   ["Paris", "Oslo", "Lima", "Quito", "Accra"] * 24)))


def phase_evaluate(d: str) -> None:
    """python -m tinygpt_tpu_torch.evaluate on the model dir `d` over a text
    the script writes (1,024 tokens, windows of 512 advanced by 256), in
    bf16 and with int8 weights, on the kernel route and on the plain route:
    the two perplexities must agree within EVAL_PPL_RTOL."""
    import contextlib
    import io

    from tinygpt_tpu_torch import evaluate
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    path = os.path.join(d, "eval.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(EVAL_TEXT)
    base = ["--model", d, "--text", path, "--dtype", "bfloat16", "--window", "512",
            "--stride", "256", "--max-tokens", "1024", "--device", DEVICE]
    runs = {"bf16": ([], ("flash_prefill",)),
            "int8": (["--quantization", "int8"],
                     ("flash_prefill", "matmul_dequant_int8_stacked", "matmul_dequant_int8")),
            "fp8 KV": (["--kv-cache-dtype", "fp8"], ("flash_prefill",))}
    by_label = {}
    for label, (extra, kernels) in runs.items():
        ppl = {}
        for impl in ("kernel", "plain"):
            out = io.StringIO()
            ak.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                rc = evaluate.main(base + extra + ["--impl", impl])
            dt = time.perf_counter() - t0
            launches = dict(ak.LAUNCHES)
            m = re.search(r"perplexity: ([0-9.]+) over (\d+) tokens", out.getvalue())
            if rc != 0 or m is None:
                raise PhaseError(f"evaluate {label} {impl}: rc {rc}, {out.getvalue()!r}")
            ppl[impl] = float(m.group(1))
            log(f"[evaluate] {label}, {impl} route: perplexity {ppl[impl]:.4f} over "
                f"{m.group(2)} tokens in {dt:.2f} s (load included); launches {launches}")
            missing = [k for k in kernels if not launches.get(k)]
            if (impl == "kernel" and missing) or (impl == "plain" and launches):
                raise PhaseError(f"evaluate {label} {impl}: launches {launches}")
        rel = abs(ppl["kernel"] - ppl["plain"]) / ppl["plain"]
        log(f"[evaluate] {label}: kernel vs plain route, relative difference {rel:.3g} "
            f"(tol {EVAL_PPL_RTOL})")
        if not rel <= EVAL_PPL_RTOL:
            raise PhaseError(f"evaluate {label}: perplexities {ppl} differ by {rel}")
        by_label[label] = ppl["kernel"]
    rel = abs(by_label["fp8 KV"] - by_label["bf16"]) / by_label["bf16"]
    log(f"[evaluate] fp8 KV against the bf16 cache (kernel route): relative difference "
        f"{rel:.3g} (tol {EVAL_FP8_RTOL})")
    if not rel <= EVAL_FP8_RTOL:
        raise PhaseError(f"evaluate: the fp8 KV cache moves the perplexity by {rel}")


def _check_native_host_cores(srv, d: str, scheduler: str, prompts) -> None:
    """The server's tokenizer runs on the native encoder and gives the
    Python pipeline's ids on `prompts` (the texts the phase sends); its
    batcher, when it has one, runs on the native pool index."""
    from tinygpt_tpu_torch.tokenizer import Tokenizer

    tok = srv.engine.ctx.tokenizer
    enc = tok.native_encoder
    if enc is None:
        raise PhaseError(f"server ({scheduler}): the tokenizer runs without its native "
                         f"encoder")
    os.environ["TINYGPT_NO_NATIVE"] = "1"
    try:
        py = Tokenizer.from_dir(d)
        if py.native_encoder is not None:
            raise PhaseError("server: TINYGPT_NO_NATIVE left the native encoder on")
    finally:
        del os.environ["TINYGPT_NO_NATIVE"]
    got = [tok.encode(p) for p in prompts]
    want = [py.encode(p) for p in prompts]
    batcher = getattr(srv.worker, "batcher", None)
    index = batcher.allocator.kind if batcher is not None else "none (sequential worker)"
    log(f"[server] {scheduler}: native encoder kind {enc.kind} over a vocab of "
        f"{tok.vocab_size}; ids of the {len(prompts)} prompts "
        f"{'equal' if got == want else 'DIFFER from'} the Python pipeline's "
        f"({[len(g) for g in got]} ids); pool index {index}")
    if got != want:
        raise PhaseError(f"server ({scheduler}): native ids {got} != Python ids {want}")
    if batcher is not None and batcher.allocator.kind != "native":
        raise PhaseError(f"server ({scheduler}): the pool index is "
                         f"{batcher.allocator.kind}, not the native one")


def phase_server(d: str, scheduler: str = "continuous") -> None:
    """TinyGPTServer on the model dir `d` (bf16, on the card), in-process on
    127.0.0.1 and a free port, with a chat template passed in: four
    concurrent clients send a completion, a streamed (SSE) completion, a
    chat completion and a health check; every answer must be a 200 with
    text and the usage counts. The server is shut down at the end.
    scheduler="continuous" serves through the continuous batcher (K8 in
    its quanta), "sequential" one request at a time through
    GPTEngine.generate_async (K2 at the default stream_chunk of 8)."""
    import concurrent.futures
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.server.http import ServerConfig, TinyGPTServer, _make_handler
    from tinygpt_tpu_torch.tokenizer.chat_template import CHATML_TEMPLATE

    max_tokens = 16
    t0 = time.perf_counter()
    srv = TinyGPTServer(ServerConfig(model_dir=d, host="127.0.0.1", port=0,
                                     max_tokens=max_tokens, chat_template=CHATML_TEMPLATE,
                                     device=DEVICE, scheduler=scheduler))
    srv.prepare()
    srv._httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(srv))
    url = f"http://127.0.0.1:{srv._httpd.server_address[1]}"
    thread = threading.Thread(target=srv._httpd.serve_forever, daemon=True)
    thread.start()
    log(f"[server] TinyGPTServer ready at {url} in {time.perf_counter() - t0:.1f} s")
    chat_messages = [{"role": "user", "content": "Hello there"}]
    _check_native_host_cores(srv, d, scheduler, [
        "The meaning of life is", "Once upon a time,",
        srv.engine.apply_chat_template(chat_messages, add_generation_prompt=True)])

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(url + path, data=data,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, resp.headers.get("Content-Type", ""), resp.read().decode()

    def completion():
        st, _, body = call("/v1/completions", {"prompt": "The meaning of life is",
                                               "max_tokens": max_tokens})
        d = json.loads(body)
        return st, d["choices"][0]["text"], d["usage"]

    def completion_sse():
        st, ctype, body = call("/v1/completions", {"prompt": "Once upon a time,",
                                                   "max_tokens": max_tokens,
                                                   "stream": True})
        frames = [f[6:] for f in body.split("\n\n") if f.startswith("data: ")]
        if not ctype.startswith("text/event-stream") or frames[-1] != "[DONE]":
            raise PhaseError(f"server: SSE answer malformed: {body[:200]!r}")
        payloads = [json.loads(f) for f in frames[:-1]]
        text = "".join(p["choices"][0].get("text", "") for p in payloads)
        return st, text, payloads[-1]["usage"]

    def chat():
        st, _, body = call("/v1/chat/completions", {
            "messages": chat_messages, "max_tokens": max_tokens})
        d = json.loads(body)
        return st, d["choices"][0]["message"]["content"], d["usage"]

    def health():
        st, _, body = call("/health")
        return st, json.loads(body)["status"], None

    calls = {"completion": completion, "completion SSE": completion_sse, "chat": chat,
             "health": health}
    try:
        ak.reset_launches()
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(calls)) as ex:
            futs = {name: ex.submit(fn) for name, fn in calls.items()}
            results = {name: f.result() for name, f in futs.items()}
        t_req = time.perf_counter() - t0
        launches = dict(ak.LAUNCHES)
    finally:
        srv._httpd.shutdown()
        srv.worker.stop()
        thread.join(timeout=30)
    for name, (st, text, usage) in results.items():
        log(f"[server] {name}: HTTP {st}, {text[:40]!r}"
            + (f", usage {usage}" if usage else ""))
        if st != 200 or not text:
            raise PhaseError(f"server: {name} answered {st} with {text!r}")
        if usage and not (usage["completion_tokens"] == max_tokens
                          and usage["prompt_tokens"] > 0 and usage["total_tokens"]
                          == usage["prompt_tokens"] + usage["completion_tokens"]):
            raise PhaseError(f"server: {name} usage {usage}")
    log(f"[server] {scheduler}: 4 concurrent requests answered in {t_req:.2f} s; "
        f"worker {type(srv.worker).__name__}; launches {launches}; server shut down "
        f"({'stopped' if not thread.is_alive() else 'STILL RUNNING'})")
    decode = "paged_decode_frozen" if scheduler == "continuous" else "flash_decode_frozen"
    if thread.is_alive() or not (launches.get(decode) and launches.get("flash_prefill")):
        raise PhaseError(f"server ({scheduler}): launches {launches}, thread alive "
                         f"{thread.is_alive()}")


# -- the JAX package's other bench shapes -----------------------------------------


def _dense_want(route, L, n, prefills=1, attn="flash_decode_frozen"):
    """Launches of `prefills` prefills and n decode steps of a dense
    llama-family model: K1 in every prefill and the decode attention
    (`attn`: K2, or the batcher's K8 / K9) L times a step; int4 adds K5b
    (4 L) and K4 (the head) to every prefill and K6 (qkv and o a layer, and
    the head) and K7 to every step (the fused route); int8 adds K5a and K3
    to every prefill and every step (the unfused route)."""
    want = {"flash_prefill": L * prefills, attn: L * n}
    if route == "int4":
        want.update({"matmul_dequant_int4_stacked": 4 * L * prefills,
                     "matmul_dequant_int4": prefills,
                     "matmul_dequant_int4_stacked_fused": (2 * L + 1) * n,
                     "mlp_fused_int4_stacked": L * n})
    elif route == "int8":
        want.update({"matmul_dequant_int8_stacked": 4 * L * (prefills + n),
                     "matmul_dequant_int8": prefills + n})
    return want


def _add_launches(table: dict, launches: dict) -> None:
    """Adds a leg's main-path launches to the kernel table's counts."""
    for name, count in launches.items():
        table[name]["launches"] += count


def _shape_params(cfg, route, dtype=None, seed=0):
    """Random params of a dense bench shape on the card (init_params in
    `dtype`, default bf16), each norm weight (input, post, final; qwen3's q
    and k) drawn as 1 + N(0, 0.1^2) so that a weight read at another head
    or layer shows against the plain route; then quantized on the card
    for route "int8" (group INT8_GROUP) or "int4" (INT4_GROUP). A tied
    head becomes a quantized transposed copy of the embedding
    (ops/quant.quantize_params)."""
    import torch

    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops.quant import quantize_params

    params = causal_lm.init_params(cfg, seed=seed, dtype=dtype or torch.bfloat16,
                                   device=DEVICE)
    g = torch.Generator(device=DEVICE).manual_seed(seed + 100)
    norms = [params["final_ln"]] + [params["layers"][k] for k in
                                     ("input_ln", "post_ln", "q_norm", "k_norm")
                                     if k in params["layers"]]
    for t in norms:
        t.mul_(1 + 0.1 * torch.randn(t.shape, generator=g, device=DEVICE).to(t.dtype))
    if route in ("int8", "int4"):
        bits = int(route[3])
        params = quantize_params(params, bits=bits,
                                 group_size=INT4_GROUP if bits == 4 else INT8_GROUP)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return params


def _param_bytes(params) -> int:
    """Bytes of every layer weight, norm and the head (quantized: data and
    scales; tied: the quantized copy, or the embedding in float): what a
    decode step reads besides the K/V cache."""
    from tinygpt_tpu_torch.ops.quant import QuantizedTensor

    def size(v):
        return _nbytes(v.data, v.scales) if isinstance(v, QuantizedTensor) else _nbytes(v)

    head = params["lm_head"] if params["lm_head"] is not None else params["embed"]
    return (sum(size(v) for v in params["layers"].values()) + size(head)
            + _nbytes(params["final_ln"]))


def _kernel_case(tag, name, kern, plain, cost, tol, iters=20):
    """One kernel at a path's shape against its plain version: max abs
    error within `tol` (a number, or a function of the plain output),
    timed beside the plain version and the bound."""
    import torch

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = tol(want) if callable(tol) else tol
    if not math.isfinite(err) or err > tol:
        raise PhaseError(f"{tag}: {name} differs from its plain version by {err} > {tol}")
    ms, plain_ms = cuda_time_ms(kern, iters), cuda_time_ms(plain, iters)
    b_ms, by = bound_ms(*cost, "bfloat16")
    log(f"{tag}: {name} max_abs_err {err:.4g} (tol {tol:.4g}), {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    del got, want
    torch.cuda.synchronize()


def _shape_kernels(tag, cfg, params) -> None:
    """The kernels of a dense leg's int4 path at its own shapes, against
    their plain versions on the same inputs (bf16, batch 4, the last
    layer): K6 for qkv with the norm prologue and, in its epilogue, a bias
    of N(0, 1) (qwen2) and q / k norm weights of 1 + N(0, 0.5^2) (qwen3)
    before RoPE on the Nq + Nk heads; K6 for o with the residual; K7; K6 for
    the head (tied: the quantized transposed embedding) with the final norm;
    K4 for the prefill's head and K5b for a 4 x 512 prefill's qkv; K1 and
    K2 at the leg's heads. Quantized outputs within QUANT_TOL of the
    largest plain output, attention within TOL. The times are warm: one
    layer called again and again, so a matrix under the 50 MB L2 is read
    from it (only the heads, 132 to 157 MB, are not), by torch.profiler."""
    import torch

    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops import quant_kernels as qk
    from tinygpt_tpu_torch.ops.quant import pad_x_to

    lay, head = params["layers"], params["lm_head"]
    H, D, L = cfg.hidden_size, cfg.head_dim, cfg.num_hidden_layers
    Nq, Nk, M, l = cfg.num_attention_heads, cfg.num_kv_heads, len(PROMPT_LENS), L - 1
    bf = torch.bfloat16
    g = torch.Generator(device=DEVICE).manual_seed(11)

    def rel(want):
        return QUANT_TOL["bfloat16"] * want.float().abs().max().item()

    def cost(qt, at, x, out_cols):
        data, scales = (qt.data[at], qt.scales[at]) if at is not None else (qt.data, qt.scales)
        return (_nbytes(data, scales, x) + x.shape[0] * out_cols * 2,
                2.0 * x.shape[0] * qt.in_dim * out_cols)

    x = torch.randn(M, H, generator=g, device=DEVICE).to(bf)
    inv = torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + cfg.rms_norm_eps)
    pos = torch.tensor(PROMPT_LENS, device=DEVICE)
    qt = lay["qkv_w"]
    kw = dict(ln=lay["input_ln"], invrms=inv, rope_cos=params["rope_cos"][pos],
              rope_sin=params["rope_sin"][pos], rope_heads=Nq + Nk, rope_dim=D)
    what = []
    if "qkv_b" in lay:
        kw["bias"] = torch.randn(L, qt.out_dim, generator=g, device=DEVICE).to(bf)
        what.append("bias")
    if cfg.qk_norm:
        kw.update(qk_norm_w=tuple((1 + 0.5 * torch.randn(L, D, generator=g, device=DEVICE))
                                  .to(bf) for _ in range(2)),
                  qk_heads=Nq, eps=cfg.rms_norm_eps)
        what.append("qk-norm")
    _kernel_case(
        tag, f"K6 qkv {H} -> {qt.out_dim} ({Nq} + 2 x {Nk} heads of {D}, "
        f"{' + '.join(what + ['RoPE'])})", lambda: qk.matmul_dequant_int4_stacked_fused(
            x, qt.data, qt.scales, l, qt.group_size, **kw),
        lambda: qk.matmul_dequant_int4_stacked_fused_plain(
            x, qt.data, qt.scales, l, qt.group_size, **kw), cost(qt, l, x, qt.out_dim), rel)
    a = torch.randn(M, Nq * D, generator=g, device=DEVICE).to(bf)
    qt = lay["o_w"]
    _kernel_case(
        tag, f"K6 o {Nq * D} (rows {qt.in_dim}) -> {H}, residual",
        lambda: qk.matmul_dequant_int4_stacked_fused(a, qt.data, qt.scales, l,
                                                     qt.group_size, res=x),
        lambda: qk.matmul_dequant_int4_stacked_fused_plain(a, qt.data, qt.scales, l,
                                                           qt.group_size, res=x),
        cost(qt, l, a, H), rel)
    gu, dn = lay["gate_up_w"], lay["down_w"]
    mlp = (x, gu.data, gu.scales, dn.data, dn.scales, lay["post_ln"], inv, l, gu.group_size)
    _kernel_case(
        tag, f"K7 MLP {H} -> 2 x {gu.out_dim // 2} -> {H}",
        lambda: qk.mlp_fused_int4_stacked(*mlp), lambda: qk.mlp_fused_int4_stacked_plain(*mlp),
        (cost(gu, l, x, gu.out_dim)[0] + _nbytes(dn.data[l], dn.scales[l]),
         2.0 * M * (gu.in_dim * gu.out_dim + dn.in_dim * H)), rel)
    tied = "tied, " if cfg.tie_word_embeddings else ""
    _kernel_case(
        tag, f"K6 head {H} (rows {head.in_dim}) -> {head.out_dim} ({tied}vocab "
        f"{cfg.vocab_size}), final norm",
        lambda: qk.matmul_dequant_int4_stacked_fused(
            x, head.data[None], head.scales[None], 0, head.group_size,
            ln=params["final_ln"][None], invrms=inv),
        lambda: qk.matmul_dequant_int4_stacked_fused_plain(
            x, head.data[None], head.scales[None], 0, head.group_size,
            ln=params["final_ln"][None], invrms=inv), cost(head, None, x, head.out_dim), rel)
    xp = pad_x_to(x, head.in_dim).contiguous()
    _kernel_case(
        tag, f"K4 head of the prefill, {M} rows",
        lambda: qk.matmul_dequant_int4(xp, head.data, head.scales, head.group_size),
        lambda: qk.matmul_dequant_int4_plain(xp, head.data, head.scales, head.group_size),
        cost(head, None, xp, head.out_dim), rel)
    qt = lay["qkv_w"]
    xs = pad_x_to(torch.randn(M * max(PROMPT_LENS), H, generator=g, device=DEVICE).to(bf),
                  qt.in_dim).contiguous()
    _kernel_case(
        tag, f"K5b qkv of the prefill, {xs.shape[0]} rows",
        lambda: qk.matmul_dequant_int4_stacked(xs, qt.data, qt.scales, l, qt.group_size),
        lambda: qk.matmul_dequant_int4_stacked_plain(xs, qt.data, qt.scales, l, qt.group_size),
        cost(qt, l, xs, qt.out_dim), rel, iters=5)
    del xs
    mp = main_path_shapes()
    tol = lambda _: TOL["bfloat16"]  # noqa: E731
    q, ks, vs, mask, ki, vi, step, window = _decode_case(
        2, M, Nq, Nk, D, mp["decode"]["T"], mp["decode"]["N"], mp["decode"]["pads"],
        mp["decode"]["length"], mp["decode"]["step"], None, bf, seed=3)
    _kernel_case(
        tag, f"K2 decode, {Nq} query over {Nk} KV heads of {D}",
        lambda: ak.flash_decode_frozen(q, ks, vs, mask, ki, vi, 1, step, scale=D ** -0.5),
        lambda: ak.flash_decode_frozen_plain(q, ks, vs, mask, ki, vi, 1, step, scale=D ** -0.5),
        _decode_cost(q, mask, ki, step, window), tol)
    pp = mp["prefill"]
    args = _prefill_case(M, Nq, Nk, D, pp["S"], pp["T"], pp["pads"], 0, None, bf, seed=4)
    _kernel_case(
        tag, f"K1 prefill, {Nq} query over {Nk} KV heads of {D}",
        lambda: ak.flash_prefill(*args), lambda: ak.flash_prefill_plain(*args),
        _prefill_cost(args[0], args[1], args[3], 0, None), tol, iters=5)
    del args
    torch.cuda.empty_cache()


def _dense_route(table, key, cfg, route, batch, T, n_check):
    """One weight format ("bf16", "int8", "int4") of a dense bench shape at
    full depth on the model phase's batch: the kernel route against the
    plain route on forced tokens over n_check chunks (SHAPE_LOGIT_TOL),
    then the main path's run (two greedy chunks of DECODE_CHUNK) with
    exact launch counts added to the table, the decode step under the
    profiler, and prefill and step times beside the step's bound.
    Returns the params."""
    import torch

    from tinygpt_tpu_torch.ops import attention_kernels as ak

    tag = f"[{key}]"
    L, B, S = cfg.num_hidden_layers, len(PROMPT_LENS), max(PROMPT_LENS)
    with torch.inference_mode():
        t0 = time.perf_counter()
        params = _shape_params(cfg, route)
        w_bytes = _param_bytes(params)
        kv_bytes = 2 * L * B * cfg.num_kv_heads * T * cfg.head_dim * 2
        log(f"{tag} {route}, {L} layers: params built on the card in "
            f"{time.perf_counter() - t0:.1f} s, a decode step reads {w_bytes / 1e9:.3f} GB "
            f"of weights and {kv_bytes / 1e9:.3f} GB of K/V")
        if route == "int4":
            _shape_kernels(f"{tag} int4 at the shape", cfg, params)
        _run_route(params, cfg, batch, T, "kernel", n_chunks=1)        # warm-up
        plain = _run_route(params, cfg, batch, T, "plain", n_chunks=n_check)
        forced = _run_route(params, cfg, batch, T, "kernel", force=plain[1],
                            n_chunks=n_check)
        ak.reset_launches()                                             # the main path's run
        kern = _run_route(params, cfg, batch, T, "kernel")
        launches = dict(ak.LAUNCHES)
        prof = _profile_decode(params, cfg, batch, T, label=f"{route}, {L} layers", tag=tag)
    want = _dense_want(route, L, N_CHUNKS * DECODE_CHUNK)
    log(f"{tag} {route} launches {launches} (want {want})")
    if launches != want:
        raise PhaseError(f"{tag} {route}: kernel launches {launches} != {want}")
    _add_launches(table, launches)
    _check_routes(f"{route}, {L} layers", forced, plain, SHAPE_LOGIT_TOL[key, route], tag)
    n_tok = min(kern[1].shape[0], plain[1].shape[0])
    same = int((kern[1][:n_tok] == plain[1][:n_tok]).all(dim=0).sum())
    bound = (w_bytes + kv_bytes) / HBM_BYTES_PER_S * 1e3
    log(f"{tag} {route}, {L} layers, summary: prefill {kern[2]:.2f} ms ({B}x{S} tokens), "
        f"decode {kern[3]:.3f} wall ms/step ({B * 1e3 / kern[3]:.1f} tok/s at batch {B}); "
        f"profiled {prof.get('wall_ms', float('nan')):.3f} wall ms/step, "
        f"{prof.get('busy_ms', float('nan')):.3f} busy ms/step, "
        f"{prof.get('launches', float('nan')):.0f} launches/step; bound of a step "
        f"{bound:.3f} ms; plain route prefill {plain[2]:.2f} ms, decode {plain[3]:.3f} "
        f"ms/step; free-running greedy tokens equal to the plain route's over the checked "
        f"positions in {same} of {B} rows; card {CARD}")
    torch.cuda.empty_cache()
    return params


def _fp32_check(key, cfg_dict, routes) -> None:
    """A dense bench shape at 4 layers in fp32, each of `routes` (float
    weights, or int4 / int8 of fp32 params): kernel route against plain
    route within MODEL_LOGIT_TOL["float32"] (summation order only), and
    identical free-running greedy tokens."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config

    tag = f"[{key}]"
    mp = main_path_shapes()
    S, T = mp["prefill"]["S"], mp["prefill"]["T"]
    cfg = parse_model_config(dict(cfg_dict, num_hidden_layers=4))
    batch = _left_padded_batch(S, PROMPT_LENS, cfg.vocab_size, seed=1)
    with torch.inference_mode():
        for route in routes:
            params = _shape_params(cfg, route, dtype=torch.float32)
            plain = _run_route(params, cfg, batch, T, "plain")
            kern = _run_route(params, cfg, batch, T, "kernel", force=plain[1])
            _check_routes(f"{route} weights, fp32, 4 layers", kern, plain,
                          MODEL_LOGIT_TOL["float32"], tag)
            if not torch.equal(_run_route(params, cfg, batch, T, "kernel")[1], plain[1]):
                raise PhaseError(f"{tag} {route}, fp32, 4 layers: free-running greedy tokens "
                                 f"of the kernel route differ from the plain route's")
            log(f"{tag} {route} weights, fp32, 4 layers: free-running greedy tokens "
                f"identical on both routes")
            del params
    torch.cuda.empty_cache()


def phase_dense_shape(table: dict, key: str, routes, fp32_routes=(),
                      n_check=SHAPE_CHECK_CHUNKS, keep=None):
    """A dense bench shape (BENCH_SHAPES[key]) at full width and depth: the
    fp32 checks at 4 layers (_fp32_check, `fp32_routes`), then each weight
    format of `routes` (_dense_route). Returns the params of route `keep`
    (the serving legs run on them), else None."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config

    if fp32_routes:
        _fp32_check(key, BENCH_SHAPES[key], fp32_routes)
    cfg = parse_model_config(BENCH_SHAPES[key])
    mp = main_path_shapes()
    S, T = mp["prefill"]["S"], mp["prefill"]["T"]
    batch = _left_padded_batch(S, PROMPT_LENS, cfg.vocab_size, seed=1)
    kept = None
    for route in routes:
        params = _dense_route(table, key, cfg, route, batch, T, n_check)
        if route == keep:
            kept = params
        del params
        torch.cuda.empty_cache()
    return kept


def phase_llama32(table: dict) -> None:
    """Llama-3.2-1B (bf16 and int4) and Llama-3.2-3B (int4), full depth."""
    phase_dense_shape(table, "llama32_1b", ("bf16", "int4"))
    phase_dense_shape(table, "llama32_3b", ("int4",))


def phase_shape_serve(table: dict, key: str, params, traffic: dict, quanta) -> None:
    """The continuous batcher (the serve phase's scheduler: capacity 16,
    block 64, quantum 8, prefix cache) on a dense bench shape's int4
    params: `traffic` (n_requests of prompt_len random tokens, max_new
    greedy new tokens each, one every gap_s seconds) on each quantum of
    `quanta` ("frozen": K8, decode_paged_steps; "stepwise": K9,
    forward_paged), after a warm-up request: TTFT p50 and p95, whole-run
    and steady tok/s, exact launch counts added to the table, and one
    quantum at 16 live rows under the profiler."""
    from collections import Counter

    import numpy as np
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    s, m, tag = SERVE, traffic, f"[{key}_serve]"
    cfg = parse_model_config(BENCH_SHAPES[key])
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    rng = np.random.default_rng(0)

    def prompt(n):
        return [int(x) for x in rng.integers(3, V, n)]

    warm = prompt(m["prompt_len"])
    prompts = [prompt(m["prompt_len"]) for _ in range(m["n_requests"])]
    with torch.inference_mode():
        for quantum in quanta:
            kname = "paged_decode_frozen" if quantum == "frozen" else "paged_decode"
            counts = Counter()
            b = _serving_batcher(params, cfg, counts, stepwise=quantum == "stepwise")
            if b.allocator.kind != "native":
                raise PhaseError(f"{tag}: the batcher's pool index is {b.allocator.kind}")
            _drive(b, [warm], s["warm_new"])
            torch.cuda.synchronize()
            counts.clear()
            ak.reset_launches()                               # this quantum's run
            run = _drive(b, prompts, m["max_new"], m["gap_s"])
            torch.cuda.synchronize()
            launches = dict(ak.LAUNCHES)
            met = _serving_metrics(run)
            steps, adm = counts["steps"], counts["admissions"]
            n_out = sorted(len(v) for v in run["streams"].values())
            log(f"{tag} int4, {quantum} quantum: {m['n_requests']} requests of "
                f"{m['prompt_len']} random tokens, {m['max_new']} new each, one every "
                f"{m['gap_s']} s: TTFT p50 {met['ttft_p50_s']:.4f} s p95 "
                f"{met['ttft_p95_s']:.4f} s; {run['toks']} tokens in {met['wall_s']:.3f} s = "
                f"{met['tok_s']:.2f} tok/s whole run, {met['steady_tok_s']:.2f} tok/s steady; "
                f"{steps} decode steps, {adm} admissions; card {CARD}")
            if n_out != [m["max_new"]] * m["n_requests"]:
                raise PhaseError(f"{tag} {quantum}: tokens per request {n_out}")
            want = _dense_want("int4", L, steps, prefills=adm, attn=kname)
            log(f"{tag} {quantum} launches {launches} (want {want})")
            if adm != m["n_requests"] or launches != want:
                raise PhaseError(f"{tag} {quantum}: launches {launches} != {want}")
            _add_launches(table, launches)
            prof = _profile_quantum(b, params, cfg, prompt, tag, (kname, "int4_gemv_kernel"))
            if prof:
                wall, busy, (a_ms, gemv_ms), n_launch = prof
                log(f"{tag} {quantum} quantum of {s['quantum']} steps at {s['capacity']} live "
                    f"rows under the profiler: wall {wall:.3f} ms/step, device busy "
                    f"{busy:.3f} ms/step ({100 * busy / wall:.1f}% busy), {n_launch} device "
                    f"launches/step; {kname} {a_ms:.4f} ms/step, the int4 GEMV (K6, K7) "
                    f"{gemv_ms:.4f} ms/step")
            del b
            torch.cuda.empty_cache()


def phase_qwen25(table: dict) -> None:
    """Qwen2.5-0.5B in bf16 and int4, full depth, then the batcher on the
    int4 params: MIXTRAL_SERVE's traffic on the frozen and the stepwise
    quantum."""
    params = phase_dense_shape(table, "qwen25_05b", ("bf16", "int4"), keep="int4")
    phase_shape_serve(table, "qwen25_05b", params, MIXTRAL_SERVE, ("frozen", "stepwise"))


def _write_shape_dir(d: str, key: str) -> None:
    """A model dir of a bench shape's widths, 2 layers, random bf16 weights
    under HF names (tied: no lm_head.weight; qwen2's q/k/v biases, qwen3's
    q_norm and k_norm) and the generated Metaspace-BPE tokenizer over the
    whole vocab."""
    import torch

    from tinygpt_tpu_torch.hf.safetensors_io import load_safetensors
    from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

    t0 = time.perf_counter()
    write_random_model_dir(d, dict(BENCH_SHAPES[key], num_hidden_layers=2), seed=6,
                           dtype=torch.bfloat16, device=DEVICE)
    names = set(load_safetensors(os.path.join(d, "model.safetensors")))
    need = {"qwen2": "model.layers.1.self_attn.v_proj.bias",
            "qwen3": "model.layers.1.self_attn.k_norm.weight"}[BENCH_SHAPES[key]["model_type"]]
    if "lm_head.weight" in names or need not in names:
        raise PhaseError(f"[{key}_engine] the dir's weights: lm_head.weight "
                         f"{'present' if 'lm_head.weight' in names else 'absent'}, {need} "
                         f"{'present' if need in names else 'absent'}")
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"[{key}_engine] model dir {size / 1e9:.2f} GB ({len(names)} tensors, tied head, "
        f"{need} among them) written in {time.perf_counter() - t0:.1f} s")


def phase_shape_engine(d: str, key: str) -> None:
    """GPTEngine on a bench shape's 2-layer dir `d` (tied head) in bf16 and
    with quantization="int4", which runs AWQ by default (awq_policy) on the
    model's qkv bias or qk norms before quantizing at group 64: every
    kernel of the route launched, 32 tokens a prompt."""
    import torch

    from tinygpt_tpu_torch.engine import engine as engine_mod
    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops.quant import QuantizedTensor

    tag, max_tokens = f"[{key}_engine]", 32
    prompts = ["The meaning of life is", "Once upon a time,",
               "In a shocking finding, scientists discovered",
               "The best way to learn programming is"]
    real_awq, awq_calls = engine_mod.awq_quantize_params, []

    def awq(*a, **kw):
        awq_calls.append(1)
        return real_awq(*a, **kw)

    runs = {"bf16": ({}, ("flash_prefill", "flash_decode_frozen")),
            "int4 (AWQ by default)": (dict(quantization="int4"), tuple(_dense_want(
                "int4", 1, 1)))}
    engine_mod.awq_quantize_params = awq
    try:
        for label, (kw, kernels) in runs.items():
            t0 = time.perf_counter()
            eng = GPTEngine(GPTConfig(model_dir=d, max_tokens=max_tokens, device=DEVICE, **kw))
            eng.prepare()
            t_load = time.perf_counter() - t0
            head = eng.ctx.params["lm_head"]
            if kw and not (isinstance(head, QuantizedTensor) and head.bits == 4
                           and awq_calls):
                raise PhaseError(f"{tag} {label}: head {head!r}, AWQ calls {len(awq_calls)}")
            ak.reset_launches()
            t0 = time.perf_counter()
            outs = eng.generate_sync(prompts)
            torch.cuda.synchronize()
            t_gen = time.perf_counter() - t0
            launches = dict(ak.LAUNCHES)
            del eng
            torch.cuda.empty_cache()
            n = [len(o.token_ids) for o in outs]
            log(f"{tag} {label}: prepare() {t_load:.1f} s; generate_sync of {len(prompts)} "
                f"prompts: {sum(n)} tokens in {t_gen * 1e3:.0f} ms; launches {launches}; "
                f"first output {outs[0].text[:40]!r}")
            missing = [k for k in kernels if not launches.get(k)]
            if n != [max_tokens] * len(prompts) or missing:
                raise PhaseError(f"{tag} {label}: {n} tokens, {missing} never launched")
    finally:
        engine_mod.awq_quantize_params = real_awq


# -- K13 and streaming ---------------------------------------------------------


def _k13_case(L, B, Nq, Nk, D, T, pads, length, window, dtype, seed):
    """Inputs of flash_decode calls over an [L, ...] stack of one-layer
    caches (a call takes layer l's views): row b holds pads[b] pad slots,
    then real tokens up to slot `length`; the query is the token at slot
    length - 1, its mask valid & causal & window as decode_step folds it."""
    import torch

    from tinygpt_tpu_torch.ops.attention import decode_mask

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dev = DEVICE
    ks = torch.randn(L, B, Nk, T, D, generator=g, device=dev).to(dtype)
    vs = torch.randn(L, B, Nk, T, D, generator=g, device=dev).to(dtype)
    q = torch.randn(B, Nq, D, generator=g, device=dev).to(dtype)
    slots = torch.arange(T, device=dev)[None, :]
    pad = torch.tensor(pads, device=dev)[:, None]
    valid = (slots >= pad) & (slots < length)
    kv_pos = (slots - pad).clamp(min=0)
    mask = decode_mask(kv_pos, valid, (length - 1 - pad).clamp(min=0), window)
    return q, ks, vs, mask.contiguous()


def _k13_cost(q, mask, Nk, kv_size=None):
    """(bytes, flops): q and the output, the visible slots' K and V
    (kv_size bytes an element, default q's), the mask bytes."""
    B, Nq, D = q.shape
    visible = int(mask.sum())
    isz = q.element_size()
    nbytes = 2 * q.numel() * isz + 2 * visible * Nk * D * (kv_size or isz) + mask.numel()
    return nbytes, 4.0 * D * visible * Nq


def _k13_cycle(q, ks, vs, mask):
    """A flash_decode call on the next layer of the stacks at each call, as
    a decode step walks them: the stacks exceed the 50 MB L2 cache, so each
    call reads cold K/V."""
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    layers = iter(range(10 ** 9))

    def call():
        l = next(layers) % ks.shape[0]
        return ak.flash_decode(q, ks[l], vs[l], mask, q.shape[-1] ** -0.5)

    return call


def phase_k13_kernels(table: dict) -> None:
    """flash_decode (K13) against its plain version on the card: the main
    path's shape (the model phase's batch at its last per-token step:
    B = 4, 32/8 heads of 128, T = 576, bf16) timed over the 32 layers'
    caches in turn (cold in L2, as a step reads them) beside its bound, the
    plain version and scaled_dot_product_attention; then fp32, fp16, head
    dim 64, 1, 3, 4 and 16 query heads per KV head, windows, a row that sees
    no slot, and the e4m3 branch at the main path's shape; then the
    stream's batch 1 beside K2 over the same slots, and K13's time against
    the cache's length at the same visible slots."""
    import torch

    from tinygpt_tpu_torch.engine.kv_cache import kv_cast
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    mp = main_path_shapes()["decode"]
    B = len(PROMPT_LENS)
    # (label, L, Nq, Nk, D, T, pads, length, window, dtype, is_main_path)
    cases = [
        ("main path", 32, 32, 8, 128, mp["T"], mp["pads"], mp["T"], None, torch.bfloat16,
         True),
        ("T1024 w300", 2, 32, 8, 128, 1024, (0, 37, 211, 600), 900, 300, torch.bfloat16,
         False),
        ("T1024 w300", 2, 32, 8, 128, 1024, (0, 37, 211, 600), 900, 300, torch.float32,
         False),
        ("T700 G=4", 2, 32, 8, 128, 700, (0, 9, 650, 1), 650, None, torch.float16, False),
        ("T1024 D64 w20", 2, 32, 8, 64, 1024, (0, 37, 211, 600), 777, 20, torch.float32,
         False),
        ("GPT-2 heads G=1", 2, 12, 12, 64, 300, (0, 100, 299, 5), 300, None,
         torch.bfloat16, False),
        ("G=3, a row sees nothing", 2, 24, 8, 64, 100, (0, 3, 100, 50), 100, None,
         torch.bfloat16, False),
        ("G=16", 2, 128, 8, 128, 576, mp["pads"], 576, None, torch.bfloat16, False),
        ("G=16 w64", 2, 128, 8, 128, 300, (0, 17, 200, 9), 290, 64, torch.float32, False),
    ]
    worst = {}
    for i, (label, L, Nq, Nk, D, T, pads, length, window, dtype, main) in enumerate(cases):
        dname = str(dtype).replace("torch.", "")
        q, ks, vs, mask = _k13_case(L, B, Nq, Nk, D, T, pads, length, window, dtype,
                                    seed=300 + i)
        err, share = 0.0, 0.0
        for l in sorted({0, L - 1}):
            got = ak.flash_decode(q, ks[l], vs[l], mask, D ** -0.5)
            want = ak.flash_decode_plain(q, ks[l], vs[l], mask, D ** -0.5)
            torch.cuda.synchronize()
            e, sh = _paged_err(got, want, dname)
            if not (math.isfinite(e) and sh <= 1):
                raise PhaseError(f"flash_decode {label} l={l} {dname}: error {e}, {sh:.3g} "
                                 f"of its bound")
            for b in range(B):  # a row that sees no slot gives zeros
                if not mask[b].any() and got[b].any():
                    raise PhaseError(f"flash_decode {label}: row {b} sees no slot "
                                     f"and is not zero")
            err, share = max(err, e), max(share, sh)
        worst[dname] = max(share, worst.get(dname, 0.0))
        t_k = cuda_time_ms(_k13_cycle(q, ks, vs, mask), iters=4 * L)
        t_p = cuda_time_ms(lambda: ak.flash_decode_plain(q, ks[L - 1], vs[L - 1], mask,
                                                         D ** -0.5), iters=10)
        t_l = cuda_time_ms(_sdpa(q[:, :, None, :], ks[L - 1], vs[L - 1],
                                 mask[:, None, None, :], D ** -0.5), iters=20)
        nbytes, flops = _k13_cost(q, mask, Nk)
        b_ms, b_by = bound_ms(nbytes, flops, dname)
        log(f"[k13] flash_decode {label} B={B} Nq={Nq} Nk={Nk} D={D} T={T} {dname}: "
            f"max_abs_err {err:.3g} ({share:.3g} of its bound) kernel {t_k:.4f} ms plain "
            f"{t_p:.4f} ms sdpa {t_l:.4f} ms bound {b_ms:.5f} ms ({b_by}, "
            f"{nbytes / 1e6:.2f} MB) ok")
        if main:
            table["flash_decode"] = dict(
                name="flash_decode", route="cuda", source=SOURCES["flash_decode"],
                replaces=REPLACES["flash_decode"], launches=0, max_abs_err=err,
                tol_share=share, ms=t_k, plain_ms=t_p, bound_ms=b_ms, bound_by=b_by, library_ms=t_l)
            # the e4m3 branch at the main path's shape (bf16 queries)
            ks8, vs8 = kv_cast(ks, E4M3), kv_cast(vs, E4M3)
            del ks, vs
            _e4m3_row("flash_decode", "[k13]", "main path", _k13_cycle(q, ks8, vs8, mask),
                      lambda: ak.flash_decode_plain(q, ks8[L - 1], vs8[L - 1], mask,
                                                    D ** -0.5),
                      _k13_cost(q, mask, Nk, kv_size=1), iters=(4 * L, 10),
                      check=lambda: (ak.flash_decode(q, ks8[L - 1], vs8[L - 1], mask,
                                                     D ** -0.5),
                                     ak.flash_decode_plain(q, ks8[L - 1], vs8[L - 1], mask,
                                                           D ** -0.5)))
            del ks8, vs8
        torch.cuda.empty_cache()
    log("[k13] worst error over the cases as a share of its limit: "
        + ", ".join(f"{k} {v:.3g}" for k, v in sorted(worst.items())))
    # the stream's shape (batch 1, a 192-slot cache, 100 prompt slots and 8
    # decoded): K13 beside K2 over the same visible slots, 32 layers in turn,
    # timed in turns (K2, K13, K13, K2) three times: the medians compared
    L, T, P, N = 32, 192, 100, 8
    q, ks, vs, mask = _k13_case(L, 1, 32, 8, 128, T, (T - 64 - P,), T - 64 + N, None,
                                torch.bfloat16, seed=399)
    ki = torch.randn(1, 8, N, 128, device=DEVICE).to(torch.bfloat16)
    frozen = mask.clone()
    frozen[:, T - 64:] = False
    layers = iter(range(10 ** 9))

    def k2():
        return ak.flash_decode_frozen(q, ks, vs, frozen, ki, ki, next(layers) % L, N - 1,
                                      128 ** -0.5)

    calls = {"k2": k2, "k13": _k13_cycle(q, ks, vs, mask)}
    times = {"k2": [], "k13": []}
    for _ in range(3):
        for name in ("k2", "k13", "k13", "k2"):
            times[name].append(cuda_time_ms(calls[name], iters=4 * L))
    t_k2, t_k13 = statistics.median(times["k2"]), statistics.median(times["k13"])
    log(f"[k13] batch 1 (the stream's shape, {int(mask.sum())} visible slots of {T}): "
        f"flash_decode {t_k13:.4f} ms, flash_decode_frozen over the same slots "
        f"{t_k2:.4f} ms (medians of 6 in turns; K13 "
        + ", ".join(f"{t:.4f}" for t in times["k13"]) + "; K2 "
        + ", ".join(f"{t:.4f}" for t in times["k2"]) + ")")
    del ks, vs
    # K13's time against the cache's length at the same visible slots (108
    # in caches of 108, 192 and 576 slots, at the start and near the end),
    # and a short span (8 visible of 192)
    for T, start, n in ((108, 0, 108), (192, 28, 108), (576, 28, 108), (576, 440, 108),
                        (192, 128, 8)):
        g = torch.Generator(device=DEVICE).manual_seed(T + start)
        ks = torch.randn(L, 1, 8, T, 128, generator=g, device=DEVICE).to(torch.bfloat16)
        vs = torch.randn(L, 1, 8, T, 128, generator=g, device=DEVICE).to(torch.bfloat16)
        mask = torch.zeros(1, T, dtype=torch.bool, device=DEVICE)
        mask[:, start:start + n] = True
        got = ak.flash_decode(q, ks[L - 1], vs[L - 1], mask, 128 ** -0.5)
        want = ak.flash_decode_plain(q, ks[L - 1], vs[L - 1], mask, 128 ** -0.5)
        err, share = _paged_err(got, want, "bfloat16")
        if not (math.isfinite(err) and share <= 1):
            raise PhaseError(f"flash_decode batch 1 T={T} visible {start}..: error {err}, "
                             f"{share:.3g} of its bound")
        t = cuda_time_ms(_k13_cycle(q, ks, vs, mask), iters=4 * L)
        log(f"[k13] batch 1, {n} visible slots ({start}..{start + n - 1}) of {T}: "
            f"flash_decode {t:.4f} ms (max_abs_err {err:.3g}, {share:.3g} of its bound)")
        del ks, vs


def _write_full_model_dir(d: str) -> None:
    """A model dir of the Mistral-7B shape at all 32 layers (about 14.5 GB of
    random bf16 weights) and the generated Metaspace-BPE tokenizer."""
    import torch

    from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

    t0 = time.perf_counter()
    write_random_model_dir(d, MISTRAL_7B, seed=3, dtype=torch.bfloat16, device=DEVICE)
    torch.cuda.empty_cache()
    size = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    log(f"[stream] full-width model dir {size / 1e9:.2f} GB written in "
        f"{time.perf_counter() - t0:.1f} s")


def _pct(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(p / 100 * len(xs)) - 1))] if xs else 0.0


def _stream_once(eng, chunk, pace):
    """One generate_async of STREAM_PROMPT at stream_chunk `chunk`: its
    output, wall seconds, time to the first text chunk and the gaps
    between text callbacks (the final flush excluded)."""
    eng.config.stream_chunk, eng.config.stream_pace = chunk, pace
    times = []
    t0 = time.perf_counter()
    out = eng.generate_async(STREAM_PROMPT, lambda c, done: done or (
        times.append(time.perf_counter()) or True))
    wall = time.perf_counter() - t0
    gaps = [b - a for a, b in zip(times, times[1:])]
    return out, wall, (times[0] - t0 if times else float("nan")), gaps


def _sync_once(eng, chunk):
    eng.config.decode_chunk = chunk
    t0 = time.perf_counter()
    out = eng.generate_sync([STREAM_PROMPT])[0]
    return out, time.perf_counter() - t0


def _stream_engine(d: str, label: str, kw: dict, table: dict) -> None:
    """The stream runs of one engine on the full-width dir `d` (bf16, or
    int4 from the engine's own quantization): route check at batch 1 (and
    at the model phase's batch 4 in bf16, whose per-token run sets K13's
    launches in the kernel table), the device's busy share and launches a
    token, then streams at stream_chunk 1 and 8, paced and not, beside
    generate_sync at the same chunk, with exact launch counts."""
    import torch

    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
    from tinygpt_tpu_torch.ops import attention_kernels as ak

    n_tok = STREAM["max_tokens"]
    t0 = time.perf_counter()
    eng = GPTEngine(GPTConfig(model_dir=d, max_tokens=n_tok, device=DEVICE, **kw))
    eng.prepare()
    log(f"[stream] {label}: prepare() {time.perf_counter() - t0:.1f} s")
    ctx = eng.ctx
    cfg, params, L = ctx.model_config, ctx.params, ctx.model_config.num_hidden_layers
    with torch.inference_mode():
        if label == "bf16":
            # the model phase's batch through the per-token route: K13's
            # launches on the main path, and the route held to the plain one
            S, T = max(PROMPT_LENS), main_path_shapes()["decode"]["T"]
            batch = _left_padded_batch(S, PROMPT_LENS, cfg.vocab_size, seed=1)
            plain = _run_route(params, cfg, batch, T, "plain")
            forced = _run_route(params, cfg, batch, T, "kernel", force=plain[1],
                                per_token=True)
            _check_routes(f"batch {len(PROMPT_LENS)}, per-token route (K13) against the "
                          f"plain route", forced, plain, MODEL_LOGIT_TOL["bfloat16"],
                          tag="[stream]")
            ak.reset_launches()                          # the per-token main path
            kern = _run_route(params, cfg, batch, T, "kernel", per_token=True)
            launches = dict(ak.LAUNCHES)
            want = {"flash_prefill": L, "flash_decode": L * N_CHUNKS * DECODE_CHUNK}
            log(f"[stream] batch {len(PROMPT_LENS)} per-token route: decode "
                f"{kern[3]:.3f} ms/step; launches {launches} (want {want})")
            if launches != want:
                raise PhaseError(f"per-token route launched {launches} != {want}")
            table["flash_decode"]["launches"] = launches["flash_decode"]
        # batch 1: the stream's prompt, per-token (K13) against chunked (K2)
        ids, positions, valid, _, _ = eng._encode_batch([STREAM_PROMPT])
        batch1 = tuple(torch.from_numpy(a).to(DEVICE) for a in (ids, positions, valid))
        c8 = STREAM["chunks"][-1]
        n8 = (n_tok - 1) // c8
        T1 = ids.shape[1] + n8 * c8                     # the engine's cache at chunk 8
        chunked = _run_route(params, cfg, batch1, T1, "kernel", n_chunks=n8, chunk=c8)
        per_tok = _run_route(params, cfg, batch1, T1, "kernel", force=chunked[1],
                             n_chunks=n8, chunk=c8, per_token=True)
        _check_routes(f"{label}, batch 1: per-token route (K13) against the chunked "
                      f"route (K2)", per_tok, chunked, MODEL_LOGIT_TOL["bfloat16"],
                      tag="[stream]")
        prof = {}
        for per_token in (True, False):
            prof[per_token] = _profile_decode(
                params, cfg, batch1, T1, label=f"{label}, batch 1, "
                f"{'per-token route' if per_token else 'a chunk of 8'}",
                tag="[stream]", per_token=per_token)
    route_toks = chunked[1][:, 0].tolist()
    _sync_once(eng, 8)                                     # warm-up
    _stream_once(eng, 1, False)
    runs = {}
    kinds = [("sync", 8, None), ("stream", 8, True), ("stream", 8, False), ("sync", 1, None),
             ("stream", 1, False)]
    # the host's time varies by 10 % to 20 % from run to run: every kind
    # runs STREAM["rounds"] times, in turns, the order reversed every round
    for r in range(STREAM["rounds"]):
        for kind, chunk, pace in (kinds if r % 2 == 0 else kinds[::-1]):
            ak.reset_launches()
            if kind == "sync":
                out, wall = _sync_once(eng, chunk)
                ttft, gaps = float("nan"), []
            else:
                out, wall, ttft, gaps = _stream_once(eng, chunk, pace)
            torch.cuda.synchronize()
            launches = dict(ak.LAUNCHES)
            runs.setdefault((kind, chunk, pace), []).append((out, wall, ttft, gaps))
            n = len(out.token_ids)
            if n != n_tok:
                raise PhaseError(f"{label} {kind} chunk {chunk}: {n} tokens, want {n_tok}")
            attn = "flash_decode" if chunk == 1 else "flash_decode_frozen"
            other = "flash_decode_frozen" if chunk == 1 else "flash_decode"
            if (launches.get(attn) != L * (n_tok - 1) or launches.get(other)
                    or launches.get("flash_prefill") != L):
                raise PhaseError(f"{label} {kind} chunk {chunk}: launches {launches}, want "
                                 f"{attn} {L * (n_tok - 1)} ({L} a token), flash_prefill {L}")
            if "quantization" in kw and not all(launches.get(k) for k in (
                    "matmul_dequant_int4_stacked", "matmul_dequant_int4_stacked_fused",
                    "mlp_fused_int4_stacked")):
                raise PhaseError(f"{label} {kind} chunk {chunk}: launches {launches}")
            if r == 0:
                log(f"[stream] {label}, chunk {chunk}, {kind}"
                    f"{'' if kind == 'sync' else ', paced' if pace else ', unpaced'}: "
                    f"launches {launches}")
    for (kind, chunk, pace), rs in runs.items():
        walls = [x[1] * 1e3 for x in rs]
        what = (f"generate_sync" if kind == "sync" else
                f"generate_async, {'paced' if pace else 'unpaced'}")
        gaps = [g for x in rs for g in x[3]]
        itl = (f"; first text median {statistics.median(x[2] for x in rs) * 1e3:.1f} ms, "
               f"inter-callback p50 {_pct(gaps, 50) * 1e3:.2f} ms p95 "
               f"{_pct(gaps, 95) * 1e3:.2f} ms ({len(gaps)} gaps)" if kind == "stream" else "")
        log(f"[stream] {label}, chunk {chunk}, {what}: {n_tok} tokens, wall median "
            f"{statistics.median(walls):.1f} ms ({statistics.median(walls) / n_tok:.2f} ms a "
            f"token; runs {', '.join(f'{w:.1f}' for w in walls)}){itl}")
    # tokens: the same route exactly; the two routes up to a near-tie (the
    # route check above holds every choice the two routes part at)
    for chunk in STREAM["chunks"]:
        toks = {k: [r[0].token_ids for r in v] for k, v in runs.items() if k[1] == chunk}
        ref = toks[("sync", chunk, None)][0]
        if any(t != ref for ts in toks.values() for t in ts):
            raise PhaseError(f"{label} chunk {chunk}: stream and generate_sync tokens "
                             f"differ on the same route: {toks}")
    t1, t8 = runs[("sync", 1, None)][0][0].token_ids, runs[("sync", 8, None)][0][0].token_ids
    part = next((i for i, (a, b) in enumerate(zip(t1, t8)) if a != b), None)
    log(f"[stream] {label}: chunk 1 and chunk 8 tokens "
        + ("identical" if part is None else f"part at position {part}")
        + f" of {n_tok}; chunk 8 equals the route check's chunked tokens: "
        + str(t8 == route_toks[:n_tok]))
    if t8 != route_toks[:n_tok]:
        raise PhaseError(f"{label}: the engine's chunk-8 tokens differ from the chunked "
                         f"route's at the same prompt")
    sync8 = statistics.median(r[1] for r in runs[("sync", 8, None)])
    paced8 = statistics.median(r[1] for r in runs[("stream", 8, True)])
    p = prof.get(True, {})
    log(f"[stream] {label} summary: paced stream at chunk 8 {paced8 * 1e3:.1f} ms against "
        f"generate_sync {sync8 * 1e3:.1f} ms (ratio of the medians {paced8 / sync8:.4f}, "
        f"{STREAM['rounds']} runs each); per-token route "
        + (f"{p['busy_ms']:.3f} busy ms in {p['wall_ms']:.3f} wall ms a token "
           f"({100 * p['busy_ms'] / p['wall_ms']:.1f}% busy), {p['launches']:.0f} device "
           f"launches a token" if p else "device time not measured"))
    del eng, ctx, params
    torch.cuda.empty_cache()


def phase_stream(table: dict) -> None:
    """Streaming at the Mistral-7B shape, not cut (32 layers, batch 1):
    writes the full-width dir under the build directory, then
    _stream_engine in bf16 and in int4 (the engine's AWQ default)."""
    from tinygpt_tpu_torch.ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    d = tempfile.mkdtemp(prefix="smoke_stream_", dir=cuda_build.BUILD_DIR)
    try:
        _write_full_model_dir(d)
        _stream_engine(d, "bf16", {}, table)
        _stream_engine(d, "int4", dict(quantization="int4"), table)
    finally:
        shutil.rmtree(d, ignore_errors=True)


# -- mesh: multi-device layouts, two ranks sharing the card ---------------------------

MESH_RANKS = 2
MESH_TIMEOUT_S = 420  # a rank that has not finished by then fails the phase
MESH_LAYERS = 16      # the full-width tp = 2 leg's depth (cut from 32 for the run's time)
MESH_SMALL = dict(MISTRAL_7B, num_hidden_layers=2)
MESH_TP_SHAPES = dict(qkv=3072, o_in=2048, gate_up=2 * 7168, down_in=7168, vocab=16384)
# the 2-layer mesh legs against one rank on the same params and inputs, max
# abs error of the logits at every position: both sides run the same
# kernels, only the order of the sums differs (an H100 read 0.03125 for the
# pipeline stages in bf16 and 0.04688 for Mixtral int4's experts over sp);
# the limits leave about 3x room, well under one logit std (1.28), so a
# rank's lost expert sum or a foreign row not zeroed fails
MESH_PIPE_TOL = 0.1
MESH_MOE_TOL = 0.15


def phase_mesh_kernels() -> None:
    """K6, K7, K2 and K1 at the local shapes that tp = 2 gives each rank at
    the Mistral-7B shape (16 query and 4 KV heads of 128; qkv 3,072 columns,
    o 2,048 rows, gate_up 2 x 7,168, down 7,168 rows), against their plain
    versions, in this process (no process group): K6 for qkv with the norm
    prologue and RoPE on the local heads, K6 for o and K7 at I / 2 with
    the residual off (the ranks other than tp rank 0), K7 with it, K2 and
    K1 at G = 4; and K11b on a stack of 4 of Mixtral's 8 experts (sp = 2),
    the ids remapped by moe_gather_local with half the rows routed to the
    other rank, against the same remap around its plain version."""
    import torch

    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops import quant_kernels as qk

    g = torch.Generator(device=DEVICE).manual_seed(7)
    H, D, L, M = MISTRAL_7B["hidden_size"], 128, 2, len(PROMPT_LENS)
    Nq, Nk = MISTRAL_7B["num_attention_heads"] // 2, MISTRAL_7B["num_key_value_heads"] // 2
    sh = MESH_TP_SHAPES
    tol = QUANT_TOL["bfloat16"] * 8
    x = torch.randn(M, H, generator=g, device=DEVICE).to(torch.bfloat16)
    ln = torch.rand(L, H, generator=g, device=DEVICE).to(torch.bfloat16) + 0.5
    inv = torch.rsqrt((x.float() ** 2).mean(-1, keepdim=True) + 1e-5)
    cos = torch.rand(M, D, generator=g, device=DEVICE)
    sin = torch.rand(M, D, generator=g, device=DEVICE)
    qd, qs = _int4_stack(g, L, H, sh["qkv"], INT4_GROUP)
    kw = dict(ln=ln, invrms=inv, rope_cos=cos, rope_sin=sin, rope_heads=Nq + Nk, rope_dim=D)
    _kernel_case(
        "[mesh] qkv, 16 + 2 x 4 local heads", "matmul_dequant_int4_stacked_fused",
        lambda: qk.matmul_dequant_int4_stacked_fused(x, qd, qs, 1, INT4_GROUP, **kw),
        lambda: qk.matmul_dequant_int4_stacked_fused_plain(x, qd, qs, 1, INT4_GROUP, **kw),
        (_nbytes(qd[1], qs[1], x) + M * sh["qkv"] * 2, 2.0 * M * H * sh["qkv"]), tol)
    a = torch.randn(M, sh["o_in"], generator=g, device=DEVICE).to(torch.bfloat16)
    od, os_ = _int4_stack(g, L, sh["o_in"], H, INT4_GROUP)
    _kernel_case(
        "[mesh] o, 2,048 local rows, residual off", "matmul_dequant_int4_stacked_fused",
        lambda: qk.matmul_dequant_int4_stacked_fused(a, od, os_, 1, INT4_GROUP),
        lambda: qk.matmul_dequant_int4_stacked_fused_plain(a, od, os_, 1, INT4_GROUP),
        (_nbytes(od[1], os_[1], a) + M * H * 2, 2.0 * M * sh["o_in"] * H), tol)
    gd, gs = _int4_stack(g, L, H, sh["gate_up"], INT4_GROUP)
    dd, ds = _int4_stack(g, L, sh["down_in"], H, INT4_GROUP)
    for residual in (True, False):
        _kernel_case(
            f"[mesh] MLP at I / 2 = 7,168, residual {'on' if residual else 'off'}",
            "mlp_fused_int4_stacked",
            lambda: qk.mlp_fused_int4_stacked(x, gd, gs, dd, ds, ln, inv, 1, INT4_GROUP,
                                              residual=residual),
            lambda: qk.mlp_fused_int4_stacked_plain(x, gd, gs, dd, ds, ln, inv, 1,
                                                    INT4_GROUP, residual=residual),
            (_nbytes(gd[1], gs[1], dd[1], ds[1], x) * 1 + M * H * 2,
             2.0 * M * H * (sh["gate_up"] + sh["down_in"])), tol)
    mp = main_path_shapes()["decode"]
    q, ks, vs, mask, ki, vi, step, window = _decode_case(
        L, M, Nq, Nk, D, mp["T"], mp["N"], mp["pads"], mp["length"], mp["step"], None,
        torch.bfloat16, seed=3)
    _kernel_case(
        "[mesh] decode, 16 query over 4 KV heads", "flash_decode_frozen",
        lambda: ak.flash_decode_frozen(q, ks, vs, mask, ki, vi, 1, step, scale=D ** -0.5),
        lambda: ak.flash_decode_frozen_plain(q, ks, vs, mask, ki, vi, 1, step, scale=D ** -0.5),
        _decode_cost(q, mask, ki, step, window), TOL["bfloat16"])
    pp = main_path_shapes()["prefill"]
    args = _prefill_case(M, Nq, Nk, D, pp["S"], pp["T"], pp["pads"], 0, None, torch.bfloat16,
                         seed=4)
    _kernel_case(
        "[mesh] prefill, 16 query over 4 KV heads", "flash_prefill",
        lambda: ak.flash_prefill(*args), lambda: ak.flash_prefill_plain(*args),
        _prefill_cost(args[0], args[1], args[3], 0, None), TOL["bfloat16"], iters=5)
    del args
    torch.cuda.empty_cache()
    _mesh_local_experts_case()


def _mesh_local_experts_case() -> None:
    """K11b on rank 1's stack of experts 4..7 of Mixtral's down (14,336 ->
    4,096, int4 at MOE_GROUP), 4 tokens x 2 experts with half the rows
    routed to rank 0's experts: the rows routed away exactly 0, the others
    within QUANT_TOL of the largest output of the plain version's."""
    import torch

    from tinygpt_tpu_torch.ops import moe_kernels as mk
    from tinygpt_tpu_torch.ops.quant import _quantize_moe_stacked

    IN, OUT, n = MIXTRAL_8X7B["intermediate_size"], MIXTRAL_8X7B["hidden_size"], 4
    g = torch.Generator(device=DEVICE).manual_seed(9)
    w = _quantize_moe_stacked(torch.randn((1, n, IN, OUT), generator=g, device=DEVICE) * 0.02,
                              4, MOE_GROUP)
    idx = torch.tensor([0, 5, 3, 4, 7, 1, 6, 2], dtype=torch.int32, device=DEVICE)
    x = (torch.randn((idx.numel(), IN), generator=g, device=DEVICE) * 0.5).to(torch.bfloat16)
    kern = lambda: mk.moe_gather_local(x, w, 0, idx, (n, n), "kernel")  # noqa: E731
    plain = lambda: mk.moe_gather_local(x, w, 0, idx, (n, n), "plain")  # noqa: E731
    got, want = kern(), plain()
    away = idx < n
    if got[away].any() or want[away].any():
        raise PhaseError("[mesh] K11b on local experts: a row routed away is not 0")
    tol = QUANT_TOL["bfloat16"] * want.float().abs().max().item()
    local = mk.local_experts(idx, (n, n))[0]
    _kernel_case(
        f"[mesh] experts {n}..{2 * n - 1} of 8 (sp = 2), 4 of 8 rows routed away",
        "moe_gather_matmul_int4", kern, plain, _moe_cost(w, 0, local, x, OUT), tol)


def _mesh_launches() -> dict:
    """The launch counts of every kernel wrapper, by name."""
    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops import moe_kernels as mk
    from tinygpt_tpu_torch.ops import quant_kernels as qk

    out = {}
    for counts in (ak.LAUNCHES, qk.LAUNCHES, mk.LAUNCHES):
        out.update({k: v for k, v in counts.items() if v})
    return out


def _mesh_reset() -> None:
    from tinygpt_tpu_torch.ops import attention_kernels as ak
    from tinygpt_tpu_torch.ops import moe_kernels as mk
    from tinygpt_tpu_torch.ops import quant_kernels as qk

    for counts in (ak.LAUNCHES, qk.LAUNCHES, mk.LAUNCHES):
        counts.clear()


def _mesh_engine(params, cfg, mesh_shape, **kw):
    """A GPTEngine around params built on the card (random, at full width:
    no model dir), cut to this rank's shard by the engine's own sharding
    (GPTEngine.shard). Returns the engine; its shard and local config are
    eng.ctx.params and eng._run_cfg."""
    import torch

    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
    from tinygpt_tpu_torch.hf.loader import GPTContext
    from tinygpt_tpu_torch.models import get_model

    eng = GPTEngine(GPTConfig(model_dir="", device=DEVICE, **kw))
    eng._device = torch.device(DEVICE)
    eng.ctx = GPTContext(cfg, None, None, params, get_model(cfg.model_type))
    eng.shard(mesh_shape)
    return eng


def _mesh_same_tokens(toks, what: str) -> None:
    """Every rank's tokens equal rank 0's (lockstep sampling)."""
    import torch

    from tinygpt_tpu_torch.parallel import distributed

    t = toks.to(torch.int64).contiguous()
    both = distributed.all_gather(t[None], torch.distributed.group.WORLD)
    if not all(torch.equal(both[0], b) for b in both):
        raise PhaseError(f"{what}: the ranks' tokens parted ways")


def _mesh_tp_full_width(rank: int, res: dict) -> None:
    """The Mistral-7B shape in int4 (group 64, MESH_LAYERS layers) at tp = 2
    through the engine's sharded path: rank 0 first runs the same params
    unsharded (the single-rank reference); both ranks then prefill the
    model phase's 4 prompts and run one decode chunk fed its tokens, and
    once free-running. The logits of every position within the int4
    engine's tolerance of the reference's, the free-running tokens the same
    on both ranks, every kernel of the path launched (K1, K5b and K4 in
    the prefill; K6, K7 and K2 in every step on both ranks, K6 for o and
    K7 adding the residual on tp rank 0 only), and each rank's busy ms a
    decode step."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm
    from tinygpt_tpu_torch.ops.quant import quantize_params
    from tinygpt_tpu_torch.parallel import distributed

    tag = "[mesh] tp=2 int4"
    mp = main_path_shapes()
    S = mp["prefill"]["S"]
    T = S + DECODE_CHUNK
    cfg = parse_model_config(dict(MISTRAL_7B, num_hidden_layers=MESH_LAYERS))
    t0 = time.perf_counter()
    params = quantize_params(causal_lm.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                                   device=DEVICE),
                             bits=4, group_size=INT4_GROUP)
    torch.cuda.empty_cache()
    log(f"{tag} rank {rank}: {MESH_LAYERS} layers built and quantized in "
        f"{time.perf_counter() - t0:.1f} s")
    batch = _left_padded_batch(S, PROMPT_LENS, cfg.vocab_size, seed=1)
    B = len(PROMPT_LENS)
    ref = None
    fed = torch.zeros((1 + DECODE_CHUNK, B), dtype=torch.int32, device=DEVICE)
    if rank == 0:
        ref = _run_route(params, cfg, batch, T, "kernel", n_chunks=1)
        fed.copy_(ref[1])
    distributed.broadcast(fed, 0, torch.distributed.group.WORLD)
    eng = _mesh_engine(params, cfg, (1, 1, 2), dtype="bfloat16")
    del params
    torch.cuda.empty_cache()
    lp, lcfg = eng.ctx.params, eng._run_cfg
    lay = lp["layers"]
    got = dict(qkv=lay["qkv_w"].out_dim, o_in=lay["o_w"].in_dim,
               gate_up=lay["gate_up_w"].out_dim, down_in=lay["down_w"].in_dim,
               vocab=lcfg.vocab_size)
    if got != MESH_TP_SHAPES:
        raise PhaseError(f"{tag}: local shapes {got} != {MESH_TP_SHAPES}")
    _run_route(lp, lcfg, batch, T, "kernel", n_chunks=1, force=fed)   # warm-up
    _mesh_reset()                                                     # the main path's run
    mesh = _run_route(lp, lcfg, batch, T, "kernel", n_chunks=1, force=fed)
    launches = _mesh_launches()
    L = MESH_LAYERS
    want = _dense_want("int4", L, DECODE_CHUNK)
    log(f"{tag} rank {rank}: launches {launches} (want {want})")
    if launches != want:
        raise PhaseError(f"{tag} rank {rank}: launches {launches} != {want}")
    res["tp_launches"] = launches
    free = _run_route(lp, lcfg, batch, T, "kernel", n_chunks=1)
    _mesh_same_tokens(free[1], tag)
    if rank == 0:
        _check_routes(f"tp=2 int4, bf16, {L} layers, against one rank", mesh, ref,
                      MODEL_LOGIT_TOL["bfloat16"], tag="[mesh]")
        same = int((free[1] == ref[1]).all(dim=0).sum())
        log(f"{tag}: free-running greedy tokens equal the single rank's over all "
            f"{free[1].shape[0]} positions in {same} of {B} rows; prefill {mesh[2]:.1f} ms, "
            f"decode {mesh[3]:.2f} ms/step (2 ranks sharing one H100 over gloo; single "
            f"rank: prefill {ref[2]:.1f} ms, decode {ref[3]:.2f} ms/step)")
    _profile_decode(lp, lcfg, batch, T, label=f"tp=2 rank {rank}", tag="[mesh]")
    del eng, lp
    torch.cuda.empty_cache()


def _mesh_batcher(rank: int) -> None:
    """The continuous batcher at (1, 1, 2), 2 layers at Mistral-7B widths in
    fp32: four requests admitted, one frozen quantum (K8) and one stepwise
    quantum (forward_paged, K9), against the same on one rank (rank 0): the
    same streams, and K8 and K9 launched on both ranks."""
    import functools

    import torch

    from tinygpt_tpu_torch.engine import scheduler
    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.models import causal_lm, get_model

    tag = "[mesh] batcher (1,1,2)"
    cfg = parse_model_config(MESH_SMALL)
    model = get_model(cfg.model_type)
    params = causal_lm.init_params(cfg, seed=5, dtype=torch.float32, device=DEVICE)
    g = torch.Generator().manual_seed(9)
    prompts = [torch.randint(3, cfg.vocab_size, (n,), generator=g).tolist()
               for n in (40, 97, 64, 130)]
    q = 8

    def run(mesh_shape):
        b = scheduler.ContinuousBatcher(
            model, cfg, params, eos_ids=set(), config=scheduler.SchedulerConfig(
                batch_capacity=4, block_size=64, n_blocks=32, max_blocks_per_seq=8,
                dtype="float32", decode_quantum=q, pipeline_quanta=False,
                enable_prefix_cache=False, mesh_shape=mesh_shape))
        for i, p in enumerate(prompts):
            b.add_request(scheduler.Request(request_id=i, prompt_ids=p,
                                            max_new_tokens=1 + 2 * q))
        got = {i: [] for i in range(len(prompts))}

        def step():
            for ev in b.step():
                if ev.token_id is not None:
                    got[ev.request_id].append(ev.token_id)

        step()                                              # the admissions
        _mesh_reset()
        step()                                              # a frozen quantum (K8)
        b._decode_fn = functools.partial(scheduler._decode_quantum, model.forward_paged)
        step()                                              # a stepwise quantum (K9)
        return got, _mesh_launches()

    if rank == 0:
        single, _ = run(None)
    got, launches = run((1, 1, 2))
    L = cfg.num_hidden_layers
    want = {"paged_decode_frozen": L * q, "paged_decode": L * q}
    log(f"{tag} rank {rank}: launches {launches} (want {want})")
    if launches != want:
        raise PhaseError(f"{tag} rank {rank}: launches {launches} != {want}")
    _mesh_same_tokens(torch.tensor([got[i] for i in range(4)]), tag)
    if rank == 0:
        _mesh_near_ties(tag, params, cfg, [prompts[i] for i in range(4)],
                        [got[i] for i in range(4)], [single[i] for i in range(4)])
    del params
    torch.cuda.empty_cache()


def _mesh_dir_engine(rank: int, d: str) -> None:
    """GPTEngine on the 2-layer model dir: at (2, 1, 1) (dp: the 4 prompts
    cut 2 and 2, the tokens all-gathered) in fp32 against one rank's
    engine, then pipeline stages at (1, 1, 2, 1) in bf16: the prefill's
    last-position logits against one rank's forward within MESH_PIPE_TOL, generate_sync's tokens equal on both ranks, and K1 (the
    prefill) and K13 (each pipelined decode step) launched."""
    import torch

    from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
    from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache

    prompts = ["The printing press changed how knowledge moved", "Once upon a time,",
               "In a shocking finding, scientists discovered", "def add(a, b):"]
    kw = dict(model_dir=d, device=DEVICE, max_tokens=9, decode_chunk=8)
    tag = "[mesh] engine (2,1,1)"
    single = None
    if rank == 0:
        eng = GPTEngine(GPTConfig(dtype="float32", **kw))
        eng.prepare()
        single = [o.token_ids for o in eng.generate_sync(prompts)]
        single_params = eng.ctx.params
        del eng
    eng = GPTEngine(GPTConfig(dtype="float32", mesh_shape=(2, 1, 1), **kw))
    eng.prepare()
    _mesh_reset()
    got = [o.token_ids for o in eng.generate_sync(prompts)]
    launches = _mesh_launches()
    log(f"{tag} rank {rank}: launches {launches}")
    if not launches.get("flash_prefill") or not launches.get("flash_decode_frozen"):
        raise PhaseError(f"{tag} rank {rank}: K1 or K2 not launched ({launches})")
    _mesh_same_tokens(torch.tensor(got), tag)
    if rank == 0:
        tok = eng.ctx.tokenizer
        _mesh_near_ties(tag, single_params, eng.ctx.model_config,
                        [tok.encode(p) for p in prompts], got, single)
        del single_params
    del eng
    torch.cuda.empty_cache()

    tag = "[mesh] pipeline (1,1,2,1)"
    eng = GPTEngine(GPTConfig(dtype="bfloat16", mesh_shape=(1, 1, 2, 1), **kw))
    eng.prepare()
    S = 64
    ids, pos, valid = _left_padded_batch(S, (64, 50, 33, 12), eng.ctx.model_config.vocab_size,
                                         seed=2)
    cache = create_kv_cache(eng._run_cfg, 4, S, dtype=torch.bfloat16, device=DEVICE)
    logits, _ = eng._forward(eng.ctx.params, ids, cache, pos, valid)
    if rank == 0:
        ref_eng = GPTEngine(GPTConfig(dtype="bfloat16", **kw))
        ref_eng.prepare()
        mc = ref_eng.ctx.model_config
        ref, _ = ref_eng.ctx.model.forward(
            ref_eng.ctx.params, mc, ids, create_kv_cache(mc, 4, S, dtype=torch.bfloat16,
                                                         device=DEVICE),
            pos, valid, last_only=True)
        err = (logits - ref).abs().max().item()
        log(f"{tag}: prefill last-position logits against one rank's forward, max_abs_err "
            f"{err:.4g} (tol {MESH_PIPE_TOL})")
        if not math.isfinite(err) or err > MESH_PIPE_TOL:
            raise PhaseError(f"{tag}: logits differ by {err}")
        del ref_eng
    _mesh_reset()
    got = [o.token_ids for o in eng.generate_sync(prompts)]
    launches = _mesh_launches()
    log(f"{tag} rank {rank}: launches {launches}")
    if not launches.get("flash_prefill") or not launches.get("flash_decode"):
        raise PhaseError(f"{tag} rank {rank}: K1 or K13 not launched ({launches})")
    _mesh_same_tokens(torch.tensor(got), tag)
    del eng
    torch.cuda.empty_cache()


def _mesh_moe(rank: int) -> None:
    """Mixtral-8x7B widths in int4 (group 128), 2 layers, its 8 experts
    over sp = 2 (1, 2, 1): each rank's K11b reads its own 4 experts (the
    rows routed to the other rank's give 0) and the partial sums meet in
    the sp all-reduce. Rank 0 first runs the params unsharded; the sharded
    logits of every position within MESH_MOE_TOL, K11b launched on both
    ranks."""
    import torch

    from tinygpt_tpu_torch.hf.config import parse_model_config
    from tinygpt_tpu_torch.parallel import distributed

    tag = "[mesh] mixtral int4 experts over sp (1,2,1)"
    cfg = parse_model_config(dict(MIXTRAL_8X7B, num_hidden_layers=2))
    params = _mixtral_params(cfg, 4)
    lens = PROMPT_LENS
    S = max(lens)
    T = S + DECODE_CHUNK
    batch = _left_padded_batch(S, lens, cfg.vocab_size, seed=3)
    fed = torch.zeros((1 + DECODE_CHUNK, len(lens)), dtype=torch.int32, device=DEVICE)
    ref = None
    if rank == 0:
        ref = _run_route(params, cfg, batch, T, "kernel", n_chunks=1)
        fed.copy_(ref[1])
    distributed.broadcast(fed, 0, torch.distributed.group.WORLD)
    eng = _mesh_engine(params, cfg, (1, 2, 1), dtype="bfloat16")
    del params
    sc = eng.ctx.params["shard"]
    if not sc.ep or sc.experts != cfg.num_local_experts // 2:
        raise PhaseError(f"{tag}: experts not cut over sp ({sc})")
    _mesh_reset()
    got = _run_route(eng.ctx.params, eng._run_cfg, batch, T, "kernel", n_chunks=1, force=fed)
    launches = _mesh_launches()
    log(f"{tag} rank {rank}: experts {sc.expert_start}..{sc.expert_start + sc.experts - 1}, "
        f"launches {launches}")
    if launches.get("moe_gather_matmul_int4", 0) != 2 * 2 * DECODE_CHUNK:
        raise PhaseError(f"{tag} rank {rank}: K11b launched "
                         f"{launches.get('moe_gather_matmul_int4', 0)} times, want "
                         f"{2 * 2 * DECODE_CHUNK}")
    if rank == 0:
        _check_routes("mixtral int4, 2 layers, experts over sp, against one rank", got, ref,
                      MESH_MOE_TOL, tag="[mesh]")
    del eng
    torch.cuda.empty_cache()


def _mesh_near_ties(tag, params, cfg, prompts, got, want, gap=1e-3) -> None:
    """Greedy streams of the mesh against one rank's (fp32): equal, or
    equal up to a first difference where both tokens are within `gap` of
    the top of one rank's dense logits (the order of a sum may swap a
    near-tie), as the CPU tests hold the port to the JAX package."""
    import torch

    from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
    from tinygpt_tpu_torch.models import causal_lm

    flips = 0
    for p, a, b in zip(prompts, got, want):
        if a == b:
            continue
        i = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]), None)
        if i is None:
            raise PhaseError(f"{tag}: streams of different lengths {a} / {b}")
        ctx = list(p) + list(a[:i])
        n = len(ctx)
        cache = create_kv_cache(cfg, 1, n, dtype=torch.float32, device=DEVICE)
        lg, _ = causal_lm.forward(params, cfg, torch.tensor([ctx], device=DEVICE), cache,
                                  torch.arange(n, device=DEVICE, dtype=torch.int32)[None],
                                  torch.ones((1, n), dtype=torch.bool, device=DEVICE),
                                  last_only=True)
        lg = lg[0, -1]
        top = lg.max().item()
        if top - lg[a[i]].item() >= gap or top - lg[b[i]].item() >= gap:
            raise PhaseError(f"{tag}: a stream departs from one rank's at token {i} "
                             f"({a[i]} / {b[i]}) without a near-tie")
        flips += 1
    log(f"{tag}: {len(got)} streams of {len(got[0])} tokens equal one rank's (fp32)"
        + (f", {flips} of them up to a near-tie" if flips else ""))


def mesh_rank_main(rank: int, port: int, d: str, out: str) -> int:
    """One rank of the mesh phase (python3 chip_smoke.py --mesh-rank R
    --mesh-port P --mesh-dir D --mesh-out F): joins the gloo group on the
    one card (NCCL refuses two ranks on one device), runs the legs, writes
    its results to F. A failed leg exits non-zero."""
    import torch

    from tinygpt_tpu_torch.parallel import distributed

    global E4M3, DEVICE
    E4M3 = torch.float8_e4m3fn
    DEVICE = "cuda:0"
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    distributed.initialize(f"localhost:{port}", MESH_RANKS, rank, backend="gloo",
                           device=DEVICE)
    res, seconds = {}, {}
    try:
        with torch.inference_mode():
            for name, leg in (("tp full width", lambda: _mesh_tp_full_width(rank, res)),
                              ("batcher", lambda: _mesh_batcher(rank)),
                              ("engine dp, pipeline", lambda: _mesh_dir_engine(rank, d)),
                              ("mixtral sp", lambda: _mesh_moe(rank))):
                t0 = time.perf_counter()
                leg()
                seconds[name] = round(time.perf_counter() - t0, 1)
    except PhaseError as e:
        print(f"chip_smoke: mesh rank {rank} FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    res["seconds"] = seconds
    with open(out, "w") as f:
        json.dump(res, f)
    distributed.barrier()
    return 0


def _mesh_cli(d: str) -> None:
    """python -m tinygpt_tpu_torch.cli --mesh 1,1,2 as two processes (the
    torch env of torchrun, gloo on the one card) on the 2-layer dir in
    fp32: rank 0 prints what one process prints."""
    root = os.path.dirname(os.path.abspath(__file__))
    args = [sys.executable, "-m", "tinygpt_tpu_torch.cli", "--model", d, "--device", "cuda:0",
            "--dtype", "float32", "--max-tokens", "8", "--prompt", "Hello world",
            "--prompt", "The best way to learn programming is"]
    env = dict(os.environ, PYTHONPATH=root)
    one = subprocess.run(args, env=env, cwd=root, capture_output=True, text=True, timeout=300)
    if one.returncode:
        raise PhaseError(f"[mesh] cli, one process: exit {one.returncode}: {one.stderr[-2000:]}")
    port = _mesh_port()
    procs = []
    for r in range(2):
        out = os.path.join(d, f"cli{r}.out")
        f = open(out, "w")
        procs.append((subprocess.Popen(
            args + ["--mesh", "1,1,2", "--dist-backend", "gloo"], cwd=root, stdout=f,
            stderr=open(out + ".err", "w"), text=True,
            env=dict(env, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE="2",
                     RANK=str(r), LOCAL_RANK=str(r))), out))
    outs = _mesh_wait(procs, 300, "cli")
    if outs[0] != one.stdout or outs[1]:
        raise PhaseError(f"[mesh] cli --mesh 1,1,2: rank 0 printed {outs[0]!r}, rank 1 "
                         f"{outs[1]!r}; one process {one.stdout!r}")
    log(f"[mesh] cli --mesh 1,1,2 (2 processes, gloo): rank 0 printed what one process "
        f"prints ({len(one.stdout)} chars), rank 1 nothing")


def _mesh_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _mesh_start(args, log_path: str, **kw):
    """A rank's process, its output and errors into log_path."""
    f = open(log_path, "w")
    return subprocess.Popen(args, stdout=f, stderr=subprocess.STDOUT, text=True, **kw), log_path


def _mesh_wait(procs, timeout: float, what: str):
    """Wait for every rank's process [(Popen, log path)]; the first that
    fails, or any still running after `timeout`, fails the phase, and every
    process still running is killed then. Returns each rank's output."""
    deadline = time.perf_counter() + timeout
    try:
        while any(p.poll() is None for p, _ in procs):
            failed = [r for r, (p, _) in enumerate(procs) if p.poll()]
            if failed or time.perf_counter() > deadline:
                break
            time.sleep(0.5)
        for r, (p, path) in enumerate(procs):
            if p.poll() is None:
                raise PhaseError(f"[mesh] {what}: rank {r} still running after {timeout} s "
                                 f"(or another rank failed)")
            if p.returncode:
                with open(path) as f:
                    raise PhaseError(f"[mesh] {what}: rank {r} exit {p.returncode}: "
                                     f"{f.read()[-3000:]}")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for _, path in procs:
        with open(path) as f:
            outs.append(f.read())
    return outs


def phase_mesh() -> None:
    """Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device): the kernels at tp = 2's local shapes here, then the ranks'
    legs (mesh_rank_main) and the CLI as two processes. The kernels were
    built by the build phase, before any rank starts: the ranks load them
    (no two processes build the same library at once). Times are those of
    2 ranks sharing one H100: they show the layouts work, not scaling."""
    import torch

    from tinygpt_tpu_torch.ops import cuda_build

    phase_mesh_kernels()
    torch.cuda.empty_cache()
    d = tempfile.mkdtemp(prefix="smoke_mesh_", dir=cuda_build.BUILD_DIR)
    try:
        _write_model_dir(d)
        port = _mesh_port()
        outs = [os.path.join(d, f"rank{r}.json") for r in range(MESH_RANKS)]
        script = os.path.abspath(__file__)
        t0 = time.perf_counter()
        procs = [_mesh_start(
            [sys.executable, script, "--mesh-rank", str(r), "--mesh-port", str(port),
             "--mesh-dir", d, "--mesh-out", outs[r]], os.path.join(d, f"rank{r}.log"),
            cwd=os.path.dirname(script)) for r in range(MESH_RANKS)]
        try:
            got = _mesh_wait(procs, MESH_TIMEOUT_S, "ranks")
        except PhaseError:
            for r in range(MESH_RANKS):  # every rank's lines, for the record
                with open(os.path.join(d, f"rank{r}.log")) as f:
                    log(f"[mesh] rank {r} log:\n{f.read()[-20000:]}")
            raise
        for r, out in enumerate(got):
            for line in out.splitlines():
                log(line if line.startswith("[mesh]") else f"[mesh] rank {r}: {line}")
        res = []
        for path in outs:
            with open(path) as f:
                res.append(json.load(f))
        log(f"[mesh] ranks done in {time.perf_counter() - t0:.1f} s; legs (s): "
            + "; ".join(f"rank {r} {x['seconds']}" for r, x in enumerate(res)))
        if not all(x["tp_launches"].get("mlp_fused_int4_stacked") for x in res):
            raise PhaseError("[mesh] K7 was not launched on every rank")
        _mesh_cli(d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def main() -> int:
    import torch

    if "--mesh-rank" in sys.argv:  # one rank of the mesh phase
        arg = dict(zip(sys.argv[1::2], sys.argv[2::2]))
        return mesh_rank_main(int(arg["--mesh-rank"]), int(arg["--mesh-port"]),
                              arg["--mesh-dir"], arg["--mesh-out"])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import tinygpt_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global E4M3
    E4M3 = torch.float8_e4m3fn

    env = phase_env()
    t_start = time.perf_counter()
    seconds = {}

    def timed(name: str, fn, *args):
        """fn(*args), its wall seconds recorded under `name`."""
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0

    try:
        timed("build", phase_build)
        table = timed("kernels", phase_kernels, main_path_shapes())
        timed("int4", phase_int4_kernels, table)
        timed("paged", phase_paged_kernels, table)
        timed("spec_kernels", phase_spec_kernels, table)
        params = timed("model", phase_model, table)
        timed("awq", phase_awq, params)
        timed("model_fp8", phase_model_fp8, params)
        del params
        torch.cuda.empty_cache()
        params4 = timed("model4", phase_model_quant, table, 4)
        timed("serve", phase_serve, table, params4)
        timed("spec_serve", phase_spec_serve, table, params4)
        del params4
        torch.cuda.empty_cache()
        timed("int8", phase_int8_kernels, table)
        timed("model8", phase_model_quant, table, 8)
        torch.cuda.empty_cache()
        gparams = timed("gpt2", phase_gpt2, table)
        timed("gpt2_serve", phase_gpt2_serve, table, gparams)
        del gparams
        torch.cuda.empty_cache()
        timed("moe_kernels", phase_moe_kernels, table)
        params4 = timed("mixtral4", phase_mixtral, table, 4)
        timed("mixtral_serve", phase_mixtral_serve, table, params4)
        del params4
        torch.cuda.empty_cache()
        timed("mixtral8", phase_mixtral, table, 8)
        torch.cuda.empty_cache()
        timed("mixtral_bf16", phase_mixtral, table, None)
        torch.cuda.empty_cache()
        params4 = timed("qwen3", phase_dense_shape, table, "qwen3_17b", ("bf16", "int8", "int4"),
                        ("float", "int4"), SHAPE_CHECK_CHUNKS, "int4")
        timed("qwen3_serve", phase_shape_serve, table, "qwen3_17b", params4, SERVE, ("frozen",))
        del params4
        torch.cuda.empty_cache()
        timed("qwen25", phase_qwen25, table)
        timed("llama32", phase_llama32, table)
        timed("moe_8x1b", phase_mixtral, table, 4, "moe_8x1b", SHAPE_CHECK_CHUNKS)
        torch.cuda.empty_cache()
        from tinygpt_tpu_torch.ops import cuda_build

        cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        d = tempfile.mkdtemp(prefix="smoke_model_", dir=cuda_build.BUILD_DIR)
        try:
            timed("model dir", _write_model_dir, d)
            timed("engine", phase_engine, d)
            timed("evaluate", phase_evaluate, d)
            timed("server", phase_server, d)
            timed("server_sequential", phase_server, d, "sequential")
        finally:
            shutil.rmtree(d, ignore_errors=True)
        d = tempfile.mkdtemp(prefix="smoke_gpt2_", dir=cuda_build.BUILD_DIR)
        try:
            timed("gpt2 dir", _write_gpt2_dir, d)
            timed("gpt2_engine", phase_gpt2_engine, d)
            timed("gpt2_server", phase_server, d)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        d = tempfile.mkdtemp(prefix="smoke_mixtral_", dir=cuda_build.BUILD_DIR)
        try:
            timed("mixtral dir", _write_mixtral_dir, d)
            timed("mixtral_engine", phase_mixtral_engine, d)
            timed("mixtral_server", phase_server, d)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        for key, short in (("qwen3_17b", "qwen3"), ("qwen25_05b", "qwen25")):
            d = tempfile.mkdtemp(prefix=f"smoke_{short}_", dir=cuda_build.BUILD_DIR)
            try:
                timed(f"{short} dir", _write_shape_dir, d, key)
                timed(f"{short}_engine", phase_shape_engine, d, key)
                timed(f"{short}_server", phase_server, d)
            finally:
                shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()
        timed("k13", phase_k13_kernels, table)
        timed("stream", phase_stream, table)
        torch.cuda.empty_cache()
        timed("mesh", phase_mesh)
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:  # also after a failure: the phases that ran, and their seconds
        log(f"[time] all phases {time.perf_counter() - t_start:.1f} s; by phase (s): "
            + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    log("[e4m3] " + json.dumps(E4M3_ROWS))
    log(env["smi"])
    log(json.dumps({"kernels": list(table.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
