"""Perplexity evaluation: the quality check of the quantized paths.

    python -m tinygpt_tpu_torch.evaluate --model DIR --text FILE
        [--quantization int8|int4] [--device cuda|cpu]

Counterpart of tinygpt_tpu/evaluate.py. Sliding-window teacher forcing:
the text is tokenized once, split into windows of `window` tokens
advanced by `stride`; within each window only the last `stride`
positions contribute NLL (the preceding tokens are context), so every
token is predicted with at least `window - stride` tokens of history,
and every token after the first is counted exactly once.

On the card each window's forward takes the kernel route (K1 over the
window; K5a or K5b for the quantized layer matmuls, K3 or K4 for the
head); on the CPU, or with `--impl plain`, the plain versions.
`kv_dtype=torch.float8_e4m3fn` (`--kv-cache-dtype fp8`) stores each
window's KV cache in e4m3: the quality check of the fp8 KV cache.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from tinygpt_tpu_torch.engine.engine import quantize_loaded
from tinygpt_tpu_torch.engine.kv_cache import create_kv_cache
from tinygpt_tpu_torch.hf.config import ModelConfig
from tinygpt_tpu_torch.hf.loader import load_model_dir
from tinygpt_tpu_torch.models import params_device, params_dtype
from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("evaluate")


def window_nll(
    model,
    cfg: ModelConfig,
    params,
    token_ids: Sequence[int],
    window: int = 512,
    stride: int = 256,
    attn_impl: str = "kernel",
    kv_dtype: Optional[torch.dtype] = None,  # None: the params' compute dtype;
                                             # float8_e4m3fn: the fp8 KV cache
) -> tuple:
    """Returns (total_nll, n_scored_tokens) over the token stream."""
    ids = np.asarray(token_ids, dtype=np.int64)
    n = len(ids)
    if n < 2:
        raise ValueError("need at least 2 tokens to score")
    dev = params_device(params)
    if kv_dtype is None:
        # K1 reads the cache in q's dtype; the JAX package's fp32 cache
        # holds the same values, since k and v are computed in this dtype
        kv_dtype = params_dtype(params)
    window = min(window, cfg.context_size, n)
    stride = min(stride, window)

    @torch.inference_mode()
    def score(chunk: np.ndarray, n_score: int) -> float:
        """NLL of the last `n_score` next-token predictions in `chunk`."""
        S = chunk.shape[0]
        toks = torch.from_numpy(chunk).to(dev)
        cache = create_kv_cache(cfg, 1, window, dtype=kv_dtype, device=dev)
        pos = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        logits, _ = model.forward(params, cfg, toks[None, :].to(torch.int32), cache,
                                  pos, torch.ones((1, S), dtype=torch.bool, device=dev),
                                  attn_impl=attn_impl)
        logp = torch.log_softmax(logits[0, :-1].float(), dim=-1)
        tok_nll = -logp.gather(-1, toks[1:, None])[:, 0]
        # score only the trailing n_score predictions (all S - 1 when
        # n_score = S, as with stride == window, where the window's first
        # token is counted but has no context to be predicted from: the
        # JAX package's count, kept)
        return float(tok_nll[max(S - 1 - n_score, 0) :].sum())

    total_nll = 0.0
    total_tokens = 0
    start = 0
    prev_end = 1  # first token can't be scored
    while prev_end < n:
        end = min(start + window, n)
        chunk = ids[start:end]
        n_score = end - prev_end
        if len(chunk) < window:
            # pad the tail window on the left with earlier context
            start = max(0, n - window)
            chunk = ids[start:n]
            n_score = n - prev_end
        total_nll += score(chunk, n_score)
        total_tokens += n_score
        prev_end = end
        start += stride
        if end >= n:
            break
    return total_nll, total_tokens


def perplexity(model, cfg, params, token_ids, window=512, stride=256,
               attn_impl: str = "kernel", kv_dtype=None) -> float:
    nll, n = window_nll(model, cfg, params, token_ids, window, stride,
                        attn_impl, kv_dtype=kv_dtype)
    return math.exp(nll / max(n, 1))


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tinygpt_tpu_torch.evaluate",
        description="perplexity over a text file",
    )
    ap.add_argument("--model", required=True)
    ap.add_argument("--text", required=True, help="UTF-8 text file")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    ap.add_argument("--impl", default="kernel", choices=["kernel", "plain"],
                    help="kernel route, or the kernels' plain versions "
                         "(a reference for the kernel route on the card)")
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--stride", type=int, default=256)
    ap.add_argument("--max-tokens", type=int, default=0,
                    help="truncate the eval stream (0 = all)")
    ap.add_argument("--quantization", default=None,
                    choices=["int8", "int4"])
    ap.add_argument("--quant-group-size", type=int, default=None,
                    help="default: 64 for int4, 128 for int8")
    ap.add_argument("--awq", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="AWQ scaling before quantization (default: on "
                         "for int4; calibrate on held-out text with "
                         "--awq-calib, not on the eval file)")
    ap.add_argument("--awq-calib", default=None, metavar="TEXT_FILE",
                    help="calibration text for --awq (default: built-in)")
    ap.add_argument("--kv-cache-dtype", default="auto", choices=["auto", "fp8"],
                    help="KV cache storage: the compute dtype, or fp8 (e4m3)")
    args = ap.parse_args(argv)

    ctx = load_model_dir(args.model, dtype=args.dtype, device=args.device)
    params = ctx.params
    if args.quantization:
        params = quantize_loaded(ctx, args.quantization, args.quant_group_size,
                                 args.awq, args.awq_calib)
    with open(args.text, "r", encoding="utf-8") as f:
        text = f.read()
    ids = ctx.tokenizer.encode(text)
    if args.max_tokens:
        ids = ids[: args.max_tokens]
    log.info("scoring %d tokens (window %d, stride %d)",
             len(ids), args.window, args.stride)
    ppl = perplexity(ctx.model, ctx.model_config, params, ids,
                     window=args.window, stride=args.stride,
                     attn_impl=args.impl,
                     kv_dtype=torch.float8_e4m3fn if args.kv_cache_dtype == "fp8" else None)
    print(f"perplexity: {ppl:.4f} over {len(ids)} tokens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
