"""Self-contained model dirs for smoke runs and tests.

`write_metaspace_tokenizer` writes a SentencePiece-style (Metaspace + BPE
with byte fallback) `tokenizer.json` / `tokenizer_config.json` generated
in code: no tokenizer asset and no `regex` package is needed.
`write_random_model_dir` adds a config.json and random safetensors
weights in HF layout (a llama-family or a GPT-2 config), so
`GPTEngine.prepare()` can load the dir.
"""

from __future__ import annotations

import itertools
import json
import os
import string
from typing import Dict, List, Tuple

import torch

from tinygpt_tpu_torch.hf.safetensors_io import save_safetensors

SPECIALS = ("<unk>", "<s>", "</s>")  # ids 0, 1, 2
EOS_ID = 2


def metaspace_bpe_vocab(vocab_size: int) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """A deterministic vocab of `vocab_size` entries and its merges:
    the specials, the 256 byte-fallback tokens, single characters, then
    merged pieces (▁x, xy, ▁xy, xyz, ▁xyz over lowercase letters) in
    merge-rank order."""
    vocab: Dict[str, int] = {}

    def add(tok: str) -> bool:
        if len(vocab) >= vocab_size:
            return False
        vocab.setdefault(tok, len(vocab))
        return True

    for tok in SPECIALS:
        add(tok)
    for b in range(256):
        add(f"<0x{b:02X}>")
    for ch in "▁" + string.ascii_letters + string.digits + ".,!?'-":
        add(ch)
    merges: List[Tuple[str, str]] = []
    low = string.ascii_lowercase
    pairs = itertools.chain(
        (("▁", c) for c in low),
        ((a, b) for a in low for b in low),
        (("▁" + a, b) for a in low for b in low),
        ((a + b, c) for a in low for b in low for c in low),
        (("▁" + a + b, c) for a in low for b in low for c in low),
    )
    for left, right in pairs:
        if not add(left + right):
            break
        merges.append((left, right))
    return vocab, merges


def write_metaspace_tokenizer(model_dir: str, vocab_size: int) -> None:
    vocab, merges = metaspace_bpe_vocab(vocab_size)
    metaspace = {"type": "Metaspace", "replacement": "▁",
                 "prepend_scheme": "first", "split": False}
    tokenizer = {
        "version": "1.0",
        "added_tokens": [
            {"id": i, "content": t, "special": True, "lstrip": False,
             "rstrip": False, "normalized": False, "single_word": False}
            for i, t in enumerate(SPECIALS)
        ],
        "normalizer": None,
        "pre_tokenizer": metaspace,
        "post_processor": None,
        "decoder": {"type": "Sequence", "decoders": [
            metaspace, {"type": "ByteFallback"}, {"type": "Fuse"}]},
        "model": {"type": "BPE", "unk_token": "<unk>", "byte_fallback": True,
                  "fuse_unk": True, "vocab": vocab,
                  "merges": [f"{a} {b}" for a, b in merges]},
    }
    config = {"bos_token": "<s>", "eos_token": "</s>", "unk_token": "<unk>",
              "add_bos_token": True, "add_eos_token": False}
    with open(os.path.join(model_dir, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tokenizer, f, ensure_ascii=False)
    with open(os.path.join(model_dir, "tokenizer_config.json"), "w",
              encoding="utf-8") as f:
        json.dump(config, f)


def random_hf_weights(hf_config: dict, seed: int = 0,
                      dtype: torch.dtype = torch.bfloat16,
                      device="cpu") -> Dict[str, torch.Tensor]:
    """Random weights under HF names, N(0, 0.02²) with unit norms, for a
    config.json dict: a llama family's ([out, in] projections) or GPT-2's
    (under `transformer.`, Conv1D weights [in, out], biases N(0, 0.02²)
    too). The head row of EOS (lm_head's, or GPT-2's tied wte row) is
    zero, so a random model never stops early under greedy decoding (its
    logit is 0, far below the maximum over the vocab)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if hf_config.get("model_type") == "gpt2":
        return _gpt2_weights(hf_config, gen, dtype, device)
    H = hf_config["hidden_size"]
    I = hf_config["intermediate_size"]
    V = hf_config["vocab_size"]
    Nq = hf_config["num_attention_heads"]
    Nk = hf_config.get("num_key_value_heads") or Nq
    D = hf_config.get("head_dim") or H // Nq

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    out = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": ones(H)}
    if not hf_config.get("tie_word_embeddings", False):
        head = w(V, H)
        head[EOS_ID] = 0
        out["lm_head.weight"] = head
    for i in range(hf_config["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out.update({
            p + "input_layernorm.weight": ones(H),
            p + "post_attention_layernorm.weight": ones(H),
            p + "self_attn.q_proj.weight": w(Nq * D, H),
            p + "self_attn.k_proj.weight": w(Nk * D, H),
            p + "self_attn.v_proj.weight": w(Nk * D, H),
            p + "self_attn.o_proj.weight": w(H, Nq * D),
            p + "mlp.gate_proj.weight": w(I, H),
            p + "mlp.up_proj.weight": w(I, H),
            p + "mlp.down_proj.weight": w(H, I),
        })
    return out


def _gpt2_weights(hf_config: dict, gen: torch.Generator, dtype: torch.dtype,
                  device) -> Dict[str, torch.Tensor]:
    H = hf_config["n_embd"]
    I = hf_config.get("n_inner") or 4 * H
    V, P = hf_config["vocab_size"], hf_config["n_positions"]

    def w(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dtype)

    def ones(n):
        return torch.ones(n, dtype=dtype, device=device)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    wte = w(V, H)
    wte[EOS_ID] = 0
    t = "transformer."
    out = {t + "wte.weight": wte, t + "wpe.weight": w(P, H),
           t + "ln_f.weight": ones(H), t + "ln_f.bias": zeros(H)}
    for i in range(hf_config["n_layer"]):
        p = f"{t}h.{i}."
        out.update({
            p + "ln_1.weight": ones(H), p + "ln_1.bias": zeros(H),
            p + "attn.c_attn.weight": w(H, 3 * H), p + "attn.c_attn.bias": w(3 * H),
            p + "attn.c_proj.weight": w(H, H), p + "attn.c_proj.bias": w(H),
            p + "ln_2.weight": ones(H), p + "ln_2.bias": zeros(H),
            p + "mlp.c_fc.weight": w(H, I), p + "mlp.c_fc.bias": w(I),
            p + "mlp.c_proj.weight": w(I, H), p + "mlp.c_proj.bias": w(H),
        })
    return out


def write_random_model_dir(model_dir: str, hf_config: dict, seed: int = 0,
                           dtype: torch.dtype = torch.bfloat16,
                           device="cpu") -> str:
    """config.json + model.safetensors (random, see random_hf_weights) +
    the generated Metaspace-BPE tokenizer."""
    os.makedirs(model_dir, exist_ok=True)
    cfg = dict(hf_config)
    cfg.setdefault("torch_dtype", str(dtype).replace("torch.", ""))
    cfg.setdefault("bos_token_id", 1)
    cfg.setdefault("eos_token_id", EOS_ID)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg, f)
    save_safetensors(os.path.join(model_dir, "model.safetensors"),
                     random_hf_weights(cfg, seed, dtype, device))
    write_metaspace_tokenizer(model_dir, cfg["vocab_size"])
    return model_dir
