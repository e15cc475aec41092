"""The comparison that decides `correct`.

Once the window has closed, the peak memory has been read and the
program's state is freed, a sample of the requests that finished in the
window, drawn from the seed with the longest among them, is run through
the plain fp32 reference (reference/<name>.py) once: each prompt followed
by the tokens served for it. At every served token the reference's logits
give the gap by which that token's logit lies below the reference's best;
greedy serving makes that gap 0 up to the program's rounding. The numbers
compared are the widest gap (`max_gap`) and the mean gap (`mean_gap`) over
the sample's served tokens, each against the limit that the workload file
states (`check.limits`), with how it was set in PERF.md.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def sample(requests: list, seed: int, target_tokens: int, max_requests: int) -> list:
    """Requests (dicts with prompt, tokens) drawn from the seed until their
    served tokens reach `target_tokens`: the longest first, then in the
    seed's order."""
    if not requests:
        return []
    reqs = sorted(requests, key=lambda r: r["id"])
    longest = max(reqs, key=lambda r: (len(r["prompt"]) + len(r["tokens"]), r["id"]))
    rng = np.random.default_rng(int(seed) + 1)
    out = [longest]
    n = len(longest["tokens"])
    for i in rng.permutation(len(reqs)):
        r = reqs[i]
        if n >= target_tokens or len(out) >= max_requests:
            break
        if r is not longest:
            out.append(r)
            n += len(r["tokens"])
    return out


def gaps(cfg: dict, weights: dict, chosen: list) -> np.ndarray:
    """Every served token's gap below the reference's best logit."""
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    seqs = [r["prompt"] + r["tokens"][:-1] for r in chosen]
    starts = [len(r["prompt"]) - 1 for r in chosen]
    out = []
    for r, lg in zip(chosen, ref.logits_at(cfg, weights, seqs, starts)):
        tok = torch.tensor(r["tokens"], dtype=torch.long, device=lg.device)
        best = lg.max(dim=-1).values
        out.append((best - lg.gather(1, tok[:, None])[:, 0]).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control_gaps(cfg: dict, weights: dict, chosen: list) -> np.ndarray:
    """The control's gaps on the same prompts and served tokens: at each
    position, the gap (under the fp32 reference) of the token that the
    reference in fp8 activations puts first."""
    ref = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    seqs = [r["prompt"] + r["tokens"][:-1] for r in chosen]
    starts = [len(r["prompt"]) - 1 for r in chosen]
    low = [lg.argmax(dim=-1) for lg in ref.logits_at(cfg, weights, seqs, starts, act_fp8=True)]
    out = []
    for tok, lg in zip(low, ref.logits_at(cfg, weights, seqs, starts)):
        out.append((lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def numbers(g: np.ndarray) -> dict:
    return {"max_gap": float(g.max()), "mean_gap": float(g.mean())} if g.size else {}


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {value, limit}}): every limited number at or under
    its limit; no number read is not correct."""
    checks = {k: {"value": nums.get(k), "limit": v} for k, v in limits.items()}
    ok = bool(nums) and all(c["value"] is not None and c["value"] <= c["limit"]
                            for c in checks.values())
    return ok, checks
