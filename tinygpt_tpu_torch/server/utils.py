"""Server-side text utilities.

Counterpart of tinygpt_tpu/server/utils.py (a copy: this package imports
nothing of the JAX package): stop-string streaming (strings are already
valid UTF-8 — chunks come from the tokenizer's UTF-8-safe stream — so the
hold-back guards stop-string buffering), earliest-match stop-string
truncation, and sampling-parameter parsing/validation from OpenAI request
bodies.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from tinygpt_tpu_torch.ops.sampling import SamplerConfig


def check_stop_strings(
    text: str, stops: List[str]
) -> Tuple[Optional[int], Optional[str]]:
    """Earliest match across all stop strings (reference:
    ServerUtils.cpp:61-85). Returns (index, matched) or (None, None)."""
    best: Optional[int] = None
    which: Optional[str] = None
    for s in stops:
        if not s:
            continue
        i = text.find(s)
        if i != -1 and (best is None or i < best):
            best, which = i, s
    return best, which


class StopStringStreamer:
    """Streaming stop-string machinery (reference: ApiHandler.cpp:239-353):
    hold back max(len(stop)) - 1 chars so a stop string split across chunks
    is still caught; emit only text that can no longer be part of a match."""

    def __init__(self, stops: List[str], include_stop: bool = False):
        self.stops = [s for s in stops if s]
        self.include_stop = include_stop
        self.hold = max((len(s) for s in self.stops), default=1) - 1
        self.buf = ""
        self.stopped = False
        self.matched: Optional[str] = None

    def push(self, chunk: str) -> str:
        """Feed a chunk; returns text safe to emit now."""
        if self.stopped:
            return ""
        self.buf += chunk
        idx, which = check_stop_strings(self.buf, self.stops)
        if idx is not None:
            self.stopped = True
            self.matched = which
            out = self.buf[: idx + len(which)] if self.include_stop else self.buf[:idx]
            self.buf = ""
            return out
        if self.hold and len(self.buf) > self.hold:
            out, self.buf = self.buf[: -self.hold], self.buf[-self.hold:]
            return out
        if not self.hold:
            out, self.buf = self.buf, ""
            return out
        return ""

    def flush(self) -> str:
        if self.stopped:
            return ""
        out, self.buf = self.buf, ""
        return out


@dataclass
class InferenceParams:
    """Per-request knobs parsed from an OpenAI request body (reference:
    ServerUtils.cpp:95-143)."""

    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    max_tokens: Optional[int] = None
    stream: bool = False
    stop: List[str] = field(default_factory=list)
    stop_token_ids: List[int] = field(default_factory=list)
    include_stop_str_in_output: bool = False


class BadRequest(ValueError):
    pass


def parse_inference_params(body: dict) -> InferenceParams:
    def num(name, lo=None, hi=None):
        v = body.get(name)
        if v is None:
            return None
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            raise BadRequest(f"{name} must be a number")
        if lo is not None and v < lo:
            raise BadRequest(f"{name} must be >= {lo}")
        if hi is not None and v > hi:
            raise BadRequest(f"{name} must be <= {hi}")
        return v

    temperature = num("temperature", 0.0, 2.0)
    top_p = num("top_p", 0.0, 1.0)
    min_p = num("min_p", 0.0, 1.0)
    top_k = body.get("top_k")
    if top_k is not None and (not isinstance(top_k, int) or top_k < 0):
        raise BadRequest("top_k must be a non-negative integer")

    max_tokens = body.get("max_completion_tokens", body.get("max_tokens"))
    if max_tokens is not None and (
        not isinstance(max_tokens, int) or max_tokens <= 0
    ):
        raise BadRequest("max_tokens must be a positive integer")

    stop = body.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    if not isinstance(stop, list) or not all(isinstance(s, str) for s in stop):
        raise BadRequest("stop must be a string or list of strings")

    stop_token_ids = body.get("stop_token_ids") or []
    if not isinstance(stop_token_ids, list) or not all(
        isinstance(i, int) for i in stop_token_ids
    ):
        raise BadRequest("stop_token_ids must be a list of integers")

    sampler = SamplerConfig(
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        min_p=min_p,
    )
    return InferenceParams(
        sampler=sampler,
        max_tokens=max_tokens,
        stream=bool(body.get("stream", False)),
        stop=stop,
        stop_token_ids=stop_token_ids,
        include_stop_str_in_output=bool(
            body.get("include_stop_str_in_output", False)
        ),
    )
