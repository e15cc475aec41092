"""OpenAI protocol handlers.

Counterpart of tinygpt_tpu/server/api.py: /v1/models with capability
flags, chat request parsing (string or multimodal text-part arrays),
SSE streaming (role chunk → delta chunks → final chunk with finish_reason
+ usage → data: [DONE]), stop-string hold-back buffering, client-
disconnect abort, and usage token accounting.

HTTP threads enqueue InferenceTasks; one worker thread owns the engine.
BatchedInferenceWorker (the server's default) runs the continuous batcher
(engine/scheduler.py) over the paged KV pool, so concurrent requests
share decode quanta. InferenceWorker (scheduler="sequential") serves one
request at a time through the engine's streaming generate_async.

Under a mesh of several ranks (one process each) rank 0 serves HTTP and
the batcher's loop runs on every rank in lockstep: before each batcher
step rank 0 broadcasts the step's plan (the requests it added and the
ones it cancelled since the last step), and every other rank applies the
same plan and steps (BatchedInferenceWorker.follow). While idle, rank 0
broadcasts an empty plan every IDLE_PLAN_S seconds.
"""

from __future__ import annotations

import json
import queue
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from tinygpt_tpu_torch.engine.engine import FinishReason, GPTEngine
from tinygpt_tpu_torch.parallel import distributed
from tinygpt_tpu_torch.server.utils import (
    BadRequest,
    InferenceParams,
    StopStringStreamer,
)
from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("server.api")

# seconds between two empty plans that an idle rank 0 sends its followers
IDLE_PLAN_S = 30.0


@dataclass
class InferenceTask:
    """One queued generation."""

    prompt: str
    params: InferenceParams
    is_chat: bool
    # streaming: the worker pushes text chunks (or (text, release_at)
    # paced slots), then the None sentinel
    chunks: "queue.Queue" = field(default_factory=queue.Queue)
    abort: threading.Event = field(default_factory=threading.Event)
    # filled by the worker on completion
    result_text: str = ""
    finish_reason: str = "length"
    completion_tokens: int = 0
    prompt_tokens: int = 0
    error: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)


class InferenceWorker:
    """The one-request-at-a-time worker (ServerConfig.scheduler=
    "sequential"): one thread owns the engine, reconfigures it for each
    request and streams it through GPTEngine.generate_async, stop strings
    held back by a StopStringStreamer; a set abort (client disconnect) or
    a matched stop string ends the stream."""

    def __init__(self, engine: GPTEngine):
        self.engine = engine
        self.tasks: "queue.Queue[Optional[InferenceTask]]" = queue.Queue()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self.tasks.put(None)
        self._thread.join(timeout=30)

    def submit(self, task: InferenceTask) -> None:
        self.tasks.put(task)

    def _run(self) -> None:
        while True:
            task = self.tasks.get()
            if task is None:
                return
            try:
                self._process(task)
            except Exception as e:  # surface errors to the waiting thread
                log.exception("inference task failed")
                task.error = str(e)
            finally:
                task.chunks.put(None)
                task.done.set()

    def _process(self, task: InferenceTask) -> None:
        p = task.params
        self.engine.reconfigure(
            sampler=p.sampler,
            max_tokens=p.max_tokens or self.engine.config.max_tokens,
            extra_stop_token_ids=p.stop_token_ids,
        )
        task.prompt_tokens = len(self.engine.ctx.tokenizer.encode(task.prompt))
        stopper = StopStringStreamer(p.stop, p.include_stop_str_in_output)
        emitted: List[str] = []

        def cb(chunk: str, finished: bool) -> bool:
            if task.abort.is_set():
                return False
            if chunk:
                out = stopper.push(chunk)
                if out:
                    emitted.append(out)
                    task.chunks.put(out)
                if stopper.stopped:
                    return False
            return True

        out = self.engine.generate_async(task.prompt, cb)
        if not stopper.stopped and not task.abort.is_set():
            tail = stopper.flush()
            if tail:
                emitted.append(tail)
                task.chunks.put(tail)
        task.result_text = "".join(emitted)
        task.completion_tokens = len(out.token_ids)
        if task.abort.is_set():
            task.finish_reason = "abort"
        elif stopper.stopped or out.finish_reason == FinishReason.STOP:
            task.finish_reason = "stop"
        else:
            task.finish_reason = "length"


class BatchedInferenceWorker:
    """Continuous-batching worker: requests join a shared paged decode
    quantum mid-flight instead of running one at a time."""

    def __init__(self, engine: GPTEngine, scheduler_config=None):
        from tinygpt_tpu_torch.engine.scheduler import (
            ContinuousBatcher,
            SchedulerConfig,
        )

        self.engine = engine
        ctx = engine.ctx
        sc = scheduler_config or SchedulerConfig(
            dtype=engine.config.dtype, attn_impl=engine._attn_impl,
        )
        # raises for a model without decode_paged_steps or forward_paged
        self.batcher = ContinuousBatcher(
            ctx.model, ctx.model_config, ctx.params,
            eos_ids=engine._eos_ids, config=sc,
        )
        self.incoming: "queue.Queue[Optional[InferenceTask]]" = queue.Queue()
        # under a mesh of several ranks: what the next plan hands the others
        self._spmd = distributed.world()[1] > 1
        self._plan_add: List = []
        self._plan_cancel: List[int] = []
        self._by_rid: Dict[int, dict] = {}
        self._next_rid = 0
        self._stopping = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        # stream pacing across quantum bursts: a decode quantum hands a row
        # up to decode_quantum tokens at once; release them to the SSE
        # writer at the measured per-step production rate instead (the
        # tokens were produced that fast; the SSE thread does the
        # sleeping, never this worker loop)
        self._last_emit_t: Optional[float] = None
        self._min_qgap = float("inf")
        self._tok_dt = 0.0

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stopping = True
        self.incoming.put(None)
        self._thread.join(timeout=30)

    def submit(self, task: InferenceTask) -> None:
        self.incoming.put(task)

    def _admit(self, task: InferenceTask) -> None:
        from tinygpt_tpu_torch.engine.scheduler import Request

        tok = self.engine.ctx.tokenizer
        rid = self._next_rid
        self._next_rid += 1
        p = task.params
        prompt_ids = tok.encode(task.prompt)
        task.prompt_tokens = len(prompt_ids)
        req = Request(
            request_id=rid,
            prompt_ids=prompt_ids,
            max_new_tokens=p.max_tokens or self.engine.config.max_tokens,
            sampler=p.sampler,
            stop_token_ids=set(p.stop_token_ids),
        )
        self._by_rid[rid] = {
            "task": task,
            "req": req,
            "stream": tok.decode_stream(skip_special_tokens=True),
            "stopper": StopStringStreamer(
                p.stop, p.include_stop_str_in_output
            ),
            "n_tokens": 0,
            "emitted": [],
        }
        self.batcher.add_request(req)
        if self._spmd:
            self._plan_add.append(req)

    def _finish(self, rid: int, reason: str) -> None:
        st = self._by_rid.pop(rid, None)
        if st is None:
            return
        task = st["task"]
        if not st["stopper"].stopped:
            tail = st["stopper"].push(st["stream"].flush())
            tail += st["stopper"].flush()
            if tail:
                st["emitted"].append(tail)
                task.chunks.put(tail)
        task.result_text = "".join(st["emitted"])
        task.completion_tokens = st["n_tokens"]
        task.finish_reason = (
            "stop" if st["stopper"].stopped else reason
        )
        task.chunks.put(None)
        task.done.set()

    def _handle_event(self, ev, now: float = 0.0, counts=None) -> None:
        st = self._by_rid.get(ev.request_id)
        if st is None:
            return
        task = st["task"]
        if task.abort.is_set():
            self._cancel(ev.request_id)
            self._finish(ev.request_id, "abort")
            return
        if ev.token_id is not None:
            st["n_tokens"] += 1
            idx = 0
            if counts is not None:
                idx = counts.get(ev.request_id, 0)
                counts[ev.request_id] = idx + 1
            chunk = st["stream"].step(ev.token_id)
            if chunk:
                out = st["stopper"].push(chunk)
                if out:
                    st["emitted"].append(out)
                    if idx and self._tok_dt:
                        # paced slot within this quantum's burst
                        task.chunks.put((out, now + idx * self._tok_dt))
                    else:
                        task.chunks.put(out)
                if st["stopper"].stopped:
                    self._cancel(ev.request_id)
                    self._finish(ev.request_id, "stop")
                    return
        if ev.finished:
            self._finish(ev.request_id, ev.finish_reason or "length")

    def _cancel(self, rid: int) -> None:
        self.batcher.cancel(rid)
        if self._spmd:
            self._plan_cancel.append(rid)

    def _send_plan(self, step: bool, stop: bool = False) -> None:
        """Rank 0: hand the other ranks what changed since the last plan."""
        if not self._spmd:
            return
        plan = {"add": self._plan_add, "cancel": self._plan_cancel, "step": step,
                "stop": stop}
        self._plan_add, self._plan_cancel = [], []
        distributed.broadcast_object(plan, src=0)

    def follow(self) -> None:
        """A rank other than 0: apply rank 0's plans and step the batcher
        with it, until rank 0 stops. Its events are rank 0's to deliver."""
        from tinygpt_tpu_torch.engine.scheduler import Request

        while True:
            plan = distributed.broadcast_object(None, src=0)
            for rid in plan["cancel"]:
                self.batcher.cancel(rid)
            for req in plan["add"]:
                self.batcher.add_request(Request(
                    request_id=req.request_id, prompt_ids=list(req.prompt_ids),
                    max_new_tokens=req.max_new_tokens, sampler=req.sampler,
                    stop_token_ids=set(req.stop_token_ids)))
            if plan["stop"]:
                return
            if plan["step"]:
                self.batcher.step()

    def _run(self) -> None:
        try:
            self._loop()
        finally:
            self._send_plan(step=False, stop=True)

    def _loop(self) -> None:
        while not self._stopping:
            # block when idle; drain opportunistically when busy
            try:
                if self.batcher.has_work:
                    task = self.incoming.get_nowait()
                elif self._spmd:
                    task = self.incoming.get(timeout=IDLE_PLAN_S)
                else:
                    task = self.incoming.get()
                if task is None:
                    return
                self._admit(task)
                continue  # favour admitting everything waiting first
            except queue.Empty:
                if not self.batcher.has_work:
                    self._send_plan(step=False)  # idle: keep the others waiting
                    continue
            try:
                self._send_plan(step=True)
                events = list(self.batcher.step())
                now = time.monotonic()
                per_rid: Dict[int, int] = {}
                for ev in events:
                    if ev.token_id is not None:
                        per_rid[ev.request_id] = per_rid.get(
                            ev.request_id, 0) + 1
                if per_rid:
                    if self._last_emit_t is not None:
                        gap = now - self._last_emit_t
                        self._min_qgap = min(self._min_qgap, gap)
                        # divide by the most tokens any row emits in THIS
                        # burst, so that idx * tok_dt stays inside the
                        # measured production span
                        q = max(max(per_rid.values()), 1)
                        self._tok_dt = min(
                            1.15 * self._min_qgap / q,
                            0.98 * self._min_qgap / max(1, q - 1),
                            0.25)
                    self._last_emit_t = now
                counts: Dict[int, int] = {}
                for ev in events:
                    self._handle_event(ev, now, counts)
            except Exception as e:  # the worker must outlive a failed step
                log.exception("batched step failed")
                for rid in list(self._by_rid):
                    self._by_rid[rid]["task"].error = str(e)
                    self._finish(rid, "error")


# -- request parsing ---------------------------------------------------------


def extract_chat_messages(body: dict) -> List[Dict[str, str]]:
    """Parse `messages`, accepting string content or multimodal arrays of
    {"type": "text", "text": ...} parts."""
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise BadRequest("messages must be a non-empty array")
    out = []
    for m in messages:
        if not isinstance(m, dict) or "role" not in m:
            raise BadRequest("each message needs a role")
        content = m.get("content", "")
        if isinstance(content, list):
            parts = []
            for part in content:
                if isinstance(part, dict) and part.get("type") == "text":
                    parts.append(part.get("text", ""))
                else:
                    raise BadRequest("only text content parts are supported")
            content = "".join(parts)
        elif not isinstance(content, str):
            raise BadRequest("message content must be a string or array")
        out.append({"role": str(m["role"]), "content": content})
    return out


# -- response builders --------------------------------------------------------


def _now() -> int:
    return int(time.time())


def _usage(task: InferenceTask) -> dict:
    return {
        "prompt_tokens": task.prompt_tokens,
        "completion_tokens": task.completion_tokens,
        "total_tokens": task.prompt_tokens + task.completion_tokens,
    }


def models_response(model_id: str, chat_enabled: bool) -> dict:
    """GET /v1/models with capability flags."""
    return {
        "object": "list",
        "data": [{
            "id": model_id,
            "object": "model",
            "created": _now(),
            "owned_by": "tinygpt_tpu",
            "capabilities": {
                "completions": True,
                "chat_completions": chat_enabled,
            },
        }],
    }


def completion_response(model_id: str, task: InferenceTask) -> dict:
    return {
        "id": f"cmpl-{uuid.uuid4().hex[:24]}",
        "object": "text_completion",
        "created": _now(),
        "model": model_id,
        "choices": [{
            "index": 0,
            "text": task.result_text,
            "finish_reason": task.finish_reason,
        }],
        "usage": _usage(task),
    }


def chat_response(model_id: str, task: InferenceTask) -> dict:
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": _now(),
        "model": model_id,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": task.result_text},
            "finish_reason": task.finish_reason,
        }],
        "usage": _usage(task),
    }


def sse(data: dict) -> bytes:
    return f"data: {json.dumps(data, ensure_ascii=False)}\n\n".encode("utf-8")


SSE_DONE = b"data: [DONE]\n\n"


def _next_chunk(task: InferenceTask) -> Optional[str]:
    """Pop the next stream chunk, honouring a (text, release_at) paced
    slot from the batched worker — the sleep runs on this per-connection
    SSE thread, never in the scheduler loop. Tokens are only ever delayed
    to the rate they were measured to be produced at."""
    item = task.chunks.get()
    if isinstance(item, tuple):
        text, release_at = item
        wait = release_at - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        return text
    return item


def chat_sse_chunks(model_id: str, task: InferenceTask):
    """Generator of SSE byte frames for a streaming chat completion: role
    chunk, delta chunks, final chunk with finish_reason + usage, [DONE]."""
    cid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
    base = {
        "id": cid, "object": "chat.completion.chunk",
        "created": _now(), "model": model_id,
    }
    yield sse({**base, "choices": [{
        "index": 0, "delta": {"role": "assistant"}, "finish_reason": None}]})
    while True:
        chunk = _next_chunk(task)
        if chunk is None:
            break
        yield sse({**base, "choices": [{
            "index": 0, "delta": {"content": chunk}, "finish_reason": None}]})
    yield sse({
        **base,
        "choices": [{"index": 0, "delta": {},
                     "finish_reason": task.finish_reason}],
        "usage": _usage(task),
    })
    yield SSE_DONE


def completion_sse_chunks(model_id: str, task: InferenceTask):
    cid = f"cmpl-{uuid.uuid4().hex[:24]}"
    base = {
        "id": cid, "object": "text_completion",
        "created": _now(), "model": model_id,
    }
    while True:
        chunk = _next_chunk(task)
        if chunk is None:
            break
        yield sse({**base, "choices": [{
            "index": 0, "text": chunk, "finish_reason": None}]})
    yield sse({
        **base,
        "choices": [{"index": 0, "text": "",
                     "finish_reason": task.finish_reason}],
        "usage": _usage(task),
    })
    yield SSE_DONE
