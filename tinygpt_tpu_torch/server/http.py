"""OpenAI-compatible HTTP server.

Counterpart of tinygpt_tpu/server/http.py: routes GET /v1/models,
GET /health, POST /v1/completions and POST /v1/chat/completions (SSE),
CORS, the static web UI, chat-template priority CLI > model > ChatML
fallback > chat disabled, graceful SIGINT/SIGTERM shutdown, and one
inference worker consuming a task queue: the continuous batcher over the
paged KV pool (server/api.BatchedInferenceWorker, the default), or with
--scheduler sequential one request at a time through the engine's
streaming generate_async (server/api.InferenceWorker).

    python -m tinygpt_tpu_torch.server --model DIR [--quantization int8|int4]

The engine runs on the card (ServerConfig.device="cuda") unless asked for
the CPU; int4 runs AWQ by default (--awq-calib FILE, --no-awq).
--speculative runs the batcher's n-gram speculative quanta (greedy
requests verify exactly, sampled ones by exact rejection sampling).
--mesh DP,SP,TP shards the engine and the batcher (one process a rank,
joined from the torch env; parallel/): rank 0 serves HTTP, and every rank
runs the same batcher loop on the same requests, which rank 0 hands the
others before each step (api.BatchedInferenceWorker).
"""

from __future__ import annotations

import argparse
import json
import mimetypes
import os
import signal
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional

from tinygpt_tpu_torch.engine.engine import GPTConfig, GPTEngine
from tinygpt_tpu_torch.ops.sampling import SamplerConfig
from tinygpt_tpu_torch.parallel import distributed
from tinygpt_tpu_torch.server import api
from tinygpt_tpu_torch.server.utils import BadRequest, parse_inference_params
from tinygpt_tpu_torch.tokenizer.chat_template import CHATML_TEMPLATE
from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("server.http")


@dataclass
class ServerConfig:
    """The JAX ServerConfig's fields, plus the device."""

    model_dir: str
    host: str = "0.0.0.0"
    port: int = 8080
    dtype: str = "bfloat16"
    max_tokens: int = 512
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    min_p: Optional[float] = None
    chat_template: Optional[str] = None  # literal template string
    chat_template_file: Optional[str] = None
    web_dir: Optional[str] = None
    quantization: Optional[str] = None  # None | "int8" | "int4"
    quant_group_size: Optional[int] = None  # None = auto (int4 64, int8 128)
    awq: Optional[bool] = None  # None = auto: on for int4
    awq_calib_path: Optional[str] = None  # None = the built-in corpus
    mesh_shape: Optional[tuple] = None  # (dp, sp, tp), one process a rank
    speculative: bool = False  # n-gram speculative quanta (greedy rows verify
    # by argmax prefix, sampled rows by exact rejection sampling)
    # "continuous" = paged continuous batching; "sequential" = the
    # one-request-at-a-time worker (streams through generate_async)
    scheduler: str = "continuous"
    batch_capacity: int = 8
    kv_block_size: int = 64
    kv_n_blocks: int = 1024
    prefill_chunk_tokens: int = 0  # >0: chunked prefill (tokens/step)
    device: Any = "cuda"


class TinyGPTServer:
    def __init__(self, config: ServerConfig):
        self.config = config
        self.engine: Optional[GPTEngine] = None
        self.worker = None  # api.BatchedInferenceWorker or api.InferenceWorker
        self.model_id = os.path.basename(os.path.normpath(config.model_dir))
        self.chat_enabled = False
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- startup ----------------------------------------------------------

    def prepare(self) -> None:
        cfg = self.config
        sampler = SamplerConfig(
            temperature=cfg.temperature, top_p=cfg.top_p, min_p=cfg.min_p
        )
        self.engine = GPTEngine(GPTConfig(
            model_dir=cfg.model_dir, dtype=cfg.dtype,
            max_tokens=cfg.max_tokens, sampler=sampler,
            quantization=cfg.quantization,
            quant_group_size=cfg.quant_group_size,
            awq=cfg.awq, awq_calib_path=cfg.awq_calib_path,
            mesh_shape=cfg.mesh_shape, device=cfg.device,
        ))
        self.engine.prepare()
        self._setup_chat_template()
        if cfg.scheduler == "continuous":
            from tinygpt_tpu_torch.engine.scheduler import SchedulerConfig

            max_blocks = -(-self.engine._max_context // cfg.kv_block_size)
            self.worker = api.BatchedInferenceWorker(
                self.engine,
                SchedulerConfig(
                    batch_capacity=cfg.batch_capacity,
                    block_size=cfg.kv_block_size,
                    n_blocks=cfg.kv_n_blocks,
                    max_blocks_per_seq=max_blocks,
                    dtype=cfg.dtype,
                    attn_impl=self.engine._attn_impl,
                    prefill_chunk_tokens=cfg.prefill_chunk_tokens,
                    speculative="ngram" if cfg.speculative else None,
                    mesh_shape=cfg.mesh_shape,
                ),
            )
        elif distributed.world()[1] > 1:
            raise ValueError("a mesh of several ranks serves through the "
                             "continuous batcher (--scheduler continuous)")
        else:
            self.worker = api.InferenceWorker(self.engine)
        if distributed.world()[0] == 0:  # the other ranks follow (serve_forever)
            self.worker.start()

    def _setup_chat_template(self) -> None:
        """Priority: CLI string/file > model template > ChatML fallback (if
        <|im_start|>/<|im_end|> are vocab tokens) > chat disabled."""
        tok = self.engine.ctx.tokenizer
        cfg = self.config
        template = cfg.chat_template
        if template is None and cfg.chat_template_file:
            with open(cfg.chat_template_file, "r", encoding="utf-8") as f:
                template = f.read()
        if template:
            tok.set_chat_template(template)
            self.chat_enabled = True
        elif tok.has_chat_template:
            self.chat_enabled = True
        elif tok.supports_chatml_fallback():
            tok.set_chat_template(CHATML_TEMPLATE)
            self.chat_enabled = True
            log.info("no chat template in model; using ChatML fallback")
        else:
            self.chat_enabled = False
            log.warning("chat template unavailable; chat endpoint disabled")

    def _resolve_web_dir(self) -> Optional[str]:
        if self.config.web_dir:
            return self.config.web_dir
        here = os.path.join(os.path.dirname(__file__), "web")
        return here if os.path.isdir(here) else None

    def serve_forever(self) -> None:
        """Serve HTTP; under a mesh, only rank 0 does, and every other rank
        follows its batcher plans (api.BatchedInferenceWorker.follow)."""
        if distributed.world()[0] != 0:
            self.worker.follow()
            return
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer(
            (self.config.host, self.config.port), handler
        )
        log.info("serving on %s:%d (model=%s, chat=%s)",
                 self.config.host, self.config.port, self.model_id,
                 self.chat_enabled)
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        if distributed.world()[0] != 0:
            return  # a follower ends with rank 0's last plan
        if self._httpd:
            threading.Thread(target=self._httpd.shutdown, daemon=True).start()
        if self.worker:
            self.worker.stop()


def _make_handler(server: TinyGPTServer):
    web_dir = server._resolve_web_dir()

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through our logger
            log.debug("%s " + fmt, self.address_string(), *args)

        # -- helpers ----------------------------------------------------

        def _cors(self):
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers",
                             "Content-Type, Authorization")

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self._cors()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str, etype="invalid_request_error"):
            self._json(code, {"error": {"message": message, "type": etype}})

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                raise BadRequest("empty request body")
            try:
                return json.loads(self.rfile.read(n))
            except json.JSONDecodeError as e:
                raise BadRequest(f"invalid JSON: {e}") from e

        def _stream_sse(self, frames, task):
            self.send_response(200)
            self._cors()
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                for frame in frames:
                    self.wfile.write(hex(len(frame))[2:].encode())
                    self.wfile.write(b"\r\n")
                    self.wfile.write(frame)
                    self.wfile.write(b"\r\n")
                    self.wfile.flush()
                self.wfile.write(b"0\r\n\r\n")
            except (BrokenPipeError, ConnectionResetError):
                task.abort.set()  # a client disconnect aborts generation

        # -- routes -----------------------------------------------------

        def do_OPTIONS(self):
            self.send_response(204)
            self._cors()
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            if self.path == "/v1/models":
                return self._json(200, api.models_response(
                    server.model_id, server.chat_enabled))
            if self.path in ("/health", "/healthz"):
                return self._json(200, {"status": "ok"})
            return self._static()

        def _static(self):
            if web_dir is None:
                return self._error(404, "not found")
            rel = self.path.lstrip("/") or "index.html"
            rel = os.path.normpath(rel)
            if rel.startswith(".."):
                return self._error(403, "forbidden")
            path = os.path.join(web_dir, rel)
            if not os.path.isfile(path):
                return self._error(404, "not found")
            ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
            with open(path, "rb") as f:
                data = f.read()
            self.send_response(200)
            self._cors()
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_POST(self):
            try:
                if self.path == "/v1/chat/completions":
                    return self._chat()
                if self.path == "/v1/completions":
                    return self._completions()
                return self._error(404, "not found")
            except BadRequest as e:
                return self._error(400, str(e))
            except Exception as e:  # the handler thread answers every request
                log.exception("request failed")
                return self._error(500, str(e), "internal_error")

        def _chat(self):
            if not server.chat_enabled:
                return self._error(
                    400,
                    "this model has no chat template; use /v1/completions",
                )
            body = self._read_body()
            messages = api.extract_chat_messages(body)
            params = parse_inference_params(body)
            add_gen = bool(body.get("add_generation_prompt", True))
            prompt = server.engine.apply_chat_template(
                messages, add_generation_prompt=add_gen
            )
            task = api.InferenceTask(prompt=prompt, params=params, is_chat=True)
            server.worker.submit(task)
            if params.stream:
                return self._stream_sse(
                    api.chat_sse_chunks(server.model_id, task), task
                )
            task.done.wait()
            if task.error:
                return self._error(500, task.error, "internal_error")
            return self._json(200, api.chat_response(server.model_id, task))

        def _completions(self):
            body = self._read_body()
            prompt = body.get("prompt")
            if isinstance(prompt, list):
                if not all(isinstance(p, str) for p in prompt):
                    raise BadRequest("prompt array must contain strings")
                prompt = "".join(prompt)
            if not isinstance(prompt, str):
                raise BadRequest("prompt must be a string")
            params = parse_inference_params(body)
            task = api.InferenceTask(prompt=prompt, params=params, is_chat=False)
            server.worker.submit(task)
            if params.stream:
                return self._stream_sse(
                    api.completion_sse_chunks(server.model_id, task), task
                )
            task.done.wait()
            if task.error:
                return self._error(500, task.error, "internal_error")
            return self._json(
                200, api.completion_response(server.model_id, task)
            )

    return Handler


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="tinygpt_tpu_torch.server",
        description="OpenAI-compatible inference server",
    )
    ap.add_argument("--model", required=True, help="HF model directory")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default: the card)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["float32", "float16", "bfloat16",
                             "fp32", "fp16", "bf16"])
    ap.add_argument("--max-tokens", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--min-p", type=float, default=None)
    ap.add_argument("--chat-template", default=None,
                    help="literal Jinja template string")
    ap.add_argument("--chat-template-file", default=None)
    ap.add_argument("--web-dir", default=None)
    ap.add_argument("--quantization", default=None, choices=["int8", "int4"])
    ap.add_argument("--quant-group-size", type=int, default=None,
                    help="default: 64 for int4, 128 for int8")
    ap.add_argument("--awq", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="AWQ activation-aware scaling (default: on "
                         "for int4; --no-awq forces plain RTN)")
    ap.add_argument("--awq-calib", default=None, metavar="TEXT_FILE")
    ap.add_argument("--mesh", default=None, metavar="DP,SP,TP",
                    help="device mesh, one process a rank (torchrun)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend under --mesh (default: nccl "
                         "on a CUDA device, gloo on the CPU)")
    ap.add_argument("--scheduler", default="continuous",
                    choices=["continuous", "sequential"])
    ap.add_argument("--batch-capacity", type=int, default=8)
    ap.add_argument("--kv-block-size", type=int, default=64)
    ap.add_argument("--kv-n-blocks", type=int, default=1024)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: max prompt tokens per step")
    ap.add_argument("--speculative", action="store_true",
                    help="n-gram speculative decode quanta (greedy requests "
                         "verify exactly, sampled ones via exact rejection "
                         "sampling; pays off on repetitive text)")
    args = ap.parse_args(argv)
    if args.mesh:
        # join the process group of the torch env (torchrun's)
        distributed.initialize(backend=args.dist_backend, device=args.device)

    server = TinyGPTServer(ServerConfig(
        model_dir=args.model, host=args.host, port=args.port,
        dtype=args.dtype, max_tokens=args.max_tokens,
        temperature=args.temperature, top_p=args.top_p, min_p=args.min_p,
        chat_template=args.chat_template,
        chat_template_file=args.chat_template_file,
        web_dir=args.web_dir,
        quantization=args.quantization,
        speculative=args.speculative,
        quant_group_size=args.quant_group_size,
        awq=args.awq, awq_calib_path=args.awq_calib,
        mesh_shape=(tuple(int(x) for x in args.mesh.split(","))
                    if args.mesh else None),
        scheduler=args.scheduler,
        batch_capacity=args.batch_capacity,
        kv_block_size=args.kv_block_size,
        kv_n_blocks=args.kv_n_blocks,
        prefill_chunk_tokens=args.prefill_chunk,
        device=args.device,
    ))
    server.prepare()

    def _stop(signum, frame):
        log.info("signal %d: shutting down", signum)
        server.shutdown()

    signal.signal(signal.SIGINT, _stop)
    signal.signal(signal.SIGTERM, _stop)
    server.serve_forever()


if __name__ == "__main__":
    main()
