"""Streaming in the port, on the CPU: GPTEngine.generate_async (the
chunked route and, at stream_chunk 1, the per-token route through
decode_step), the CLI's --stream, and the server's sequential worker
(scheduler="sequential"), against the JAX package's on the same model dir
(a tiny random llama in fp32 with the generated Metaspace-BPE tokenizer of
tinygpt_tpu_torch.utils.fixtures), mirroring tests/test_engine.py's
streaming tests and tests/test_server.py's sequential mode.

Greedy decoding: the same token ids from both engines, and the streamed
text chunks joined equal to generate_sync's text. A sampled stream equals
the port's own generate_sync at the same seed and chunk (torch.Generator
and jax.random draw different numbers, so never JAX's)."""

import concurrent.futures
import http.server
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from tinygpt_tpu.engine.engine import FinishReason as JFinishReason
from tinygpt_tpu.engine.engine import GPTConfig as JGPTConfig
from tinygpt_tpu.engine.engine import GPTEngine as JGPTEngine
from tinygpt_tpu.server.http import ServerConfig as JServerConfig
from tinygpt_tpu.server.http import TinyGPTServer as JTinyGPTServer
from tinygpt_tpu.server.http import _make_handler as j_make_handler
from tinygpt_tpu_torch import cli
from tinygpt_tpu_torch.engine import engine as engine_mod
from tinygpt_tpu_torch.engine.engine import FinishReason, GPTConfig, GPTEngine
from tinygpt_tpu_torch.ops.sampling import SamplerConfig
from tinygpt_tpu_torch.server.http import ServerConfig, TinyGPTServer, _make_handler
from tinygpt_tpu_torch.tokenizer.chat_template import CHATML_TEMPLATE
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

TINY_LLAMA = dict(model_type="llama", vocab_size=503, hidden_size=64,
                  intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=256, rms_norm_eps=1e-5)
PROMPT = "the quick brown fox jumps over the lazy dog"
KW = dict(dtype="float32", max_tokens=20, prefill_bucket=16, decode_chunk=4)
ROUTES = [(1, False), (1, True), (8, False), (8, True)]  # (stream_chunk, stream_pace)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_stream_llama")
    return write_random_model_dir(str(d), TINY_LLAMA, seed=11, dtype=torch.float32)


def _engine(model_dir, **kw):
    eng = GPTEngine(GPTConfig(model_dir=model_dir, device="cpu", **dict(KW, **kw)))
    eng.prepare()
    return eng


def _jengine(model_dir, **kw):
    eng = JGPTEngine(JGPTConfig(model_dir=model_dir, **dict(KW, **kw)))
    eng.prepare()
    return eng


def _stream(eng, prompt=PROMPT):
    calls = []
    out = eng.generate_async(prompt, lambda c, done: (calls.append((c, done)), True)[1])
    return out, calls


@pytest.fixture(scope="module")
def jax_stream(model_dir):
    return _stream(_jengine(model_dir))


@pytest.mark.parametrize("chunk,pace", ROUTES)
def test_generate_async_matches_jax_and_sync(model_dir, jax_stream, chunk, pace):
    """Greedy: the JAX stream's tokens and text; the chunks joined are
    generate_sync's text (at its decode_chunk, which takes the other
    route at chunk 1); the final flush comes last, with finished=True."""
    eng = _engine(model_dir, stream_chunk=chunk, stream_pace=pace)
    out, calls = _stream(eng)
    jout, jcalls = jax_stream
    sync = eng.generate_sync([PROMPT])[0]
    assert out.token_ids == jout.token_ids == sync.token_ids
    assert len(out.token_ids) == KW["max_tokens"]
    assert out.finish_reason is FinishReason.LENGTH
    assert "".join(c for c, _ in calls) == sync.text == out.text == jout.text
    assert [d for _, d in calls] == [False] * (len(calls) - 1) + [True]
    assert [c for c, _ in calls] == [c for c, _ in jcalls]


def test_stream_chunk_one_takes_the_per_token_route(model_dir, monkeypatch):
    """stream_chunk 1 runs decode_step once a token and decode_steps never;
    stream_chunk 8 runs decode_steps in chunks of 8."""
    eng = _engine(model_dir, stream_chunk=1)
    model = eng.ctx.model
    counts = {"decode_step": 0, "decode_steps": 0}
    for name in counts:
        real = getattr(model, name)

        def counting(*a, _real=real, _name=name, **kw):
            counts[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(model, name, counting)
    out, _ = _stream(eng)
    assert counts == {"decode_step": len(out.token_ids) - 1, "decode_steps": 0}
    eng.config.stream_chunk = 8
    counts.update(decode_step=0, decode_steps=0)
    _stream(eng)
    assert counts == {"decode_step": 0, "decode_steps": -(-(KW["max_tokens"] - 1) // 8)}


def test_sampled_stream_equals_sync_at_the_same_seed_and_chunk(model_dir):
    sampler = SamplerConfig(temperature=1.0, top_k=20)
    for chunk in (1, 8):
        toks = []
        for mode in ("sync", "async"):
            eng = _engine(model_dir, seed=5, stream_chunk=chunk, decode_chunk=chunk)
            eng.reconfigure(sampler=sampler)
            if mode == "sync":
                toks.append(eng.generate_sync([PROMPT])[0].token_ids)
            else:
                toks.append(_stream(eng)[0].token_ids)
        assert toks[0] == toks[1], chunk


@pytest.mark.parametrize("chunk", [1, 8])
def test_abort_emits_nothing_after_false(model_dir, chunk):
    """The callback returns False at its third text chunk, while chunks are
    launched ahead: no callback after it, no final flush, ABORT; the
    tokens are the stream's prefix. Aborting at the first text chunk keeps
    the tokens up to the first that completes a character, as
    tests/test_engine.py's test_streaming_abort."""
    eng = _engine(model_dir, stream_chunk=chunk)
    full, _ = _stream(eng)
    calls = []

    def cb(c, done):
        calls.append((c, done))
        return len(calls) < 3

    out = eng.generate_async(PROMPT, cb)
    assert out.finish_reason is FinishReason.ABORT
    assert len(calls) == 3 and not any(d for _, d in calls)
    assert out.token_ids == full.token_ids[: len(out.token_ids)]
    assert len(out.token_ids) < len(full.token_ids)
    calls.clear()
    out = eng.generate_async(PROMPT, lambda c, d: calls.append(c) and False)
    assert out.finish_reason is FinishReason.ABORT and len(calls) == 1
    assert out.token_ids == full.token_ids[: len(out.token_ids)]
    tok = eng.ctx.tokenizer
    assert tok.decode(out.token_ids, skip_special_tokens=True) == calls[0]
    assert tok.decode(out.token_ids[:-1], skip_special_tokens=True).strip("\ufffd") == ""


@pytest.mark.parametrize("chunk", [1, 8])
def test_stop_token_ends_the_stream_like_jax(model_dir, chunk):
    """An extra stop id (the EOS set) that the stream generates ends it
    with STOP and a final flush, in both engines."""
    eng = _engine(model_dir, stream_chunk=chunk)
    jeng = _jengine(model_dir, stream_chunk=chunk)
    base, _ = _stream(eng)
    stop = base.token_ids[5]
    outs = []
    for e in (eng, jeng):
        e.reconfigure(extra_stop_token_ids=[stop])
        outs.append(_stream(e))
        e.reconfigure(extra_stop_token_ids=[])
    (out, calls), (jout, jcalls) = outs
    assert out.finish_reason is FinishReason.STOP
    assert jout.finish_reason is JFinishReason.STOP
    assert out.token_ids == jout.token_ids == base.token_ids[: base.token_ids.index(stop)]
    assert calls[-1][1] and "".join(c for c, _ in calls) == out.text == jout.text


def test_speculative_stream_matches_jax(model_dir):
    """speculative="ngram" streams one prompt through the speculative loop:
    the chunked loop's greedy tokens, and the JAX speculative stream's."""
    prompt = "the cat sat on the mat. the cat sat on the"
    kw = dict(speculative="ngram", spec_draft_len=4, spec_ngram=2, max_tokens=24)
    out, calls = _stream(_engine(model_dir, **kw), prompt)
    jout, _ = _stream(_jengine(model_dir, **kw), prompt)
    plain = _engine(model_dir, max_tokens=24).generate_sync([prompt])[0]
    assert out.token_ids == jout.token_ids == plain.token_ids
    assert "".join(c for c, _ in calls) == plain.text


def _launch(host, n_chunks, tick_s=0.01, chunk=8):
    """Drives host as the decode loop does: a chunk of `chunk` steps takes
    `chunk` ticks of tick_s (advance() after each), then its tokens are put.
    Returns the perf_counter of every emission."""
    times = []
    host.on_token = lambda step, t: times.append(time.perf_counter()) or True
    host.put(0, torch.zeros(1, 1, dtype=torch.int32), decode=False, last=False)
    for c in range(n_chunks):
        host.advance(keep=engine_mod.RUN_AHEAD)
        for _ in range(chunk):
            time.sleep(tick_s)
            host.advance()
        host.put(1 + chunk * c, torch.arange(chunk, dtype=torch.int32)[:, None],
                 decode=True, last=c == n_chunks - 1)
    host.advance(keep=0)
    return np.array(times)


def test_host_tokens_pace_the_middle_chunks():
    """Paced, a decode chunk's tokens spread over the next chunk's launch
    (JAX's min-gap rule, emitted between launched steps); the first decode
    chunk and the last burst. Unpaced, every chunk bursts."""
    paced = _launch(engine_mod._HostTokens(None, chunk=8, pace=True), 4)
    burst = _launch(engine_mod._HostTokens(None, chunk=8, pace=False), 4)
    assert len(paced) == len(burst) == 1 + 4 * 8
    spans = [np.ptp(paced[1 + 8 * c: 9 + 8 * c]) for c in range(4)]
    assert spans[1] >= 0.04 and spans[2] >= 0.04    # over most of a chunk's 80 ms
    assert spans[0] < 0.005 and spans[3] < 0.005     # the first and last chunk burst
    assert max(np.ptp(burst[1 + 8 * c: 9 + 8 * c]) for c in range(4)) < 0.005


def test_host_tokens_wait_for_the_device_only_when_asked(monkeypatch):
    """advance() emits only what the device finished (an event that has
    not passed holds its chunk back); advance(keep) waits for it."""

    class Event:
        passed = False

        def query(self):
            return self.passed

        def synchronize(self):
            self.passed = True

    ev = Event()
    monkeypatch.setattr(engine_mod, "_to_host", lambda toks: (ev, toks))
    seen = []
    host = engine_mod._HostTokens(lambda step, t: seen.append(step) or True, chunk=4,
                                  pace=True)
    host.put(1, torch.zeros(4, 1, dtype=torch.int32), decode=True, last=False)
    host.advance()
    assert seen == []
    host.advance(keep=1)
    assert seen == []                 # one chunk waits: no more than keep
    host.advance(keep=0)
    assert seen == [1, 2, 3, 4] and ev.passed


@pytest.mark.parametrize("stop_at", [0, 1, 7, 20])
def test_host_tokens_stop_at_the_first_false(stop_at):
    """on_token is never called after it returned False, whether the stop
    falls in a burst or between paced slots."""
    for pace in (False, True):
        calls = []
        host = engine_mod._HostTokens(None, chunk=4, pace=pace)
        host.on_token = lambda step, t: calls.append(step) or step < stop_at
        for c in range(8):
            host.put(1 + 4 * c, torch.arange(4, dtype=torch.int32)[:, None], decode=True,
                     last=c == 7)
            time.sleep(0.002)
            host.advance()
        host.advance(keep=0)
        assert calls == list(range(1, max(stop_at, 1) + 1))
        assert host.stopped


def test_cli_stream(model_dir, capsys):
    rc = cli.main(["--model", model_dir, "--device", "cpu", "--dtype", "float32",
                   "--max-tokens", "6", "--stream", "--prompt", "Hello", "--prompt", "x"])
    assert rc == 0
    out = capsys.readouterr().out
    eng = _engine(model_dir, max_tokens=6, prefill_bucket=64)
    want = eng.generate_sync(["Hello"])[0].text
    assert out == f">>> Hello\n{want}"


# -- the sequential server ------------------------------------------------------------


def _serve(srv, handler):
    srv.prepare()
    srv._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler(srv))
    t = threading.Thread(target=srv._httpd.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv._httpd.server_address[1]}", t


@pytest.fixture(scope="module")
def servers(model_dir):
    """The port's and the JAX package's sequential servers on one dir."""
    kw = dict(model_dir=model_dir, host="127.0.0.1", port=0, dtype="float32",
              max_tokens=6, chat_template=CHATML_TEMPLATE, scheduler="sequential")
    srv = TinyGPTServer(ServerConfig(device="cpu", **kw))
    jsrv = JTinyGPTServer(JServerConfig(**kw))
    (url, t), (jurl, jt) = _serve(srv, _make_handler), _serve(jsrv, j_make_handler)
    yield url, jurl, srv
    for s, th in ((srv, t), (jsrv, jt)):
        s._httpd.shutdown()
        s.worker.stop()
        th.join(timeout=30)


def _post(url, path, body, raw=False):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    resp = urllib.request.urlopen(req, timeout=120)
    return resp if raw else json.loads(resp.read())


def _sse(url, path, body):
    resp = _post(url, path, dict(body, stream=True), raw=True)
    assert resp.headers["Content-Type"].startswith("text/event-stream")
    frames = [f for f in resp.read().decode().split("\n\n") if f.startswith("data: ")]
    assert frames[-1] == "data: [DONE]"
    return [json.loads(f[6:]) for f in frames[:-1]]


def test_sequential_completions_match_jax(servers):
    url, jurl, srv = servers
    assert type(srv.worker).__name__ == "InferenceWorker"
    body = {"prompt": "the quick brown fox", "max_tokens": 5}
    got, want = _post(url, "/v1/completions", body), _post(jurl, "/v1/completions", body)
    assert got["choices"][0]["text"] == want["choices"][0]["text"]
    assert got["choices"][0]["finish_reason"] == want["choices"][0]["finish_reason"]
    assert got["usage"] == want["usage"] and got["usage"]["completion_tokens"] == 5
    frames = _sse(url, "/v1/completions", body)
    assert "".join(p["choices"][0]["text"] for p in frames) == got["choices"][0]["text"]
    assert frames[-1]["choices"][0]["finish_reason"] == "length"
    assert frames[-1]["usage"] == got["usage"]


def test_sequential_chat_matches_jax(servers):
    url, jurl, _ = servers
    body = {"messages": [{"role": "user", "content": "Hi there"}], "max_tokens": 4}
    got, want = (_post(u, "/v1/chat/completions", body) for u in (url, jurl))
    assert got["choices"][0]["message"] == want["choices"][0]["message"]
    assert got["usage"] == want["usage"]
    frames, jframes = (_sse(u, "/v1/chat/completions", body) for u in (url, jurl))
    assert frames[0]["choices"][0]["delta"] == {"role": "assistant"}
    text = "".join(p["choices"][0]["delta"].get("content", "") for p in frames[1:])
    assert text == got["choices"][0]["message"]["content"]
    assert text == "".join(p["choices"][0]["delta"].get("content", "") for p in jframes[1:])
    assert frames[-1]["choices"][0]["finish_reason"] == jframes[-1]["choices"][0][
        "finish_reason"]


def test_sequential_stop_string(servers):
    """A stop string taken from the greedy text cuts it there, with
    finish_reason "stop", streamed and not, as the JAX server does."""
    url, jurl, _ = servers
    full = _post(url, "/v1/completions", {"prompt": "a b c", "max_tokens": 6})
    text = full["choices"][0]["text"]
    stop = text.strip()[1:3]
    assert stop
    body = {"prompt": "a b c", "max_tokens": 6, "stop": [stop]}
    for u in (url, jurl):
        d = _post(u, "/v1/completions", body)
        assert d["choices"][0]["finish_reason"] == "stop"
        assert d["choices"][0]["text"] == text[: text.index(stop)]
    frames = _sse(url, "/v1/completions", body)
    assert "".join(p["choices"][0]["text"] for p in frames) == text[: text.index(stop)]
    assert frames[-1]["choices"][0]["finish_reason"] == "stop"


def test_sequential_requests_are_served_in_turn(servers):
    """Two concurrent requests, one streamed: each gets the text it gets
    alone (one engine, one request at a time)."""
    url, _, _ = servers
    bodies = [{"prompt": "request number one", "max_tokens": 5},
              {"prompt": "another request", "max_tokens": 5, "stream": True}]
    alone = [_post(url, "/v1/completions", dict(b, stream=False))["choices"][0]["text"]
             for b in bodies]

    def one(body):
        if body.get("stream"):
            return "".join(p["choices"][0]["text"] for p in _sse(url, "/v1/completions", body))
        return _post(url, "/v1/completions", body)["choices"][0]["text"]

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        assert list(ex.map(one, bodies)) == alone
