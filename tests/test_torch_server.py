"""The port's OpenAI-compatible server: the contracts of
tests/test_server.py (/v1/models, completions and chat, non-streaming and
SSE, validation errors, 404, the web UI, /health, concurrent requests
through the continuous batcher, the stop-string machinery and request
parsing), on the CPU, on a tiny llama model dir with the port's generated
Metaspace-BPE tokenizer. The sequential worker has its tests in
tests/test_torch_stream.py. The pure helpers are held against the JAX
package's, and a greedy completion against the port's batcher driven
directly."""

import concurrent.futures
import http.server
import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from tinygpt_tpu.server import utils as j_utils
from tinygpt_tpu_torch.server.http import ServerConfig, TinyGPTServer, _make_handler
from tinygpt_tpu_torch.server.utils import (
    BadRequest,
    StopStringStreamer,
    check_stop_strings,
    parse_inference_params,
)
from tinygpt_tpu_torch.tokenizer.chat_template import CHATML_TEMPLATE
from tinygpt_tpu_torch.utils.fixtures import write_random_model_dir

TINY_LLAMA = dict(model_type="llama", vocab_size=503, hidden_size=64,
                  intermediate_size=128, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=2,
                  max_position_embeddings=256, rms_norm_eps=1e-5)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_srv_model")
    return write_random_model_dir(str(d), TINY_LLAMA, seed=3, dtype=torch.float32)


@pytest.fixture(scope="module")
def server(model_dir):
    srv = TinyGPTServer(ServerConfig(
        model_dir=model_dir, host="127.0.0.1", port=0, dtype="float32",
        max_tokens=6, device="cpu",
        # the generated tokenizer has no chat template and no ChatML tokens:
        # force one through the CLI-priority path
        chat_template=CHATML_TEMPLATE, batch_capacity=4, kv_n_blocks=64,
    ))
    srv.prepare()
    srv._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(srv))
    port = srv._httpd.server_address[1]
    t = threading.Thread(target=srv._httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{port}", srv
    srv._httpd.shutdown()
    srv.worker.stop()
    t.join(timeout=30)
    assert not t.is_alive()


def _post(url, path, body, raw=False):
    req = urllib.request.Request(
        url + path, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    resp = urllib.request.urlopen(req, timeout=120)
    if raw:
        return resp
    return json.loads(resp.read())


def _get(url, path):
    return json.loads(urllib.request.urlopen(url + path, timeout=30).read())


def _sse_payloads(resp):
    body = resp.read().decode()
    frames = [f for f in body.split("\n\n") if f.startswith("data: ")]
    assert frames[-1] == "data: [DONE]"
    return [json.loads(f[6:]) for f in frames[:-1]]


def test_models_endpoint(server):
    url, srv = server
    d = _get(url, "/v1/models")
    assert d["object"] == "list"
    m = d["data"][0]
    assert m["id"] == srv.model_id
    assert m["capabilities"] == {"completions": True, "chat_completions": True}


def test_completions_nonstream(server):
    url, _ = server
    d = _post(url, "/v1/completions", {"prompt": "Hello", "max_tokens": 4})
    c = d["choices"][0]
    assert isinstance(c["text"], str) and c["text"]
    assert c["finish_reason"] == "length"
    u = d["usage"]
    assert u["prompt_tokens"] > 0 and u["completion_tokens"] == 4
    assert u["total_tokens"] == u["prompt_tokens"] + u["completion_tokens"]


def test_completion_matches_the_batcher(server, model_dir):
    """The server's greedy text is the batcher's greedy stream, decoded
    token by token as the worker streams it."""
    from tinygpt_tpu_torch.engine.scheduler import Request

    url, srv = server
    text = _post(url, "/v1/completions",
                 {"prompt": "the quick brown fox", "max_tokens": 5})["choices"][0]["text"]
    eng = srv.engine
    b = srv.worker.batcher.__class__(eng.ctx.model, eng.ctx.model_config,
                                     eng.ctx.params, eos_ids=eng._eos_ids,
                                     config=srv.worker.batcher.sc)
    b.add_request(Request(request_id=0, max_new_tokens=5,
                          prompt_ids=eng.ctx.tokenizer.encode("the quick brown fox")))
    toks = []
    while b.has_work:
        toks += [ev.token_id for ev in b.step() if ev.token_id is not None]
    stream = eng.ctx.tokenizer.decode_stream(skip_special_tokens=True)
    assert len(toks) == 5
    assert text == "".join(stream.step(t) for t in toks) + stream.flush()


def test_completions_stream_sse(server):
    url, _ = server
    resp = _post(url, "/v1/completions",
                 {"prompt": "Hello", "max_tokens": 4, "stream": True}, raw=True)
    assert resp.headers["Content-Type"].startswith("text/event-stream")
    payloads = _sse_payloads(resp)
    assert payloads[-1]["choices"][0]["finish_reason"] == "length"
    assert payloads[-1]["usage"]["completion_tokens"] == 4
    streamed = "".join(p["choices"][0].get("text", "") for p in payloads)
    whole = _post(url, "/v1/completions",
                  {"prompt": "Hello", "max_tokens": 4})["choices"][0]["text"]
    assert streamed == whole


def test_chat_completions_nonstream(server):
    url, _ = server
    d = _post(url, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Hi there"}], "max_tokens": 4,
    })
    msg = d["choices"][0]["message"]
    assert msg["role"] == "assistant" and isinstance(msg["content"], str)
    assert d["usage"]["completion_tokens"] <= 4


def test_chat_multimodal_text_parts(server):
    url, _ = server
    d = _post(url, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": [
            {"type": "text", "text": "Hello "}, {"type": "text", "text": "world"},
        ]}],
        "max_tokens": 2,
    })
    assert d["choices"][0]["finish_reason"] in ("length", "stop")


def test_chat_stream_role_then_deltas(server):
    url, _ = server
    resp = _post(url, "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "Hi"}], "max_tokens": 3,
        "stream": True,
    }, raw=True)
    payloads = _sse_payloads(resp)
    assert payloads[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert payloads[-1]["choices"][0]["finish_reason"] in ("length", "stop")
    assert "usage" in payloads[-1]


def test_stop_string(server):
    """A stop string taken from the greedy text itself cuts it there."""
    url, _ = server
    full = _post(url, "/v1/completions",
                 {"prompt": "a b c", "max_tokens": 6})["choices"][0]["text"]
    stop = full.strip()[1:3]
    assert stop
    d = _post(url, "/v1/completions",
              {"prompt": "a b c", "max_tokens": 6, "stop": [stop]})
    assert d["choices"][0]["finish_reason"] == "stop"
    assert d["choices"][0]["text"] == full[: full.index(stop)]


def test_validation_errors(server):
    url, _ = server
    for body, frag in [
        ({"prompt": 42}, "prompt"),
        ({"prompt": "x", "temperature": 9}, "temperature"),
        ({"prompt": "x", "max_tokens": -1}, "max_tokens"),
        ({"prompt": "x", "stop": [3]}, "stop"),
    ]:
        with pytest.raises(urllib.error.HTTPError) as exc:
            _post(url, "/v1/completions", body)
        assert exc.value.code == 400
        assert frag in json.loads(exc.value.read())["error"]["message"]


def test_chat_missing_messages(server):
    url, _ = server
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(url, "/v1/chat/completions", {"messages": []})
    assert exc.value.code == 400


def test_unknown_route_404(server):
    url, _ = server
    with pytest.raises(urllib.error.HTTPError) as exc:
        _post(url, "/v1/embeddings", {})
    assert exc.value.code == 404


def test_web_ui_served(server):
    url, _ = server
    html = urllib.request.urlopen(url + "/", timeout=30).read().decode()
    assert "tinygpt_tpu" in html and "<html" in html


def test_health(server):
    url, _ = server
    assert _get(url, "/health")["status"] == "ok"


def test_concurrent_requests_interleave(server):
    """Continuous batching: simultaneous requests, sampled and greedy,
    streaming and not, all complete."""
    url, srv = server
    assert type(srv.worker).__name__ == "BatchedInferenceWorker"

    def one(i):
        body = {"prompt": f"request number {i}", "max_tokens": 5}
        if i % 2:
            body.update(temperature=0.8, top_k=40)
        if i % 3 == 0:
            body["stream"] = True
            payloads = _sse_payloads(_post(url, "/v1/completions", body, raw=True))
            return payloads[-1]
        return _post(url, "/v1/completions", body)

    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        results = list(ex.map(one, range(6)))
    for d in results:
        assert d["choices"][0]["finish_reason"] in ("length", "stop")
        assert 0 < d["usage"]["completion_tokens"] <= 5


# -- stop-string machinery and request parsing (pure) -------------------------


def test_check_stop_strings():
    assert check_stop_strings("hello world", ["world", "lo"]) == (3, "lo")
    assert check_stop_strings("abc", ["x"]) == (None, None)


@pytest.mark.parametrize("stops,include,chunks", [
    (["STOP"], False, ["hello ST", "OP world"]),
    (["END"], True, ["abcEND xyz"]),
    (["LONGSTOP"], False, ["abcdefgh"]),
    (["ab", "xyz"], False, ["x", "y", "zab"]),
])
def test_stop_streamer_matches_jax(stops, include, chunks):
    port, ref = StopStringStreamer(stops, include), j_utils.StopStringStreamer(
        stops, include)
    outs = [(port.push(c), ref.push(c)) for c in chunks]
    assert all(a == b for a, b in outs)
    assert port.flush() == ref.flush()
    assert (port.stopped, port.matched) == (ref.stopped, ref.matched)


def test_parse_inference_params():
    p = parse_inference_params({})
    assert p.sampler.is_greedy and not p.stream
    assert parse_inference_params({"max_completion_tokens": 7}).max_tokens == 7
    body = {"temperature": 0.5, "top_k": 3, "top_p": 0.9, "min_p": 0.1, "stop": "x",
            "stop_token_ids": [4], "stream": True, "max_tokens": 9}
    got, want = parse_inference_params(body), j_utils.parse_inference_params(body)
    assert (got.max_tokens, got.stream, got.stop, got.stop_token_ids) == (
        want.max_tokens, want.stream, want.stop, want.stop_token_ids)
    assert vars(got.sampler) == vars(want.sampler)
    with pytest.raises(BadRequest):
        parse_inference_params({"top_k": -1})
