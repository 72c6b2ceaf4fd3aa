"""The port's HTTP server on the CPU with the tiny model: the routes and
JSON shapes of the JAX server, a 501 naming the feature of each JAX
route the port does not serve, and a 400 naming each request feature
the port does not serve yet."""

import json
import re
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from production_stack_tpu_torch.engine.server import (
    UNPORTED_ROUTES,
    make_server,
    unported_feature,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def base_url():
    server = make_server(["--model", "tiny-llama", "--random-weights",
                          "--device", "cpu", "--host", "127.0.0.1",
                          "--port", "0", "--max-model-len", "256",
                          "--prefill-chunk-size", "64"])
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    yield "http://127.0.0.1:%d" % server.server_address[1]
    server.shutdown()
    thread.join(timeout=30)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, resp.read().decode()


def _get_status(url):
    try:
        return _get(url)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_health_and_models(base_url):
    status, text = _get(base_url + "/health")
    assert status == 200 and json.loads(text)["status"] == "ok"
    status, text = _get(base_url + "/v1/models")
    data = json.loads(text)["data"]
    assert status == 200 and data[0]["id"] == "tiny-llama"


def test_completion(base_url):
    status, text = _post(base_url + "/v1/completions", {
        "model": "tiny-llama", "prompt": "hello there", "max_tokens": 6,
        "temperature": 0, "ignore_eos": True})
    assert status == 200
    out = json.loads(text)
    assert out["object"] == "text_completion"
    assert out["choices"][0]["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": 12, "completion_tokens": 6,
                            "total_tokens": 18}
    # Greedy is deterministic across requests.
    assert json.loads(_post(base_url + "/v1/completions", {
        "prompt": "hello there", "max_tokens": 6, "temperature": 0,
        "ignore_eos": True})[1])["choices"][0]["text"] == \
        out["choices"][0]["text"]


def test_streamed_chat_completion(base_url):
    status, text = _post(base_url + "/v1/chat/completions", {
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5,
        "temperature": 0.8, "top_p": 0.95, "ignore_eos": True,
        "stream": True, "stream_options": {"include_usage": True}})
    assert status == 200
    frames = [line[len("data: "):] for line in text.split("\n\n")
              if line.startswith("data: ")]
    assert frames[-1] == "[DONE]"
    chunks = [json.loads(f) for f in frames[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant"}
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    content = [c["choices"][0]["delta"].get("content") for c in chunks
               if c["choices"]]
    # One delta per token, except that a run of bytes ending inside a
    # UTF-8 sequence is held back and joins the next delta.
    assert 1 <= len([c for c in content if c]) <= 5
    assert chunks[-2]["choices"][0]["finish_reason"] == "length"
    assert chunks[-1]["usage"]["completion_tokens"] == 5


def test_metrics(base_url):
    status, text = _get(base_url + "/metrics")
    assert status == 200
    for name in ("vllm:num_requests_running", "vllm:num_requests_waiting",
                 "vllm:gpu_cache_usage_perc",
                 "vllm:engine_ragged_steps_total",
                 "vllm:generation_tokens_total"):
        assert f"\n{name} " in text


@pytest.mark.parametrize("extra,feature", [
    ({"logprobs": 2}, "logprobs"),
    ({"presence_penalty": 0.5}, "penalties"),
    ({"logit_bias": {"5": 10}}, "logit_bias"),
    ({"min_tokens": 2}, "min_tokens"),
    ({"response_format": {"type": "json_object"}}, "guided output"),
    ({"model": "my-adapter"}, "LoRA"),
    ({"n": 2}, "'n' > 1"),
])
def test_unported_features_are_rejected(base_url, extra, feature):
    status, text = _post(base_url + "/v1/completions",
                         {"prompt": "x", "max_tokens": 2, **extra})
    assert status == 400
    assert feature in json.loads(text)["error"]["message"]


def _reference_routes():
    """(method, path) of every route the JAX server registers, read from
    its source as text (no import), so the list cannot drift."""
    src = (Path(__file__).resolve().parents[1] / "production_stack_tpu"
           / "engine" / "server.py").read_text()
    return [(m.upper(), p) for m, p in
            re.findall(r'add_(get|post)\(\s*"([^"]+)"', src)]


SERVED_ROUTES = {("GET", "/health"), ("GET", "/v1/models"),
                 ("GET", "/metrics"), ("POST", "/v1/completions"),
                 ("POST", "/v1/chat/completions")}


def test_every_reference_route_is_served_or_answers_501(base_url):
    routes = _reference_routes()
    assert len(routes) == 24
    for method, path in routes:
        # A templated segment ({request_id}) takes a concrete value.
        concrete = re.sub(r"\{[^}]+\}", "req-123", path)
        url = base_url + concrete
        body = {"prompt": "x", "max_tokens": 1, "temperature": 0,
                "messages": [{"role": "user", "content": "x"}]}
        status, text = (_get_status(url) if method == "GET"
                        else _post(url, body))
        if (method, path) in SERVED_ROUTES:
            assert status == 200, (method, path, text)
            continue
        feature = unported_feature(method, concrete)
        assert feature, (method, path)
        assert status == 501, (method, path, text)
        message = json.loads(text)["error"]["message"]
        assert feature in message and "not ported" in message
    assert len(UNPORTED_ROUTES) == 24 - len(SERVED_ROUTES)


@pytest.mark.parametrize("method,path", [
    ("GET", "/nope"), ("POST", "/v1/nope"), ("GET", "/debug/trace/"),
    ("GET", "/drain"), ("POST", "/version")])
def test_unknown_routes_answer_404(base_url, method, path):
    status, text = (_get_status(base_url + path) if method == "GET"
                    else _post(base_url + path, {}))
    assert status == 404 and "no route" in json.loads(text)["error"][
        "message"]


def test_server_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server(["--model", "tiny-llama", "--port", "0"])
