"""The port's HTTP server on the CPU with the tiny model: the routes and
JSON shapes of the JAX server, a 501 naming the feature of each JAX
route the port does not serve, the request options of the JAX server
(penalties, ``logit_bias``, ``min_tokens``, ``response_format``,
logprobs in both forms, ``n`` and ``best_of``; twins of the reference's
``tests/test_engine_server.py`` cases) with its 400s, and a 400 for a
LoRA adapter, which the port does not serve."""

import json
import re
import threading
import urllib.error
import urllib.request
from pathlib import Path

import pytest
import torch

from production_stack_tpu.router.stats.engine_stats import EngineStats
from production_stack_tpu_torch.engine.server import (
    UNPORTED_ROUTES,
    make_server,
    unported_feature,
)
from production_stack_tpu_torch.engine.step_graphs import (
    STEP_KINDS,
    StepGraphs,
)
from tests.test_torch_step_graphs import RecordingGraph

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


def test_metrics_carry_the_compile_ledger_the_router_reads(base_url):
    """The JAX server's compile-ledger names, types and kind labels,
    read by the reference router's parser; the CPU captures nothing, so
    every kind stands at 0."""
    _, text = _get(base_url + "/metrics")
    for name in ("vllm:engine_compile_events_total",
                 "vllm:engine_compile_seconds_total",
                 "vllm:engine_eager_steps_total"):
        assert f"# TYPE {name} counter" in text
    stats = EngineStats.from_prometheus_text(text)
    assert stats.compile_events_by_kind == dict.fromkeys(STEP_KINDS, 0.0)
    assert stats.compile_seconds_by_kind == dict.fromkeys(STEP_KINDS, 0.0)
    assert '\nvllm:engine_eager_steps_total{reason="seeded"} 0.0' in text


def test_compile_ledger_counts_step_graph_captures():
    """A server whose runner replays step graphs (the CPU stand-in)
    counts each capture by kind on /metrics, with its seconds."""
    server = make_server(["--model", "tiny-llama", "--random-weights",
                          "--device", "cpu", "--host", "127.0.0.1",
                          "--port", "0", "--max-model-len", "256",
                          "--prefill-chunk-size", "64"])
    runner = server.app.engine.runner
    runner.graphs = StepGraphs(torch.device("cpu"),
                               generators=[runner.generator],
                               graph_factory=RecordingGraph)
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        for seed in (None, 3):
            status, _ = _post(base + "/v1/completions", {
                "model": "tiny-llama", "prompt": "hello there",
                "max_tokens": 4, "temperature": 0.5, "seed": seed,
                "ignore_eos": True})
            assert status == 200
        _, text = _get(base + "/metrics")
    finally:
        server.shutdown()
        thread.join(timeout=30)
    stats = EngineStats.from_prometheus_text(text)
    events = stats.compile_events_by_kind
    assert set(events) == set(STEP_KINDS)
    # The prefill key and the decode key, each captured once; the
    # unified kind is there at 0 (no mixed step in a lone request).
    assert events["step"] == len(runner.graphs.keys()) == 2
    assert stats.compile_seconds_by_kind["step"] > 0
    # The seeded request's four steps ran without a graph.
    assert '\nvllm:engine_eager_steps_total{reason="seeded"} 4.0' in text


@pytest.mark.parametrize("extra,feature", [
    ({"model": "my-adapter"}, "LoRA"),
])
def test_unported_features_are_rejected(base_url, extra, feature):
    """LoRA adapters, the one request feature the port does not serve."""
    status, text = _post(base_url + "/v1/completions",
                         {"prompt": "x", "max_tokens": 2, **extra})
    assert status == 400
    assert feature in json.loads(text)["error"]["message"]


@pytest.mark.parametrize("extra", [
    {"logprobs": 2},
    {"presence_penalty": 0.5},
    {"logit_bias": {"5": 10}},
    {"min_tokens": 2},
    {"response_format": {"type": "json_object"}},
    {"n": 2},
], ids=["logprobs", "penalties", "logit_bias", "min_tokens",
        "response_format", "n"])
def test_sampling_options_are_served(base_url, extra):
    """The options the port answered with a 400 before it served them
    (the JAX server serves each)."""
    status, text = _post(base_url + "/v1/completions",
                         {"prompt": "x", "max_tokens": 2,
                          "temperature": 0, **extra})
    assert status == 200, text
    out = json.loads(text)
    assert len(out["choices"]) == extra.get("n", 1)
    lp = out["choices"][0]["logprobs"]
    if "logprobs" in extra:
        assert len(lp["tokens"]) == len(lp["token_logprobs"]) >= 1
    else:
        assert lp is None


@pytest.mark.parametrize("body", [
    {"prompt": "x", "suffix": "tail"},
    {"prompt": "x", "echo": True, "logprobs": 1},
    {"prompt": "x", "n": 1, "best_of": 2, "stream": True},
    {"prompt": "x", "n": 3, "best_of": 2},
    {"prompt": "x", "n": 0},
    {"prompt": "x", "n": "many"},
    {"prompt": "x", "n": 17},
    {"prompt": "x", "logprobs": True, "top_logprobs": 21},
    {"prompt": "x", "logprobs": False, "top_logprobs": 2},
    {"prompt": "x", "logit_bias": {"600": 1}},
    {"prompt": "x", "logit_bias": {"5": 101}},
    {"prompt": "x", "min_tokens": 9, "max_tokens": 8},
    {"prompt": "x", "presence_penalty": 2.5},
    {"prompt": "x", "repetition_penalty": 0},
    {"prompt": "x", "response_format": {"type": "json_schema"}},
], ids=["suffix", "echo-logprobs", "stream-best_of", "best_of<n", "n=0",
        "n-not-int", "n=17", "top_logprobs=21", "top_logprobs-alone",
        "logit_bias-vocab", "logit_bias-range", "min_tokens>max",
        "presence-range", "repetition-0", "response_format-schema"])
def test_reference_400s(base_url, body):
    """The 400s the JAX server gives: ``suffix``, ``echo`` with
    ``logprobs``, a streamed ``best_of`` > n, and out-of-range values
    (the tiny model's vocabulary is 512)."""
    status, text = _post(base_url + "/v1/completions", body)
    assert status == 400, text
    assert json.loads(text)["error"]["type"] == "invalid_request_error"


def _sse(text):
    return [json.loads(line[len("data: "):]) for line in text.splitlines()
            if line.startswith("data: {")]


def _chat(base_url, **kw):
    body = {"model": "tiny-llama",
            "messages": [{"role": "user", "content": "hello"}]}
    body.update(kw)
    return _post(base_url + "/v1/chat/completions", body)


def test_n_choices_non_streaming(base_url):
    status, text = _chat(base_url, max_tokens=6, temperature=0.0, n=3,
                         ignore_eos=True)
    data = json.loads(text)
    assert status == 200
    assert [c["index"] for c in data["choices"]] == [0, 1, 2]
    # Greedy: every choice the same, and complete.
    assert len({c["message"]["content"] for c in data["choices"]}) == 1
    assert data["usage"]["completion_tokens"] == 18


def test_n_choices_streaming_indexes_chunks(base_url):
    status, text = _chat(base_url, max_tokens=4, temperature=0.0, n=2,
                         stream=True)
    assert status == 200 and text.strip().endswith("data: [DONE]")
    finishes = {c["choices"][0]["index"] for c in _sse(text)
                if c["choices"][0].get("finish_reason")}
    assert finishes == {0, 1}


def test_penalties_change_sampling(base_url):
    _, plain = _chat(base_url, max_tokens=16, temperature=0.0,
                     ignore_eos=True)
    status, text = _chat(base_url, max_tokens=16, temperature=0.0,
                         ignore_eos=True, presence_penalty=2.0,
                         frequency_penalty=1.5)
    assert status == 200
    assert json.loads(plain)["usage"]["completion_tokens"] == 16
    assert json.loads(text)["usage"]["completion_tokens"] == 16


def test_chat_logprobs(base_url):
    """Greedy: the sampled token is the first alternative, at its
    logprob."""
    status, text = _chat(base_url, max_tokens=5, temperature=0.0,
                         ignore_eos=True, logprobs=True, top_logprobs=3)
    assert status == 200
    content = json.loads(text)["choices"][0]["logprobs"]["content"]
    assert len(content) == 5
    for entry in content:
        assert entry["logprob"] <= 0.0
        assert len(entry["top_logprobs"]) == 3
        assert entry["top_logprobs"][0]["token"] == entry["token"]
        assert abs(entry["top_logprobs"][0]["logprob"]
                   - entry["logprob"]) < 1e-4
        assert entry["bytes"] == list(entry["token"].encode())


def test_completions_legacy_logprobs(base_url):
    status, text = _post(base_url + "/v1/completions", {
        "model": "tiny-llama", "prompt": "hello world", "max_tokens": 4,
        "temperature": 0.0, "ignore_eos": True, "logprobs": 2})
    assert status == 200
    lp = json.loads(text)["choices"][0]["logprobs"]
    assert len(lp["tokens"]) == len(lp["token_logprobs"]) == 4
    # Text-keyed: ids that decode alike collapse.
    assert all(1 <= len(t) <= 2 for t in lp["top_logprobs"])


def test_logprobs_streaming_chunks(base_url):
    status, text = _chat(base_url, max_tokens=4, temperature=0.0,
                         ignore_eos=True, logprobs=True, top_logprobs=2,
                         stream=True)
    entries = []
    for c in _sse(text):
        lp = c["choices"][0].get("logprobs")
        if lp:
            entries.extend(lp["content"])
    assert status == 200 and len(entries) == 4
    # Legacy stream: the same tokens' entries, in the legacy form.
    _, text = _post(base_url + "/v1/completions", {
        "prompt": "hello", "max_tokens": 4, "temperature": 0.0,
        "ignore_eos": True, "logprobs": 1, "stream": True})
    tokens = [t for c in _sse(text) if c["choices"]
              and c["choices"][0].get("logprobs")
              for t in c["choices"][0]["logprobs"]["tokens"]]
    assert len(tokens) == 4


def test_stop_string_drops_truncated_logprob_entries(base_url):
    """The entries of a stop-truncated completion spell its text."""
    base = dict(max_tokens=10, temperature=0.0, ignore_eos=True,
                logprobs=True, top_logprobs=1)
    full = json.loads(_chat(base_url, **base)[1])["choices"][0]
    assert len(full["logprobs"]["content"]) == 10
    stop = full["message"]["content"][3:6]
    for stream in (False, True):
        _, text = _chat(base_url, stop=stop, stream=stream, **base)
        if stream:
            chunks = [c["choices"][0] for c in _sse(text)]
            got = "".join(c["delta"].get("content", "") for c in chunks)
            entries = [e for c in chunks if c.get("logprobs")
                       for e in c["logprobs"]["content"]]
        else:
            choice = json.loads(text)["choices"][0]
            got, entries = (choice["message"]["content"],
                            choice["logprobs"]["content"])
        assert stop not in got
        assert got == full["message"]["content"][
            :full["message"]["content"].find(stop)]
        assert "".join(e["token"] for e in entries) == got


def test_best_of_returns_top_n(base_url):
    """best_of generates extra candidates and returns the n of highest
    mean token logprob, without the logprobs it forced on."""
    status, text = _post(base_url + "/v1/completions", {
        "model": "tiny-llama", "prompt": "hello world", "max_tokens": 6,
        "temperature": 0.9, "seed": 11, "ignore_eos": True, "n": 2,
        "best_of": 4})
    data = json.loads(text)
    assert status == 200
    assert [c["index"] for c in data["choices"]] == [0, 1]
    assert all(c["logprobs"] is None for c in data["choices"])
    assert data["usage"]["completion_tokens"] == 24
    # Legacy integer logprobs 0 (the sampled logprob, no alternatives)
    # survives the forcing.
    _, text = _post(base_url + "/v1/completions", {
        "model": "tiny-llama", "prompt": "hello world", "max_tokens": 4,
        "temperature": 0.9, "seed": 3, "ignore_eos": True, "n": 1,
        "best_of": 2, "logprobs": 0})
    lp = json.loads(text)["choices"][0]["logprobs"]
    assert lp is not None and len(lp["token_logprobs"]) == 4
    assert lp["top_logprobs"] == [{}] * 4


def test_best_of_ranks_by_mean_logprob(base_url):
    """The kept choices are the candidates of highest mean logprob:
    each returned text's own mean is at least that of every dropped
    candidate (the same seeds regenerate every candidate)."""
    body = {"prompt": "hello world", "max_tokens": 5, "temperature": 0.9,
            "seed": 21, "ignore_eos": True, "logprobs": 0}
    means = []
    for i in range(3):
        lp = json.loads(_post(base_url + "/v1/completions", dict(
            body, seed=21 + i))[1])["choices"][0]["logprobs"]
        means.append(sum(lp["token_logprobs"]) / 5)
    _, text = _post(base_url + "/v1/completions", dict(body, best_of=3))
    kept = json.loads(text)["choices"][0]["logprobs"]["token_logprobs"]
    assert abs(sum(kept) / 5 - max(means)) < 1e-5


def test_logit_bias_and_min_tokens_on_the_server(base_url):
    """+100 forces a token; min_tokens holds EOS back (the reference's
    ``test_logit_bias.py`` and ``test_min_tokens.py`` server twins)."""
    _, text = _post(base_url + "/v1/completions", {
        "prompt": "hello", "max_tokens": 5, "temperature": 0.0,
        "ignore_eos": True, "logit_bias": {"65": 100}})
    assert json.loads(text)["choices"][0]["text"] == "AAAAA"
    # EOS (257) forced by its bias, but not before the 4th token.
    _, text = _post(base_url + "/v1/completions", {
        "prompt": "hello", "max_tokens": 8, "temperature": 0.0,
        "min_tokens": 4, "logit_bias": {"257": 100}})
    out = json.loads(text)
    assert out["usage"]["completion_tokens"] == 5
    assert out["choices"][0]["finish_reason"] == "stop"


def test_response_format_json_object(base_url):
    """Guided JSON over HTTP: with the structural bytes and EOS biased
    up (in the order that closes a document), greedy decoding writes
    one, which parses."""
    bias = {str(ord(c)): v for c, v in
            (("{", 60), ('"', 100), (":", 80), ("}", 50))}
    bias["257"] = 100
    for stream in (False, True):
        status, text = _chat(base_url, max_tokens=64, temperature=0.0,
                             response_format={"type": "json_object"},
                             logit_bias=bias, stream=stream)
        assert status == 200
        if stream:
            content = "".join(c["choices"][0]["delta"].get("content", "")
                              for c in _sse(text))
        else:
            choice = json.loads(text)["choices"][0]
            assert choice["finish_reason"] == "stop"
            content = choice["message"]["content"]
        assert json.loads(content) == {"": ""}


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
