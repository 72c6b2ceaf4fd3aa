"""The port's HTTP server on the CPU with the tiny model: the routes and
JSON shapes of the JAX server, a 501 naming the feature of each JAX
route the port does not serve, the role in ``/health`` and the flags'
names and defaults against the JAX server's, the request options of the JAX server
(penalties, ``logit_bias``, ``min_tokens``, ``response_format``,
logprobs in both forms, ``n`` and ``best_of``; twins of the reference's
``tests/test_engine_server.py`` cases) with its 400s, and a model name
that is no adapter served by the base model, as the JAX server serves
it (LoRA itself: tests/test_torch_lora.py)."""

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
    build_engine_from_args,
    make_server,
    parse_args,
    resolve_attention_impl,
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


@pytest.mark.parametrize("role", ["prefill", "decode", "both"])
def test_health_and_version_report_the_configured_role(role):
    """The router's role probe reads ``role`` from /health (the JAX
    server's field): the configured --engine-role, never a constant."""
    server = make_server(["--device", "cpu", "--host", "127.0.0.1",
                          "--port", "0", "--max-model-len", "128",
                          "--num-pages", "32", "--engine-role", role])
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        status, text = _get(url + "/health")
        assert status == 200
        assert json.loads(text) == {"status": "ok", "role": role,
                                    "draining": False,
                                    "active_requests": 0, "build_id": ""}
        assert json.loads(_get(url + "/version")[1])["role"] == role
        from production_stack_tpu.router.service_discovery import (
            K8sServiceDiscovery,
        )
        assert K8sServiceDiscovery._probe_role(url) == role
    finally:
        server.shutdown()
        thread.join(timeout=30)


def _reference_flags():
    """{flag: default source text} of every flag the JAX server's
    parser defines, read from its source as text (no import)."""
    src = (Path(__file__).resolve().parents[1] / "production_stack_tpu"
           / "engine" / "server.py").read_text()
    flags = {}
    for call in re.findall(r'add_argument\((.*?)\)\n', src, re.S):
        names = re.findall(r'"(--[a-z0-9-]+)"', call)
        default = re.search(r"default=([^,\n]+)", call)
        for name in names:
            flags[name] = default.group(1).strip() if default else None
    return flags


def test_flags_are_the_jax_servers():
    """All 75 of the JAX server's flags, each under its JAX name; the
    five of disaggregation, the profiler, the observatory and tracing,
    the eleven of autotuning, --pooling, the four small ones,
    --quantization, the four of LoRA, --tokenizer, --chat-template,
    --deferred-kv-writes, the three of tensor parallelism, the three
    of pipeline and context parallelism and the four of multi-host
    serving with the JAX defaults and choices. --device is the port's
    own."""
    reference = _reference_flags()
    assert len(reference) == 76  # 75 flags, one with an alias
    src = (Path(__file__).resolve().parents[1] / "production_stack_tpu_torch"
           / "engine" / "server.py").read_text()
    port = set(re.findall(r'add_argument\(\s*"(--[a-z0-9-]+)"', src))
    assert port - set(reference) == {"--device"}
    assert set(reference) - port == {"--profiler-dir"}  # the alias
    assert len(port) - 1 == 75
    # --distributed is store_true in both: no default in the source.
    assert reference["--distributed"] is None
    assert parse_args([]).distributed is False
    assert parse_args(["--distributed"]).distributed is True
    new = {"--engine-role": "both", "--profile-dir": None,
           "--device-peak-flops": 0.0, "--request-span-log": None,
           "--trace-ring-size": 256,
           "--autotune": "off", "--autotune-interval-s": 2.0,
           "--autotune-dead-band": 0.05, "--autotune-controllers": "all",
           "--autotune-freeze-window-s": 30.0,
           "--autotune-burn-threshold": 1.0,
           "--autotune-target-itl-ms": 50.0, "--autotune-min-spec-k": 1,
           "--autotune-min-checkpoint-interval-tokens": 64,
           "--autotune-max-checkpoint-interval-tokens": 4096,
           "--autotune-min-shed-threshold": 0.5,
           "--pooling": "last", "--dtype": None,
           "--attention-impl": "auto", "--compilation-cache-dir": None,
           "--quantization": "none", "--lora-modules": None,
           "--max-loras": 8, "--max-lora-rank": 16,
           "--tokenizer": None, "--chat-template": None,
           "--deferred-kv-writes": "auto", "--tensor-parallel-size": 1,
           "--num-slices": 0, "--mesh-placement": "auto",
           "--pipeline-parallel-size": 1, "--context-parallel-size": 1,
           "--long-prefill-threshold": None,
           "--coordinator-address": None, "--num-processes": None,
           "--process-id": None}
    args = vars(parse_args([]))
    for flag, default in new.items():
        assert flag in port
        assert reference[flag] == repr(default).replace("'", '"')
        assert args[flag[2:].replace("-", "_")] == default
    assert args["disable_prefix_caching"] is False
    assert args["enable_lora"] is False
    assert reference["--profiler-dir"] == "None"
    assert parse_args(["--profiler-dir", "d"]).profile_dir == "d"
    for flag, bad in (("--engine-role", "compute"), ("--autotune", "auto"),
                      ("--pooling", "cls"), ("--dtype", "int8"),
                      ("--attention-impl", "triton"),
                      ("--quantization", "fp8"),
                      ("--deferred-kv-writes", "always"),
                      ("--tensor-parallel-size", "two"),
                      ("--num-processes", "two")):
        with pytest.raises(SystemExit):
            parse_args([flag, bad])


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
    counts each capture by kind on /metrics, with its seconds (the
    graphs report to the runner's observatory, which /metrics reads)."""
    server = make_server(["--model", "tiny-llama", "--random-weights",
                          "--device", "cpu", "--host", "127.0.0.1",
                          "--port", "0", "--max-model-len", "256",
                          "--prefill-chunk-size", "64"])
    runner = server.app.engine.runner
    runner.graphs = StepGraphs(torch.device("cpu"),
                               generators=[runner.generator],
                               graph_factory=RecordingGraph,
                               observatory=runner.observatory)
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
    """A ``model`` that names no registered LoRA adapter is served by
    the base model, as the JAX server serves it (the router already
    filtered by served name): the same greedy tokens as the served
    name, and the response names the served model."""
    body = {"prompt": "hello there", "max_tokens": 6, "temperature": 0,
            "ignore_eos": True}
    status, text = _post(base_url + "/v1/completions", {**body, **extra})
    assert status == 200, (feature, text)
    out = json.loads(text)
    served = json.loads(_post(base_url + "/v1/completions",
                              {**body, "model": "tiny-llama"})[1])
    assert out["model"] == served["model"] == "tiny-llama"
    assert out["choices"][0]["text"] == served["choices"][0]["text"]


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
                 ("POST", "/v1/chat/completions"), ("GET", "/version"),
                 ("GET", "/kv/summary"), ("POST", "/v1/resume"),
                 ("POST", "/drain"), ("POST", "/v1/disagg/prefill"),
                 ("POST", "/v1/disagg/handoff"),
                 ("POST", "/debug/profiler/start"),
                 ("POST", "/debug/profiler/stop"),
                 ("GET", "/debug/trace/{request_id}"),
                 ("GET", "/debug/steps"), ("GET", "/debug/compiles"),
                 ("GET", "/debug/memory"), ("POST", "/v1/embeddings"),
                 ("POST", "/v1/score"), ("POST", "/score"),
                 ("POST", "/v1/rerank"), ("POST", "/rerank"),
                 ("GET", "/autotune/status"), ("POST", "/autotune/reset")}
# The pooled routes' 400 for a body without their fields, the JAX
# server's message.
POOLED_400 = {"/v1/embeddings": "'input' must be",
              "/v1/score": "'text_1' (string)", "/score": "'text_1' (string)",
              "/v1/rerank": "'query' (string)", "/rerank": "'query' (string)"}


def test_every_reference_route_is_served_or_answers_501(base_url):
    routes = _reference_routes()
    assert len(routes) == 24
    for method, path in routes:
        # A templated segment ({request_id}) takes a concrete value.
        concrete = re.sub(r"\{[^}]+\}", "req-123", path)
        url = base_url + concrete
        body = {"prompt": "x", "max_tokens": 1, "temperature": 0,
                "messages": [{"role": "user", "content": "x"}]}
        if (method, path) == ("POST", "/drain"):
            # Served (tests/test_torch_fleet.py drives it on a server of
            # its own): a drain here would turn this module's later
            # requests away.
            assert (method, path) in SERVED_ROUTES
            assert unported_feature(method, concrete) is None
            continue
        status, text = (_get_status(url) if method == "GET"
                        else _post(url, body))
        if (method, path) in (("POST", "/v1/resume"),
                              ("POST", "/v1/disagg/handoff")):
            # Served: a body without a descriptor is the JAX server's 400.
            assert status == 400 and "descriptor" in text, text
            continue
        if (method, path) == ("GET", "/debug/trace/{request_id}"):
            # Served: an id the flight recorder never saw is a 404.
            assert status == 404 and "no trace" in text, text
            continue
        if path in POOLED_400:
            # Served: a completion's body has none of their fields.
            assert status == 400 and POOLED_400[path] in text, text
            continue
        if (method, path) in SERVED_ROUTES:
            assert status == 200, (method, path, text)
            continue
        feature = unported_feature(method, concrete)
        assert feature, (method, path)
        assert status == 501, (method, path, text)
        message = json.loads(text)["error"]["message"]
        assert feature in message and "not ported" in message
    assert len(SERVED_ROUTES) == 24
    assert UNPORTED_ROUTES == ()
    assert unported_feature("POST", "/v1/embeddings") is None


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


# ---- the four small flags --------------------------------------------------


def _cpu_args(*extra):
    return parse_args(["--model", "tiny-llama", "--device", "cpu",
                       "--max-model-len", "256", "--prefill-chunk-size",
                       "64", *extra])


@pytest.mark.parametrize("disabled", [False, True])
def test_disable_prefix_caching_flag(disabled):
    """--disable-prefix-caching: a repeated prompt hits no cached page."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    engine, _ = build_engine_from_args(_cpu_args(
        *(["--disable-prefix-caching"] if disabled else [])))
    assert engine.config.cache.enable_prefix_caching is not disabled
    prompt = list(range(1, 70))
    for _ in range(2):
        engine.generate(prompt, SamplingParams(temperature=0.0,
                                               max_tokens=2))
    hits = engine.cache_manager.prefix_hit_tokens
    assert (hits == 0) if disabled else (hits == 64)


class _FakeKernelLib:
    """The kernel library's support questions, answered from
    PSTT_FOR_EACH_GEOMETRY (csrc/paged_kv_common.cuh): the (dtype code,
    cache code) pairs it instantiates, at every head dim that a tile of
    PSTT_FOR_EACH_HEAD_DIM holds (head_dim_tile: 1 up to the widest
    tile) and, where the list has a slab instance (its last, SLABS
    true), every head dim past the widest tile (head_dim_slabs), for any
    query group of 1 or more; and any page of 1 token or more over those
    caches (page_size_ok)."""

    _SRC = (Path(__file__).resolve().parents[1] / "production_stack_tpu_torch"
            / "csrc" / "paged_kv_common.cuh").read_text()
    PAIRS = {tuple(map(int, x)) for x in re.findall(
        r"PSTT_FOR_EACH_HEAD_DIM\(X, (\d), [\w ]+, (\d), [\w ]+\)", _SRC)}
    INSTANCES = re.findall(r"X\(code, T, ccode, C, (\d+), (true|false)\)",
                           _SRC)
    TILES = [int(d) for d, slab in INSTANCES if slab == "false"]
    SLABS = [int(d) for d, slab in INSTANCES if slab == "true"]

    def pstt_kernel_supports(self, dtype, cache_dtype, group, head_dim):
        return int((dtype, cache_dtype) in self.PAIRS and group >= 1
                   and head_dim >= 1 and (
                       any(head_dim <= t for t in self.TILES)
                       or bool(self.SLABS)))

    def pstt_page_size_supported(self, page_size):
        return int(page_size >= 1)


def test_fake_kernel_lib_is_the_geometry_list():
    """The fake answers as the instantiation list reads, and the list is
    the Python rule (kernel_geometry_supported) over dtype codes, cache
    codes, groups and head dims, in and out of it."""
    from production_stack_tpu_torch.ops import paged_kv_common
    assert _FakeKernelLib.PAIRS == {(0, 0), (0, 2), (3, 3), (3, 2), (1, 1),
                                    (1, 2)}
    assert _FakeKernelLib.TILES == list(
        paged_kv_common.KERNEL_HEAD_DIM_TILES)
    assert _FakeKernelLib.SLABS == [paged_kv_common.SLAB_HEAD_DIM]
    codes = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 3,
             torch.int8: 2}
    fake = _FakeKernelLib()
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for cache in codes:
            for group in (0, 1, 3, 7, 8, 16):
                for d in (-1, 0, 1, 32, 33, 64, 80, 96, 100, 128, 160,
                          256, 257, 288, 512, 1100):
                    assert bool(fake.pstt_kernel_supports(
                        codes[dtype], codes[cache], group, d)) == (
                        paged_kv_common.kernel_geometry_supported(
                            dtype, cache, group, d)), (dtype, cache, group, d)


def _checkpoint_config(tmp_path, head_dim):
    """A llama config.json whose heads are ``head_dim`` wide (no
    weights: the gate runs before any is read)."""
    import json
    heads = 8
    (tmp_path / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "vocab_size": 512,
        "hidden_size": heads * head_dim, "intermediate_size": 256,
        "num_hidden_layers": 2, "num_attention_heads": heads,
        "num_key_value_heads": 2, "head_dim": head_dim}))
    return str(tmp_path)


@pytest.mark.parametrize("head_dim,dtype", [
    (288, "bfloat16"),
    (288, "float16"),
    (320, "float32"),
])
def test_dtype_the_kernels_lack_is_refused_on_the_card(monkeypatch, tmp_path,
                                                       head_dim, dtype):
    """--dtype on the card at a checkpoint's head_dim past the widest
    tile: no geometry of 1 or more is refused any more. The start-up
    gate passes, the rule and the library (its slab instance) both
    serving it over the model's dtype and over int8, before any weight
    is read; a head_dim under 1 is still refused, naming the rule."""
    from production_stack_tpu_torch.engine.model_runner import (
        check_engine_geometry)
    from production_stack_tpu_torch.engine.server import (
        engine_config_from_args)
    from production_stack_tpu_torch.ops import paged_kv_common
    monkeypatch.setattr(paged_kv_common, "kernel_lib", _FakeKernelLib)
    config, _ = engine_config_from_args(parse_args([
        "--model", _checkpoint_config(tmp_path, head_dim),
        "--random-weights", "--tokenizer", "bench", "--dtype", dtype]),
        torch.device("cpu"))
    assert config.model.head_dim == head_dim
    assert config.model.num_attention_heads // (
        config.model.num_key_value_heads) == 4
    for kv in ("auto", "int8"):
        config.cache.kv_cache_dtype = kv
        check_engine_geometry(config)
    with pytest.raises(NotImplementedError,
                       match="every head_dim of 1 or more.*not 0"):
        paged_kv_common.check_kernel_shapes(8, 2, 0, 16,
                                            config.model.torch_dtype)
    # The preset dtypes pass the same question.
    paged_kv_common.check_kernel_shapes(32, 8, 64, 128, torch.bfloat16)
    paged_kv_common.check_kernel_shapes(4, 2, 32, 16, torch.float32,
                                        torch.int8)


@pytest.mark.parametrize("model,dtype", [("bench-1b", "float32"),
                                         ("bench-1b", "float16"),
                                         ("tiny-llama", "bfloat16"),
                                         ("tiny-opt", "float16")])
def test_dtype_the_kernels_serve_passes_the_gate(monkeypatch, model, dtype):
    """Every --dtype of a preset passes the start-up gate on the card:
    the rule and the library (its instantiation list) both serve it."""
    from production_stack_tpu_torch.engine.model_runner import (
        check_engine_geometry)
    from production_stack_tpu_torch.engine.server import (
        engine_config_from_args)
    from production_stack_tpu_torch.ops import paged_kv_common
    monkeypatch.setattr(paged_kv_common, "kernel_lib", _FakeKernelLib)
    config, _ = engine_config_from_args(
        parse_args(["--model", model, "--dtype", dtype]),
        torch.device("cpu"))
    for kv in ("auto", "int8"):
        config.cache.kv_cache_dtype = kv
        check_engine_geometry(config)


def test_dtype_applies_on_the_cpu():
    """With --device cpu the dtype is served (plain versions)."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    engine, _ = build_engine_from_args(_cpu_args("--dtype", "bfloat16"))
    assert engine.config.model.dtype == "bfloat16"
    assert engine.runner.params.embed.dtype == torch.bfloat16
    out = engine.generate([1, 2, 3], SamplingParams(temperature=0.0,
                                                    max_tokens=3,
                                                    ignore_eos=True))
    assert len(out.output_token_ids) == 3


@pytest.mark.parametrize("impl,card,expected", [
    ("auto", True, "cuda"), ("pallas", True, "cuda"),
    ("xla", True, None), ("pallas-interpret", True, None),
    ("auto", False, "plain"), ("pallas", False, "plain"),
    ("xla", False, "plain"), ("pallas-interpret", False, "plain"),
])
def test_attention_impl_maps_onto_the_ports(impl, card, expected):
    device = torch.device("cuda" if card else "cpu")
    if expected is None:
        with pytest.raises(ValueError, match="never serves"):
            resolve_attention_impl(impl, device)
    else:
        assert resolve_attention_impl(impl, device) == expected


@pytest.mark.parametrize("impl", ["xla", "pallas-interpret"])
def test_reference_impls_are_refused_at_start_on_the_card(monkeypatch,
                                                          impl):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="plain attention"):
        make_server(["--model", "tiny-llama", "--attention-impl", impl,
                     "--port", "0"])
    engine, _ = build_engine_from_args(_cpu_args("--attention-impl", impl))
    assert engine.runner.observatory.attention_impls() == dict.fromkeys(
        ("decode", "prefill", "unified"), "plain")


def test_compilation_cache_dir_moves_the_kernel_build(monkeypatch,
                                                      tmp_path):
    """--compilation-cache-dir DIR: the library is built and found under
    DIR/kernels/<source hash>/, so a restart with the same DIR finds the
    build and runs no nvcc."""
    from production_stack_tpu_torch.ops import paged_kv_common
    monkeypatch.setattr(paged_kv_common, "BUILD_ROOT",
                        paged_kv_common.BUILD_ROOT)
    default = paged_kv_common.BUILD_ROOT
    assert default == Path(paged_kv_common.__file__).resolve().parents[2] / (
        "build/kernels")
    build_engine_from_args(_cpu_args("--compilation-cache-dir",
                                     str(tmp_path)))
    assert paged_kv_common.BUILD_ROOT == tmp_path / "kernels"
    built = (tmp_path / "kernels" / paged_kv_common._source_digest()
             / paged_kv_common.LIB_NAME)
    built.parent.mkdir(parents=True)
    built.write_bytes(b"")

    def no_nvcc():
        raise AssertionError("nvcc run although the build exists")

    monkeypatch.setattr(paged_kv_common, "_find_nvcc", no_nvcc)
    assert paged_kv_common.build_kernels() == built


# ---- checkpoint directories, tiny-opt, --tokenizer and --chat-template ------

CHECKPOINT_ARGS = ["--dtype", "float32", "--max-model-len", "256",
                   "--prefill-chunk-size", "16", "--page-size", "8",
                   "--num-pages", "128", "--max-num-seqs", "4"]
CHAT_TEMPLATE = ("<s> {% for m in messages %}{{ m['content'] }} says "
                 "{{ m['role'] }} {% endfor %}")


@pytest.fixture(scope="module")
def checkpoint_dir(tmp_path_factory):
    """A tiny HF llama checkpoint (transformers' save_pretrained) with a
    word-level tokenizer of its vocab in the same directory."""
    from tests.test_model_parity import _save_tiny_llama
    from tests.test_torch_hf_tokenizer import write_tokenizer
    path, _ = _save_tiny_llama(tmp_path_factory.mktemp("ckpt"))
    write_tokenizer(path, vocab_size=128)
    return path


def _serve(server):
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]

    def stop():
        server.shutdown()
        thread.join(timeout=30)
    return url, stop


def _jax_server(argv):
    """The JAX server from its own flags, serving in a thread."""
    from production_stack_tpu.engine import server as jax_server
    from tests.test_torch_crash_recovery import _serve_app_in_thread
    args = jax_server.parse_args(argv)
    engine, name = jax_server.build_engine_from_args(args)
    return _serve_app_in_thread(jax_server.EngineServer(
        engine, name, chat_template=jax_server._load_chat_template(args)
    ).build_app())


def _metric_names(text: str) -> set:
    """The sample names of a Prometheus text page, labels aside."""
    return {re.match(r"[^{ ]+", line).group(0)
            for line in text.splitlines() if line and line[0] != "#"}


# Names only the port's /metrics has: the steps the card ran without a
# step graph (the graphs have no JAX counterpart), and the JAX engine's
# own stats() counters of checkpoints, resumes and the offload tier,
# which its server keeps off the page.
PORT_ONLY_METRICS = {
    "vllm:engine_eager_steps_total", "vllm:checkpoint_ships_total",
    "vllm:checkpoint_kv_bytes_total", "vllm:stream_resumes_total",
    "vllm:kv_offload_host_pages", "vllm:kv_offload_host_bytes",
    "vllm:kv_offload_host_hit_rate", "vllm:kv_offload_offloaded_pages",
    "vllm:kv_offload_restored_pages"}


def test_metrics_names_are_the_jax_servers():
    """Both servers at tiny-llama on the CPU, one completion each: every
    metric name of the JAX server's /metrics (labels aside) on the
    port's, the slice gauges included and each reading slice 0 live,
    and nothing more than the port's own PORT_ONLY_METRICS."""
    argv = ["--model", "tiny-llama", "--max-model-len", "128",
            "--num-pages", "64"]
    port_url, port_stop = _serve(make_server(
        argv + ["--device", "cpu", "--host", "127.0.0.1", "--port", "0"]))
    jax_url, jax_stop = _jax_server(argv + ["--random-weights"])
    try:
        pages = []
        for url in (port_url, jax_url):
            status, _ = _post(url + "/v1/completions", {
                "prompt": "hi", "max_tokens": 4, "temperature": 0})
            assert status == 200
            pages.append(_get(url + "/metrics")[1])
    finally:
        port_stop()
        jax_stop()
    ours, theirs = (_metric_names(p) for p in pages)
    assert ours - PORT_ONLY_METRICS == theirs and PORT_ONLY_METRICS <= ours, (
        f"only the port's: {sorted(ours - theirs)}; "
        f"only the JAX server's: {sorted(theirs - ours)}")
    for page in pages:
        assert "vllm:engine_slice_id 0.0" in page.splitlines()
        assert 'vllm:engine_slice_live{slice="0"} 1.0' in page.splitlines()


@pytest.mark.parametrize("tokenizer", [[], ["--tokenizer", "bench"]],
                         ids=["own", "bench"])
def test_model_dir_serves_as_the_jax_server(checkpoint_dir, tokenizer):
    """--model DIR (its config, safetensors weights and tokenizer, or
    --tokenizer bench) with --chat-template: the chat and completion
    answers of the JAX server over the same directory, text and usage
    alike (greedy, f32 on the CPU)."""
    argv = ["--model", checkpoint_dir, *CHECKPOINT_ARGS, *tokenizer,
            "--chat-template", CHAT_TEMPLATE]
    port_url, port_stop = _serve(make_server(
        argv + ["--device", "cpu", "--host", "127.0.0.1", "--port", "0"]))
    jax_url, jax_stop = _jax_server(argv)
    try:
        bodies = [("/v1/chat/completions", {"messages": [
            {"role": "system", "content": "the cat"},
            {"role": "user", "content": "hello world"}]}),
            ("/v1/completions", {"prompt": "hi there the mat"}),
            ("/v1/completions", {"prompt": [3, 11, 25, 99, 7, 42]})]
        for path, body in bodies:
            body = {**body, "max_tokens": 10, "temperature": 0,
                    "ignore_eos": True}
            status, got = _post(port_url + path, body)
            ref_status, ref = _post(jax_url + path, body)
            assert status == ref_status == 200, got
            got, ref = json.loads(got), json.loads(ref)
            assert got["usage"] == ref["usage"], path
            for a, b in zip(got["choices"], ref["choices"]):
                assert (a.get("message") or a.get("text")) == (
                    b.get("message") or b.get("text")), path
            assert got["model"] == ref["model"] == checkpoint_dir
    finally:
        port_stop()
        jax_stop()


def test_random_weights_over_a_directory(checkpoint_dir):
    """--random-weights takes the directory's config (and tokenizer) and
    no weight of its checkpoint."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.engine.tokenizer import HFTokenizer
    from production_stack_tpu_torch.engine.weights import (
        load_model_config,
        load_weights,
    )
    engine, name = build_engine_from_args(parse_args(
        ["--model", checkpoint_dir, "--random-weights", "--device", "cpu",
         *CHECKPOINT_ARGS]))
    assert name == checkpoint_dir
    cfg = load_model_config(checkpoint_dir)
    assert engine.config.model.hidden_size == cfg.hidden_size == 64
    assert engine.config.model.vocab_size == 128
    assert isinstance(engine.tokenizer, HFTokenizer)
    loaded = load_weights(checkpoint_dir, cfg, torch.float32, "cpu")
    assert not torch.equal(engine.runner.params.embed, loaded.embed)
    out = engine.generate([5, 6, 7], SamplingParams(
        temperature=0.0, max_tokens=4, ignore_eos=True))
    assert len(out.output_token_ids) == 4


def test_tiny_opt_serves_as_the_jax_preset():
    """--model tiny-opt: the JAX preset's geometry (OPT, 4 heads of 32,
    one kv head each) with random weights and the bench tokenizer at
    its vocab; completions answer, the pooled routes answer 501 as for
    every non-llama architecture."""
    from production_stack_tpu.engine.config import (
        tiny_model_config as jax_tiny,
    )
    server = make_server(["--model", "tiny-opt", "--device", "cpu",
                          "--host", "127.0.0.1", "--port", "0",
                          "--max-model-len", "256",
                          "--prefill-chunk-size", "64"])
    url, stop = _serve(server)
    try:
        model = server.app.engine.config.model
        ref = jax_tiny("opt")
        for field in ("architecture", "vocab_size", "hidden_size",
                      "num_attention_heads", "num_key_value_heads",
                      "head_dim", "activation", "dtype"):
            assert getattr(model, field) == getattr(ref, field), field
        assert server.app.tokenizer.vocab_size == 512
        status, text = _post(url + "/v1/completions", {
            "prompt": "hello", "max_tokens": 5, "temperature": 0,
            "ignore_eos": True})
        assert status == 200
        assert json.loads(text)["usage"]["completion_tokens"] == 5
        assert json.loads(_get(url + "/v1/models")[1])["data"][0][
            "id"] == "tiny-opt"
        status, text = _post(url + "/v1/embeddings", {"input": "hi"})
        assert status == 501 and "llama family" in text
    finally:
        stop()
