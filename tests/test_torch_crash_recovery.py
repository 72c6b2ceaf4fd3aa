"""Stream checkpoints and ``/v1/resume`` in the port, modelled on the
reference's ``tests/test_crash_recovery.py`` (its real-engine resume
cases): a greedy stream checkpointed by one port server is resumed by
another over a remote KV tier (``host_pool_bytes`` 0, so every restore
is a real fetch from the cache server), for bf16-family and int8 KV; a
checkpoint whose pages are gone recomputes from the token journal; a
resume parked in AWAITING_KV holds no page; the resume route answers
the JAX server's 400s and 409; and a JAX engine's checkpoint, with its
pages on the JAX cache server, is resumed by a port engine.

Both packages serve tiny-llama with the same weights (the JAX
``init_params`` dict, converted). Tolerance: the resumed text must be
byte-identical to the uninterrupted stream (greedy decoding).
"""

import asyncio
import json
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import config as port_config
from production_stack_tpu_torch.engine.cache_server import (
    build_cache_server,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.offload import _stable_key
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    SequenceState,
)
from production_stack_tpu_torch.engine.server import (
    EngineHTTPServer,
    EngineServer,
)
from production_stack_tpu_torch.engine.tokenizer import BenchTokenizer
from production_stack_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

PAGE_SIZE = 16
# Long prompt: several full KV pages committed before generation, so
# checkpoints have real pages to ship.
LONG_CHAT = {
    "model": "tiny-llama",
    "messages": [{"role": "user", "content": " ".join(["hello"] * 8)}],
    "max_tokens": 12,
    "temperature": 0,
    "ignore_eos": True,
    "stream": True,
}


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


# ---- helpers shared with tests/test_torch_fleet.py ---------------------------


def engine_config(remote_url=None, kv_dtype="auto", checkpoint=4,
                  handoff_timeout_s=30.0, host_pool_bytes=0,
                  num_pages=64, max_num_seqs=2, enable_offload=None,
                  layout="auto", **extra):
    """The reference test's engine: tiny-llama, pages of 16, a remote
    tier only (``host_pool_bytes`` 0) unless asked."""
    return port_config.EngineConfig(
        model=port_config.tiny_model_config("llama"),
        cache=port_config.CacheConfig(page_size=PAGE_SIZE,
                                      num_pages=num_pages,
                                      kv_cache_dtype=kv_dtype,
                                      cache_layout=layout),
        scheduler=port_config.SchedulerConfig(**{
            "max_num_seqs": max_num_seqs, "max_model_len": 256,
            "prefill_chunk_size": 64, **extra.pop("scheduler", {})}),
        offload=port_config.OffloadConfig(
            enable=(remote_url is not None if enable_offload is None
                    else enable_offload),
            remote_url=remote_url, host_pool_bytes=host_pool_bytes),
        checkpoint_interval_tokens=checkpoint,
        handoff_timeout_s=handoff_timeout_s, **extra)


def port_engine(weights, cfg) -> LLMEngine:
    # BenchTokenizer: one printable character a token, so a stream
    # under random weights has content deltas to carry checkpoints.
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                   "cpu"),
                     tokenizer=BenchTokenizer(cfg.model.vocab_size),
                     device="cpu")


class PortServer:
    """A port server on a free port, serving on a thread."""

    def __init__(self, engine: LLMEngine, **kwargs):
        self.app = EngineServer(engine, "tiny-llama", **kwargs)
        self.http = EngineHTTPServer(("127.0.0.1", 0), self.app)
        self.thread = threading.Thread(target=self.http.serve, daemon=True)
        self.thread.start()
        self.url = "http://127.0.0.1:%d" % self.http.server_address[1]
        self.engine = engine

    def stop(self) -> None:
        self.http.shutdown()
        self.thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


def serve_cache(**kwargs):
    """The port's cache server on a thread: (url, server)."""
    server = build_cache_server(256 * 1024 ** 2, **kwargs)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server.url, server


def request(method, url, body=None, headers=None, timeout=120):
    """(status, text, headers) of one request; HTTP errors included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type":
                                          "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), dict(e.headers)


def parse_stream(raw: str):
    """Ordered (kind, payload) events: ("ckpt", descriptor) for
    checkpoint comment frames, ("data", event) for data events,
    ("migrating", None) for the drain cut's marker."""
    events = []
    for block in raw.split("\n\n"):
        block = block.strip()
        if block.startswith(": checkpoint "):
            events.append(("ckpt", json.loads(block[len(": checkpoint "):])))
        elif block == ": migrating":
            events.append(("migrating", None))
        elif block.startswith("data: ") and block != "data: [DONE]":
            events.append(("data", json.loads(block[len("data: "):])))
    return events


def delta_content(event: dict) -> str:
    return (event["choices"][0].get("delta") or {}).get("content") or ""


def pick_checkpoint(events, max_tokens=LONG_CHAT["max_tokens"]):
    """The first mid-stream checkpoint whose journal does not end on a
    page boundary (so its last full page was shipped and a restore
    hits), with the content characters delivered before it."""
    seen = 0
    for kind, payload in events:
        if kind == "data":
            seen += len(delta_content(payload))
        elif (kind == "ckpt" and payload["output_tokens"] < max_tokens
              and len(payload["tokens"]) % PAGE_SIZE != 0):
            return payload, seen
    raise AssertionError("no usable mid-stream checkpoint frame")


def capture_interrupted(url):
    """Stream LONG_CHAT from ``url``: (full text, response id,
    descriptor, characters delivered before it)."""
    status, raw, _ = request("POST", url + "/v1/chat/completions",
                             LONG_CHAT)
    assert status == 200, raw
    assert raw.rstrip().endswith("data: [DONE]")
    events = parse_stream(raw)
    datas = [e for kind, e in events if kind == "data"]
    desc, delivered = pick_checkpoint(events)
    assert len(desc["tokens"]) // PAGE_SIZE >= 1
    return ("".join(delta_content(e) for e in datas), datas[0]["id"], desc,
            delivered)


def resume_tail(url, desc, delivered):
    """POST /v1/resume and return (status, data events)."""
    status, raw, _ = request("POST", url + "/v1/resume", {
        "descriptor": desc, "delivered_text_chars": delivered,
        "stream": True})
    events = parse_stream(raw) if status == 200 else []
    assert all(kind in ("data", "ckpt") for kind, _ in events)
    return status, [e for kind, e in events if kind == "data"]


def free_port_url() -> str:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return f"http://127.0.0.1:{port}"


@pytest.fixture(scope="module")
def cache_url():
    url, server = serve_cache()
    yield url
    server.shutdown()


# ---- the tests -----------------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_resume_byte_identical_across_port_servers(weights, cache_url,
                                                   kv_dtype):
    """A fresh port server restores the shipped checkpoint pages from
    the remote tier and continues the greedy stream: the concatenated
    text is byte-identical, under the original response id, with no
    second role chunk."""
    with PortServer(port_engine(weights, engine_config(
            cache_url, kv_dtype))) as a:
        full_text, rid, desc, delivered = capture_interrupted(a.url)
        stats = a.engine.stats()
    assert desc["kv_dtype"] == a.engine.config.cache.resolved_kv_dtype()
    assert stats["checkpoint_ships_total"] > 0
    assert stats["checkpoint_kv_bytes_total"] > 0
    assert desc["response_id"] == rid and desc["chat"] is True

    with PortServer(port_engine(weights, engine_config(
            cache_url, kv_dtype))) as b:
        status, datas = resume_tail(b.url, desc, delivered)
        assert status == 200
        tail = "".join(delta_content(e) for e in datas)
        assert full_text[:delivered] + tail == full_text
        assert {e["id"] for e in datas} == {rid}
        assert all("role" not in (e["choices"][0].get("delta") or {})
                   for e in datas)
        assert datas[-1]["choices"][0]["finish_reason"] == "length"
        # The pages came back from the tier (a hit, not a recompute).
        assert b.engine.offload.restored_pages > 0
        assert b.engine.stats()["kv_offload_cluster_hits"] > 0
        assert b.engine.stats()["stream_resumes_total"] == 1
        # The AWAITING_KV admission fed the handoff-latency histogram.
        assert b.engine.metrics.handoff_latency.n == 1
        assert "vllm:disagg_handoff_latency_seconds_count 1" in request(
            "GET", b.url + "/metrics")[1]


def test_resume_checkpoint_miss_recomputes_parity(weights, cache_url):
    """A replacement whose tier lost the pages (here: unreachable)
    recomputes from the token journal; the tail is byte-identical."""
    with PortServer(port_engine(weights, engine_config(cache_url))) as a:
        full_text, rid, desc, delivered = capture_interrupted(a.url)
    with PortServer(port_engine(weights, engine_config(
            free_port_url(), checkpoint=0, handoff_timeout_s=0.0))) as b:
        status, datas = resume_tail(b.url, desc, delivered)
        assert status == 200
        tail = "".join(delta_content(e) for e in datas)
        assert full_text[:delivered] + tail == full_text
        assert {e["id"] for e in datas} == {rid}
        assert b.engine.offload.restored_pages == 0  # recomputed
        assert b.engine.stats()["stream_resumes_total"] == 1


def test_resume_without_a_tier_recomputes_non_streamed(weights, cache_url):
    """No offload tier at all: the resume recomputes from the journal,
    and a non-streamed resume answers the rest as one completion whose
    usage counts the journal's tokens."""
    with PortServer(port_engine(weights, engine_config(cache_url))) as a:
        full_text, rid, desc, delivered = capture_interrupted(a.url)
    with PortServer(port_engine(weights, engine_config(
            None, checkpoint=0))) as b:
        status, text, _ = request("POST", b.url + "/v1/resume", {
            "descriptor": desc, "delivered_text_chars": delivered,
            "stream": False})
        assert status == 200, text
        ans = json.loads(text)
        assert ans["id"] == rid and ans["object"] == "chat.completion"
        assert full_text[:delivered] + ans["choices"][0]["message"][
            "content"] == full_text
        assert ans["usage"]["completion_tokens"] == LONG_CHAT["max_tokens"]
        assert b.engine.offload is None


def test_resume_abort_while_awaiting_kv_frees_every_page(weights,
                                                         cache_url):
    """A resume parked in AWAITING_KV holds no page: an abort while it
    waits releases nothing, leaves every page free and no work."""
    eng = port_engine(weights, engine_config(cache_url))
    # Pin the sequence in AWAITING_KV: no tier verdict, and the 30 s
    # timeout never fires within the test.
    eng.offload.handoff_ready = lambda page_hash: None
    free_before = eng.cache_manager.num_free_pages
    assert free_before == eng.config.cache.num_pages - 1
    sid = eng.add_resume(list(range(1, 50)), 7, SamplingParams(
        max_tokens=12, temperature=0.0, ignore_eos=True))
    seq = eng.sequences[sid]
    for _ in range(3):
        eng.step()
    assert seq.state == SequenceState.AWAITING_KV
    stats = eng.stats()
    assert stats["num_requests_waiting"] == 1
    assert stats["disagg_awaiting_kv_requests"] == 1
    assert stats["stream_resumes_total"] == 1
    eng.abort_request(sid)
    assert sid not in eng.sequences
    assert eng.stats()["num_requests_waiting"] == 0
    assert eng.cache_manager.num_free_pages == free_before
    assert not eng.scheduler.has_work()


GOOD_DESC = {"tokens": [5, 6, 7, 8, 9], "output_tokens": 2,
             "kv_dtype": "bf16", "chat": True, "sampling": {}}


@pytest.mark.parametrize("body,status,message", [
    ({}, 400, "'descriptor' object is required"),
    ({"descriptor": "x"}, 400, "'descriptor' object is required"),
    ({"descriptor": dict(GOOD_DESC, tokens=[])}, 400,
     "descriptor missing tokens/output_tokens"),
    ({"descriptor": dict(GOOD_DESC, tokens=[1, "a"])}, 400,
     "descriptor missing tokens/output_tokens"),
    ({"descriptor": dict(GOOD_DESC, output_tokens=0)}, 400,
     "descriptor missing tokens/output_tokens"),
    ({"descriptor": dict(GOOD_DESC, output_tokens=5)}, 400,
     "descriptor missing tokens/output_tokens"),
    ({"descriptor": dict(GOOD_DESC, kv_dtype="int8")}, 409,
     "checkpoint KV not restorable here (descriptor kv_dtype 'int8', "
     "engine 'bf16')"),
    ({"descriptor": dict(GOOD_DESC, sampling={"guided": "json"})}, 400,
     "guided streams cannot be resumed"),
    ({"descriptor": GOOD_DESC, "delivered_text_chars": -3}, 400,
     "delivered_text_chars must be a non-negative integer"),
    ({"descriptor": GOOD_DESC, "delivered_text_chars": "x"}, 400,
     "delivered_text_chars must be a non-negative integer"),
], ids=["no-descriptor", "descriptor-not-object", "no-tokens",
        "bad-token", "no-output", "all-output", "kv-dtype", "guided",
        "negative-delivered", "bad-delivered"])
def test_resume_route_answers_the_reference_400s_and_409(weights, body,
                                                         status, message):
    """The JAX server's answers to a bad resume, message for message
    (``production_stack_tpu/engine/server.py`` ``resume``)."""
    with PortServer(port_engine(weights, engine_config(None))) as srv:
        got, text, _ = request("POST", srv.url + "/v1/resume", body)
        assert got == status, text
        assert json.loads(text)["error"]["message"] == message
        assert srv.engine.stats()["stream_resumes_total"] == 0


def _serve_app_in_thread(app):
    """An aiohttp app on a real socket in a daemon thread: (url, stop)."""
    from aiohttp import web
    loop = asyncio.new_event_loop()
    started = threading.Event()
    port_box = {}

    def serve():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        port_box["port"] = site._server.sockets[0].getsockname()[1]
        started.set()
        loop.run_forever()
        loop.run_until_complete(runner.cleanup())

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    assert started.wait(10.0)

    def stop():
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=10.0)

    return f"http://127.0.0.1:{port_box['port']}", stop


def test_jax_checkpoint_resumed_by_a_port_engine(weights):
    """Across packages: a JAX engine's checkpoint, its pages on the JAX
    cache server, resumed by a port engine with the converted weights,
    continues byte-identically; the pages restore from the JAX server
    under the keys the port computes (tier keys and payloads are the
    same on both sides)."""
    import jax.numpy as jnp

    from production_stack_tpu.engine.cache_server import (
        build_cache_server as jax_cache_server,
    )
    from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
    from production_stack_tpu.engine.kv_cache import (
        PagedCacheManager as JaxCache,
    )
    from production_stack_tpu.engine.server import (
        EngineServer as JaxServer,
    )
    from production_stack_tpu.engine.tokenizer import (
        BenchTokenizer as JaxBench,
    )

    cache = jax_cache_server(256 * 1024 ** 2)
    cache_url, stop_cache = _serve_app_in_thread(cache)
    jax_cfg = jax_config.EngineConfig(
        model=jax_config.tiny_model_config("llama"),
        cache=jax_config.CacheConfig(page_size=PAGE_SIZE, num_pages=64),
        scheduler=jax_config.SchedulerConfig(max_num_seqs=2, max_model_len=256,
                                     prefill_chunk_size=64),
        offload=jax_config.OffloadConfig(enable=True, remote_url=cache_url,
                                 host_pool_bytes=0),
        checkpoint_interval_tokens=4)
    jax_engine = JaxEngine(jax_cfg, params={
        k: jnp.asarray(v) for k, v in weights.items()},
        tokenizer=JaxBench(512))
    app_url, stop_app = _serve_app_in_thread(
        JaxServer(jax_engine, "tiny-llama").build_app())
    try:
        full_text, rid, desc, delivered = capture_interrupted(app_url)
    finally:
        stop_app()
    try:
        # The port's tier keys of the journal's full pages are the keys
        # the JAX engine stored them under.
        store = cache["store"]
        hashes = JaxCache.chain_hashes(desc["tokens"][:-1], PAGE_SIZE)
        assert hashes and all(
            _stable_key(h, "float32") in store._blobs
            for h in hashes[:desc["num_pages"]])
        with PortServer(port_engine(weights, engine_config(
                cache_url))) as b:
            status, datas = resume_tail(b.url, desc, delivered)
            assert status == 200
            tail = "".join(delta_content(e) for e in datas)
            assert full_text[:delivered] + tail == full_text
            assert {e["id"] for e in datas} == {rid}
            assert b.engine.offload.restored_pages > 0
    finally:
        stop_cache()
