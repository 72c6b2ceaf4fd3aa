"""Disaggregated prefill and decode in the port, modelled on the
reference's ``tests/test_disaggregation.py``: the role rules of the
config, a prefill-role engine shipping the prompt's pages to the port's
cache server and a decode-role engine continuing from them, byte for
byte the port's monolithic stream and the JAX engine's, for f32 and int8
KV; a missing page and an unreachable tier degrade to an exact
recompute; an abort while parked frees nothing; the descriptor has the
JAX server's keys and each server's handoff route takes the other's
descriptor; the repo's router in front of a prefill-role and a
decode-role port server gives the monolithic stream.

Tiny-llama with the JAX package's random weights, converted; greedy
streams must be byte-identical.
"""

import asyncio
import json

import numpy as np
import pytest
import torch

import jax

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import config as port_config
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    SequenceState,
)
from production_stack_tpu_torch.engine.server import (
    build_engine_from_args,
    parse_args,
)
from tests.test_torch_crash_recovery import (
    PortServer,
    _serve_app_in_thread,
    engine_config,
    free_port_url,
    parse_stream,
    port_engine,
    request,
    serve_cache,
)

torch.set_num_threads(2)

PROMPT = list(range(1, 50))  # 3 full pages of 16 and a tail
# Never shipped by any test: its pages miss in the shared tier.
MISS_PROMPT = list(range(101, 150))
MAX_TOKENS = 12


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


@pytest.fixture(scope="module")
def cache_url():
    url, server = serve_cache()
    yield url
    server.shutdown()


def _sampling():
    return SamplingParams(max_tokens=MAX_TOKENS, temperature=0.0,
                          ignore_eos=True)


def _engine(weights, remote_url=None, role="both", kv_dtype="auto",
            **extra):
    return port_engine(weights, engine_config(
        remote_url, kv_dtype=kv_dtype, checkpoint=0, engine_role=role,
        **extra))


def _jax_engine(weights, kv_dtype):
    import jax.numpy as jnp

    from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
    return JaxEngine(jax_config.EngineConfig(
        model=jax_config.tiny_model_config("llama"),
        cache=jax_config.CacheConfig(page_size=16, num_pages=64,
                                     kv_cache_dtype=kv_dtype),
        scheduler=jax_config.SchedulerConfig(
            max_num_seqs=2, max_model_len=256, prefill_chunk_size=64)),
        params={k: jnp.asarray(v) for k, v in weights.items()})


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The JAX engine's greedy streams: PROMPT with f32 and int8 KV, and
    MISS_PROMPT ("miss") with f32."""
    from production_stack_tpu.engine.sequence import (
        SamplingParams as JaxSampling,
    )

    def stream(engine, prompt):
        return engine.generate(list(prompt), JaxSampling(
            max_tokens=MAX_TOKENS, temperature=0.0,
            ignore_eos=True)).output_token_ids

    f32 = _jax_engine(weights, "auto")
    return {"auto": stream(f32, PROMPT), "miss": stream(f32, MISS_PROMPT),
            "int8": stream(_jax_engine(weights, "int8"), PROMPT)}


def _prefill(engine, prompt):
    """Drive a prefill-role engine to its handoff: (first token, the
    staged descriptor payload)."""
    sid = engine.add_request(list(prompt), _sampling(), handoff_prefill=True)
    outs = []
    while not outs or not outs[-1].finished:
        outs.extend(engine.step())
    assert outs[-1].finish_reason == "handoff"
    return outs[-1].new_token, engine.take_handoff_info(sid)


def _decode(engine, prompt, first):
    """Drive a decode-role engine from a handoff to its end: the whole
    output, the first token included."""
    seq = engine.sequences[engine.add_handoff(list(prompt), first,
                                              _sampling())]
    while seq.state not in (SequenceState.FINISHED, SequenceState.ABORTED):
        engine.step()
    assert seq.state == SequenceState.FINISHED
    return [first] + seq.output_token_ids


# ---- the config's role rules ------------------------------------------------


def test_engine_role_value_validated():
    with pytest.raises(ValueError, match="engine_role"):
        port_config.EngineConfig(engine_role="compute")
    with pytest.raises(ValueError, match="handoff_timeout_s"):
        port_config.EngineConfig(handoff_timeout_s=-1.0)
    with pytest.raises(ValueError, match="device_peak_flops"):
        port_config.EngineConfig(device_peak_flops=-1.0)


def test_engine_role_prefill_rejects_speculative_k():
    with pytest.raises(ValueError, match="engine_role"):
        port_config.EngineConfig(
            engine_role="prefill",
            scheduler=port_config.SchedulerConfig(speculative_k=2))
    port_config.EngineConfig(
        engine_role="decode",
        scheduler=port_config.SchedulerConfig(speculative_k=2))


def test_engine_role_prefill_accepts_async_scheduling():
    """Legal and inert: a prefill-role engine has no decode step to
    overlap."""
    for role in ("prefill", "both"):
        port_config.EngineConfig(
            engine_role=role,
            scheduler=port_config.SchedulerConfig(async_scheduling=True))


@pytest.mark.parametrize("role,async_on,unified", [
    ("both", True, True), ("prefill", False, False),
    ("decode", True, False)])
def test_server_auto_resolution_by_role(role, async_on, unified):
    """--unified-step auto resolves through unified_step_eligible (off
    for a role engine); --async-scheduling auto is off for the prefill
    role, as the JAX server resolves them."""
    engine, _ = build_engine_from_args(parse_args(
        ["--device", "cpu", "--engine-role", role, "--max-model-len",
         "128", "--num-pages", "32"]))
    sched = engine.config.scheduler
    assert (sched.async_scheduling, sched.unified_step) == (async_on,
                                                           unified)
    assert engine.config.engine_role == role
    assert engine.tracer is not None and engine.tracer.role == role


# ---- the engines: prefill ships, decode continues ----------------------------


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_disagg_parity_with_monolithic(weights, cache_url, jax_streams,
                                       kv_dtype):
    ref = _engine(weights, kv_dtype=kv_dtype).generate(list(PROMPT),
                                                        _sampling())
    pre = _engine(weights, cache_url, "prefill", kv_dtype)
    first, info = _prefill(pre, PROMPT)
    assert info["num_pages"] == 3 and len(info["page_keys"]) == 3
    # 3 pages of 16 tokens, 2 layers x 2 planes x 2 kv heads x 32:
    # f32 4 bytes a value; int8 1 byte and an f32 scale a slot.
    per_page = (16 * 2 * 2 * 2 * 32 * 4 if kv_dtype == "auto"
                else 16 * 2 * 2 * 2 * (32 + 4))
    assert info["kv_bytes"] == 3 * per_page
    stats = pre.stats()
    assert stats["disagg_prefill_requests_total"] == 1
    assert stats["disagg_kv_bytes_shipped_total"] == info["kv_bytes"]
    assert not pre.scheduler.has_work()  # retired, its pages free

    dec = _engine(weights, cache_url, "decode", kv_dtype)
    seq = dec.sequences[dec.add_handoff(list(PROMPT), first, _sampling())]
    assert seq.state == SequenceState.AWAITING_KV
    assert dec.stats()["disagg_awaiting_kv_requests"] == 1
    while seq.state != SequenceState.FINISHED:
        dec.step()
    got = [first] + seq.output_token_ids
    assert got == ref.output_token_ids == jax_streams[kv_dtype]
    assert dec.offload.restored_pages == 3
    assert dec.stats()["disagg_decode_requests_total"] == 1
    assert dec.stats()["disagg_awaiting_kv_requests"] == 0


def test_handoff_kv_miss_recomputes_exactly(weights, cache_url,
                                            jax_streams):
    """Pages never shipped: the decode engine recomputes at once and
    still gives the monolithic stream."""
    ref = _engine(weights).generate(list(MISS_PROMPT), _sampling())
    assert ref.output_token_ids == jax_streams["miss"]
    dec = _engine(weights, cache_url, "decode")
    assert _decode(dec, MISS_PROMPT, ref.output_token_ids[0]) == jax_streams[
        "miss"]
    assert dec.offload.restored_pages == 0


def test_handoff_tier_unreachable_times_out_to_recompute(weights,
                                                         jax_streams):
    dec = _engine(weights, free_port_url(), "decode",
                  handoff_timeout_s=0.0)
    got = _decode(dec, PROMPT, jax_streams["auto"][0])
    assert got == jax_streams["auto"]
    assert dec.offload.restored_pages == 0


def test_handoff_without_a_tier_recomputes(weights, jax_streams):
    dec = _engine(weights, None, "decode")
    assert dec.offload is None
    assert _decode(dec, PROMPT, jax_streams["auto"][0]) == jax_streams[
        "auto"]


def test_awaiting_kv_abort_releases_nothing_and_clears_depth(weights,
                                                             cache_url):
    dec = _engine(weights, cache_url, "decode")
    dec.offload.handoff_ready = lambda page_hash: None  # never a verdict
    free_before = dec.cache_manager.num_free_pages
    did = dec.add_handoff(list(PROMPT), 7, _sampling())
    seq = dec.sequences[did]
    for _ in range(3):
        dec.step()
    assert seq.state == SequenceState.AWAITING_KV
    assert dec.stats()["disagg_awaiting_kv_requests"] == 1
    assert dec.stats()["num_requests_waiting"] == 1
    assert dec.cache_manager.num_free_pages == free_before
    dec.abort_request(did)
    assert did not in dec.sequences
    assert dec.stats()["disagg_awaiting_kv_requests"] == 0
    assert dec.stats()["num_requests_waiting"] == 0
    assert dec.cache_manager.num_free_pages == free_before
    assert not dec.scheduler.has_work()


def test_first_token_that_finishes_ships_nothing(weights, cache_url):
    """max_tokens 1: the first token finishes the request, so nothing is
    shipped and no descriptor is staged."""
    pre = _engine(weights, cache_url, "prefill")
    sid = pre.add_request(list(PROMPT), SamplingParams(
        max_tokens=1, temperature=0.0, ignore_eos=True),
        handoff_prefill=True)
    outs = []
    while not outs or not outs[-1].finished:
        outs.extend(pre.step())
    assert outs[-1].finish_reason == "length"
    assert pre.take_handoff_info(sid) is None
    assert pre.stats()["disagg_kv_bytes_shipped_total"] == 0


# ---- the routes, against the JAX server -------------------------------------


def _completion(prompt, stream=False):
    return {"model": "tiny-llama", "prompt": list(prompt),
            "max_tokens": MAX_TOKENS, "temperature": 0,
            "ignore_eos": True, "stream": stream}


def _jax_server(weights, cache_url, role):
    import jax.numpy as jnp

    from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
    from production_stack_tpu.engine.server import (
        EngineServer as JaxServer,
    )
    from production_stack_tpu.engine.tokenizer import (
        BenchTokenizer as JaxBench,
    )
    engine = JaxEngine(jax_config.EngineConfig(
        model=jax_config.tiny_model_config("llama"),
        cache=jax_config.CacheConfig(page_size=16, num_pages=64),
        scheduler=jax_config.SchedulerConfig(
            max_num_seqs=2, max_model_len=256, prefill_chunk_size=64),
        offload=jax_config.OffloadConfig(enable=True, remote_url=cache_url,
                                         host_pool_bytes=0),
        engine_role=role),
        params={k: jnp.asarray(v) for k, v in weights.items()},
        tokenizer=JaxBench(512))
    return _serve_app_in_thread(JaxServer(engine, "tiny-llama").build_app())


def test_descriptors_cross_between_the_port_and_jax_servers(weights,
                                                            cache_url):
    """The port's descriptor has the JAX descriptor's keys; a JAX
    decode-role server continues the port's descriptor and a port one
    the JAX server's, each giving the monolithic text."""
    with PortServer(_engine(weights, cache_url)) as mono:
        status, text, _ = request("POST", mono.url + "/v1/completions",
                                  _completion(PROMPT))
        assert status == 200
        expected = json.loads(text)["choices"][0]["text"]
    jax_pre, stop_pre = _jax_server(weights, cache_url, "prefill")
    jax_dec, stop_dec = _jax_server(weights, cache_url, "decode")
    try:
        with PortServer(_engine(weights, cache_url, "prefill")) as pre, \
                PortServer(_engine(weights, cache_url, "decode")) as dec:
            descs = {}
            for name, url in (("port", pre.url), ("jax", jax_pre)):
                status, text, _ = request("POST", url + "/v1/disagg/prefill",
                                          _completion(PROMPT))
                assert status == 200, text
                descs[name] = json.loads(text)["descriptor"]
            assert set(descs["port"]) == set(descs["jax"])
            for key in ("token_ids", "first_token", "finish_reason",
                        "kv_dtype", "page_keys", "num_pages", "kv_bytes",
                        "chat", "model", "version"):
                assert descs["port"][key] == descs["jax"][key], key
            for desc, url in ((descs["port"], jax_dec),
                              (descs["jax"], dec.url)):
                status, text, _ = request("POST", url + "/v1/disagg/handoff",
                                          {"descriptor": desc})
                assert status == 200, text
                answer = json.loads(text)
                assert answer["choices"][0]["text"] == expected
                assert answer["usage"] == {
                    "prompt_tokens": len(PROMPT),
                    "completion_tokens": MAX_TOKENS,
                    "total_tokens": len(PROMPT) + MAX_TOKENS}
            assert dec.engine.offload.restored_pages == 3
            # The streamed form: a chunk a token from the first on.
            status, raw, _ = request("POST", dec.url + "/v1/disagg/handoff",
                                     {"descriptor": descs["port"],
                                      "stream": True})
            datas = [e for kind, e in parse_stream(raw) if kind == "data"]
            assert "".join(e["choices"][0]["text"] for e in datas) == expected
            assert datas[-1]["choices"][0]["finish_reason"] == "length"
            assert raw.rstrip().endswith("data: [DONE]")
    finally:
        stop_pre()
        stop_dec()


def test_handoff_route_validation_and_roles(weights, cache_url):
    """The JAX handlers' 400s and 409; and, as in the JAX server, no
    role gate: a decode-role engine prefills and answers a descriptor, a
    prefill-role engine continues a handoff."""
    with PortServer(_engine(weights, cache_url, "decode")) as dec, \
            PortServer(_engine(weights, cache_url, "prefill")) as pre:
        for body in ({}, {"descriptor": {"token_ids": [1, 2]}},
                     {"descriptor": {"token_ids": "x", "first_token": 1}}):
            status, _, _ = request("POST", dec.url + "/v1/disagg/handoff",
                                   body)
            assert status == 400
        status, text, _ = request(
            "POST", dec.url + "/v1/disagg/handoff",
            {"descriptor": {"token_ids": [1, 2], "first_token": 3,
                            "kv_dtype": "int8"}})
        assert status == 409 and "kv_dtype" in text
        for body in ({"prompt": [1, 2, 3], "logprobs": 2},
                     {"prompt": [1, 2, 3],
                      "response_format": {"type": "json_object"}},
                     {"prompt": [1] * 300}):
            status, _, _ = request("POST", pre.url + "/v1/disagg/prefill",
                                   body)
            assert status == 400
        status, text, _ = request("POST", dec.url + "/v1/disagg/prefill",
                                  _completion(PROMPT))
        assert status == 200, text
        desc = json.loads(text)["descriptor"]
        assert desc["token_ids"] == PROMPT and desc["num_pages"] == 3
        status, text, _ = request("POST", pre.url + "/v1/disagg/handoff",
                                  {"descriptor": desc})
        assert status == 200, text
        answer = json.loads(text)
        assert answer["usage"]["completion_tokens"] == MAX_TOKENS
        assert pre.engine.stats()["disagg_decode_requests_total"] == 1
        # A descriptor whose first token already finished: that token
        # alone, no engine sequence.
        status, text, _ = request(
            "POST", dec.url + "/v1/disagg/handoff",
            {"descriptor": {"token_ids": [1, 2], "first_token": 65,
                            "finish_reason": "length", "chat": False}})
        answer = json.loads(text)
        assert status == 200 and answer["choices"][0] == {
            "index": 0, "text": "A", "finish_reason": "length"}
        assert dec.engine.stats()["disagg_decode_requests_total"] == 0


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_two_hops_on_same_role_engines_match_monolithic(weights, cache_url,
                                                        role):
    """Both hops against two engines of one role, as a stale or static
    role would send them: the greedy stream is byte-identical to the
    monolithic server's."""
    with PortServer(_engine(weights, cache_url)) as mono:
        status, text, _ = request("POST", mono.url + "/v1/completions",
                                  _completion(PROMPT))
        assert status == 200
        expected = json.loads(text)["choices"][0]["text"]
    with PortServer(_engine(weights, cache_url, role)) as first, \
            PortServer(_engine(weights, cache_url, role)) as second:
        status, text, _ = request("POST", first.url + "/v1/disagg/prefill",
                                  _completion(PROMPT))
        assert status == 200, text
        desc = json.loads(text)["descriptor"]
        status, text, _ = request("POST", second.url + "/v1/disagg/handoff",
                                  {"descriptor": desc})
        assert status == 200, text
        assert json.loads(text)["choices"][0]["text"] == expected
        assert second.engine.offload.restored_pages == 3


# ---- the repo's router in front of two port servers -----------------------------


def test_router_two_hop_over_port_servers_matches_monolithic(weights,
                                                             cache_url):
    from aiohttp.test_utils import TestClient, TestServer

    from production_stack_tpu.router.app import build_app
    from production_stack_tpu.router.resilience import (
        ResilienceConfig,
        initialize_resilience,
    )
    from production_stack_tpu.router.routing.logic import (
        initialize_routing_logic,
    )
    from production_stack_tpu.router.service_discovery import (
        initialize_service_discovery,
    )
    from production_stack_tpu.router.services import request_service
    from production_stack_tpu.router.services.rewriter import (
        initialize_request_rewriter,
    )
    from production_stack_tpu.router.stats.engine_stats import (
        initialize_engine_stats_scraper,
    )
    from production_stack_tpu.router.stats.request_stats import (
        initialize_request_stats_monitor,
    )

    chat = {"model": "tiny-llama", "max_tokens": MAX_TOKENS,
            "temperature": 0, "ignore_eos": True,
            "messages": [{"role": "user", "content": "hello " * 8}]}
    with PortServer(_engine(weights)) as mono:
        ref = json.loads(request("POST", mono.url + "/v1/chat/completions",
                                 chat)[1])["choices"][0]["message"]
        raw = request("POST", mono.url + "/v1/chat/completions",
                      dict(chat, stream=True))[1]
        ref_deltas = [e["choices"][0]["delta"].get("content")
                      for kind, e in parse_stream(raw) if kind == "data"]
    with PortServer(_engine(weights, cache_url, "prefill")) as pre, \
            PortServer(_engine(weights, cache_url, "decode")) as dec:

        async def run():
            request_service.disagg_handoffs_total = 0
            request_service.disagg_fallbacks_total = 0
            initialize_service_discovery(
                "static", urls=[pre.url, dec.url],
                models=["tiny-llama"] * 2, roles=["prefill", "decode"])
            initialize_request_stats_monitor(60.0)
            initialize_engine_stats_scraper(3600.0)
            initialize_routing_logic("roundrobin")
            initialize_request_rewriter("noop")
            initialize_resilience(ResilienceConfig(
                max_retries=2, backend_connect_timeout=5.0,
                backend_timeout=60.0, health_check_interval=0.0))
            client = TestClient(TestServer(build_app()))
            await client.start_server()
            try:
                resp = await client.post("/v1/chat/completions", json=chat)
                assert resp.status == 200
                whole = await resp.json()
                resp = await client.post("/v1/chat/completions",
                                         json=dict(chat, stream=True))
                assert resp.status == 200
                return whole, await resp.text()
            finally:
                await client.close()

        whole, streamed = asyncio.run(run())
        assert whole["choices"][0]["message"] == ref
        deltas = [e["choices"][0]["delta"].get("content")
                  for kind, e in parse_stream(streamed) if kind == "data"]
        assert "".join(d or "" for d in deltas) == "".join(
            d or "" for d in ref_deltas)
        assert request_service.disagg_handoffs_total == 2
        assert request_service.disagg_fallbacks_total == 0
        assert pre.engine.stats()["disagg_prefill_requests_total"] == 2
        assert dec.engine.stats()["disagg_decode_requests_total"] == 2
        assert dec.engine.offload.restored_pages > 0
