"""The port's pooled routes (engine/embeddings.py, models/llama.py
``encode``; /v1/embeddings, /v1/score, /score, /v1/rerank, /rerank)
against the JAX package's, modelled on the reference's
``tests/test_embeddings.py`` and ``tests/test_score_rerank.py``.

- ``parse_embedding_input`` gives the JAX token lists, or the JAX
  error, for every input form.
- ``encode`` and the ``Embedder`` at the same f32 tiny-llama weights
  (the JAX ``init_params`` dict, carried across): hidden states and
  pooled unit vectors within 1e-5 of the JAX package's, pooling
  ``last`` and ``mean``, across token buckets and batch chunks; a
  vector does not depend on its padding; the same refusals.
- The five routes of a port server and of the JAX server over the same
  weights: the same values within 1e-5, the same order, the same
  errors.
- An embeddings request while a completion streams: the completion is
  byte-identical to the same completion alone, and each embed chunk
  counts one eager step of reason ``embed`` (the runner replays stand-in
  step graphs, as on the card).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine import embeddings as jax_embeddings
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.server import EngineServer as JaxServer
from production_stack_tpu.engine.tokenizer import BenchTokenizer as JaxBench
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import config as port_config
from production_stack_tpu_torch.engine import embeddings as port_embeddings
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.server import (
    EngineHTTPServer,
    EngineServer,
)
from production_stack_tpu_torch.engine.step_graphs import StepGraphs
from production_stack_tpu_torch.engine.tokenizer import BenchTokenizer
from production_stack_tpu_torch.models import llama as port_llama
from production_stack_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_crash_recovery import _serve_app_in_thread
from tests.test_torch_step_graphs import RecordingGraph

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _port_params(weights):
    return params_from_numpy(weights, port_config.tiny_model_config("llama"),
                             "cpu")


def _jax_params(weights):
    return {k: jnp.asarray(v) for k, v in weights.items()}


# ---- parse_embedding_input --------------------------------------------------


INPUTS = {
    "string": "hello world",
    "strings": ["ab", "c", "hello"],
    "token_array": [5, 6, 7],
    "token_arrays": [[5, 6], [7], [1] * 50],
    "mixed_list": ["ab", [3, 4]],
    "none": None,
    "number": 42,
    "empty_list": [],
    "empty_string": [""],
    "empty_tokens": [[]],
    "bad_entry": [["x"]],
    "float_entry": [[1.5, 2]],
    "dict": {"text": "x"},
}


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("max_len", [None, 8])
def test_parse_embedding_input_matches_jax(name, max_len):
    raw = INPUTS[name]

    def parse(module, tokenizer):
        try:
            return module.parse_embedding_input(raw, tokenizer,
                                                max_len=max_len)
        except ValueError as e:
            return ("ValueError", str(e))

    got = parse(port_embeddings, BenchTokenizer(512))
    assert got == parse(jax_embeddings, JaxBench(512))
    if name in ("none", "number", "empty_tokens", "bad_entry", "dict"):
        assert got[0] == "ValueError"


# ---- encode and the Embedder ------------------------------------------------


def test_encode_matches_jax(weights):
    cfg = port_config.tiny_model_config("llama")
    tokens = np.random.RandomState(0).randint(0, 512, size=(3, 37))
    got = port_llama.encode(_port_params(weights), cfg,
                            torch.from_numpy(tokens))
    ref = jax_llama.encode(_jax_params(weights),
                           jax_config.tiny_model_config("llama"),
                           jnp.asarray(tokens))
    assert got.shape == (3, 37, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


def _token_lists(seed=1):
    """Eleven inputs of 1 to 120 tokens: two chunks of 8, buckets 16 to
    128."""
    rs = np.random.RandomState(seed)
    return [[int(x) for x in rs.randint(1, 512, size=n)]
            for n in (1, 3, 15, 16, 17, 40, 64, 65, 100, 120, 7)]


@pytest.mark.parametrize("pooling", ["last", "mean"])
def test_embedder_matches_jax(weights, pooling):
    port = port_embeddings.Embedder(port_config.tiny_model_config("llama"),
                                    _port_params(weights), max_len=128,
                                    pooling=pooling)
    ref = jax_embeddings.Embedder(jax_config.tiny_model_config("llama"),
                                  _jax_params(weights), max_len=128,
                                  pooling=pooling)
    inputs = _token_lists()
    got = port.embed_batch(inputs)
    assert got.dtype == np.float32 and got.shape == (11, 128)
    np.testing.assert_allclose(got, ref.embed_batch(inputs), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0,
                               rtol=1e-5)
    # One chunk on its own, as the server's engine loop runs it.
    tokens = np.zeros((8, 16), np.int32)
    tokens[0, :3] = [4, 5, 6]
    lengths = np.array([3, 0, 0, 0, 0, 0, 0, 0], np.int32)
    np.testing.assert_allclose(port.run_chunk(tokens, lengths),
                               ref.run_chunk(tokens, lengths), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("pooling", ["last", "mean"])
def test_embedder_padding_invariance(weights, pooling):
    """An input embeds the same alone and beside longer ones (another
    token bucket, another chunk position)."""
    emb = port_embeddings.Embedder(port_config.tiny_model_config("llama"),
                                   _port_params(weights), max_len=128,
                                   pooling=pooling, batch_width=4)
    alone = emb.embed_batch([[4, 5, 6]])[0]
    batched = emb.embed_batch([list(range(1, 60)), [4, 5, 6],
                               list(range(1, 100))])[1]
    np.testing.assert_allclose(alone, batched, atol=ATOL, rtol=0)
    other = emb.embed_batch([[4, 5, 7]])[0]
    assert np.abs(alone - other).max() > 1e-3


def test_embedder_refusals_match_jax(weights):
    for module, cfg_mod, params in (
            (port_embeddings, port_config, _port_params(weights)),
            (jax_embeddings, jax_config, _jax_params(weights))):
        cfg = cfg_mod.tiny_model_config("llama")
        with pytest.raises(ValueError, match="pooling must be one of"):
            module.Embedder(cfg, params, max_len=64, pooling="cls")
        cfg.architecture = "opt"
        with pytest.raises(NotImplementedError,
                           match="implemented for the llama family"):
            module.Embedder(cfg, params, max_len=64)
    emb = port_embeddings.Embedder(port_config.tiny_model_config("llama"),
                                   _port_params(weights), max_len=100)
    assert [emb._bucket(n) for n in (1, 16, 17, 33, 64, 65, 100)] == [
        16, 16, 32, 64, 64, 100, 100]


# ---- the routes, against the JAX server -------------------------------------


def _port_engine(weights, pooling_max_len=128):
    cfg = port_config.EngineConfig(
        model=port_config.tiny_model_config("llama"),
        cache=port_config.CacheConfig(page_size=16, num_pages=64),
        scheduler=port_config.SchedulerConfig(
            max_num_seqs=2, max_model_len=pooling_max_len,
            prefill_chunk_size=32))
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model, "cpu"),
                     tokenizer=BenchTokenizer(512), device="cpu")


class _PortServer:
    def __init__(self, engine, pooling="last"):
        self.app = EngineServer(engine, "tiny-llama", pooling=pooling)
        self.http = EngineHTTPServer(("127.0.0.1", 0), self.app)
        self.thread = threading.Thread(target=self.http.serve, daemon=True)
        self.thread.start()
        self.url = "http://127.0.0.1:%d" % self.http.server_address[1]

    def close(self):
        self.http.shutdown()
        self.thread.join(timeout=30)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module", params=["last", "mean"])
def servers(request, weights):
    pooling = request.param
    port = _PortServer(_port_engine(weights), pooling)
    engine = JaxEngine(jax_config.EngineConfig(
        model=jax_config.tiny_model_config("llama"),
        cache=jax_config.CacheConfig(page_size=16, num_pages=64),
        scheduler=jax_config.SchedulerConfig(
            max_num_seqs=2, max_model_len=128, prefill_chunk_size=32)),
        params=_jax_params(weights), tokenizer=JaxBench(512))
    url, stop = _serve_app_in_thread(
        JaxServer(engine, "tiny-llama", pooling=pooling).build_app())
    yield port.url, url
    port.close()
    stop()


ROUTE_BODIES = [
    ("/v1/embeddings", {"input": ["hello", "world", "a longer input " * 9]}),
    ("/v1/embeddings", {"input": [[5, 6, 7], [9] * 130]}),
    ("/v1/embeddings", {"input": "one string"}),
    ("/v1/score", {"text_1": "the quick brown fox",
                   "text_2": ["the quick brown fox", "completely different",
                              "the quick"]}),
    ("/score", {"text_1": "abc", "text_2": "abc"}),
    ("/v1/score", {"query": "alpha", "documents": ["alpha beta", "gamma"]}),
    ("/v1/rerank", {"query": "alpha beta gamma",
                    "documents": ["zzz unrelated text", "alpha beta gamma",
                                  "alpha beta", 17]}),
    ("/rerank", {"query": "q", "documents": ["q r", "s", "q"], "top_n": 2}),
    ("/v1/rerank", {"query": "q", "documents": ["a", "b"], "top_n": 0}),
]

ERROR_BODIES = [
    ("/v1/embeddings", {"input": 42}),
    ("/v1/embeddings", {"input": [[1.5]]}),
    ("/v1/embeddings", {}),
    ("/v1/score", {"text_1": "x"}),
    ("/v1/score", {"text_1": 3, "text_2": "x"}),
    ("/score", {"text_2": "x"}),
    ("/v1/rerank", {"query": "x"}),
    ("/rerank", {"query": "x", "documents": "not a list"}),
    ("/v1/rerank", {"documents": ["a"]}),
]


def _strip(answer: dict) -> dict:
    """The answer without its random id, vectors and scores apart."""
    answer = dict(answer)
    answer.pop("id", None)
    values = []
    for entry in answer.get("data", []):
        values.append(entry.pop("embedding", None) or entry.pop("score"))
    for entry in answer.get("results", []):
        values.append(entry.pop("relevance_score"))
    return answer, values


@pytest.mark.parametrize("case", range(len(ROUTE_BODIES)))
def test_pooled_routes_match_jax(servers, case):
    port_url, jax_url = servers
    path, body = ROUTE_BODIES[case]
    status, got = _post(port_url + path, body)
    ref_status, ref = _post(jax_url + path, body)
    assert status == ref_status == 200, got
    got, got_values = _strip(got)
    ref, ref_values = _strip(ref)
    assert got == ref  # shapes, indices, order, usage
    np.testing.assert_allclose(np.asarray(got_values, np.float64),
                               np.asarray(ref_values, np.float64),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", range(len(ERROR_BODIES)))
def test_pooled_route_errors_match_jax(servers, case):
    port_url, jax_url = servers
    path, body = ERROR_BODIES[case]
    status, got = _post(port_url + path, body)
    ref_status, ref = _post(jax_url + path, body)
    assert status == ref_status == 400
    assert got == ref


OUT_OF_VOCAB = {"input": [[5, 600, -3, 7], [-1, 511, 512, 100000, -100000],
                           [9999] * 20]}


def test_out_of_vocab_ids_embed_as_the_jax_gather_reads_them(servers):
    """Ids at or past the vocabulary and negative ids on /v1/embeddings:
    200 on both servers, and the port's vectors the JAX embedder's
    (whose gather wraps a negative id and clamps the rest), cosine at
    least 0.9999 each."""
    port_url, jax_url = servers
    status, got = _post(port_url + "/v1/embeddings", OUT_OF_VOCAB)
    ref_status, ref = _post(jax_url + "/v1/embeddings", OUT_OF_VOCAB)
    assert status == ref_status == 200, got
    for mine, theirs in zip(got["data"], ref["data"]):
        a, b = (np.asarray(x["embedding"], np.float64)
                for x in (mine, theirs))
        assert a @ b / np.linalg.norm(a) / np.linalg.norm(b) >= 0.9999
    assert got["usage"] == ref["usage"]
    # The same ids mapped by hand give the same vectors.
    _, mapped = _post(port_url + "/v1/embeddings", {"input": [
        [5, 511, 509, 7], [511, 511, 511, 511, 0], [511] * 20]})
    np.testing.assert_allclose(
        [d["embedding"] for d in got["data"]],
        [d["embedding"] for d in mapped["data"]], atol=ATOL, rtol=0)


def test_scores_are_the_vectors_cosines(weights):
    server = _PortServer(_port_engine(weights))
    try:
        docs = ["alpha beta", "gamma delta", "alpha"]
        _, emb = _post(server.url + "/v1/embeddings",
                       {"input": ["alpha"] + docs})
        vecs = np.asarray([d["embedding"] for d in emb["data"]])
        _, score = _post(server.url + "/v1/score",
                         {"text_1": "alpha", "text_2": docs})
        cos = vecs[1:] @ vecs[0]
        np.testing.assert_allclose([d["score"] for d in score["data"]], cos,
                                   atol=1e-6)
        _, rerank = _post(server.url + "/v1/rerank",
                          {"query": "alpha", "documents": docs})
        assert [r["index"] for r in rerank["results"]] == list(
            np.argsort(-cos))
    finally:
        server.close()


# ---- an embed request beside a streaming completion -------------------------


def _stream_text(url, body):
    req = urllib.request.Request(url + "/v1/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read().decode()
    return "".join(json.loads(line[len("data: "):])["choices"][0]["text"]
                   for line in raw.split("\n\n")
                   if line.startswith("data: ") and line != "data: [DONE]")


def test_embedding_beside_a_stream_leaves_it_intact(weights):
    body = {"prompt": list(range(1, 40)), "max_tokens": 48,
            "temperature": 0, "ignore_eos": True, "stream": True}
    alone = _PortServer(_port_engine(weights))
    try:
        expected = _stream_text(alone.url, body)
    finally:
        alone.close()
    engine = _port_engine(weights)
    runner = engine.runner
    graphs = runner.graphs = StepGraphs(
        torch.device("cpu"), generators=[runner.generator],
        graph_factory=RecordingGraph, observatory=runner.observatory)
    server = _PortServer(engine)
    try:
        result = {}
        streamer = threading.Thread(target=lambda: result.update(
            text=_stream_text(server.url, body)))
        streamer.start()
        # Embed while the stream runs: 11 inputs are two chunks of 8.
        while not graphs.replays["step"]:
            pass
        status, emb = _post(server.url + "/v1/embeddings",
                            {"input": _token_lists()})
        streamer.join(timeout=120)
        assert status == 200 and len(emb["data"]) == 11
        assert result["text"] == expected
        assert graphs.eager_steps == {"seeded": 0, "embed": 2}
        with urllib.request.urlopen(server.url + "/metrics") as resp:
            text = resp.read().decode()
        assert '\nvllm:engine_eager_steps_total{reason="embed"} 2.0' in text
    finally:
        server.close()
