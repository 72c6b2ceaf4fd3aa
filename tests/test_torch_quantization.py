"""Weight-only int8 in the port against the JAX package's
``engine/quantization.py``, on the CPU.

Inputs come from numpy seeds and go through both implementations:
``quantize_weight`` bitwise (an all-zero output channel included); the
port's fused ``QuantLinear``s bitwise against JAX's separate
quantizations carried across by ``params_from_numpy``;
``dequant_matmul`` and the int8-weight kernel's plain version against
JAX's ``dequant_matmul`` (1e-5 relative in f32, 2e-2 in bf16); the tiny
llama's quantized forward at 1e-4 (f32); greedy streams of the
quantized engines byte-identical in prefill, decode, unified, burst
(K = 4) and spec-verify steps; ``init_random_quantized``'s leaves; the
embedder's refusal and the pooled routes' 501; the observatory's weight
bytes against the JAX ledger. The kernel itself runs on the card
(``tests/test_torch_cuda_kernels.py``, marker ``cuda``).
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
from production_stack_tpu.engine import quantization as jax_quant
from production_stack_tpu.engine.embeddings import Embedder as JaxEmbedder
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.embeddings import Embedder
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.quantization import (
    FUSED_TARGETS,
    QuantLinear,
    dequant_matmul,
    has_quantized_leaves,
    init_random_quantized,
    quantize_params,
    quantize_weight,
)
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import make_server
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops.int8_matmul_cuda import (
    INT8_KERNEL_MAX_ROWS,
    int8_weight_matmul,
    int8_weight_matmul_plain,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _jax_quantized(weights):
    cfg = jax_config.tiny_model_config("llama")
    q = jax_quant.quantize_params(
        {k: jnp.asarray(v) for k, v in weights.items()}, cfg)
    return {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                else np.asarray(v)) for k, v in q.items()}


@pytest.mark.parametrize("shape", [(2, 64, 96), (1, 128, 40)])
def test_quantize_weight_is_jaxs_bit_for_bit(shape):
    rs = np.random.RandomState(sum(shape))
    w = rs.randn(*shape).astype(np.float32)
    w[..., 7] = 0.0  # an all-zero output channel: the 1e-8 scale floor
    jq, js = (np.asarray(x) for x in jax_quant.quantize_weight(
        jnp.asarray(w)))
    pq, ps = quantize_weight(torch.from_numpy(w).transpose(-1, -2))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.transpose(-1, -2).numpy(), jq)
    np.testing.assert_array_equal(ps.numpy(), js)
    assert (pq[..., 7, :] == 0).all()
    assert (ps[..., 7] == np.float32(1e-8)).all()


def test_fused_quantlinears_equal_jaxs_separate_quantizations(weights):
    """Per output channel scales: quantizing the fused qkv / gate_up is
    quantizing wq, wk, wv / w_gate, w_up apart and concatenating."""
    cfg = config.tiny_model_config()
    ours = quantize_params(params_from_numpy(weights, cfg, "cpu"), cfg)
    theirs = params_from_numpy(_jax_quantized(weights), cfg, "cpu")
    assert has_quantized_leaves(ours) and has_quantized_leaves(theirs)
    for a, b in zip(ours.layers, theirs.layers):
        for name in FUSED_TARGETS:
            qa, qb = getattr(a, name), getattr(b, name)
            assert isinstance(qa, QuantLinear) and isinstance(qb, QuantLinear)
            assert torch.equal(qa.weight_int8, qb.weight_int8)
            assert torch.equal(qa.scale, qb.scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 24, INT8_KERNEL_MAX_ROWS + 40])
def test_dequant_matmul_and_the_kernels_plain_version_match_jax(dtype, m):
    rs = np.random.RandomState(m)
    w = rs.randn(128, 96).astype(np.float32)
    x = rs.randn(m, 128).astype(np.float32)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    ref = np.asarray(jax_quant.dequant_matmul(jnp.asarray(x, jdt),
                                              (jq, js))).astype(np.float32)
    q = torch.from_numpy(np.array(jq)).t().contiguous()
    scale = torch.from_numpy(np.array(js))
    xt = torch.from_numpy(x).to(tdt)
    rel = 1e-5 if dtype == "float32" else 2e-2
    for got in (dequant_matmul(xt, q, scale),
                int8_weight_matmul_plain(xt, q, scale),
                int8_weight_matmul(xt, q, scale)):
        assert got.dtype == tdt and got.shape == (m, 96)
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= rel * np.abs(ref).max()


def test_quantlinear_takes_the_kernel_up_to_the_row_threshold(monkeypatch):
    """Products of at most INT8_KERNEL_MAX_ROWS rows go to the int8
    kernel's wrapper; larger ones to JAX's dequantize-then-matmul."""
    import production_stack_tpu_torch.engine.quantization as quant
    calls = []
    monkeypatch.setattr(quant, "int8_weight_matmul",
                        lambda *a: calls.append("kernel") or
                        int8_weight_matmul(*a))
    monkeypatch.setattr(quant, "dequant_matmul",
                        lambda *a: calls.append("dequant") or
                        dequant_matmul(*a))
    lin = QuantLinear.from_linear(torch.nn.Linear(64, 32, bias=True))
    for rows in (1, INT8_KERNEL_MAX_ROWS, INT8_KERNEL_MAX_ROWS + 1):
        out = lin(torch.randn(rows, 1, 64))
        assert out.shape == (rows, 1, 32)
    assert calls == ["kernel", "kernel", "dequant"]


def test_quantized_forward_matches_jax(weights):
    jax_cfg = jax_config.tiny_model_config("llama")
    cfg = config.tiny_model_config()
    qparams = _jax_quantized(weights)
    jax_params = {k: (tuple(jnp.asarray(x) for x in v)
                      if isinstance(v, tuple) else jnp.asarray(v))
                  for k, v in qparams.items()}
    port = params_from_numpy(qparams, cfg, "cpu")
    rs = np.random.RandomState(2)
    b, t, ps, pages = 2, 16, 16, 8
    tokens = rs.randint(1, 500, (b, t)).astype(np.int32)
    positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    table = np.array([[1, 2], [3, 4]], np.int32)
    kv_lens = np.full((b,), t, np.int32)
    valid = np.ones((b, t), bool)
    layers, kv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim)
    shape = (kv, pages, d, ps)
    want, _, _ = jax_llama.forward(
        jax_params, jax_cfg, *(jnp.asarray(x) for x in (
            tokens, positions, table, kv_lens, valid)),
        jnp.zeros((layers,) + shape), jnp.zeros((layers,) + shape))
    got = llama.forward(port, cfg, *(torch.from_numpy(x) for x in (
        tokens, positions, table, kv_lens, valid)),
        [torch.zeros(shape) for _ in range(layers)],
        [torch.zeros(shape) for _ in range(layers)], kind="prefill")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def _prompts():
    rs = np.random.RandomState(5)
    return [[4, 5, 6] * 13, [int(x) for x in rs.randint(1, 500, 41)],
            [21, 22, 23, 24] * 12, [8] * 10]


# step kinds -> (unified, decode_steps, speculative_k)
MODES = {
    "prefill_decode": (False, 1, 0),
    "unified": (True, 1, 0),
    "burst": (False, 4, 0),
    "spec_verify": (False, 1, 4),
}


def _engine_config(cfg, mode, quantization="int8"):
    unified, decode_steps, spec_k = MODES[mode]
    model = cfg.tiny_model_config("llama")
    model.quantization = quantization
    return cfg.EngineConfig(
        model=model, cache=cfg.CacheConfig(page_size=16, num_pages=128),
        scheduler=cfg.SchedulerConfig(
            max_num_seqs=4, max_model_len=256, prefill_chunk_size=32,
            unified_step=unified, decode_steps=decode_steps,
            speculative_k=spec_k, speculative_min_match=2))


def _streams(engine, sampling_cls):
    seqs = engine.generate_batch(_prompts(), sampling_cls(
        temperature=0.0, max_tokens=14, ignore_eos=True))
    return [list(s.output_token_ids) for s in seqs]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quantized_greedy_streams_match_jax(weights, mode):
    qparams = _jax_quantized(weights)
    jax_params = {k: (tuple(jnp.asarray(x) for x in v)
                      if isinstance(v, tuple) else jnp.asarray(v))
                  for k, v in qparams.items()}
    want = _streams(JaxEngine(_engine_config(jax_config, mode),
                              params=jax_params), JaxSamplingParams)
    cfg = _engine_config(config, mode)
    engine = LLMEngine(cfg, params=params_from_numpy(qparams, cfg.model,
                                                     "cpu"), device="cpu")
    assert _streams(engine, SamplingParams) == want
    # Dense weights given to an int8 engine are quantized at start, to
    # the same int8 model.
    dense = LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                    "cpu"), device="cpu")
    assert has_quantized_leaves(dense.runner.params)
    assert _streams(dense, SamplingParams) == want
    m = engine.metrics
    if mode == "unified":
        assert m.ragged_steps_total > 0
    if mode == "spec_verify":
        assert m.spec_draft_tokens_total > 0


def test_init_random_quantized_has_jaxs_leaves():
    jcfg = jax_config.tiny_model_config("llama")
    cfg = config.tiny_model_config()
    ref = jax_quant.init_random_quantized(jax_llama.init_params, jcfg,
                                          seed=0)
    ours = init_random_quantized(cfg, 0, torch.device("cpu"))
    layers = cfg.num_hidden_layers
    for i, layer in enumerate(ours.layers):
        for name, targets in FUSED_TARGETS.items():
            lin = getattr(layer, name)
            assert isinstance(lin, QuantLinear)
            q = np.concatenate([np.asarray(ref[t][0][i]) for t in targets],
                               axis=1)
            scale = np.concatenate([np.asarray(ref[t][1][i])
                                    for t in targets])
            assert lin.weight_int8.dtype == torch.int8
            assert tuple(lin.weight_int8.shape) == q.T.shape
            np.testing.assert_array_equal(lin.scale.numpy(), scale)
            w = lin.weight_int8.numpy()
            assert w.min() >= -127 and w.max() <= 127 and w.std() > 50
        np.testing.assert_array_equal(layer.attn_norm.numpy(),
                                      np.asarray(ref["attn_norm"][i]))
        np.testing.assert_array_equal(layer.mlp_norm.numpy(),
                                      np.asarray(ref["mlp_norm"][i]))
    assert np.asarray(ref["wq"][0]).shape[0] == layers
    for name, leaf in (("embed", ours.embed),
                       ("lm_head", ours.lm_head.weight.T)):
        assert tuple(leaf.shape) == np.asarray(ref[name]).shape
        assert leaf.dtype == torch.float32
        assert 0.015 < float(leaf.std()) < 0.025
    np.testing.assert_array_equal(ours.final_norm.numpy(),
                                  np.asarray(ref["final_norm"]))


def test_an_int8_engine_draws_int8_weights_directly():
    cfg = _engine_config(config, "prefill_decode")
    engine = LLMEngine(cfg, device="cpu")
    assert all(isinstance(getattr(layer, name), QuantLinear)
               for layer in engine.runner.params.layers
               for name in FUSED_TARGETS)
    out = engine.generate([5, 6, 7], SamplingParams(
        temperature=0.0, max_tokens=4, ignore_eos=True))
    assert len(out.output_token_ids) == 4


def test_the_embedder_refuses_quantized_weights(weights):
    cfg = config.tiny_model_config()
    qparams = _jax_quantized(weights)
    with pytest.raises(NotImplementedError) as ours:
        Embedder(cfg, params_from_numpy(qparams, cfg, "cpu"), max_len=64)
    with pytest.raises(NotImplementedError) as theirs:
        JaxEmbedder(jax_config.tiny_model_config("llama"),
                    {k: (tuple(jnp.asarray(x) for x in v)
                         if isinstance(v, tuple) else jnp.asarray(v))
                     for k, v in qparams.items()}, max_len=64)
    assert str(ours.value) == str(theirs.value)


def test_pooled_routes_answer_501_on_an_int8_server():
    server = make_server(["--model", "tiny-llama", "--device", "cpu",
                          "--host", "127.0.0.1", "--port", "0",
                          "--max-model-len", "128", "--num-pages", "32",
                          "--quantization", "int8"])
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        for path, body in (("/v1/embeddings", {"input": "hi"}),
                           ("/v1/score", {"text_1": "a", "text_2": "b"}),
                           ("/v1/rerank", {"query": "a",
                                           "documents": ["b"]})):
            req = urllib.request.Request(
                url + path, data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(req, timeout=60)
            assert err.value.code == 501
            assert "unquantized" in json.loads(
                err.value.read())["error"]["message"]
        req = urllib.request.Request(
            url + "/v1/completions", data=json.dumps(
                {"prompt": "hi", "max_tokens": 3, "temperature": 0,
                 "ignore_eos": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert json.loads(resp.read())["usage"]["completion_tokens"] == 3
    finally:
        server.shutdown()
        thread.join(timeout=30)


def test_observatory_weight_bytes_equal_the_jax_ledger(weights):
    qparams = _jax_quantized(weights)
    jax_params = {k: (tuple(jnp.asarray(x) for x in v)
                      if isinstance(v, tuple) else jnp.asarray(v))
                  for k, v in qparams.items()}
    jax_obs = JaxEngine(_engine_config(jax_config, "prefill_decode"),
                        params=jax_params).runner.observatory
    cfg = _engine_config(config, "prefill_decode")
    obs = LLMEngine(cfg, params=params_from_numpy(qparams, cfg.model, "cpu"),
                    device="cpu").runner.observatory
    assert obs.params_bytes == jax_obs.params_bytes
    assert obs.param_count == jax_obs.param_count
    dense = LLMEngine(_engine_config(config, "prefill_decode", "none"),
                      params=params_from_numpy(weights, cfg.model, "cpu"),
                      device="cpu").runner.observatory
    # int8 values where f32 ones were, plus an f32 scale a channel.
    assert obs.params_bytes < dense.params_bytes
