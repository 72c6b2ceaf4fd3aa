"""Multi-LoRA serving in the port against the JAX package's
``engine/lora.py``, on the CPU (tiny f32 llama).

Covers: a zero stack gives the base logits bit for bit; per-row
adapter isolation against JAX's ``forward`` with the same adapter
(1e-4 f32); the PEFT loader on a directory written with
``safetensors.numpy.save_file`` (and the ``.npz`` fallback) against
JAX's loader; the port's safetensors reader against
``safetensors.numpy.load_file`` for F32, F16 and BF16; the oversized
rank refused and a failed install rolled back; ``cache_root`` equal to
JAX's; the prefix cache never crossing adapters; greedy streams of
mixed base and adapter rows byte-identical to the JAX engine's in
prefill, decode, unified, burst and verify steps, on dense and on int8
weights; an adapter registered after the step graphs captured is read
by the next replay (stand-in graphs) with no new key; and the server:
``/v1/models`` lists adapters with their parent, the response echoes
the adapter's name, ``/v1/disagg/prefill`` refuses adapter names only,
and stream checkpoints skip LoRA rows.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import ml_dtypes  # noqa: F401  (numpy's bfloat16 for safetensors.numpy)
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine import lora as jax_lora
from production_stack_tpu.engine import quantization as jax_quant
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
    SequenceState as JaxSequenceState,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine import lora as port_lora
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.lora import (
    LoRAAdapter,
    LoRARegistry,
    _read_safetensors,
    empty_lora_stack,
    load_peft_adapter,
    target_shapes,
)
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    SequenceState,
)
from production_stack_tpu_torch.engine.server import make_server
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_step_graphs import RecordingGraph

torch.set_num_threads(2)

MAX_RANK = 4


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _adapter_weights(cfg, rank, seed, targets=None):
    """Per-target (A [L, in, R], B [L, R, out]) f32, rank-padded."""
    rs = np.random.RandomState(seed)
    out = {}
    for tgt, (d_in, d_out) in target_shapes(cfg).items():
        if targets is not None and tgt not in targets:
            continue
        a = np.zeros((cfg.num_hidden_layers, d_in, MAX_RANK), np.float32)
        b = np.zeros((cfg.num_hidden_layers, MAX_RANK, d_out), np.float32)
        a[:, :, :rank] = 0.1 * rs.randn(cfg.num_hidden_layers, d_in, rank)
        b[:, :rank, :] = 0.1 * rs.randn(cfg.num_hidden_layers, rank, d_out)
        out[tgt] = (a, b)
    return out


def _adapters(cfg):
    """Two adapters, as (name, scaling, weights): every target, and the
    attention targets alone."""
    return [("ada", 0.5, _adapter_weights(cfg, 4, 7)),
            ("bee", 2.0, _adapter_weights(cfg, 2, 8, ("wq", "wv", "wo")))]


def _register(registry, module, cfg):
    for name, scaling, w in _adapters(cfg):
        registry.register(module.LoRAAdapter(name=name, rank=MAX_RANK,
                                             scaling=scaling, weights=w))


def _forward_inputs(cfg):
    rs = np.random.RandomState(2)
    b, t, ps, pages = 3, 8, 16, 8
    tokens = rs.randint(1, 500, (b, t)).astype(np.int32)
    positions = np.tile(np.arange(t, dtype=np.int32), (b, 1))
    table = np.array([[1, 2], [3, 4], [5, 6]], np.int32)
    kv_lens = np.full((b,), t, np.int32)
    valid = np.ones((b, t), bool)
    shape = (cfg.num_key_value_heads, pages, cfg.head_dim, ps)
    return (tokens, positions, table, kv_lens, valid), shape


def _port_forward(params, cfg, lora=None, ids=None):
    inputs, shape = _forward_inputs(cfg)
    layers = cfg.num_hidden_layers
    kwargs = {} if lora is None else dict(
        lora=lora, lora_ids=torch.tensor(ids, dtype=torch.int32))
    return llama.forward(params, cfg, *(torch.from_numpy(x) for x in inputs),
                         [torch.zeros(shape) for _ in range(layers)],
                         [torch.zeros(shape) for _ in range(layers)],
                         kind="prefill", **kwargs)


def test_a_zero_stack_gives_the_base_logits_bit_for_bit(weights):
    cfg = config.tiny_model_config()
    params = params_from_numpy(weights, cfg, "cpu")
    base = _port_forward(params, cfg)
    zero = _port_forward(params, cfg, empty_lora_stack(cfg, 2, MAX_RANK),
                         [0, 1, 2])
    assert torch.equal(base, zero)


def test_per_row_adapters_match_jax(weights):
    jcfg = jax_config.tiny_model_config("llama")
    cfg = config.tiny_model_config()
    jreg = jax_lora.LoRARegistry(jcfg, 2, MAX_RANK)
    preg = LoRARegistry(cfg, 2, MAX_RANK)
    _register(jreg, jax_lora, jcfg)
    _register(preg, port_lora, cfg)
    ids = [0, 1, 2]
    inputs, shape = _forward_inputs(cfg)
    layers = cfg.num_hidden_layers
    want, _, _ = jax_llama.forward(
        {k: jnp.asarray(v) for k, v in weights.items()}, jcfg,
        *(jnp.asarray(x) for x in inputs),
        jnp.zeros((layers,) + shape), jnp.zeros((layers,) + shape),
        lora=jreg.stack, lora_ids=jnp.asarray(ids, jnp.int32))
    params = params_from_numpy(weights, cfg, "cpu")
    got = _port_forward(params, cfg, preg.stack, ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    base = _port_forward(params, cfg)
    assert torch.equal(got[0], base[0])
    for row in (1, 2):
        assert (got[row] - base[row]).abs().max() > 1e-2


def _write_peft(tmp_path, cfg, fmt="safetensors", rank=2, alpha=4.0,
                dtype=np.float32):
    rs = np.random.RandomState(3)
    raw = {}
    for i in range(cfg.num_hidden_layers):
        for proj, section, (d_in, d_out) in (
                ("q_proj", "self_attn", (cfg.hidden_size,
                                         cfg.num_attention_heads
                                         * cfg.head_dim)),
                ("v_proj", "self_attn", (cfg.hidden_size,
                                         cfg.num_key_value_heads
                                         * cfg.head_dim)),
                ("down_proj", "mlp", (cfg.intermediate_size,
                                      cfg.hidden_size))):
            prefix = f"base_model.model.model.layers.{i}.{section}.{proj}"
            raw[f"{prefix}.lora_A.weight"] = rs.randn(rank, d_in).astype(
                dtype)
            raw[f"{prefix}.lora_B.weight"] = rs.randn(d_out, rank).astype(
                dtype)
    path = os.path.join(str(tmp_path), f"adapter-{fmt}")
    os.makedirs(path, exist_ok=True)
    if fmt == "safetensors":
        save_file(raw, os.path.join(path, "adapter_model.safetensors"))
    else:
        np.savez(os.path.join(path, "adapter_model.npz"), **raw)
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha,
                   "target_modules": ["q_proj", "v_proj", "down_proj"]}, f)
    return path


@pytest.mark.parametrize("fmt", ["safetensors", "npz"])
def test_peft_loader_matches_jax(tmp_path, fmt):
    cfg = config.tiny_model_config()
    path = _write_peft(tmp_path, cfg, fmt)
    ours = load_peft_adapter(path, cfg, MAX_RANK, name="x")
    theirs = jax_lora.load_peft_adapter(
        path, jax_config.tiny_model_config("llama"), MAX_RANK, name="x")
    assert (ours.name, ours.rank, ours.scaling) == (
        theirs.name, theirs.rank, theirs.scaling) == ("x", 2, 2.0)
    assert sorted(ours.weights) == sorted(theirs.weights) == [
        "w_down", "wq", "wv"]
    for tgt, (a, b) in theirs.weights.items():
        np.testing.assert_array_equal(ours.weights[tgt][0], a)
        np.testing.assert_array_equal(ours.weights[tgt][1], b)


@pytest.mark.parametrize("dtype", [np.float32, np.float16,
                                   ml_dtypes.bfloat16])
def test_safetensors_reader_matches_the_package(tmp_path, dtype):
    rs = np.random.RandomState(4)
    tensors = {"a.lora_A.weight": rs.randn(3, 5).astype(dtype),
               "b": rs.randn(7).astype(dtype),
               "scalar": np.asarray(rs.randn(), dtype)}
    path = os.path.join(str(tmp_path), "t.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    want = load_file(path)
    got = _read_safetensors(path)
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        assert got[name].shape == arr.shape
        wide = np.float32 if dtype is ml_dtypes.bfloat16 else arr.dtype
        assert got[name].dtype == wide
        np.testing.assert_array_equal(got[name], arr.astype(wide))


def test_oversized_rank_is_refused(tmp_path):
    cfg = config.tiny_model_config()
    path = _write_peft(tmp_path, cfg, rank=8)
    for loader, c in ((load_peft_adapter, cfg), (
            jax_lora.load_peft_adapter,
            jax_config.tiny_model_config("llama"))):
        with pytest.raises(ValueError, match="exceeds --max-lora-rank 4"):
            loader(path, c, MAX_RANK)


def test_a_failed_install_rolls_back():
    cfg = config.tiny_model_config()
    registry = LoRARegistry(cfg, 2, MAX_RANK)
    bad = LoRAAdapter(name="bad", rank=2, scaling=1.0, weights={
        "not_a_target": (np.zeros((2, 4, 4)), np.zeros((2, 4, 4)))})
    before = {t: v.clone() for t, v in registry.stack["a"].items()}
    with pytest.raises(ValueError, match="Unknown LoRA target"):
        registry.register(bad)
    assert "bad" not in registry.slots and registry.names() == []
    assert all(torch.equal(before[t], v)
               for t, v in registry.stack["a"].items())
    name, scaling, w = _adapters(cfg)[0]
    assert registry.register(LoRAAdapter(name, MAX_RANK, scaling, w)) == 1
    with pytest.raises(ValueError, match="All 2 LoRA slots"):
        registry.register(LoRAAdapter("c", 1, 1.0, w))
        registry.register(LoRAAdapter("d", 1, 1.0, w))


def test_cache_roots_and_in_place_installs_match_jax():
    jcfg = jax_config.tiny_model_config("llama")
    cfg = config.tiny_model_config()
    jreg = jax_lora.LoRARegistry(jcfg, 2, MAX_RANK)
    preg = LoRARegistry(cfg, 2, MAX_RANK)
    ptrs = {t: v.data_ptr() for t, v in preg.stack["a"].items()}
    _register(jreg, jax_lora, jcfg)
    _register(preg, port_lora, cfg)
    # In place: every stack keeps its address.
    assert ptrs == {t: v.data_ptr() for t, v in preg.stack["a"].items()}
    assert preg.slots == jreg.slots == {"ada": 1, "bee": 2}
    for slot in (0, 1, 2):
        assert preg.cache_root(slot) == jreg.cache_root(slot)
    for part in ("a", "b"):
        for tgt, arr in jreg.stack[part].items():
            np.testing.assert_array_equal(preg.stack[part][tgt].numpy(),
                                          np.asarray(arr))
    np.testing.assert_array_equal(preg.stack["scaling"].numpy(),
                                  np.asarray(jreg.stack["scaling"]))
    # Re-registering a name with fewer targets zeroes the others.
    name, scaling, w = _adapters(cfg)[0]
    preg.register(LoRAAdapter(name, MAX_RANK, scaling, {"wq": w["wq"]}))
    assert not preg.stack["a"]["w_up"][:, 1].any()


def _prompts():
    rs = np.random.RandomState(5)
    return [[4, 5, 6] * 13, [int(x) for x in rs.randint(1, 500, 41)],
            [21, 22, 23, 24] * 12, [8] * 10, [9, 10] * 20,
            [int(x) for x in rs.randint(1, 500, 19)]]


LORA_NAMES = [None, "ada", "bee", "ada", None, "bee"]

# step kinds -> (unified, decode_steps, speculative_k, async)
MODES = {
    "prefill_decode": (False, 1, 0, False),
    "unified_async": (True, 1, 0, True),
    "burst": (False, 4, 0, False),
    "spec_verify": (False, 1, 4, False),
}


def _engine_config(cfg, mode, quantization="none"):
    unified, decode_steps, spec_k, async_on = MODES[mode]
    model = cfg.tiny_model_config("llama")
    model.quantization = quantization
    return cfg.EngineConfig(
        model=model, cache=cfg.CacheConfig(page_size=16, num_pages=160),
        scheduler=cfg.SchedulerConfig(
            max_num_seqs=6, max_model_len=256, prefill_chunk_size=32,
            unified_step=unified, decode_steps=decode_steps,
            speculative_k=spec_k, async_scheduling=async_on),
        lora=cfg.LoRAConfig(enable=True, max_loras=2,
                            max_lora_rank=MAX_RANK))


def _streams(engine, sampling_cls, finished, names=LORA_NAMES):
    seqs = []
    for prompt, name in zip(_prompts(), names):
        sid = engine.add_request(prompt, sampling_cls(
            temperature=0.0, max_tokens=12, ignore_eos=True),
            lora_name=name)
        seqs.append(engine.sequences[sid])
    for _ in range(400):
        if not engine.has_work():
            break
        engine.step()
    assert all(s.state == finished for s in seqs)
    return [list(s.output_token_ids) for s in seqs]


def _jax_streams(weights, mode, quantization="none"):
    params = {k: jnp.asarray(v) for k, v in weights.items()}
    jcfg = _engine_config(jax_config, mode, quantization)
    if quantization == "int8":
        params = jax_quant.quantize_params(params, jcfg.model)
    engine = JaxEngine(jcfg, params=params)
    _register(engine.runner.lora_registry, jax_lora, jcfg.model)
    return _streams(engine, JaxSamplingParams, JaxSequenceState.FINISHED)


def _port_engine(weights, mode, quantization="none"):
    cfg = _engine_config(config, mode, quantization)
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model, "cpu"),
                     device="cpu")


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mixed_adapter_streams_match_jax(weights, mode):
    engine = _port_engine(weights, mode)
    _register(engine.runner.lora_registry, port_lora,
        engine.config.model)
    got = _streams(engine, SamplingParams, SequenceState.FINISHED)
    assert got == _jax_streams(weights, mode)
    # The adapters change the tokens of the rows that name them.
    assert got[1] != got[0] or got[2] != got[0]
    m = engine.metrics
    if mode == "unified_async":
        assert m.ragged_steps_total > 0
    if mode == "spec_verify":
        assert m.spec_draft_tokens_total > 0


@pytest.mark.parametrize("mode", ["prefill_decode", "unified_async"])
def test_adapters_on_int8_weights_match_jax(weights, mode):
    engine = _port_engine(weights, mode, "int8")
    _register(engine.runner.lora_registry, port_lora,
        engine.config.model)
    got = _streams(engine, SamplingParams, SequenceState.FINISHED)
    assert got == _jax_streams(weights, mode, "int8")


def test_lora_off_refuses_adapter_requests_as_jax():
    port = LLMEngine(config.EngineConfig(
        model=config.tiny_model_config()), device="cpu")
    jax_engine = JaxEngine(jax_config.EngineConfig(
        model=jax_config.tiny_model_config("llama")))
    for engine, sp in ((port, SamplingParams), (jax_engine,
                                                JaxSamplingParams)):
        with pytest.raises(ValueError,
                           match="LoRA is not enabled on this engine"):
            engine.add_request([1, 2, 3], sp(max_tokens=2),
                               lora_name="x")
        with pytest.raises(ValueError, match="LoRA is not enabled"):
            engine.register_lora("/nonexistent")
        assert engine.lora_names() == []
        assert not engine.sequences


def test_unknown_adapter_name_raises_keyerror(weights):
    engine = _port_engine(weights, "prefill_decode")
    with pytest.raises(KeyError):
        engine.add_request([1, 2, 3], SamplingParams(max_tokens=2),
                           lora_name="nope")


def test_prefix_cache_never_crosses_adapters(weights):
    """Adapter KV (wk/wv carry deltas) must not serve base requests on
    the same prompt, nor the reverse: the page-hash chain is salted by
    the adapter's content-addressed cache root."""
    sp = lambda: SamplingParams(  # noqa: E731
        max_tokens=6, temperature=0.0, ignore_eos=True)
    prompt = list(range(3, 43))  # > 2 full pages
    clean = _port_engine(weights, "prefill_decode")
    base_expected = clean.generate(prompt, sp()).output_token_ids
    engine = _port_engine(weights, "prefill_decode")
    _register(engine.runner.lora_registry, port_lora,
        engine.config.model)

    def run(name):
        sid = engine.add_request(prompt, sp(), lora_name=name)
        seq = engine.sequences[sid]
        while engine.has_work():
            engine.step()
        return list(seq.output_token_ids)

    adapter_out = run("ada")
    assert run(None) == base_expected
    assert adapter_out != base_expected
    hits = engine.cache_manager.prefix_hit_tokens
    assert run("ada") == adapter_out
    assert engine.cache_manager.prefix_hit_tokens > hits


def test_an_adapter_registered_after_capture_is_read_by_the_next_replay(
        weights):
    """The stacks are written in place, so a step graph captured with
    an empty slot reads the adapter at its next replay, under the same
    key."""
    from production_stack_tpu_torch.engine.step_graphs import StepGraphs

    engine = _port_engine(weights, "prefill_decode")
    engine.runner.graphs = StepGraphs(
        torch.device("cpu"), generators=[engine.runner.generator],
        graph_factory=RecordingGraph)
    stack = engine.runner.lora_registry.stack
    ptrs = [t.data_ptr() for part in ("a", "b")
            for t in stack[part].values()] + [stack["scaling"].data_ptr()]
    names = [None] * 6
    before = _streams(engine, SamplingParams, SequenceState.FINISHED, names)
    keys = set(engine.runner.graphs.keys())
    _register(engine.runner.lora_registry, port_lora,
        engine.config.model)
    assert ptrs == [t.data_ptr() for part in ("a", "b")
                    for t in stack[part].values()] + [
                        stack["scaling"].data_ptr()]
    # New prompts (no prefix hits), the same shapes: the keys captured.
    after = _streams(engine, SamplingParams, SequenceState.FINISHED,
                     LORA_NAMES)
    assert set(engine.runner.graphs.keys()) == keys
    fresh = _port_engine(weights, "prefill_decode")
    _register(fresh.runner.lora_registry, port_lora,
        fresh.config.model)
    assert after == _streams(fresh, SamplingParams, SequenceState.FINISHED)
    assert after != before


# ---- the server -------------------------------------------------------------


@pytest.fixture(scope="module")
def lora_server(tmp_path_factory):
    cfg = config.tiny_model_config()
    path = _write_peft(tmp_path_factory.mktemp("peft"), cfg)
    server = make_server(["--model", "tiny-llama", "--device", "cpu",
                          "--host", "127.0.0.1", "--port", "0",
                          "--max-model-len", "256", "--num-pages", "64",
                          "--lora-modules", f"sql-lora={path}",
                          "--max-lora-rank", "4",
                          "--checkpoint-interval-tokens", "4"])
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    yield "http://127.0.0.1:%d" % server.server_address[1], server
    server.shutdown()
    thread.join(timeout=30)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_server_lists_adapters_with_their_parent(lora_server):
    url, _ = lora_server
    with urllib.request.urlopen(url + "/v1/models", timeout=60) as resp:
        data = json.loads(resp.read())["data"]
    assert [m["id"] for m in data] == ["tiny-llama", "sql-lora"]
    assert data[1]["parent"] == "tiny-llama" and "parent" not in data[0]


def test_server_runs_and_echoes_the_adapter(lora_server):
    url, server = lora_server
    body = {"prompt": "hello there", "max_tokens": 8, "temperature": 0,
            "ignore_eos": True}
    outs = {}
    for model in ("sql-lora", "tiny-llama", "some-alias"):
        status, text = _post(url + "/v1/completions",
                             dict(body, model=model))
        assert status == 200, text
        out = json.loads(text)
        outs[model] = out["choices"][0]["text"]
        assert out["model"] == ("sql-lora" if model == "sql-lora"
                                else "tiny-llama")
    assert outs["some-alias"] == outs["tiny-llama"]
    assert outs["sql-lora"] != outs["tiny-llama"]
    # The same adapter through the engine directly.
    engine = server.app.engine
    prompt = engine.tokenizer.encode("hello there")
    seq = engine.sequences[engine.add_request(
        prompt, SamplingParams(temperature=0.0, max_tokens=8,
                               ignore_eos=True), lora_name="sql-lora")]
    assert seq.lora_id == 1 and seq.cache_salt != 0
    status, text = _post(url + "/v1/chat/completions", {
        "model": "sql-lora", "messages": [{"role": "user", "content": "hi"}],
        "max_tokens": 4})
    assert status == 200 and json.loads(text)["model"] == "sql-lora"


def test_disagg_prefill_refuses_adapter_names_only(lora_server):
    url, _ = lora_server
    status, text = _post(url + "/v1/disagg/prefill", {
        "model": "sql-lora", "prompt": "hi", "max_tokens": 4})
    assert status == 400
    assert "LoRA adapters are monolithic-only" in json.loads(
        text)["error"]["message"]
    for model in ("tiny-llama", "another-name"):
        status, text = _post(url + "/v1/disagg/prefill", {
            "model": model, "prompt": "hi", "max_tokens": 4,
            "temperature": 0})
        assert status == 200, text
        assert json.loads(text)["descriptor"]["first_token"] is not None


def test_stream_checkpoints_skip_lora_rows(lora_server):
    url, _ = lora_server
    frames = {}
    for model in ("tiny-llama", "sql-lora"):
        req = urllib.request.Request(
            url + "/v1/completions", data=json.dumps({
                "model": model, "prompt": "hello", "max_tokens": 16,
                "temperature": 0, "ignore_eos": True,
                "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            raw = resp.read().decode()
        frames[model] = raw.count(": checkpoint ")
    assert frames["tiny-llama"] > 0 and frames["sql-lora"] == 0


def test_lora_modules_entries_must_be_name_equals_path():
    with pytest.raises(ValueError, match="name=path"):
        make_server(["--device", "cpu", "--port", "0", "--num-pages", "16",
                     "--max-model-len", "64", "--lora-modules", "just-a-name"])
