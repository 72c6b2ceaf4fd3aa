"""The port's OPT, GPT-2 and Mixtral forwards against the JAX package's,
same weights.

Each family's JAX ``init_params`` dict (biases and norms given values,
so every leaf is exercised) is carried across with
``params_from_numpy``; both forwards then run a prefill chunk, a T = 1
decode step and a mixed [R, W] block (a decode row, a prefill chunk
row and a pad row, the port's ragged route) over the same paged cache.
JAX attends through its XLA reference; for OPT also through its Pallas
kernels in interpret mode (decode, prefill and, for the mixed block,
the ragged kernel). The port attends through its kernels' plain
versions on the CPU.

Tolerance: f32 logits at atol = rtol = 1e-4, the llama parity test's:
the attention sums run in another order (page walk against one
softmax), and each layer's rounding carries into the next.

Also here: the registry's architectures, the learned-position clamp,
the MoE's top-k ties, and the check that the six architectures'
published geometries are ones the kernels serve, at every dtype.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine.config import ModelConfig as JaxModelConfig
from production_stack_tpu.engine.config import (
    tiny_model_config as jax_tiny_model_config,
)
from production_stack_tpu.models import registry as jax_registry
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    ModelConfig,
    SchedulerConfig,
    tiny_model_config,
)
from production_stack_tpu_torch.models import mixtral, registry
from production_stack_tpu_torch.models.convert import params_from_numpy

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
PAGE_SIZE, NUM_PAGES, MAX_PAGES = 16, 16, 4
FAMILIES = ("opt", "gpt2", "mixtral")


def _tiny_mixtral(cls):
    return cls(name="tiny-mixtral", architecture="mixtral", vocab_size=512,
               hidden_size=128, intermediate_size=96, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2,
               max_position_embeddings=512, rope_theta=1e6,
               num_local_experts=4, num_experts_per_tok=2,
               dtype="float32")


def _configs(arch):
    if arch == "mixtral":
        return _tiny_mixtral(JaxModelConfig), _tiny_mixtral(ModelConfig)
    return jax_tiny_model_config(arch), tiny_model_config(arch)


def _params(arch, jax_cfg):
    init, _ = jax_registry.get_model(jax_cfg)
    params = {k: np.asarray(v) for k, v in
              init(jax_cfg, jax.random.PRNGKey(3)).items()}
    rng = np.random.RandomState(4)
    for name, v in params.items():
        # Zero biases and unit norms: give them values.
        if name.startswith("b") or name.endswith("_b"):
            params[name] = (0.05 * rng.randn(*v.shape)).astype(np.float32)
        elif "norm" in name:
            params[name] = (1 + 0.1 * rng.randn(*v.shape)).astype(
                np.float32)
    if arch == "mixtral":
        # A sharper router, so the top-2 choice varies by token.
        params["moe_gate"] = (params["moe_gate"] * 20).astype(np.float32)
    return params


def _steps():
    """(tokens, positions, page_table, kv_lens, valid) per step, the
    engine's conventions (test_torch_llama.py's steps)."""
    rng = np.random.RandomState(5)
    tok = lambda *s: rng.randint(1, 500, size=s).astype(np.int32)  # noqa
    table = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 0, 0]], np.int32)
    prefill_pos = np.zeros((2, 16), np.int32)
    prefill_valid = np.zeros((2, 16), bool)
    prefill_pos[0], prefill_valid[0] = np.arange(16), True
    prefill_pos[1, :10], prefill_valid[1, :10] = np.arange(10), True
    prefill = (tok(2, 16), prefill_pos, table[:2],
               np.array([16, 10], np.int32), prefill_valid)
    decode = (tok(2, 1), np.array([[16], [10]], np.int32), table[:2],
              np.array([17, 11], np.int32), np.ones((2, 1), bool))
    mixed_pos = np.zeros((3, 8), np.int32)
    mixed_valid = np.zeros((3, 8), bool)
    mixed_pos[0, 0], mixed_valid[0, 0] = 17, True  # decode row
    mixed_pos[1], mixed_valid[1] = np.arange(11, 19), True  # chunk row
    mixed = (tok(3, 8), mixed_pos, table, np.array([18, 19, 0], np.int32),
             mixed_valid)
    return {"prefill": prefill, "decode": decode, "mixed": mixed}


KINDS = {"prefill": "prefill", "decode": "decode", "mixed": "ragged"}


def _run_both(arch, jax_impl="xla"):
    jax_cfg, port_cfg = _configs(arch)
    jax_cfg.attention_impl = jax_impl
    np_params = _params(arch, jax_cfg)
    jax_params = {k: jnp.asarray(v) for k, v in np_params.items()}
    port_params = params_from_numpy(np_params, port_cfg, "cpu")
    layers, kv, d = (port_cfg.num_hidden_layers,
                     port_cfg.num_key_value_heads, port_cfg.head_dim)
    shape = (kv, NUM_PAGES, d, PAGE_SIZE)
    jax_k = tuple(jnp.zeros(shape, jnp.float32) for _ in range(layers))
    jax_v = tuple(jnp.zeros(shape, jnp.float32) for _ in range(layers))
    port_k = [torch.zeros(shape) for _ in range(layers)]
    port_v = [torch.zeros(shape) for _ in range(layers)]
    _, jax_fwd = jax_registry.get_model(jax_cfg)
    _, port_fwd = registry.get_model(port_cfg)
    for name, step in _steps().items():
        cfg = jax_cfg
        if name == "mixed" and jax_impl == "pallas-interpret":
            cfg = dataclasses.replace(
                jax_cfg, attention_impl_prefill="pallas_ragged-interpret")
        expected, jax_k, jax_v = jax.jit(
            lambda *a, cfg=cfg: jax_fwd(a[0], cfg, *a[1:]))(
                jax_params, *(jnp.asarray(x) for x in step), jax_k, jax_v)
        got = port_fwd(port_params, port_cfg,
                       *(torch.from_numpy(x) for x in step), port_k,
                       port_v, kind=KINDS[name])
        yield name, step[4], got.numpy(), np.asarray(expected)
    for layer in range(layers):
        np.testing.assert_allclose(port_k[layer].numpy()[:, 1:],
                                   np.asarray(jax_k[layer])[:, 1:], **TOL)
        np.testing.assert_allclose(port_v[layer].numpy()[:, 1:],
                                   np.asarray(jax_v[layer])[:, 1:], **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_matches_jax(arch):
    for name, valid, got, expected in _run_both(arch):
        np.testing.assert_allclose(got[valid], expected[valid], **TOL,
                                   err_msg=f"{arch} {name}")


def test_opt_forward_matches_jax_pallas_interpret():
    """OPT (group 1) against the JAX Pallas kernels run in interpret
    mode: decode, prefill and the ragged kernel for the mixed block."""
    for name, valid, got, expected in _run_both("opt", "pallas-interpret"):
        np.testing.assert_allclose(got[valid], expected[valid], **TOL,
                                   err_msg=f"opt pallas-interpret {name}")


def test_registry_lists_the_jax_architectures():
    assert registry.list_architectures() == (
        jax_registry.list_architectures())
    for arch, cls in (("llama", "LlamaParams"), ("mistral", "LlamaParams"),
                      ("qwen2", "LlamaParams"), ("opt", "OPTParams"),
                      ("gpt2", "GPT2Params"),
                      ("mixtral", "MixtralParams")):
        cfg = ModelConfig(architecture=arch)
        assert registry.params_class(cfg).__name__ == cls
        init, fwd = registry.get_model(cfg)
        assert callable(init) and callable(fwd)
    with pytest.raises(ValueError, match="Unknown architecture"):
        registry.get_model(ModelConfig(architecture="bloom"))
    with pytest.raises(ValueError, match="Unknown architecture"):
        jax_registry.get_model(JaxModelConfig(architecture="bloom"))


@pytest.mark.parametrize("arch", ["opt", "gpt2"])
def test_positions_past_the_table_are_clamped(arch):
    """A position past the learned table reads its last row, as the
    JAX gather clamps (the card would trap on the index); the engine
    caps max_model_len at the table, as JAX's EngineConfig does."""
    _, cfg = _configs(arch)
    gen = torch.Generator().manual_seed(0)
    init, fwd = registry.get_model(cfg)
    params = init(cfg, gen, torch.device("cpu"))
    rows = params.pos_embed.shape[0]
    assert rows == cfg.max_position_embeddings + (2 if arch == "opt" else 0)
    shape = (cfg.num_key_value_heads, 8, cfg.head_dim, PAGE_SIZE)

    def run(pos):
        caches = ([torch.zeros(shape) for _ in range(2)],
                  [torch.zeros(shape) for _ in range(2)])
        return fwd(params, cfg, torch.tensor([[7]], dtype=torch.int32),
                   torch.tensor([[pos]], dtype=torch.int32),
                   torch.tensor([[1, 2]], dtype=torch.int32),
                   torch.tensor([1], dtype=torch.int32),
                   torch.ones((1, 1), dtype=torch.bool), *caches,
                   kind="decode")
    last = rows - 1 - params.POS_OFFSET
    torch.testing.assert_close(run(last + 5000), run(last))
    engine = EngineConfig(model=cfg, cache=CacheConfig(),
                          scheduler=SchedulerConfig(max_model_len=4096))
    assert engine.scheduler.max_model_len == cfg.max_position_embeddings


def test_moe_top_k_breaks_ties_by_the_lower_index():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.5, 3.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0]])
    vals, idx = mixtral.top_k_lower_index(logits, 2)
    assert idx.tolist() == [[1, 2], [0, 1]]
    jvals, jidx = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    assert np.asarray(jidx).tolist() == idx.tolist()
    np.testing.assert_array_equal(np.asarray(jvals), vals.numpy())


# Published configs' attention geometry at bf16: (architecture, q heads,
# kv heads, head_dim), from each model's config.json.
PUBLISHED = [
    ("llama", "meta-llama/Meta-Llama-3-8B", 32, 8, 128),
    ("mistral", "mistralai/Mistral-7B-v0.1", 32, 8, 128),
    ("qwen2", "Qwen/Qwen2-7B", 28, 4, 128),
    ("opt", "facebook/opt-1.3b", 32, 32, 64),
    ("gpt2", "openai-community/gpt2", 12, 12, 64),
    ("mixtral", "mistralai/Mixtral-8x7B-v0.1", 32, 8, 128),
]


@pytest.mark.parametrize("arch,source,nh,nkv,d", PUBLISHED,
                         ids=[p[0] for p in PUBLISHED])
def test_published_geometries_have_kernel_lines(arch, source, nh, nkv, d):
    """The geometry ``check_kernel_shapes`` asks about, over bf16 pages
    and int8 pages and at every --dtype, is one the kernels serve
    (``kernel_geometry_supported``, the rule PSTT_FOR_EACH_GEOMETRY
    instantiates)."""
    from production_stack_tpu_torch.ops.paged_kv_common import (
        kernel_geometry_supported,
    )
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for cache in (dtype, torch.int8):
            assert kernel_geometry_supported(dtype, cache, nh // nkv, d), (
                source, dtype, cache)


# ---- adapters and int8 weights on the families ------------------------------

MAX_RANK = 4
# PEFT module names per family, with (section, projection, in, out) read
# off the tiny configs: what a PEFT adapter of that family trains.


def _peft_modules(arch, cfg):
    h, ffn = cfg.hidden_size, cfg.intermediate_size
    hd = cfg.num_attention_heads * cfg.head_dim
    kvd = cfg.num_key_value_heads * cfg.head_dim
    if arch == "opt":
        return [("self_attn.q_proj", h, hd), ("self_attn.k_proj", h, hd),
                ("self_attn.v_proj", h, hd), ("self_attn.out_proj", hd, h),
                ("fc1", h, ffn), ("fc2", ffn, h)]
    if arch == "gpt2":
        return [("attn.c_attn", h, 3 * hd), ("attn.c_proj", hd, h),
                ("mlp.c_fc", h, ffn), ("mlp.c_proj", ffn, h)]
    return [("self_attn.q_proj", h, hd), ("self_attn.k_proj", h, kvd),
            ("self_attn.v_proj", h, kvd), ("self_attn.o_proj", hd, h)]


def _write_peft(path, arch, cfg, rank=3, seed=6):
    from safetensors.numpy import save_file
    rs = np.random.RandomState(seed)
    layer = "h" if arch == "gpt2" else "model.layers"
    raw = {}
    for i in range(cfg.num_hidden_layers):
        for module, d_in, d_out in _peft_modules(arch, cfg):
            prefix = f"base_model.model.{layer}.{i}.{module}"
            raw[f"{prefix}.lora_A.weight"] = (
                0.1 * rs.randn(rank, d_in)).astype(np.float32)
            raw[f"{prefix}.lora_B.weight"] = (
                0.1 * rs.randn(d_out, rank)).astype(np.float32)
    path.mkdir(parents=True, exist_ok=True)
    save_file(raw, str(path / "adapter_model.safetensors"))
    (path / "adapter_config.json").write_text(
        '{"r": %d, "lora_alpha": 6}' % rank)
    return str(path)


@pytest.mark.parametrize("arch", FAMILIES)
def test_adapters_match_jax(tmp_path, arch):
    """The PEFT loader's targets (GPT-2's c_attn: A shared, B split in
    three) and a forward with base and adapter rows, against JAX's
    ``load_peft_adapter`` and ``forward`` with the same stacks."""
    from production_stack_tpu.engine import lora as jax_lora
    from production_stack_tpu_torch.engine import lora as port_lora
    jax_cfg, port_cfg = _configs(arch)
    path = _write_peft(tmp_path / "adapter", arch, port_cfg)
    ours = port_lora.load_peft_adapter(path, port_cfg, MAX_RANK, name="x")
    theirs = jax_lora.load_peft_adapter(path, jax_cfg, MAX_RANK, name="x")
    assert sorted(ours.weights) == sorted(theirs.weights) == sorted(
        port_lora.target_shapes(port_cfg))
    assert ours.scaling == theirs.scaling == 2.0
    for tgt, (a, b) in theirs.weights.items():
        np.testing.assert_array_equal(ours.weights[tgt][0], a)
        np.testing.assert_array_equal(ours.weights[tgt][1], b)
    jreg = jax_lora.LoRARegistry(jax_cfg, 2, MAX_RANK)
    preg = port_lora.LoRARegistry(port_cfg, 2, MAX_RANK)
    jreg.register(theirs)
    preg.register(ours)
    np_params = _params(arch, jax_cfg)
    step = _steps()["prefill"]
    ids = [1, 0]
    layers, kv, d = (port_cfg.num_hidden_layers,
                     port_cfg.num_key_value_heads, port_cfg.head_dim)
    shape = (kv, NUM_PAGES, d, PAGE_SIZE)
    _, jax_fwd = jax_registry.get_model(jax_cfg)
    want, _, _ = jax_fwd(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jax_cfg,
        *(jnp.asarray(x) for x in step),
        tuple(jnp.zeros(shape) for _ in range(layers)),
        tuple(jnp.zeros(shape) for _ in range(layers)),
        lora=jreg.stack, lora_ids=jnp.asarray(ids, jnp.int32))
    _, port_fwd = registry.get_model(port_cfg)
    params = params_from_numpy(np_params, port_cfg, "cpu")

    def run(**lora):
        return port_fwd(params, port_cfg,
                        *(torch.from_numpy(x) for x in step),
                        [torch.zeros(shape) for _ in range(layers)],
                        [torch.zeros(shape) for _ in range(layers)],
                        kind="prefill", **lora)
    got = run(lora=preg.stack, lora_ids=torch.tensor(ids, dtype=torch.int32))
    valid = step[4]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               **TOL)
    base = run()
    assert torch.equal(got[1], base[1])  # slot 0: the base model
    assert (got[0] - base[0]).abs().max() > 1e-3


@pytest.mark.parametrize("arch", ["opt", "gpt2"])
def test_int8_weights_match_jax(arch):
    """JAX's ``quantize_params`` carried across, and the port's own
    quantization of the dense weights, against JAX's quantized
    forward."""
    from production_stack_tpu.engine import quantization as jax_quant
    from production_stack_tpu_torch.engine import quantization
    jax_cfg, port_cfg = _configs(arch)
    np_params = _params(arch, jax_cfg)
    jq = jax_quant.quantize_params(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jax_cfg)
    jq_np = {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                 else np.asarray(v)) for k, v in jq.items()}
    carried = params_from_numpy(jq_np, port_cfg, "cpu")
    own = quantization.quantize_params(
        params_from_numpy(np_params, port_cfg, "cpu"), port_cfg)
    for a, b in zip(carried.state_dict().items(), own.state_dict().items()):
        assert a[0] == b[0] and torch.equal(a[1], b[1]), a[0]
    assert quantization.has_quantized_leaves(own)
    layers, kv, d = (port_cfg.num_hidden_layers,
                     port_cfg.num_key_value_heads, port_cfg.head_dim)
    shape = (kv, NUM_PAGES, d, PAGE_SIZE)
    _, jax_fwd = jax_registry.get_model(jax_cfg)
    _, port_fwd = registry.get_model(port_cfg)
    jax_k = tuple(jnp.zeros(shape) for _ in range(layers))
    jax_v = tuple(jnp.zeros(shape) for _ in range(layers))
    port_k = [torch.zeros(shape) for _ in range(layers)]
    port_v = [torch.zeros(shape) for _ in range(layers)]
    for name, step in _steps().items():
        want, jax_k, jax_v = jax_fwd(jq, jax_cfg,
                                     *(jnp.asarray(x) for x in step),
                                     jax_k, jax_v)
        got = port_fwd(carried, port_cfg,
                       *(torch.from_numpy(x) for x in step), port_k, port_v,
                       kind=KINDS[name])
        np.testing.assert_allclose(got.numpy()[step[4]],
                                   np.asarray(want)[step[4]], **TOL,
                                   err_msg=f"{arch} int8 {name}")


def test_mixtral_int8_is_refused_as_jax():
    from production_stack_tpu.engine import quantization as jax_quant
    from production_stack_tpu_torch.engine import quantization
    jax_cfg, port_cfg = _configs("mixtral")
    gen = torch.Generator().manual_seed(0)
    params = mixtral.init_params(port_cfg, gen, torch.device("cpu"))
    with pytest.raises(NotImplementedError) as ours:
        quantization.quantize_params(params, port_cfg)
    with pytest.raises(NotImplementedError) as theirs:
        jax_quant.quantize_params({}, jax_cfg)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(NotImplementedError) as ours:
        quantization.init_random_quantized(port_cfg, 0, torch.device("cpu"))
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("arch", ("llama",) + FAMILIES)
def test_the_kernels_get_contiguous_queries(monkeypatch, arch):
    """The CUDA wrappers refuse a non-contiguous q; OPT's and GPT-2's
    q (no RoPE) is a view of the fused projection's output, so
    ``self_attention`` makes it contiguous before dispatch."""
    from production_stack_tpu_torch.models import llama
    seen = []
    dispatch = llama.dispatch_attention

    def check(config, q, *args, **kwargs):
        seen.append(q.is_contiguous())
        return dispatch(config, q, *args, **kwargs)
    monkeypatch.setattr(llama, "dispatch_attention", check)
    _, cfg = _configs(arch)
    init, fwd = registry.get_model(cfg)
    params = init(cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    shape = (cfg.num_key_value_heads, NUM_PAGES, cfg.head_dim, PAGE_SIZE)
    for name, step in _steps().items():
        fwd(params, cfg, *(torch.from_numpy(x) for x in step),
            [torch.zeros(shape) for _ in range(2)],
            [torch.zeros(shape) for _ in range(2)], kind=KINDS[name])
    assert seen and all(seen)
