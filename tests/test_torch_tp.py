"""Tensor parallelism in the port against the JAX package's, on the CPU.

JAX runs on the fake CPU devices of tests/conftest.py, with its weights
and caches placed by ``parallel/mesh.shard_params`` / ``shard_cache``
on ``build_mesh(tensor_parallel_size=2)`` and GSPMD writing the
collectives. The port runs tp 2 in two ways: in one process, two ranks
in two threads over ``FakeTPGroup`` (its reduction sums the partials in
rank order) and ``FakeTransport`` (the step bridge's queues); and as a
real two-process server over gloo (``--tensor-parallel-size 2 --device
cpu``).

Held here: each family's tp forward (llama, qwen2's biases, opt, gpt2,
mixtral) against JAX's sharded forward, logits at the families test's
f32 tolerance (atol = rtol = 1e-4: the row-parallel sums run in another
order) and every rank's logits bitwise alike; each rank's shards
bitwise against JAX's shards read back (fused qkv and gate/up cut part
by part, int8 pairs, LoRA stacks); OPT's replicated biases added once;
Mixtral's expert split; greedy engine streams byte-identical to the JAX
engine at tp 2 and to the port at tp 1, and the port's seeded and
stochastic rows the same at tp 1 and tp 2 through every step kind; an
adapter installed into a running tp engine; the step bridge over the
fake transport; a page read whole off the ranks and written cut, so
the offload tier, disaggregated hops and stream checkpoints run under
tp; the refusals.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine import lora as jax_lora
from production_stack_tpu.engine import quantization as jax_quant
from production_stack_tpu.engine import weights as jax_weights
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import registry as jax_registry
from production_stack_tpu.parallel import mesh as jax_mesh
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine import lora as port_lora
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.lora import LoRAAdapter, LoRARegistry
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    SequenceState,
)
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch.models import mixtral, registry
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.models.llama import row_parallel
from production_stack_tpu_torch.parallel import mesh
from production_stack_tpu_torch.parallel.collectives import (
    FakeTPGroup,
    TPGroup,
    run_ranks,
)
from production_stack_tpu_torch.parallel.distributed import (
    FakeTransport,
    StepBridge,
)
from tests import test_model_parity as parity
from tests import test_torch_lora as lora_tests
from tests import test_torch_model_families as fam

torch.set_num_threads(2)

TP = 2
ARCHS = ("llama", "qwen2", "opt", "gpt2", "mixtral")
ROOT = Path(__file__).resolve().parents[1]


def _configs(arch):
    if arch == "qwen2":
        jc, pc = fam._configs("llama")
        return tuple(dataclasses.replace(c, architecture="qwen2",
                                         attention_bias=True)
                     for c in (jc, pc))
    return fam._configs(arch)


def _np_params(arch, jax_cfg):
    return fam._params(arch, jax_cfg)


def _jax_mesh():
    return jax_mesh.build_mesh(tensor_parallel_size=TP)


def _jax_shard(arr, jmesh, rank):
    """Rank ``rank``'s shard of a placed JAX array, as numpy."""
    dev = jmesh.devices.reshape(-1)[rank]
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)


def _port_shards(np_params, port_cfg):
    return [mesh.shard_params(params_from_numpy(np_params, port_cfg, "cpu"),
                              port_cfg, r, TP) for r in range(TP)]


# ---- (a) each family's forward -----------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_forward_matches_jax(arch):
    """Prefill, decode and a mixed block (fam._steps) through the
    port's tp-2 forward (two fake ranks) and JAX's forward on its
    tp-2 mesh: logits within the f32 tolerance, both ranks' logits
    bitwise alike, each rank's pages JAX's kv-head shard."""
    jax_cfg, port_cfg = _configs(arch)
    np_params = _np_params(arch, jax_cfg)
    jmesh = _jax_mesh()
    jax_params = jax_mesh.shard_params(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jax_cfg, jmesh)
    layers, kv, d = (port_cfg.num_hidden_layers,
                     port_cfg.num_key_value_heads, port_cfg.head_dim)
    shape = (kv, fam.NUM_PAGES, d, fam.PAGE_SIZE)
    jax_k = tuple(jax_mesh.shard_cache(jnp.zeros(shape, jnp.float32), jmesh)
                  for _ in range(layers))
    jax_v = tuple(jax_mesh.shard_cache(jnp.zeros(shape, jnp.float32), jmesh)
                  for _ in range(layers))
    _, jax_fwd = jax_registry.get_model(jax_cfg)
    _, port_fwd = registry.get_model(port_cfg)
    shards = _port_shards(np_params, port_cfg)
    rank_cfg = mesh.rank_model_config(port_cfg, TP)
    rank_shape = (kv // TP,) + shape[1:]
    caches = [([torch.zeros(rank_shape) for _ in range(layers)],
               [torch.zeros(rank_shape) for _ in range(layers)])
              for _ in range(TP)]
    groups = FakeTPGroup.world(TP)
    fwd = jax.jit(lambda *a: jax_fwd(a[0], jax_cfg, *a[1:]))
    for name, step in fam._steps().items():
        expected, jax_k, jax_v = fwd(
            jax_params, *(jnp.asarray(x) for x in step), jax_k, jax_v)
        outs = run_ranks(groups, lambda g, step=step, name=name: port_fwd(
            shards[g.rank], rank_cfg, *(torch.from_numpy(x) for x in step),
            caches[g.rank][0], caches[g.rank][1], kind=fam.KINDS[name],
            tp=g))
        valid = step[4]
        np.testing.assert_allclose(outs[0].numpy()[valid],
                                   np.asarray(expected)[valid], **fam.TOL,
                                   err_msg=f"{arch} {name}")
        assert torch.equal(outs[0], outs[1])
    for r in range(TP):
        for layer in range(layers):
            for port_c, jax_c in ((caches[r][0][layer], jax_k[layer]),
                                  (caches[r][1][layer], jax_v[layer])):
                np.testing.assert_allclose(
                    port_c.numpy()[:, 1:],
                    _jax_shard(jax_c, jmesh, r)[:, 1:], **fam.TOL)


# ---- (b) the shards ------------------------------------------------------------


def _port_leaf(params, cfg, rank_cfg, name):
    """The port shard's leaf ``name`` in the JAX layout ([L, ...] and
    [in, out]); an int8 projection as its (q, scale) pair."""
    nh, nkv, d = (rank_cfg.num_attention_heads,
                  rank_cfg.num_key_value_heads, rank_cfg.head_dim)
    ffn = rank_cfg.intermediate_size
    opt = cfg.architecture in ("opt", "gpt2")
    qkv = ((0, nh * d), (nh * d, 2 * nh * d), (2 * nh * d, 3 * nh * d)) \
        if opt else ((0, nh * d), (nh * d, (nh + nkv) * d),
                     ((nh + nkv) * d, (nh + 2 * nkv) * d))
    column = {"wq": ("qkv", qkv[0]), "wk": ("qkv", qkv[1]),
              "wv": ("qkv", qkv[2]), "fc1": ("fc1", None),
              "w_gate": ("gate_up", (0, ffn)),
              "w_up": ("gate_up", (ffn, 2 * ffn))}
    row = {"wo": "o", "w_down": "down", "fc2": "fc2"}
    bias = {"bq": ("qkv", qkv[0]), "bk": ("qkv", qkv[1]),
            "bv": ("qkv", qkv[2]), "fc1_b": ("fc1", None)}
    row_bias = {"bo": "o", "fc2_b": "fc2"}

    def stack(fn):
        return np.stack([np.asarray(fn(layer)) for layer in params.layers])

    def t(x):
        return x.detach().float().numpy() if x.is_floating_point() \
            else x.detach().numpy()

    if cfg.architecture == "mixtral" and name in ("w_gate", "w_up"):
        return np.transpose(stack(lambda layer: t(getattr(layer, name))),
                            (0, 1, 3, 2))
    if cfg.architecture == "mixtral" and name == "w_down":
        return np.transpose(stack(lambda layer: t(layer.w_down)),
                            (0, 2, 3, 1))
    if name in ("embed", "pos_embed", "final_norm", "final_norm_w",
                "final_norm_b"):
        return t(getattr(params, name))
    if name == "lm_head":
        return t(params.lm_head.weight).T
    if name in column or name in row:
        proj, span = column.get(name, (row.get(name), None))
        module = getattr(params.layers[0], proj)
        if hasattr(module, "weight_int8"):
            def q(layer):
                w = t(getattr(layer, proj).weight_int8)
                return w[slice(*span)] if span else w
            def s(layer):
                sc = t(getattr(layer, proj).scale)
                return sc[slice(*span)] if span else sc
            return (np.transpose(stack(q), (0, 2, 1)), stack(s))
        w = stack(lambda layer: t(getattr(layer, proj).weight))
        w = np.transpose(w, (0, 2, 1))
        return w[:, :, slice(*span)] if span else w
    if name in bias:
        proj, span = bias[name]
        b = stack(lambda layer: t(getattr(layer, proj).bias))
        return b[:, slice(*span)] if span else b
    if name in row_bias:
        return stack(lambda layer: t(getattr(layer, row_bias[name])
                                     .row_bias))
    if name == "moe_gate":
        return np.transpose(stack(lambda layer: t(layer.moe_gate.weight)),
                            (0, 2, 1))
    return stack(lambda layer: t(getattr(layer, name)))


@pytest.mark.parametrize("arch", ("llama", "qwen2", "opt", "mixtral"))
def test_shards_are_jaxs_shards(arch):
    """Every leaf of each rank's shard, bitwise JAX's shard of it on the
    tp-2 mesh: q, k and v (and gate, up) cut apart, then fused."""
    jax_cfg, port_cfg = _configs(arch)
    np_params = _np_params(arch, jax_cfg)
    jmesh = _jax_mesh()
    placed = jax_mesh.shard_params(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jax_cfg, jmesh)
    rank_cfg = mesh.rank_model_config(port_cfg, TP)
    for r, shard in enumerate(_port_shards(np_params, port_cfg)):
        for name, arr in placed.items():
            np.testing.assert_array_equal(
                _port_leaf(shard, port_cfg, rank_cfg, name),
                _jax_shard(arr, jmesh, r), err_msg=f"{arch} {name} {r}")


@pytest.mark.parametrize("arch", ("llama", "opt"))
def test_int8_pairs_are_jaxs_shards(arch):
    """JAX-quantized weights (values and per-channel scales) cut as JAX
    cuts the pairs: a column-parallel scale with its channels, a
    row-parallel one whole."""
    jax_cfg, port_cfg = _configs(arch)
    np_params = _np_params(arch, jax_cfg)
    quantized = jax_quant.quantize_params(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jax_cfg)
    jmesh = _jax_mesh()
    placed = jax_mesh.shard_params(quantized, jax_cfg, jmesh)
    as_numpy = {k: (tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
                    else np.asarray(v)) for k, v in quantized.items()}
    rank_cfg = mesh.rank_model_config(port_cfg, TP)
    pairs = [k for k, v in placed.items() if isinstance(v, tuple)]
    assert pairs
    for r in range(TP):
        shard = mesh.shard_params(
            params_from_numpy(as_numpy, port_cfg, "cpu"), port_cfg, r, TP)
        for name in pairs:
            q, scale = _port_leaf(shard, port_cfg, rank_cfg, name)
            np.testing.assert_array_equal(
                q, _jax_shard(placed[name][0], jmesh, r), err_msg=name)
            np.testing.assert_array_equal(
                scale, _jax_shard(placed[name][1], jmesh, r), err_msg=name)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_cache_shards_are_jaxs_shards(int8, stacked):
    """A rank's kv heads of every cache form (per-layer or stacked, full
    precision or int8 with its scales), bitwise JAX's ``shard_cache``
    shards."""
    from production_stack_tpu.ops.quant_kv import QuantKV as JaxQuantKV
    from production_stack_tpu_torch.ops.quant_kv import QuantKV
    rs = np.random.RandomState(9)
    shape = ((3,) if stacked else ()) + (4, 6, 8, 16)
    if int8:
        data = rs.randint(-127, 128, size=shape).astype(np.int8)
        scale = rs.rand(*shape[:-2], 16).astype(np.float32)
        theirs = jax_mesh.shard_cache(
            JaxQuantKV(jnp.asarray(data), jnp.asarray(scale)), _jax_mesh())
        leaves = [(theirs.data, lambda c: c.data), (theirs.scale,
                                                     lambda c: c.scale)]
        full = QuantKV(torch.from_numpy(data), torch.from_numpy(scale))
    else:
        data = rs.randn(*shape).astype(np.float32)
        theirs = jax_mesh.shard_cache(jnp.asarray(data), _jax_mesh())
        leaves = [(theirs, lambda c: c)]
        full = torch.from_numpy(data)
    for r in range(TP):
        ours = mesh.shard_cache(full, r, TP)
        for arr, leaf in leaves:
            np.testing.assert_array_equal(leaf(ours).numpy(),
                                          _jax_shard(arr, _jax_mesh(), r))


def test_lora_stacks_are_jaxs_shards():
    """Adapter stacks installed through each rank's registry (the
    adapter cut as its base projections) bitwise JAX's stacks placed
    by ``lora_stack_specs`` on the tp-2 mesh."""
    jcfg = jax_config.tiny_model_config("llama")
    pcfg = config.tiny_model_config("llama")
    jreg = jax_lora.LoRARegistry(jcfg, 2, lora_tests.MAX_RANK)
    lora_tests._register(jreg, jax_lora, jcfg)
    jmesh = _jax_mesh()
    stack_ab = {"a": jreg.stack["a"], "b": jreg.stack["b"]}
    specs = jax_lora.lora_stack_specs(
        stack_ab, None, functools.partial(jax_mesh._on_mesh, mesh=jmesh))
    rank_cfg = mesh.rank_model_config(pcfg, TP)
    for r in range(TP):
        preg = LoRARegistry(rank_cfg, 2, lora_tests.MAX_RANK, shard=(
            lambda a, r=r: mesh.shard_lora_adapter(a, r, TP)))
        lora_tests._register(preg, port_lora, pcfg)
        for side in ("a", "b"):
            for tgt, arr in stack_ab[side].items():
                placed = jax.device_put(
                    arr, NamedSharding(jmesh, specs[side][tgt]))
                np.testing.assert_array_equal(
                    preg.stack[side][tgt].numpy(),
                    _jax_shard(placed, jmesh, r), err_msg=f"{side} {tgt}")
        assert preg.names() == jreg.names()
        for slot in (1, 2):
            assert preg.cache_root(slot) == jreg.cache_root(slot)


# ---- a rank's shard built one module at a time ---------------------------------


CPU = torch.device("cpu")
SAVERS = {"llama": parity._save_tiny_llama, "opt": parity._save_tiny_opt,
          "mixtral": parity._save_tiny_mixtral}


def _assert_same(got, want):
    a = {**dict(got.named_parameters()), **dict(got.named_buffers())}
    b = {**dict(want.named_parameters()), **dict(want.named_buffers())}
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def _random_build(cfg, rank, tp, seed=3):
    from production_stack_tpu_torch.models.llama import random_leaf
    gen = torch.Generator().manual_seed(seed)
    return mesh.build_rank_params(
        cfg, lambda path, shape, dtype: random_leaf(path, shape, dtype, gen,
                                                    CPU), rank, tp)


@pytest.mark.parametrize("tp", (1, TP))
@pytest.mark.parametrize("arch", ARCHS)
def test_a_built_rank_is_the_full_init_cut(arch, tp):
    """Random weights made a module at a time are the bits of the
    family's init_params, and each rank keeps its shard_params shard."""
    _, cfg = _configs(arch)
    init, _ = registry.get_model(cfg)
    for rank in range(tp):
        full = init(cfg, torch.Generator().manual_seed(3), CPU)
        _assert_same(_random_build(cfg, rank, tp),
                     mesh.shard_params(full, cfg, rank, tp))


def test_a_rank_never_holds_the_whole_model(monkeypatch):
    """While a rank's shard is made, the leaves made so far never pass
    the rank's shard plus one module in full (the old path held the
    whole model, then cut it): the cut weights are 1/tp of the whole,
    the replicated ones (embeddings, norms) whole."""
    _, cfg = _configs("llama")
    cfg = dataclasses.replace(cfg, num_hidden_layers=4,
                              num_key_value_heads=4)

    def nbytes(module):
        return sum(p.numel() * p.element_size()
                   for p in [*module.parameters(), *module.buffers()]
                   if p.device.type != "meta")

    peak, biggest = [0], [0]
    finish = mesh.finish_module

    def counted(params, path, *args):
        module = params.get_submodule(path) if path else params
        biggest[0] = max(biggest[0], sum(
            p.numel() * p.element_size()
            for p in module.parameters(recurse=False)))
        peak[0] = max(peak[0], nbytes(params))
        finish(params, path, *args)

    monkeypatch.setattr(mesh, "finish_module", counted)
    whole = _random_build(cfg, 0, 1)
    full = nbytes(whole)
    specs = mesh.param_specs(cfg)
    replicated = full - sum(
        p.numel() * p.element_size() for name, p in whole.named_parameters()
        if name.rpartition(".")[0].rpartition(".")[2] in specs)
    for tp in (TP, 4):
        peak[0] = biggest[0] = 0
        shard = nbytes(_random_build(cfg, 1, tp))
        assert shard == replicated + (full - replicated) // tp
        assert peak[0] <= shard + biggest[0]
        assert peak[0] < full


@pytest.mark.parametrize("arch", sorted(SAVERS))
def test_the_loader_keeps_each_ranks_shard(tmp_path, arch):
    """``load_weights(..., rank, tp)`` finishes each module as its last
    piece arrives: the rank's shard of the whole checkpoint, bitwise."""
    from production_stack_tpu_torch.engine import weights as port_weights
    path, _ = SAVERS[arch](tmp_path)
    cfg = port_weights.load_model_config(path)
    cfg.dtype = "float32"
    for rank in range(TP):
        full = port_weights.load_weights(path, cfg, device="cpu")
        got = port_weights.load_weights(path, cfg, device="cpu", rank=rank,
                                        tp=TP)
        _assert_same(got, mesh.shard_params(full, cfg, rank, TP))
        with pytest.raises(ValueError, match="already hold"):
            mesh.shard_params(got, cfg, 1 - rank, TP)


def test_int8_ranks_quantize_the_whole_weight_then_cut(tmp_path):
    """int8 under tp: the loader and the random int8 init give each
    rank the cut of the fully quantized model (a row-parallel scale
    from its whole input), as quantize-then-shard_params does."""
    from production_stack_tpu_torch.engine import quantization
    from production_stack_tpu_torch.engine import weights as port_weights
    path, _ = parity._save_tiny_llama(tmp_path)
    cfg = port_weights.load_model_config(path)
    cfg.dtype = "float32"
    cfg.quantization = "int8"
    for rank in range(TP):
        full = quantization.quantize_params(
            port_weights.load_weights(path, dataclasses.replace(
                cfg, quantization="none"), device="cpu"), cfg)
        got = port_weights.load_weights(path, cfg, device="cpu", rank=rank,
                                        tp=TP)
        assert quantization.has_quantized_leaves(got)
        _assert_same(got, mesh.shard_params(full, cfg, rank, TP))
        _assert_same(quantization.init_random_quantized(cfg, 5, CPU, rank,
                                                        TP),
                     mesh.shard_params(quantization.init_random_quantized(
                         cfg, 5, CPU), cfg, rank, TP))


# ---- (c) OPT's biases, (d) Mixtral's experts -----------------------------------


def test_opt_row_biases_are_added_once():
    """OPT's output and fc2 biases are replicated: a rank's row-parallel
    projection holds none in its product, the whole bias rides
    ``row_bias``, and the reduced output adds it once (an all-rank add
    would give tp times the bias)."""
    _, cfg = _configs("opt")
    gen = torch.Generator().manual_seed(0)
    init, _ = registry.get_model(cfg)
    full = init(cfg, gen, torch.device("cpu"))
    with torch.no_grad():
        for layer in full.layers:
            layer.o.bias.normal_(0, 0.5, generator=gen)
            layer.fc2.bias.normal_(0, 0.5, generator=gen)
    shards = [mesh.shard_params(init(cfg, torch.Generator().manual_seed(0),
                                     torch.device("cpu")), cfg, r, TP)
              for r in range(TP)]
    with torch.no_grad():
        for shard in shards:
            for ls, lf in zip(shard.layers, full.layers):
                assert ls.o.bias is None and ls.fc2.bias is None
                ls.o.row_bias.copy_(lf.o.bias)
                ls.fc2.row_bias.copy_(lf.fc2.bias)
    x = torch.randn(2, 3, cfg.intermediate_size, generator=gen)
    want = full.layers[0].fc2(x)
    groups = FakeTPGroup.world(TP)
    outs = run_ranks(groups, lambda g: row_parallel(
        mesh.cut(x, 2, g.rank, TP), shards[g.rank].layers[0].fc2, None,
        "fc2", None, None, g))
    torch.testing.assert_close(outs[0], want, atol=1e-5, rtol=1e-5)
    assert torch.equal(outs[0], outs[1])


def test_mixtral_expert_split():
    """Rank r holds experts [r E/2, (r+1) E/2) of each expert tensor and
    the whole router; the two ranks' MoE blocks, reduced, are the full
    block's."""
    _, cfg = _configs("mixtral")
    gen = torch.Generator().manual_seed(1)
    init, _ = registry.get_model(cfg)
    full = init(cfg, gen, torch.device("cpu"))
    with torch.no_grad():
        full.layers[0].moe_gate.weight.mul_(20)
    e = cfg.num_local_experts // TP
    shards = []
    for r in range(TP):
        shard = init(cfg, torch.Generator().manual_seed(1),
                     torch.device("cpu"))
        with torch.no_grad():
            shard.layers[0].moe_gate.weight.mul_(20)
        shards.append(mesh.shard_params(shard, cfg, r, TP))
        layer, whole = shards[r].layers[0], full.layers[0]
        assert torch.equal(layer.w_gate, whole.w_gate[r * e:(r + 1) * e])
        assert torch.equal(layer.w_up, whole.w_up[r * e:(r + 1) * e])
        assert torch.equal(layer.w_down, whole.w_down[:, r * e:(r + 1) * e])
        assert torch.equal(layer.moe_gate.weight, whole.moe_gate.weight)
    x = torch.randn(2, 5, cfg.hidden_size, generator=gen)
    want = mixtral.moe_block(x, full.layers[0], cfg.num_experts_per_tok)
    outs = run_ranks(FakeTPGroup.world(TP), lambda g: mixtral.moe_block(
        x, shards[g.rank].layers[0], cfg.num_experts_per_tok, g))
    torch.testing.assert_close(outs[0], want, atol=1e-5, rtol=1e-5)


# ---- engines -------------------------------------------------------------------


PROMPTS = [[3, 11, 25, 99, 7, 42, 58, 13, 77, 21, 5, 64] * 3,
           [5, 6, 7, 8, 9, 10], [100, 200, 300],
           [1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3]]


def _engine_config(module, model, tp=1, kv="auto", layout="auto",
                   lora=False, **sched):
    extra = {}
    if tp > 1:
        extra["parallel"] = module.ParallelConfig(tensor_parallel_size=tp)
    if lora:
        extra["lora"] = module.LoRAConfig(enable=True, max_loras=2,
                                          max_lora_rank=lora_tests.MAX_RANK)
    return module.EngineConfig(
        model=model, cache=module.CacheConfig(
            page_size=8, num_pages=160, kv_cache_dtype=kv,
            cache_layout=layout),
        scheduler=module.SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                         prefill_chunk_size=16, **sched),
        **extra)


def _run_streams(engine, sampling, done=SequenceState.FINISHED,
                 names=None):
    seqs = [engine.sequences[engine.add_request(
        list(p), sp, **({} if names is None else {"lora_name": n}))]
        for p, sp, n in zip(PROMPTS, sampling, names or [None] * 4)]
    for _ in range(500):
        if not engine.has_work() and getattr(engine, "_in_flight",
                                             None) is None:
            break
        engine.step()
    assert all(s.state == done for s in seqs)
    return [list(s.output_token_ids) for s in seqs]


class FakeTP:
    """A tp-2 port engine in one process: rank 0's LLMEngine on this
    thread, rank 1's runner replaying the bridge on another."""

    def __init__(self, cfg, np_params=None, tokenizer=None):
        groups = FakeTPGroup.world(TP, timeout_s=60.0)
        transport = FakeTransport(TP)
        self.error = None

        def params():
            if np_params is None:
                return None
            return params_from_numpy(np_params, cfg.model, "cpu")

        ready = threading.Event()
        self.worker_runner = None

        def worker():
            try:
                runner = self.worker_runner = ModelRunner(
                    dataclasses.replace(cfg), params=params(), device="cpu",
                    tp=groups[1])
                ready.set()
                StepBridge(runner, transport.endpoint(1)).worker_loop()
            except BaseException as exc:  # surfaced by close()
                self.error = exc
                ready.set()
                groups[1]._world.barrier.abort()

        self.thread = threading.Thread(target=worker, daemon=True)
        self.thread.start()
        ready.wait(60)
        self.engine = LLMEngine(
            dataclasses.replace(cfg), params=params(), device="cpu",
            tokenizer=tokenizer, tp=groups[0],
            bridge=StepBridge(None, transport.endpoint(0)))

    def close(self):
        self.engine.runner.bridge.shutdown()
        self.thread.join(60)
        if self.error is not None:
            raise self.error


GREEDY = [SamplingParams(max_tokens=12, temperature=0.0, ignore_eos=True)
          for _ in PROMPTS]
MIXED_SAMPLING = [
    SamplingParams(max_tokens=14, temperature=0.0, ignore_eos=True),
    SamplingParams(max_tokens=9, temperature=0.0),
    SamplingParams(max_tokens=12, temperature=0.8, top_p=0.9, seed=7,
                   ignore_eos=True),
    SamplingParams(max_tokens=11, temperature=0.7, ignore_eos=True)]


@pytest.mark.parametrize("arch", ("llama", "opt", "mixtral"))
def test_fake_tp_engine_streams_match_jax_tp2(arch):
    """Greedy streams of the port's tp-2 engine (two fake ranks, the
    step bridge between them) byte-identical to the JAX engine's on
    its tp-2 mesh, same weights, and to the port's tp-1 engine."""
    jax_cfg, port_cfg = _configs(arch)
    np_params = _np_params(arch, jax_cfg)
    jengine = JaxEngine(
        _engine_config(jax_config, jax_cfg, TP), mesh=_jax_mesh(),
        params=jax_mesh.shard_params(
            {k: jnp.asarray(v) for k, v in np_params.items()}, jax_cfg,
            _jax_mesh()))
    theirs = _run_streams(
        jengine, [JaxSamplingParams(max_tokens=12, temperature=0.0,
                                    ignore_eos=True) for _ in PROMPTS],
        done=type(jengine.sequences[jengine.add_request(
            [1], JaxSamplingParams(max_tokens=1))].state).FINISHED)
    single = _run_streams(LLMEngine(
        _engine_config(config, port_cfg), params=params_from_numpy(
            np_params, port_cfg, "cpu"), device="cpu"), GREEDY)
    tp = FakeTP(_engine_config(config, port_cfg, TP), np_params)
    try:
        ours = _run_streams(tp.engine, GREEDY)
    finally:
        tp.close()
    assert ours == theirs
    assert ours == single


VARIANTS = {
    "plain": dict(),
    "async_unified": dict(async_scheduling=True, unified_step=True),
    "spec_unified": dict(speculative_k=3, unified_step=True),
    "burst": dict(decode_steps=4),
    "deferred_burst": dict(decode_steps=4, deferred_kv_writes=True),
    "int8_kv_stacked_deferred": dict(decode_steps=4, deferred_kv_writes=True,
                                     kv="int8", layout="stacked"),
    "int8_weights_async": dict(quant="int8", async_scheduling=True,
                               unified_step=True),
    "no_prefix_cache": dict(async_scheduling=True),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tp2_streams_equal_tp1_with_seeded_and_stochastic_rows(variant):
    """Greedy, stop-token, seeded and unseeded stochastic rows: the same
    streams at tp 2 as at tp 1, through every step kind. Every rank
    samples from the same gathered logits with a generator seeded
    alike, so no sampled token is broadcast."""
    kw = dict(VARIANTS[variant])
    quant = kw.pop("quant", "none")

    def model():
        m = config.tiny_model_config("llama")
        m.quantization = quant
        return m

    def cfg(tp):
        c = _engine_config(config, model(), tp, **kw)
        if variant == "no_prefix_cache":
            c.cache.enable_prefix_caching = False
        return c

    single = _run_streams(LLMEngine(cfg(1), device="cpu"), MIXED_SAMPLING)
    tp = FakeTP(cfg(TP))
    try:
        ours = _run_streams(tp.engine, MIXED_SAMPLING)
    finally:
        tp.close()
    assert ours == single


def test_an_adapter_installed_into_a_running_tp_engine():
    """LoRA under tp: adapters registered after the engine served its
    first requests reach every rank (each installs its own cut), and
    the adapter rows' greedy streams are the tp-1 engine's."""
    model = config.tiny_model_config("llama")
    names = [None, "ada", "bee", "ada"]

    def register(engine):
        for name, scaling, w in lora_tests._adapters(model):
            engine.runner.register_lora(LoRAAdapter(
                name=name, rank=lora_tests.MAX_RANK, scaling=scaling,
                weights=w))

    single_engine = LLMEngine(_engine_config(config, model, lora=True,
                                             async_scheduling=True),
                              device="cpu")
    _run_streams(single_engine, GREEDY)
    register(single_engine)
    single = _run_streams(single_engine, GREEDY, names=names)
    tp = FakeTP(_engine_config(config, model, TP, lora=True,
                               async_scheduling=True))
    try:
        _run_streams(tp.engine, GREEDY)
        register(tp.engine)
        ours = _run_streams(tp.engine, GREEDY, names=names)
        assert tp.engine.runner.lora_registry.stack["b"]["wq"].shape[-1] == (
            model.num_attention_heads // TP * model.head_dim)
    finally:
        tp.close()
    assert ours == single
    assert ours[1] != _run_streams(single_engine, GREEDY)[1]


def test_pooled_routes_under_tp_match_tp1():
    """The pooled routes' dense encode under tp: rank 0 publishes each
    chunk, every rank runs it on its shard (row-parallel output and
    down projections reduced), and the pooled unit vectors are tp 1's."""
    from production_stack_tpu_torch.engine.embeddings import Embedder
    model = config.tiny_model_config("llama")
    texts = [[1, 2, 3, 4], [5, 6, 7, 8, 9, 10, 11], [42] * 20]

    def embed(engine):
        return Embedder(model, engine.runner.params, max_len=256,
                        encode_fn=engine.runner.encode).embed_batch(texts)

    want = embed(LLMEngine(_engine_config(config, model), device="cpu"))
    tp = FakeTP(_engine_config(config, model, TP))
    try:
        got = embed(tp.engine)
    finally:
        tp.close()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_out_of_vocab_pooled_ids_leave_the_workers_serving():
    """An id past the vocabulary and a negative id on the pooled path of
    a tp-2 engine: mapped before rank 0 publishes the chunk (the JAX
    gather's wrap and clamp), so the vectors are tp 1's of the mapped
    ids, and the worker rank then serves the greedy streams of tp 1."""
    from production_stack_tpu_torch.engine.embeddings import Embedder
    model = config.tiny_model_config("llama")
    texts = [[1, 2, 100000, 4], [-1, 6, -600, 8]]
    mapped = [[1, 2, 511, 4], [511, 6, 0, 8]]

    def embed(engine, ids):
        return Embedder(model, engine.runner.params, max_len=256,
                        encode_fn=engine.runner.encode).embed_batch(ids)

    single_engine = LLMEngine(_engine_config(config, model), device="cpu")
    want = embed(single_engine, mapped)
    single = _run_streams(single_engine, GREEDY)
    tp = FakeTP(_engine_config(config, model, TP))
    try:
        got = embed(tp.engine, texts)
        ours = _run_streams(tp.engine, GREEDY)
    finally:
        tp.close()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert ours == single


def test_collectives_are_counted_a_call():
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    COUNTERS.reset()
    groups = FakeTPGroup.world(TP)
    outs = run_ranks(groups, lambda g: (
        g.all_reduce(torch.full((3,), float(g.rank + 1))),
        g.all_gather(torch.full((2, 1), float(g.rank)))))
    assert outs[0][0].tolist() == [3.0, 3.0, 3.0]
    assert outs[1][1].tolist() == [[0.0, 1.0], [0.0, 1.0]]
    assert COUNTERS.launches["tp_all_reduce"] == TP
    assert COUNTERS.launches["tp_all_gather"] == TP
    COUNTERS.reset()


# ---- (j) the step bridge -------------------------------------------------------


class _Recorder:
    def __init__(self):
        self.records = []

    def execute(self, record):
        self.records.append(record)


def test_bridge_followers_mirror_the_records_in_order():
    transport = FakeTransport(3)
    publisher = StepBridge(None, transport.endpoint(0))
    followers = [StepBridge(_Recorder(), transport.endpoint(i))
                 for i in (1, 2)]
    counts = [None, None]
    threads = [threading.Thread(target=lambda i=i: counts.__setitem__(
        i, followers[i].worker_loop())) for i in range(2)]
    for t in threads:
        t.start()
    sent = [{"op": "step", "payload": {"tokens": np.arange(i + 1)}}
            for i in range(5)] + [{"op": "guided", "mask": np.ones(3)}]
    for record in sent:
        publisher.publish(record)
    publisher.shutdown()
    for t in threads:
        t.join(10)
    assert counts == [6, 6]
    for f in followers:
        got = f.runner.records
        assert [r["op"] for r in got] == [r["op"] for r in sent]
        for r, s in zip(got[:5], sent[:5]):
            np.testing.assert_array_equal(r["payload"]["tokens"],
                                          s["payload"]["tokens"])
    assert publisher.published == 6


def test_bridge_rejects_a_header_that_drifts_from_its_template():
    """A message that is not (kind, seq, record) stops the follower:
    a bare int32 header array is one."""
    transport = FakeTransport(2)
    transport.endpoint(0).broadcast(np.zeros((3,), np.int32))
    with pytest.raises(ValueError, match="does not match"):
        StepBridge(_Recorder(), transport.endpoint(1)).worker_loop()


@pytest.mark.parametrize("message", [(1, 0), (7, 0, {}), None])
def test_bridge_rejects_a_message_of_another_form(message):
    transport = FakeTransport(2)
    transport.endpoint(0).broadcast(message)
    with pytest.raises(ValueError, match="does not match"):
        StepBridge(_Recorder(), transport.endpoint(1)).worker_loop()


def test_bridge_rejects_a_record_out_of_order():
    transport = FakeTransport(2)
    out = transport.endpoint(0)
    out.broadcast((1, 5, {"op": "step"}))
    with pytest.raises(RuntimeError, match="expected record 0"):
        StepBridge(_Recorder(), transport.endpoint(1)).worker_loop()


def test_an_ahead_step_feeds_only_on_the_step_before_it():
    """Rank 0 refuses to publish an ahead step whose tokens are not the
    last dispatch's: the other ranks could not find them."""
    tp = FakeTP(_engine_config(config, config.tiny_model_config("llama"),
                               TP))
    try:
        runner = tp.engine.runner
        with pytest.raises(RuntimeError, match="feeds only on the step"):
            runner.dispatch_decode([None] * 4, token_source=torch.zeros(
                4, dtype=torch.int32), ahead=True)
    finally:
        tp.close()


# ---- refusals ------------------------------------------------------------------


def test_heads_must_divide_by_tp():
    cfg = config.tiny_model_config("llama")  # 4 q heads, 2 kv heads
    with pytest.raises(ValueError, match="must divide both"):
        mesh.rank_model_config(cfg, 4)
    with pytest.raises(ValueError, match="must divide both"):
        ModelRunner(_engine_config(config, cfg), device="cpu",
                    tp=FakeTPGroup.world(4)[0])


def test_a_gloo_group_refuses_the_step_graphs(monkeypatch):
    """On the card a gloo group runs eager only: a runner asked for
    graphs over one refuses at construction (never a silent eager
    step), and a gloo collective under capture raises."""
    group = TPGroup(0, 2, "gloo")
    assert not group.capturable and TPGroup(0, 2, "nccl").capturable
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="cannot run inside the step"):
        ModelRunner(_engine_config(config, config.tiny_model_config("llama")),
                    device="cuda", cuda_graphs=True, tp=group)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    t = torch.zeros(2)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(RuntimeError, match="cannot be captured"):
        group.all_reduce(t)


# ---- (e) a real two-process server ----------------------------------------------


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=20) as resp:
        return json.loads(resp.read())


def test_two_process_server_matches_jax_and_tp1(tmp_path):
    """``--tensor-parallel-size 2 --device cpu`` over a llama checkpoint:
    the server spawns rank 1 itself (gloo), serves, reports the mesh on
    /metrics, and its greedy completions are byte-identical to the JAX
    engine's at tp 2 and to the port's tp-1 engine; the worker is gone
    after the server stops. Every wait is bounded: the test gives up
    after 110 s in all."""
    path, _ = parity._save_tiny_llama(tmp_path)
    jcfg = jax_weights.load_model_config(path)
    jcfg.dtype = "float32"
    jax_params = jax_weights.load_weights(path, jcfg)
    jengine = JaxEngine(_engine_config(jax_config, jcfg, TP),
                        mesh=_jax_mesh(), params=jax_mesh.shard_params(
                            jax_params, jcfg, _jax_mesh()))
    theirs = _run_streams(
        jengine, [JaxSamplingParams(max_tokens=12, temperature=0.0,
                                    ignore_eos=True) for _ in PROMPTS],
        done=type(jengine.sequences[jengine.add_request(
            [1], JaxSamplingParams(max_tokens=1))].state).FINISHED)
    port = int(os.environ.get("PSTT_TEST_PORT_BASE", "0")) or _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", path, "--tokenizer", "bench", "--device", "cpu",
         "--dtype", "float32", "--tensor-parallel-size", "2",
         "--page-size", "8", "--num-pages", "160", "--max-num-seqs", "4",
         "--max-model-len", "256", "--prefill-chunk-size", "16",
         "--host", "127.0.0.1", "--port", str(port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 110
    try:
        while True:
            try:
                with urllib.request.urlopen(base + "/health", timeout=2):
                    break
            except OSError:
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError(proc.stdout.read().decode()[-3000:])
                time.sleep(0.3)
        texts = [_post(base + "/v1/completions", {
            "prompt": p, "max_tokens": 12, "temperature": 0,
            "ignore_eos": True})["choices"][0]["text"] for p in PROMPTS]
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            metrics = r.read().decode()
    finally:
        proc.terminate()
        out = proc.communicate(
            timeout=max(5.0, deadline - time.monotonic()))[0].decode()
    tok = get_tokenizer("bench")
    assert texts == [tok.decode(ids) for ids in theirs], out[-3000:]
    _, pcfg = _configs("llama")
    from production_stack_tpu_torch.engine import weights as port_weights
    pcfg = port_weights.load_model_config(path)
    pcfg.dtype = "float32"
    single = _run_streams(LLMEngine(
        _engine_config(config, pcfg), params=port_weights.load_weights(
            path, pcfg, device="cpu"), device="cpu"), GREEDY)
    assert single == theirs
    assert 'vllm:engine_mesh_shape{axis="tp"} 2.0' in metrics
    assert "tp rank 1 shutting down" in out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---- pages across the ranks: the offload tier, disaggregation, checkpoints ---


@pytest.mark.parametrize("kv", ["auto", "int8"])
@pytest.mark.parametrize("layout", ["per_layer", "stacked"])
def test_a_page_is_read_whole_and_written_cut(kv, layout):
    """``write_page`` publishes the full page and every rank writes its
    kv heads of it; ``read_page`` gathers the ranks' heads back: the
    page bitwise, in the cache's type (the JAX tp engine's page)."""
    model = config.tiny_model_config("llama")
    m = model
    tp = FakeTP(_engine_config(config, model, TP, kv=kv, layout=layout))
    try:
        gen = torch.Generator().manual_seed(5)
        shape = (m.num_hidden_layers, m.num_key_value_heads, m.head_dim, 8)
        if kv == "int8":
            page = (torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8),
                    torch.randint(-127, 128, shape, generator=gen,
                                  dtype=torch.int8),
                    torch.rand(shape[:-2] + (8,), generator=gen),
                    torch.rand(shape[:-2] + (8,), generator=gen))
        else:
            page = tuple(torch.randn(shape, generator=gen) for _ in range(2))
        tp.engine.runner.write_page(7, *page)
        got = tp.engine.runner.read_page(7)
        assert all(torch.equal(a, b) and a.dtype == b.dtype
                   for a, b in zip(got, page))
        for rank, runner in ((0, tp.engine.runner), (1, tp.worker_runner)):
            mine = runner._page_planes()
            for (plane, stacked), full in zip(mine, page):
                local = (plane[:, :, 7] if stacked else
                         torch.stack([c[:, 7] for c in plane]))
                assert torch.equal(local, mesh.cut(full, 1, rank, TP))
    finally:
        tp.close()


@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_an_evicted_prefix_restores_under_tp(kv):
    """The host tier under tp: a cached prefix evicted to the host pool
    (every rank's heads gathered into one page) and restored (each rank
    its heads) gives the recompute's stream."""
    model = config.tiny_model_config("llama")
    shared = list(range(1, 65))
    sp = SamplingParams(max_tokens=4, temperature=0.0, ignore_eos=True)

    def cfg(tp, offload, pages):
        c = config.EngineConfig(
            model=model, cache=config.CacheConfig(
                page_size=16, num_pages=pages, kv_cache_dtype=kv),
            scheduler=config.SchedulerConfig(
                max_num_seqs=2, max_model_len=256, prefill_chunk_size=64),
            offload=config.OffloadConfig(enable=offload,
                                         host_pool_bytes=256 * 1024 ** 2),
            parallel=config.ParallelConfig(tensor_parallel_size=tp))
        return c

    expected = LLMEngine(cfg(1, False, 64), device="cpu").generate(
        shared + [99, 98], sp).output_token_ids
    tp = FakeTP(cfg(TP, True, 5 if kv == "int8" else 16))
    try:
        engine = tp.engine
        assert engine.generate(shared + [99, 98], sp).output_token_ids == (
            expected)
        for i in range(4):
            engine.generate([200 + i] * 80, sp)
        assert engine.offload.offloaded_pages > 0
        before = engine.offload.restored_pages
        again = engine.generate(shared + [99, 98], sp)
        assert engine.offload.restored_pages > before
        assert again.output_token_ids == expected
    finally:
        tp.close()


def test_disaggregated_hops_and_checkpoints_under_tp():
    """A tp-2 prefill-role engine hands off to a tp-1 decode-role one
    and a tp-1 prefill engine to a tp-2 decode engine, over the shared
    tier: both give the monolithic stream. A tp-2 engine with stream
    checkpoints ships its pages as it decodes, its stream unchanged."""
    from production_stack_tpu_torch.engine.tokenizer import BenchTokenizer
    from tests import test_torch_crash_recovery as recovery
    from tests import test_torch_disaggregation as disagg
    url, cache = recovery.serve_cache()
    model = config.tiny_model_config("llama")

    def cfg(tp, role="both", checkpoint=0):
        c = recovery.engine_config(url, checkpoint=checkpoint,
                                   engine_role=role)
        c.parallel = config.ParallelConfig(tensor_parallel_size=tp)
        return c

    tok = BenchTokenizer(model.vocab_size)
    try:
        ref = LLMEngine(cfg(1), device="cpu", tokenizer=tok).generate(
            list(disagg.PROMPT), disagg._sampling()).output_token_ids
        for pre_tp, dec_tp in ((TP, 1), (1, TP)):
            made = []

            def engine(tp, role):
                if tp == 1:
                    return LLMEngine(cfg(1, role), device="cpu",
                                     tokenizer=tok)
                made.append(FakeTP(cfg(tp, role), tokenizer=tok))
                return made[-1].engine
            try:
                first, info = disagg._prefill(engine(pre_tp, "prefill"),
                                              disagg.PROMPT)
                assert info["num_pages"] == 3
                dec = engine(dec_tp, "decode")
                assert disagg._decode(dec, disagg.PROMPT, first) == ref
                assert dec.offload.restored_pages == 3
            finally:
                for t in made:
                    t.close()
        tp = FakeTP(cfg(TP, checkpoint=4), tokenizer=tok)
        try:
            got = tp.engine.generate(list(disagg.PROMPT), disagg._sampling())
            assert got.output_token_ids == ref
            assert tp.engine.checkpoint_ships > 0
            assert tp.engine.checkpoint_kv_bytes > 0
        finally:
            tp.close()
    finally:
        cache.shutdown()
