"""Pipeline parallelism in the port against the JAX package's, on the CPU.

JAX runs on the fake CPU devices of tests/conftest.py: its dense
``pipeline_forward``, its serving ``pp_paged_forward`` and its engine on
``build_mesh(pipeline_parallel_size=S[, tensor_parallel_size=2])``. The
port runs the same weights (JAX's init carried across) over fake ranks
of a tp x pp world, one thread each (``parallel/collectives.fake_mesh``;
an engine's rank 0 is its ``LLMEngine``, the others runners replaying
the step bridge over ``FakeTransport``), and as a real two-process
server over gloo (``--pipeline-parallel-size 2 --device cpu``).

Held here: the dense forward (f32 within 1e-5), the serving forward on
the same pages (logits within 1e-5, each stage's cache JAX's layers at
1e-5) for llama, qwen2's biases and gpt2, at pp 2 and pp x tp 2; greedy
engine streams byte-identical to the JAX engine's at pp 2 and 4, pp x
tp 2, int8 weights (and with tp), GPT-2, LoRA (and with tp) and a batch
that pads to a stage multiple, and the port's other step kinds (async
unified, speculative verify, bursts, int8 KV) equal to its pp 1 engine;
the stacked layout and the stage's layers; the pooled routes' staged
forward; a page read off a pp-2 engine bitwise the pp-1 engine's, and a
resume and disaggregated handoffs between pp-2 and pp-1 engines; the
refusals, with JAX's messages.
"""

import dataclasses
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
from jax.sharding import Mesh

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine import quantization as jax_quant
from production_stack_tpu.engine import weights as jax_weights
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.lora import LoRAAdapter as JaxLoRAAdapter
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu.models import registry as jax_registry
from production_stack_tpu.parallel import mesh as jax_mesh
from production_stack_tpu.parallel.pipeline import (
    pipeline_forward as jax_pipeline_forward,
)
from production_stack_tpu.parallel.pipeline import shard_params_pipeline
from production_stack_tpu.parallel.pipeline_serving import (
    pp_paged_forward as jax_pp_paged_forward,
)
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.lora import LoRAAdapter, target_shapes
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch.models.convert import (
    params_from_numpy,
    stage_params_from_numpy,
)
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.parallel import mesh
from production_stack_tpu_torch.parallel.collectives import (
    MeshGroups,
    fake_mesh,
    run_ranks,
)
from production_stack_tpu_torch.parallel.distributed import (
    FakeTransport,
    StepBridge,
    TensorParallelRuntime,
)
from production_stack_tpu_torch.parallel.pipeline import pipeline_forward
from production_stack_tpu_torch.parallel.pipeline_serving import (
    pp_paged_forward,
)
from tests import test_model_parity as parity
from tests import test_torch_model_families as fam

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


# ---- a parallel engine in one process ---------------------------------------


class FakeMesh:
    """A tp x sp x pp port engine in one process: rank 0's LLMEngine on
    this thread, every other rank's runner replaying the step bridge on
    its own thread (the fake groups of ``fake_mesh``). ``params()``
    gives each rank its weights (None: random from the config's seed)."""

    def __init__(self, cfg, params=None, tokenizer=None):
        par = cfg.parallel
        tp, pp, sp = (par.tensor_parallel_size, par.pipeline_parallel_size,
                      par.context_parallel_size)
        n = tp * pp * sp
        groups = fake_mesh(tp=tp, pp=pp, sp=sp, timeout_s=60.0)
        transport = FakeTransport(n)
        self.errors = []
        self.runners = [None] * n
        started = threading.Barrier(n, timeout=120)

        def build(rank):
            g = groups[rank]
            return dict(params=None if params is None else params(),
                        device="cpu", tp=g.tp, pp=g.pp, sp=g.sp)

        def worker(rank):
            try:
                runner = self.runners[rank] = ModelRunner(
                    _copy(cfg), **build(rank))
                started.wait()
                StepBridge(runner, transport.endpoint(rank)).worker_loop()
            except BaseException as exc:  # surfaced by close()
                self.errors.append(exc)
                started.abort()
                groups[rank].abort()

        self.threads = [threading.Thread(target=worker, args=(r,),
                                         daemon=True) for r in range(1, n)]
        for t in self.threads:
            t.start()
        self.engine = LLMEngine(_copy(cfg), tokenizer=tokenizer,
                                bridge=StepBridge(None, transport.endpoint(0)),
                                **build(0))
        self.runners[0] = self.engine.runner
        started.wait()

    def close(self):
        self.engine.runner.bridge.shutdown()
        for t in self.threads:
            t.join(60)
        if self.errors:
            raise self.errors[0]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _copy(cfg):
    """A config of its own for each rank (the runner resolves the cache
    layout in place)."""
    return dataclasses.replace(cfg, cache=dataclasses.replace(cfg.cache),
                               scheduler=dataclasses.replace(cfg.scheduler),
                               model=dataclasses.replace(cfg.model))


def run_streams(engine, prompts, sampling, names=None):
    """Every prompt's greedy output ids, one engine, continuous
    batching."""
    seqs = [engine.sequences[engine.add_request(
        list(p), sampling(), **({} if names is None else
                                {"lora_name": names[i]}))]
        for i, p in enumerate(prompts)]
    for _ in range(1000):
        if not engine.has_work() and getattr(engine, "_in_flight",
                                             None) is None:
            break
        engine.step()
    assert all(s.state == type(s.state).FINISHED for s in seqs)
    return [list(s.output_token_ids) for s in seqs]


def _jax_sampling(max_tokens=8):
    return lambda: JaxSamplingParams(max_tokens=max_tokens, temperature=0.0,
                                     ignore_eos=True)


def _port_sampling(max_tokens=8):
    return lambda: SamplingParams(max_tokens=max_tokens, temperature=0.0,
                                  ignore_eos=True)


# ---- (a) the dense forward --------------------------------------------------


def _dense_configs(layers=4, bias=False):
    kw = dict(name="pp-test", architecture="llama", vocab_size=128,
              hidden_size=64, intermediate_size=96,
              num_hidden_layers=layers, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64,
              dtype="float32", attention_bias=bias)
    return jax_config.ModelConfig(**kw), config.ModelConfig(**kw)


def _dense_params(jcfg, seed, bias=False):
    params = {k: np.asarray(v) for k, v in jax_llama.init_params(
        jcfg, jax.random.PRNGKey(seed)).items()}
    if bias:
        params["bq"] = (0.1 * np.random.RandomState(2).randn(
            *params["bq"].shape)).astype(np.float32)
    return params


def _pp_dense(np_params, cfg, tokens, pp, microbatches):
    def rank(g):
        lo_hi = mesh.stage_layers(cfg.num_hidden_layers, g.pp.rank, pp)
        params = stage_params_from_numpy(np_params, cfg, lo_hi, "cpu")
        return pipeline_forward(params, cfg, torch.from_numpy(tokens), g.pp,
                                num_microbatches=microbatches)
    return run_ranks(fake_mesh(pp=pp), rank)


@pytest.mark.parametrize("pp,layers,microbatches", [
    (2, 4, 2), (4, 4, 4), (2, 4, 4)])
def test_pipeline_forward_matches_jax(pp, layers, microbatches):
    """The dense pipeline over fake pp stages (each holding its stage's
    layers, from ``stage_params_from_numpy``) against JAX's on its pp
    mesh: every stage's logits f32 within 1e-5."""
    jcfg, cfg = _dense_configs(layers)
    np_params = _dense_params(jcfg, 0)
    tokens = np.random.RandomState(0).randint(
        0, 128, (microbatches * 2, 16)).astype(np.int32)
    jmesh = Mesh(np.asarray(jax.devices()[:pp]), ("pp",))
    jparams = {k: jnp.asarray(v) for k, v in np_params.items()}
    want = jax_pipeline_forward(shard_params_pipeline(jparams, jcfg, jmesh),
                                jcfg, jnp.asarray(tokens), jmesh,
                                num_microbatches=microbatches)
    outs = _pp_dense(np_params, cfg, tokens, pp, microbatches)
    for out in outs:
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_pipeline_forward_with_attention_bias():
    jcfg, cfg = _dense_configs(4, bias=True)
    np_params = _dense_params(jcfg, 1, bias=True)
    tokens = np.random.RandomState(1).randint(0, 128, (4, 8)).astype(
        np.int32)
    jmesh = Mesh(np.asarray(jax.devices()[:2]), ("pp",))
    want = jax_pipeline_forward(
        shard_params_pipeline({k: jnp.asarray(v) for k, v in
                               np_params.items()}, jcfg, jmesh),
        jcfg, jnp.asarray(tokens), jmesh, num_microbatches=2)
    out = _pp_dense(np_params, cfg, tokens, 2, 2)[1]
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pp,layers,batch,microbatches,match", [
    (3, 4, 6, 3, "layers 4 must divide by pp size 3"),
    (2, 4, 5, 2, "batch 5 must divide by microbatches 2"),
    (2, 4, 6, 3, "microbatches 3 must divide by pp size 2")])
def test_pipeline_forward_refuses_bad_shapes(pp, layers, batch,
                                             microbatches, match):
    """JAX's three refusals, with its messages."""
    jcfg, cfg = _dense_configs(layers)
    params = params_from_numpy(_dense_params(jcfg, 0), cfg, "cpu")
    with pytest.raises(ValueError, match=match):
        run_ranks(fake_mesh(pp=pp), lambda g: pipeline_forward(
            params, cfg, torch.zeros((batch, 8), dtype=torch.long), g.pp,
            num_microbatches=microbatches))


# ---- (b) the serving forward on pages ---------------------------------------


def _fam_configs(arch):
    if arch == "qwen2":
        jc, pc = fam._configs("llama")
        return tuple(dataclasses.replace(c, architecture="qwen2",
                                         attention_bias=True)
                     for c in (jc, pc))
    return fam._configs(arch)


@pytest.mark.parametrize("pp,tp", [(2, 1), (2, 2)])
@pytest.mark.parametrize("arch", ["llama", "qwen2", "gpt2"])
def test_pp_paged_forward_matches_jax(arch, pp, tp):
    """A prefill chunk, a decode step and a mixed block with a pad row
    (fam._steps: 2, 2 and 3 rows, the last padded to a stage multiple)
    through the port's staged forward over fake pp x tp ranks and JAX's
    on its mesh: logits within 1e-5 on every rank, every rank's stacked
    cache its stage's layers and heads of JAX's."""
    jcfg, cfg = _fam_configs(arch)
    np_params = fam._params(arch if arch != "qwen2" else "llama", jcfg)
    if arch == "qwen2":
        rng = np.random.RandomState(9)
        for b in ("bq", "bk", "bv"):
            layers, width = np_params["wq" if b == "bq" else "wk"].shape[
                ::2]
            np_params[b] = (0.05 * rng.randn(layers, width)).astype(
                np.float32)
    jmesh = jax_mesh.build_mesh(pipeline_parallel_size=pp,
                                tensor_parallel_size=tp)
    jparams = jax_mesh.shard_params(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jcfg, jmesh)
    layers, kv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim)
    shape = (layers, kv, fam.NUM_PAGES, d, fam.PAGE_SIZE)
    jk = jax_mesh.shard_cache(jnp.zeros(shape, jnp.float32), jmesh)
    jv = jax_mesh.shard_cache(jnp.zeros(shape, jnp.float32), jmesh)
    fwd = jax.jit(lambda p, *a: jax_pp_paged_forward(p, jcfg, *a,
                                                     mesh=jmesh))
    groups = fake_mesh(tp=tp, pp=pp)
    ranks = []
    for g in groups:
        stage = 0 if g.pp is None else g.pp.rank
        lo_hi = mesh.stage_layers(layers, stage, pp)
        params = stage_params_from_numpy(np_params, cfg, lo_hi, "cpu")
        if tp > 1:
            mesh.shard_params(params, dataclasses.replace(
                cfg, num_hidden_layers=lo_hi[1] - lo_hi[0]), g.tp.rank, tp)
        rank_shape = ((lo_hi[1] - lo_hi[0], kv // tp) + shape[2:])
        ranks.append(dict(params=params, lo_hi=lo_hi,
                          cfg=mesh.stage_model_config(cfg, tp, stage, pp),
                          k=torch.zeros(rank_shape),
                          v=torch.zeros(rank_shape)))
    for name, step in fam._steps().items():
        want, jk, jv = fwd(jparams, *(jnp.asarray(x) for x in step), jk, jv)

        def rank(g, step=step, name=name):
            r = ranks[groups.index(g)]
            return pp_paged_forward(
                r["params"], r["cfg"], *(torch.from_numpy(x) for x in step),
                r["k"], r["v"], kind=fam.KINDS[name], pp=g.pp, tp=g.tp)
        outs = run_ranks(groups, rank)
        valid = step[4]
        for out in outs:
            np.testing.assert_allclose(out.numpy()[valid],
                                       np.asarray(want)[valid], **TOL,
                                       err_msg=f"{arch} {name}")
    for g, r in zip(groups, ranks):
        lo, hi = r["lo_hi"]
        t = 0 if g.tp is None else g.tp.rank
        heads = slice(t * kv // tp, (t + 1) * kv // tp)
        for port_c, jax_c in ((r["k"], jk), (r["v"], jv)):
            np.testing.assert_allclose(
                port_c.numpy()[:, :, 1:],
                np.asarray(jax_c)[lo:hi, heads, 1:], **TOL)


# ---- (c) engines ------------------------------------------------------------


PROMPTS = [list(range(2, 2 + n)) for n in (18, 7, 33)]


def _engine_config(module, arch="llama", pp=1, tp=1, quant="none",
                   lora=False, layers=4, **sched):
    model = module.tiny_model_config(arch)
    model.num_hidden_layers = layers
    model.quantization = quant
    extra = {}
    if lora:
        extra["lora"] = module.LoRAConfig(enable=True, max_loras=2,
                                          max_lora_rank=4)
    return module.EngineConfig(
        model=model, cache=module.CacheConfig(page_size=16, num_pages=64),
        scheduler=module.SchedulerConfig(
            max_num_seqs=4, max_model_len=128, prefill_chunk_size=32,
            prefill_batch_size=2, **sched),
        parallel=module.ParallelConfig(pipeline_parallel_size=pp,
                                       tensor_parallel_size=tp),
        **extra)


def _weights(arch="llama", quant="none", layers=4, seed=5):
    jcfg = jax_config.tiny_model_config(arch)
    jcfg.num_hidden_layers = layers
    init, _ = jax_registry.get_model(jcfg)
    params = {k: np.asarray(v) for k, v in
              init(jcfg, jax.random.PRNGKey(seed)).items()}
    if quant == "int8":
        q = jax_quant.quantize_params(
            {k: jnp.asarray(v) for k, v in params.items()}, jcfg)
        params = {k: (tuple(np.asarray(x) for x in v)
                      if isinstance(v, tuple) else np.asarray(v))
                  for k, v in q.items()}
    return params


def _jax_params(np_params):
    return {k: (tuple(jnp.asarray(x) for x in v) if isinstance(v, tuple)
                else jnp.asarray(v)) for k, v in np_params.items()}


def _adapter_pairs(model, seed=11):
    rs = np.random.RandomState(seed)
    return {tgt: ((rs.randn(model.num_hidden_layers, d_in, 4) * 0.05
                   ).astype(np.float32),
                  (rs.randn(model.num_hidden_layers, 4, d_out) * 0.05
                   ).astype(np.float32))
            for tgt, (d_in, d_out) in target_shapes(model).items()}


def _jax_streams(arch, pp, tp, quant, lora, np_params, prompts, names,
                 max_tokens=8):
    jcfg = _engine_config(jax_config, arch, pp, tp, quant, lora)
    jmesh = (jax_mesh.build_mesh(pipeline_parallel_size=pp,
                                 tensor_parallel_size=tp)
             if pp * tp > 1 else None)
    params = _jax_params(np_params)
    engine = JaxEngine(jcfg, mesh=jmesh, params=(
        jax_mesh.shard_params(params, jcfg.model, jmesh) if jmesh else
        params))
    if lora:
        engine.runner.lora_registry.register(JaxLoRAAdapter(
            name="adapter-x", rank=4, scaling=0.5,
            weights=_adapter_pairs(jcfg.model)))
    return run_streams(engine, prompts, _jax_sampling(max_tokens), names)


def _port_streams(arch, pp, tp, quant, lora, np_params, prompts, names,
                  max_tokens=8, **sched):
    cfg = _engine_config(config, arch, pp, tp, quant, lora, **sched)

    def register(engine):
        if lora:
            engine.runner.register_lora(LoRAAdapter(
                name="adapter-x", rank=4, scaling=0.5,
                weights=_adapter_pairs(cfg.model)))

    def params():
        return params_from_numpy(np_params, cfg.model, "cpu")
    if pp * tp == 1:
        engine = LLMEngine(cfg, params=params(), device="cpu")
        register(engine)
        return run_streams(engine, prompts, _port_sampling(max_tokens),
                           names), engine
    with FakeMesh(cfg, params) as fm:
        register(fm.engine)
        out = run_streams(fm.engine, prompts, _port_sampling(max_tokens),
                          names)
    return out, fm


ENGINES = {
    "pp2": dict(pp=2),
    "pp4": dict(pp=4),
    "pp2_tp2": dict(pp=2, tp=2),
    "pp2_int8_weights": dict(pp=2, quant="int8"),
    "pp2_tp2_int8_weights": dict(pp=2, tp=2, quant="int8"),
    "gpt2_pp2": dict(pp=2, arch="gpt2"),
    "pp4_pads_a_batch": dict(pp=4, prompts=[list(range(3, 3 + n))
                                           for n in (11, 21, 5)],
                             max_tokens=6),
    "pp2_lora": dict(pp=2, lora=True),
    "pp2_tp2_lora": dict(pp=2, tp=2, lora=True),
}


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_pp_engine_streams_match_jax(case):
    """Greedy streams of the port's pp engine (fake ranks, the step
    bridge between them) byte-identical to the JAX engine's on its
    (pp, tp) mesh, the same weights; the mirror of
    tests/test_pipeline_parallel.py's engine cases. LoRA: row 1 through
    an adapter installed into the running engine (every stage installs
    its layers of it), the others base rows."""
    kw = dict(ENGINES[case])
    arch, pp, tp = kw.pop("arch", "llama"), kw.pop("pp"), kw.pop("tp", 1)
    quant, lora = kw.pop("quant", "none"), kw.pop("lora", False)
    prompts = kw.pop("prompts", PROMPTS)
    max_tokens = kw.pop("max_tokens", 8)
    names = ([None, "adapter-x", None][:len(prompts)] if lora else None)
    np_params = _weights(arch, quant)
    want = _jax_streams(arch, pp, tp, quant, lora, np_params, prompts,
                        names, max_tokens)
    got, fm = _port_streams(arch, pp, tp, quant, lora, np_params, prompts,
                            names, max_tokens)
    assert got == want
    for runner in fm.runners:
        assert runner.cache_layout == "stacked"
        assert len(runner.params.layers) == 4 // pp
        assert runner.k_cache.shape[0] == 4 // pp


VARIANTS = {
    "async_unified": dict(async_scheduling=True, unified_step=True),
    "spec_unified": dict(speculative_k=3, unified_step=True),
    "burst": dict(decode_steps=4),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["int8_kv"])
def test_pp2_step_kinds_equal_pp1(variant):
    """The async pipeline's ahead steps, unified and verify blocks,
    bursts and int8 KV ride the staged body: greedy streams at pp 2
    equal the port's pp 1 engine's (and a repeating prompt drafts)."""
    np_params = _weights()
    sched = VARIANTS.get(variant, {})
    prompts = PROMPTS + [[5, 6, 7, 8] * 6]

    def cfg(pp):
        c = _engine_config(config, pp=pp, **sched)
        if variant == "int8_kv":
            c.cache.kv_cache_dtype = "int8"
        return c

    single = run_streams(LLMEngine(cfg(1), params=params_from_numpy(
        np_params, cfg(1).model, "cpu"), device="cpu"), prompts,
        _port_sampling(12))
    with FakeMesh(cfg(2), lambda: params_from_numpy(
            np_params, cfg(2).model, "cpu")) as fm:
        got = run_streams(fm.engine, prompts, _port_sampling(12))
        m = fm.engine.metrics
    assert got == single
    if variant == "spec_unified":
        assert m.spec_draft_tokens_total > 0
    if variant == "async_unified":
        assert m.ragged_steps_total > 0


def test_pp_stage_hops_and_kernels_a_step():
    """A pp-2 decode step: M + S - 2 = 2 hops and one masked sum on each
    rank; each stage runs its own layers' attention (2 of 4)."""
    np_params = _weights()
    cfg = _engine_config(config, pp=2)
    with FakeMesh(cfg, lambda: params_from_numpy(np_params, cfg.model,
                                                 "cpu")) as fm:
        run_streams(fm.engine, PROMPTS[:1], _port_sampling(2))
        COUNTERS.reset()
        fm.engine.add_request([3, 4, 5], SamplingParams(
            max_tokens=2, temperature=0.0, ignore_eos=True))
        fm.engine.step()  # the prefill
        # A page read is a record both ranks run: once rank 0 is past
        # its gather, rank 1 has counted everything before it.
        fm.engine.runner.read_page(0)
        COUNTERS.reset()
        fm.engine.step()  # one decode step
        fm.engine.runner.read_page(0)
        counts = {k: v for k, v in COUNTERS.launches.items()
                  if k in ("pp_hop", "pp_sum")}
    # Both ranks (threads) count into one table.
    assert counts == {"pp_hop": 2 * 2, "pp_sum": 2}


def test_pooled_forward_is_staged():
    """The pooled routes' dense forward at pp 2 (stage by stage, the
    last stage's hidden states summed back) equals pp 1's."""
    np_params = _weights()
    cfg1, cfg2 = (_engine_config(config, pp=p) for p in (1, 2))
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        1, 500, (3, 16)))
    want = LLMEngine(cfg1, params=params_from_numpy(
        np_params, cfg1.model, "cpu"), device="cpu").runner.encode(tokens)
    with FakeMesh(cfg2, lambda: params_from_numpy(np_params, cfg2.model,
                                                  "cpu")) as fm:
        got = fm.engine.runner.encode(tokens)
    assert torch.equal(got, want)


def test_a_stage_is_made_alone_with_the_full_models_draws():
    """Random weights at pp 2: each stage draws every leaf (so its
    layers are the full model's) and keeps its layers only; the int8
    init the same."""
    for quant in ("none", "int8"):
        cfg = _engine_config(config, quant=quant)
        full = ModelRunner(_copy(cfg), device="cpu").params
        for stage, groups in enumerate(fake_mesh(pp=2)):
            c = _copy(_engine_config(config, pp=2, quant=quant))
            runner = ModelRunner(c, device="cpu", pp=groups.pp)
            assert len(runner.params.layers) == 2
            mine = dict(runner.params.named_parameters())
            mine.update(runner.params.named_buffers())
            want = dict(full.named_parameters())
            want.update(full.named_buffers())
            for name, value in mine.items():
                if name.startswith("layers."):
                    i, rest = name.split(".", 2)[1:]
                    name = f"layers.{int(i) + 2 * stage}.{rest}"
                assert torch.equal(value, want[name]), (quant, name)


# ---- pages across the stages: the offload tier, resume, disaggregation ------


def test_a_page_read_off_a_pp2_engine_is_the_pp1_engines():
    """The same prompt prefilled at pp 1 and pp 2: every page read off
    the pp-2 engine (stages' layers joined, layer order) bitwise the
    pp-1 engine's; a page written at pp 2 is cut by layer and read back
    whole."""
    np_params = _weights()
    prompt = list(range(5, 45))
    cfg1, cfg2 = (_engine_config(config, pp=p) for p in (1, 2))
    cfg1.cache.cache_layout = "stacked"
    one = LLMEngine(cfg1, params=params_from_numpy(np_params, cfg1.model,
                                                   "cpu"), device="cpu")

    def prefilled(engine):
        # The prompt's two chunks; its pages are read while it runs.
        seq = engine.sequences[engine.add_request(
            prompt, _port_sampling(4)())]
        engine.step()
        engine.step()
        assert seq.num_generated == 1
        return seq

    seq1 = prefilled(one)
    want = [one.runner.read_page(p) for p in seq1.pages[:3]]
    with FakeMesh(cfg2, lambda: params_from_numpy(np_params, cfg2.model,
                                                  "cpu")) as fm:
        seq2 = prefilled(fm.engine)
        got = [fm.engine.runner.read_page(p) for p in seq2.pages[:3]]
        page = tuple(torch.randn(w.shape) for w in want[0])
        fm.engine.runner.write_page(9, *page)
        back = fm.engine.runner.read_page(9)
        local = fm.runners[1].k_cache[:, :, 9]
    assert seq1.output_token_ids == seq2.output_token_ids
    for a, b in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(back, page))
    assert torch.equal(local, page[0][2:4])


def test_resume_and_handoffs_between_pp2_and_pp1():
    """Over the shared tier: a stream checkpointed on a pp-2 server
    resumes on a pp-1 server and the other way round, the text
    byte-identical; a pp-2 prefill-role engine hands off to a pp-1
    decode-role one and back, each the monolithic stream."""
    from production_stack_tpu_torch.engine.tokenizer import BenchTokenizer
    from tests import test_torch_crash_recovery as recovery
    from tests import test_torch_disaggregation as disagg
    url, cache = recovery.serve_cache()
    # The recovery tests' weights: their stream carries checkpoints.
    np_params = _weights(layers=2, seed=11)
    tok = BenchTokenizer(512)

    def cfg(pp, role="both", checkpoint=4):
        c = recovery.engine_config(url, checkpoint=checkpoint,
                                   engine_role=role)
        c.parallel = config.ParallelConfig(pipeline_parallel_size=pp)
        return c

    made = []

    def engine(pp, role="both", checkpoint=4):
        c = cfg(pp, role, checkpoint)
        if pp == 1:
            return LLMEngine(c, params=params_from_numpy(
                np_params, c.model, "cpu"), tokenizer=tok, device="cpu")
        made.append(FakeMesh(c, lambda: params_from_numpy(
            np_params, c.model, "cpu"), tokenizer=tok))
        return made[-1].engine

    try:
        ref = LLMEngine(cfg(1, checkpoint=0), params=params_from_numpy(
            np_params, cfg(1).model, "cpu"), tokenizer=tok,
            device="cpu").generate(list(disagg.PROMPT),
                                   disagg._sampling()).output_token_ids
        for a_pp, b_pp in ((2, 1), (1, 2)):
            with recovery.PortServer(engine(a_pp)) as a:
                full, rid, desc, delivered = recovery.capture_interrupted(
                    a.url)
            with recovery.PortServer(engine(b_pp)) as b:
                status, datas = recovery.resume_tail(b.url, desc,
                                                     delivered)
                assert status == 200
                tail = "".join(recovery.delta_content(e) for e in datas)
                assert full[:delivered] + tail == full
                assert b.engine.offload.restored_pages > 0
            first, info = disagg._prefill(engine(a_pp, "prefill"),
                                          disagg.PROMPT)
            assert info["num_pages"] == 3
            dec = engine(b_pp, "decode")
            assert disagg._decode(dec, disagg.PROMPT, first) == ref
            assert dec.offload.restored_pages == 3
    finally:
        for fm in made:
            fm.close()
        cache.shutdown()


# ---- refusals ---------------------------------------------------------------


def _runner(module_cfg, groups=None):
    return ModelRunner(module_cfg, device="cpu",
                       **({} if groups is None else
                          dict(tp=groups.tp, pp=groups.pp, sp=groups.sp)))


@pytest.mark.parametrize("change,error,match", [
    (dict(arch="opt"), NotImplementedError,
     "pipeline parallelism serves llama/mistral/qwen2/gpt2"),
    (dict(layers=3), ValueError,
     "layers 3 must divide by pipeline_parallel_size 2"),
    (dict(tp=4), ValueError,
     "pp x tp needs attention/kv heads divisible by tensor_parallel_size"),
    (dict(layout="per_layer"), NotImplementedError,
     "cache_layout='per_layer' with pipeline/context parallelism"),
    (dict(deferred=True), NotImplementedError,
     "deferred_kv_writes with pipeline/context parallelism"),
    (dict(group=False), ValueError,
     "pipeline_parallel_size 2 needs the rank's pp group of that size")])
def test_pp_refusals(change, error, match):
    """JAX's refusals of a pp engine it cannot serve, with its messages
    (the mesh check becomes the missing group's)."""
    cfg = _engine_config(config, change.get("arch", "llama"), pp=2,
                         tp=change.get("tp", 1),
                         layers=change.get("layers", 4),
                         **(dict(decode_steps=4, deferred_kv_writes=True)
                            if change.get("deferred") else {}))
    cfg.cache.cache_layout = change.get("layout", "auto")
    with pytest.raises(error, match=match):
        _runner(cfg, None if change.get("group") is False
                else fake_mesh(pp=2, tp=change.get("tp", 1))[0])


def test_the_server_refuses_before_it_starts_a_rank():
    from production_stack_tpu_torch.engine.server import (
        build_engine_from_args,
        parse_args,
    )
    with pytest.raises(ValueError, match="must divide by "
                       "pipeline_parallel_size 3"):
        build_engine_from_args(parse_args([
            "--model", "tiny-llama", "--device", "cpu",
            "--pipeline-parallel-size", "3"]))


# ---- a real two-process server ----------------------------------------------


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=20) as resp:
        return json.loads(resp.read())


def serve_two_ranks(path, flags, prompts, deadline_s=110):
    """(completion texts, /metrics, output) of a two-process port server
    over ``path``'s checkpoint with ``flags`` (the server spawns rank 1
    itself, over gloo on the CPU); every wait bounded."""
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.engine.server",
         "--model", path, "--tokenizer", "bench", "--device", "cpu",
         "--dtype", "float32", "--page-size", "16", "--num-pages", "64",
         "--max-num-seqs", "4", "--max-model-len", "128",
         "--prefill-chunk-size", "32", "--prefill-batch-size", "2",
         "--host", "127.0.0.1", "--port", str(port)] + flags,
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    base = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + deadline_s
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
            "prompt": p, "max_tokens": 8, "temperature": 0,
            "ignore_eos": True})["choices"][0]["text"] for p in prompts]
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            metrics = r.read().decode()
    finally:
        proc.terminate()
        out = proc.communicate(
            timeout=max(5.0, deadline - time.monotonic()))[0].decode()
    return texts, metrics, out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def jax_checkpoint_streams(path, prompts, parallel):
    """The JAX engine's greedy streams over ``path``'s checkpoint on its
    mesh (``parallel``: the ParallelConfig keywords)."""
    jcfg = jax_weights.load_model_config(path)
    jcfg.dtype = "float32"
    params = jax_weights.load_weights(path, jcfg)
    cfg = jax_config.EngineConfig(
        model=jcfg, cache=jax_config.CacheConfig(page_size=16, num_pages=64),
        scheduler=jax_config.SchedulerConfig(
            max_num_seqs=4, max_model_len=128, prefill_chunk_size=32,
            prefill_batch_size=2),
        parallel=jax_config.ParallelConfig(**parallel))
    jmesh = jax_mesh.build_mesh(
        tensor_parallel_size=parallel.get("tensor_parallel_size", 1),
        pipeline_parallel_size=parallel.get("pipeline_parallel_size", 1),
        context_parallel_size=parallel.get("context_parallel_size", 1))
    engine = JaxEngine(cfg, mesh=jmesh,
                       params=jax_mesh.shard_params(params, jcfg, jmesh))
    return run_streams(engine, prompts, _jax_sampling())


class _Worker:
    """A worker process handle that stays alive until terminated."""

    def __init__(self):
        self.alive = True

    def join(self, timeout=None):
        pass

    def is_alive(self):
        return self.alive

    def terminate(self):
        self.alive = False

    kill = terminate


@pytest.mark.parametrize("stage,match", [
    ("bridge", "shutdown record did not finish"),
    ("process_group", "process group teardown .* did not finish"),
])
def test_close_fails_loudly_when_a_stage_hangs(stage, match, monkeypatch):
    """Rank 0's close when the bridge's shutdown or the process group's
    teardown never returns: it raises within its bound, naming the
    stage, with the workers stopped."""
    import torch.distributed as dist
    never = threading.Event()

    class Bridge:
        def shutdown(self):
            if stage == "bridge":
                never.wait()

    monkeypatch.setattr(dist, "is_initialized",
                        lambda: stage == "process_group")
    monkeypatch.setattr(dist, "destroy_process_group", never.wait)
    worker = _Worker()
    runtime = TensorParallelRuntime(MeshGroups(), Bridge(), [worker], [])
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match=match):
            runtime.close(timeout_s=0.2)
    finally:
        never.set()
    assert time.monotonic() - t0 < 5.0
    assert not worker.alive and runtime.closed


def test_two_process_pp_server_matches_jax(tmp_path):
    """``--pipeline-parallel-size 2 --device cpu`` over a llama
    checkpoint (each rank reads its stage's layers): greedy completions
    byte-identical to the JAX engine's at pp 2; the mesh on /metrics;
    the worker gone after the server stops."""
    path, _ = parity._save_tiny_llama(tmp_path)
    theirs = jax_checkpoint_streams(path, PROMPTS,
                                    dict(pipeline_parallel_size=2))
    texts, metrics, out = serve_two_ranks(
        path, ["--pipeline-parallel-size", "2"], PROMPTS)
    tok = get_tokenizer("bench")
    assert texts == [tok.decode(ids) for ids in theirs], out[-3000:]
    assert 'vllm:engine_mesh_shape{axis="pp"} 2.0' in metrics
    assert 'vllm:engine_mesh_shape{axis="tp"} 1.0' in metrics
    assert "tp rank 1 shutting down" in out
