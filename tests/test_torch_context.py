"""Context parallelism in the port against the JAX package's, on the CPU.

JAX runs ``sp_prefill_forward`` and its engine on ``build_mesh(
context_parallel_size=N[, tensor_parallel_size=2])`` over the fake CPU
devices of tests/conftest.py; the port runs the same weights over fake
ranks of a tp x sp world in threads (tests/test_torch_pipeline.py's
``FakeMesh``) and as a real two-process server over gloo
(``--context-parallel-size 2 --device cpu``).

Held here: the whole-prompt prefill on the same pages (the last
token's logits within 1e-5 f32, every rank's replica of the cache
JAX's at 1e-5) for llama, qwen2's biases and gpt2 at sp 2 and 4 and
sp x tp 2; greedy streams byte-identical to the JAX engine's at sp 2
and 4, sp x tp 2, int8 weights, LoRA, GPT-2 (and with tp), qwen2 with
biases, mixed lengths under continuous batching and short prompts on
the chunked path, each long prompt in exactly one sp dispatch; the
port's other step kinds after an sp prefill equal to its cp 1 engine;
logprobs and penalties riding the sp prefill; the default threshold; a
page written to every replica; the refusals, with JAX's messages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.lora import LoRAAdapter as JaxLoRAAdapter
from production_stack_tpu.parallel import mesh as jax_mesh
from production_stack_tpu.parallel.context_serving import (
    sp_prefill_forward as jax_sp_prefill_forward,
)
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.lora import LoRAAdapter
from production_stack_tpu_torch.engine.model_runner import ModelRunner
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.parallel import mesh
from production_stack_tpu_torch.parallel.collectives import (
    fake_mesh,
    run_ranks,
)
from production_stack_tpu_torch.parallel.context_serving import (
    sp_prefill_forward,
)
from tests import test_model_parity as parity
from tests import test_torch_model_families as fam
from tests import test_torch_pipeline as pipe
from tests.test_torch_cuda_kernels import split_against_whole

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


# ---- (a) the prefill on pages -----------------------------------------------


def _prefill_inputs(t=64):
    """Two prompts over pages of 16: row 0 all ``t`` tokens, row 1 its
    first 40 (the rest pad slots on the trash page)."""
    rng = np.random.RandomState(5)
    tokens = rng.randint(1, 500, size=(2, t)).astype(np.int32)
    valid = np.zeros((2, t), bool)
    valid[0], valid[1, :40] = True, True
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 0]], np.int32)
    last = np.array([t - 1, 39], np.int32)
    return tokens, table, valid, last


@pytest.mark.parametrize("sp,tp", [(2, 1), (4, 1), (2, 2)])
@pytest.mark.parametrize("arch", ["llama", "qwen2", "gpt2"])
def test_sp_prefill_forward_matches_jax(arch, sp, tp):
    """The whole-prompt prefill over fake sp x tp ranks and JAX's on its
    mesh: the last tokens' logits within 1e-5 on every rank, and every
    rank's replica of the stacked cache (its tp heads) JAX's."""
    jcfg, cfg = pipe._fam_configs(arch)
    np_params = fam._params("llama" if arch == "qwen2" else arch, jcfg)
    if arch == "qwen2":
        rng = np.random.RandomState(9)
        for b, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
            shape = (np_params[w].shape[0], np_params[w].shape[2])
            np_params[b] = (0.05 * rng.randn(*shape)).astype(np.float32)
    jmesh = jax_mesh.build_mesh(context_parallel_size=sp,
                                tensor_parallel_size=tp)
    jparams = jax_mesh.shard_params(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jcfg, jmesh)
    layers, kv, d = (cfg.num_hidden_layers, cfg.num_key_value_heads,
                     cfg.head_dim)
    shape = (layers, kv, fam.NUM_PAGES, d, fam.PAGE_SIZE)
    inputs = _prefill_inputs()
    want, jk, jv = jax.jit(lambda p, *a: jax_sp_prefill_forward(
        p, jcfg, *a, mesh=jmesh))(
        jparams, *(jnp.asarray(x) for x in inputs),
        jax_mesh.shard_cache(jnp.zeros(shape, jnp.float32), jmesh),
        jax_mesh.shard_cache(jnp.zeros(shape, jnp.float32), jmesh))
    groups = fake_mesh(tp=tp, sp=sp)
    rank_shape = (layers, kv // tp) + shape[2:]
    caches = [(torch.zeros(rank_shape), torch.zeros(rank_shape))
              for _ in groups]
    rank_cfg = mesh.rank_model_config(cfg, tp)

    def rank(g):
        params = params_from_numpy(np_params, cfg, "cpu")
        if tp > 1:
            mesh.shard_params(params, cfg, g.tp.rank, tp)
        k, v = caches[groups.index(g)]
        return sp_prefill_forward(
            params, rank_cfg, *(torch.from_numpy(x) for x in inputs), k, v,
            sp=g.sp, tp=g.tp)
    outs = run_ranks(groups, rank)
    for out in outs:
        np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)
    for g, (k, v) in zip(groups, caches):
        t = 0 if g.tp is None else g.tp.rank
        heads = slice(t * kv // tp, (t + 1) * kv // tp)
        for port_c, jax_c in ((k, jk), (v, jv)):
            np.testing.assert_allclose(port_c.numpy()[:, :, 1:],
                                       np.asarray(jax_c)[:, heads, 1:],
                                       **TOL)


def test_an_sp_prefill_gathers_once_a_layer():
    """sp 2: each rank one K/V gather a layer and one for the last
    token's row, and one ring hop a layer."""
    jcfg, cfg = fam._configs("gpt2")
    np_params = fam._params("gpt2", jcfg)
    groups = fake_mesh(sp=2)
    inputs = _prefill_inputs()
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, fam.NUM_PAGES,
             cfg.head_dim, fam.PAGE_SIZE)
    COUNTERS.reset()
    run_ranks(groups, lambda g: sp_prefill_forward(
        params_from_numpy(np_params, cfg, "cpu"), cfg,
        *(torch.from_numpy(x) for x in inputs), torch.zeros(shape),
        torch.zeros(shape), sp=g.sp))
    layers = cfg.num_hidden_layers
    assert COUNTERS.launches == {"sp_hop": 2 * layers,
                                 "sp_all_gather": 2 * (layers + 1)}


# ---- (b) engines ------------------------------------------------------------


def _engine_config(module, sp=1, tp=1, family="llama", quant="none",
                   lora=False, threshold=64, bias=False, **sched):
    model = module.tiny_model_config(family)
    model.quantization = quant
    model.attention_bias = bias or model.attention_bias
    return module.EngineConfig(
        model=model, cache=module.CacheConfig(page_size=16, num_pages=128),
        scheduler=module.SchedulerConfig(
            max_num_seqs=4, max_model_len=512, prefill_chunk_size=32,
            prefill_batch_size=2, **sched),
        parallel=module.ParallelConfig(context_parallel_size=sp,
                                       tensor_parallel_size=tp,
                                       long_prefill_threshold=threshold),
        lora=(module.LoRAConfig(enable=True, max_loras=2, max_lora_rank=4)
              if lora else module.LoRAConfig()))


def _weights(family="llama", quant="none", bias=False):
    params = pipe._weights(family, quant, layers=2)
    if bias:
        rng = np.random.RandomState(13)
        for b, w in (("bq", "wq"), ("bk", "wk"), ("bv", "wv")):
            shape = (params[w].shape[0], params[w].shape[2])
            params[b] = (0.05 * rng.randn(*shape)).astype(np.float32)
    return params


LONG = list(range(2, 2 + 4 * 32 + 9))  # 137 tokens, not a power of two


ENGINES = {
    "sp2": dict(sp=2),
    "sp4": dict(sp=4),
    "sp2_tp2": dict(sp=2, tp=2),
    "sp4_int8_weights": dict(sp=4, quant="int8"),
    "sp2_tp2_int8_weights": dict(sp=2, tp=2, quant="int8"),
    "sp4_lora": dict(sp=4, lora=True),
    "sp2_tp2_lora": dict(sp=2, tp=2, lora=True),
    "gpt2_sp4": dict(sp=4, family="gpt2"),
    "gpt2_sp2_tp2": dict(sp=2, tp=2, family="gpt2"),
    "qwen2_bias_sp4": dict(sp=4, bias=True),
    "mixed_lengths_sp4": dict(sp=4, prompts=[
        list(range(2, 2 + 130)), list(range(3, 3 + 20)),
        list(range(4, 4 + 70))]),
    "mixed_lengths_sp2_tp2": dict(sp=2, tp=2, prompts=[
        list(range(2, 2 + 130)), list(range(3, 3 + 20)),
        list(range(4, 4 + 70))]),
    "short_prompt_chunked_sp4": dict(sp=4, prompts=[list(range(5, 45))]),
}


def _jax_engine(sp, tp, family, quant, lora, bias, np_params, **sched):
    jcfg = _engine_config(jax_config, sp, tp, family, quant, lora,
                          bias=bias, **sched)
    jmesh = (jax_mesh.build_mesh(context_parallel_size=sp,
                                 tensor_parallel_size=tp)
             if sp * tp > 1 else None)
    params = pipe._jax_params(np_params)
    engine = JaxEngine(jcfg, mesh=jmesh, params=(
        jax_mesh.shard_params(params, jcfg.model, jmesh) if jmesh
        else params))
    if lora:
        engine.runner.lora_registry.register(JaxLoRAAdapter(
            name="adapter-x", rank=4, scaling=0.5,
            weights=pipe._adapter_pairs(jcfg.model)))
    return engine


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_cp_engine_streams_match_jax(case):
    """Greedy streams of the port's cp engine (fake ranks, the step
    bridge between them) byte-identical to the JAX engine's on its
    (sp, tp) mesh, the same weights, one engine serving every prompt;
    each prompt of at least the threshold (64) takes exactly one sp
    prefill dispatch and the shorter ones the chunked path; the mirror
    of tests/test_context_parallel_serving.py's cases. LoRA: every
    other row through an adapter installed into the running engine."""
    kw = dict(ENGINES[case])
    sp, tp = kw.pop("sp"), kw.pop("tp", 1)
    family, quant = kw.pop("family", "llama"), kw.pop("quant", "none")
    lora, bias = kw.pop("lora", False), kw.pop("bias", False)
    prompts = kw.pop("prompts", [LONG])
    if lora:
        prompts = [LONG, list(range(7, 7 + 90))]
    names = ([None, "adapter-x"] if lora else None)
    np_params = _weights(family, quant, bias)
    want = pipe.run_streams(
        _jax_engine(sp, tp, family, quant, lora, bias, np_params), prompts,
        pipe._jax_sampling(), names)
    cfg = _engine_config(config, sp, tp, family, quant, lora, bias=bias)
    with pipe.FakeMesh(cfg, lambda: params_from_numpy(
            np_params, cfg.model, "cpu")) as fm:
        if lora:
            fm.engine.runner.register_lora(LoRAAdapter(
                name="adapter-x", rank=4, scaling=0.5,
                weights=pipe._adapter_pairs(cfg.model)))
        got = pipe.run_streams(fm.engine, prompts, pipe._port_sampling(),
                               names)
    assert got == want
    assert fm.engine.runner.sp_prefill_steps == sum(len(p) >= 64
                                                    for p in prompts)
    assert all(r.cache_layout == "stacked" for r in fm.runners)


VARIANTS = {
    "async_unified": dict(async_scheduling=True, unified_step=True),
    "spec_unified": dict(speculative_k=3, unified_step=True),
    "burst": dict(decode_steps=4),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["int8_kv"])
def test_cp2_step_kinds_after_an_sp_prefill_equal_cp1(variant):
    """After the sp prefills, the async pipeline, unified and verify
    blocks, bursts and int8 KV run replicated on each rank: greedy
    streams at cp 2 equal the port's cp 1 engine's (which prefills the
    same prompts in chunks)."""
    np_params = _weights()
    sched = VARIANTS.get(variant, {})
    prompts = [LONG, [5, 6, 7, 8] * 20, list(range(9, 29))]

    def cfg(sp):
        c = _engine_config(config, sp, **sched)
        if variant == "int8_kv":
            c.cache.kv_cache_dtype = "int8"
        return c

    single = pipe.run_streams(LLMEngine(cfg(1), params=params_from_numpy(
        np_params, cfg(1).model, "cpu"), device="cpu"), prompts,
        pipe._port_sampling(12))
    with pipe.FakeMesh(cfg(2), lambda: params_from_numpy(
            np_params, cfg(2).model, "cpu")) as fm:
        got = pipe.run_streams(fm.engine, prompts, pipe._port_sampling(12))
    assert got == single
    assert fm.engine.runner.sp_prefill_steps == 2


# ---- (c) unified and verify dispatches split over the sp ranks ------------


SHORT = list(range(9, 29))  # a chunked prompt that mixes with decode rows


@pytest.mark.parametrize("case", sorted(ENGINES))
def test_cp_unified_streams_match_jax(case):
    """Each engine case of ``test_cp_engine_streams_match_jax`` with the
    unified step on in both engines and a short prompt beside its own,
    so that prefill chunks ride unified [R, W] blocks with decode rows:
    greedy streams byte-identical to the JAX cp engine's (its W axis
    split over sp, the port's rows), and on every rank each unified
    dispatch computed R/sp of its rows."""
    kw = dict(ENGINES[case])
    sp, tp = kw.pop("sp"), kw.pop("tp", 1)
    family, quant = kw.pop("family", "llama"), kw.pop("quant", "none")
    lora, bias = kw.pop("lora", False), kw.pop("bias", False)
    prompts = kw.pop("prompts", [LONG]) + [SHORT]
    names = None
    if lora:
        prompts = [LONG, list(range(7, 7 + 90)), SHORT]
        names = [None, "adapter-x", None]
    np_params = _weights(family, quant, bias)
    want = pipe.run_streams(
        _jax_engine(sp, tp, family, quant, lora, bias, np_params,
                    unified_step=True), prompts, pipe._jax_sampling(), names)
    cfg = _engine_config(config, sp, tp, family, quant, lora, bias=bias,
                         unified_step=True)
    with pipe.FakeMesh(cfg, lambda: params_from_numpy(
            np_params, cfg.model, "cpu")) as fm:
        if lora:
            fm.engine.runner.register_lora(LoRAAdapter(
                name="adapter-x", rank=4, scaling=0.5,
                weights=pipe._adapter_pairs(cfg.model)))
        got = pipe.run_streams(fm.engine, prompts, pipe._port_sampling(),
                               names)
    assert got == want
    for runner in fm.runners:
        dispatches, mine, rows = runner.sp_split_rows["unified"]
        assert dispatches > 0 and mine * sp == rows


def _split_spy(monkeypatch):
    """Wrap every runner's split forward so that each ragged call of
    the model on a rank records (the rank's sp group, rows run)."""
    from production_stack_tpu_torch.engine import model_runner
    seen = []
    real = model_runner.shard_rows_forward

    def spying(forward, sp):
        def inner(*args, **kwargs):
            if kwargs.get("kind") == "ragged":
                seen.append((sp, args[2].shape[0]))
            return forward(*args, **kwargs)
        return real(inner, sp)

    monkeypatch.setattr(model_runner, "shard_rows_forward", spying)
    return seen


SPEC_PROMPTS = [[5, 6, 7, 8] * 6, list(range(40, 140)), SHORT]
# The 300-token prompt is still in chunks when the first drafts come.
MIXED_PROMPTS = [[5, 6, 7, 8] * 6, list(range(40, 340)), SHORT]


def _spec_engine_config(sp, tp=1):
    """Speculative decoding with the unified step: decode rows carry
    drafts (the repeating prompt) in unified blocks beside the chunks
    of a 100-token prompt (the threshold above it), and verify blocks
    once no prefill is left."""
    return _engine_config(config, sp, tp, threshold=512, speculative_k=3,
                          unified_step=True)


@pytest.mark.parametrize("sp,tp", [(2, 1), (4, 1), (2, 2)])
def test_each_sp_rank_runs_its_share_of_unified_and_verify(sp, tp,
                                                           monkeypatch):
    """Every unified and verify dispatch of a speculative cp engine:
    each fake sp rank ran exactly R/sp of the block's rows through the
    model (the spy), as its counter says, and the greedy streams equal
    the port's cp 1 engine's."""
    seen = _split_spy(monkeypatch)
    np_params = _weights()
    single = pipe.run_streams(LLMEngine(
        _spec_engine_config(1), params=params_from_numpy(
            np_params, _spec_engine_config(1).model, "cpu"),
        device="cpu"), SPEC_PROMPTS, pipe._port_sampling(12))
    cfg = _spec_engine_config(sp, tp)
    with pipe.FakeMesh(cfg, lambda: params_from_numpy(
            np_params, cfg.model, "cpu")) as fm:
        got = pipe.run_streams(fm.engine, SPEC_PROMPTS,
                               pipe._port_sampling(12))
    assert got == single
    for runner in fm.runners:
        counts = runner.sp_split_rows
        assert set(counts) == {"unified", "spec_verify"}, counts
        calls = [n for g, n in seen if g is runner.sp]
        assert len(calls) == sum(c[0] for c in counts.values())
        assert sum(calls) == sum(c[1] for c in counts.values())
        for dispatches, mine, rows in counts.values():
            assert dispatches > 0 and mine * sp == rows


def test_every_replica_holds_the_same_pages_after_a_mixed_step(
        monkeypatch):
    """A unified block with a verify row (a decode row and its drafts)
    and a prefill chunk row, split over two sp ranks of two tp ranks:
    afterwards every sp replica's cache is bitwise the others' (the
    same tp index), every page but the trash page, int8 scales
    included."""
    steps = []
    from production_stack_tpu_torch.engine import model_runner
    real = model_runner.ModelRunner._run_step

    def recording(self, kind, shape, payload, *args):
        if self.tp is None or self.tp.rank == 0 and self.sp.rank == 0:
            steps.append((kind, payload))
        return real(self, kind, shape, payload, *args)

    monkeypatch.setattr(model_runner.ModelRunner, "_run_step", recording)
    for kv in ("auto", "int8"):
        cfg = _spec_engine_config(2, 2)
        cfg.cache.kv_cache_dtype = kv
        with pipe.FakeMesh(cfg) as fm:
            pipe.run_streams(fm.engine, MIXED_PROMPTS,
                             pipe._port_sampling(12))
        mixed = [p for k, p in steps if k == "unified"
                 and (p["draft_lens"] > 0).any()
                 and (p["valid"].sum(axis=1) > 4).any()]
        assert mixed, "no unified block held a verify row and a chunk"
        steps.clear()
        # Global rank (sp, tp), tp fastest: sp replicas r and r + 2.
        for a, b in ((0, 2), (1, 3)):
            for name in ("k_cache", "v_cache"):
                x, y = (getattr(fm.runners[i], name) for i in (a, b))
                leaves = ((x.data, y.data), (x.scale, y.scale)) if (
                    kv == "int8") else ((x, y),)
                for u, v in leaves:
                    assert torch.equal(u[:, :, 1:], v[:, :, 1:]), (kv, name)


@pytest.mark.parametrize("sp", [2, 3])
@pytest.mark.parametrize("kv", ["auto", "int8"])
def test_a_split_ragged_block_is_the_whole_blocks(sp, kv):
    """``shard_rows_forward`` over fake sp ranks: each rank's logits
    are the whole block's forward's within 1e-5 (f32), and each rank's
    cache holds every row's new K/V as the whole run's does (the trash
    page aside), int8 values and scales included."""
    split, whole, ranks, whole_caches = split_against_whole("cpu", sp, kv)
    for logits in split:
        torch.testing.assert_close(logits, whole, **TOL)
    for kc, vc in ranks:
        for got, want in zip((kc, vc), whole_caches):
            leaves = ((got.data, want.data), (got.scale, want.scale)) if (
                kv == "int8") else ((got, want),)
            for a, b in leaves:
                if a.dtype == torch.int8:
                    assert (a[:, :, 1:].int() - b[:, :, 1:].int()
                            ).abs().max() <= 1
                else:
                    torch.testing.assert_close(a[:, :, 1:], b[:, :, 1:],
                                               **TOL)


def test_logprobs_and_penalties_ride_the_sp_prefill():
    """A long prompt's first token with top-5 logprobs and a repetition
    penalty: the sp prefill's token equals cp 1's chunked prefill's and
    its logprobs agree within 1e-4 (ring against page walk)."""
    np_params = _weights()
    sampling = SamplingParams(max_tokens=4, temperature=0.0, logprobs=True,
                              top_logprobs=5, repetition_penalty=1.3,
                              ignore_eos=True)

    def first(engine):
        seq = engine.sequences[engine.add_request(list(LONG), sampling)]
        outs = []
        while engine.has_work():
            outs.extend(engine.step())
        return seq.output_token_ids, outs[0].logprobs

    c1 = _engine_config(config, 1)
    want_ids, want_lp = first(LLMEngine(c1, params=params_from_numpy(
        np_params, c1.model, "cpu"), device="cpu"))
    c2 = _engine_config(config, 2)
    with pipe.FakeMesh(c2, lambda: params_from_numpy(
            np_params, c2.model, "cpu")) as fm:
        got_ids, got_lp = first(fm.engine)
    assert fm.engine.runner.sp_prefill_steps == 1
    assert got_ids == want_ids
    assert got_lp[1][0][0] == want_lp[1][0][0]
    np.testing.assert_allclose([got_lp[0]] + [x[1] for x in got_lp[1]],
                               [want_lp[0]] + [x[1] for x in want_lp[1]],
                               rtol=1e-4, atol=1e-4)


def test_the_default_threshold_is_two_chunks():
    c = _engine_config(config, 2, threshold=None)
    with pipe.FakeMesh(c) as fm:
        assert fm.engine.scheduler.sp_threshold == 64
    one = LLMEngine(_engine_config(config, 1, threshold=None), device="cpu")
    assert one.scheduler.sp_threshold is None


def test_a_page_write_reaches_every_replica():
    """A restored page lands in every sp rank's replica (each its tp
    heads), and reads back whole."""
    cfg = _engine_config(config, 2, 2)
    m = cfg.model
    with pipe.FakeMesh(cfg) as fm:
        gen = torch.Generator().manual_seed(3)
        shape = (m.num_hidden_layers, m.num_key_value_heads, m.head_dim, 16)
        page = tuple(torch.randn(shape, generator=gen) for _ in range(2))
        fm.engine.runner.write_page(11, *page)
        back = fm.engine.runner.read_page(11)
    # After close every rank has run every record.
    for rank, runner in enumerate(fm.runners):
        # Global rank (sp, tp), tp fastest: its tp index is rank % 2.
        assert torch.equal(runner.k_cache[:, :, 11],
                           mesh.cut(page[0], 1, rank % 2, 2))
    assert all(torch.equal(a, b) for a, b in zip(back, page))


# ---- refusals ---------------------------------------------------------------


@pytest.mark.parametrize("change,error,match", [
    (dict(family="opt"), NotImplementedError,
     "context parallelism serves llama/mistral/qwen2/gpt2"),
    (dict(pp=2), NotImplementedError,
     "context parallelism with pipeline parallelism"),
    (dict(tp=4), ValueError,
     "sp x tp needs attention/kv heads divisible by tensor_parallel_size"),
    (dict(layout="per_layer"), NotImplementedError,
     "cache_layout='per_layer' with pipeline/context parallelism"),
    (dict(deferred=True), NotImplementedError,
     "deferred_kv_writes with pipeline/context parallelism"),
    (dict(group=False), ValueError,
     "context_parallel_size 2 needs the rank's sp group of that size")])
def test_cp_refusals(change, error, match):
    """JAX's refusals of a cp engine it cannot serve, with its messages
    (the mesh check becomes the missing group's)."""
    cfg = _engine_config(config, 2, change.get("tp", 1),
                         change.get("family", "llama"),
                         **(dict(decode_steps=4, deferred_kv_writes=True)
                            if change.get("deferred") else {}))
    cfg.parallel.pipeline_parallel_size = change.get("pp", 1)
    cfg.cache.cache_layout = change.get("layout", "auto")
    groups = (None if change.get("group") is False else
              fake_mesh(sp=2, tp=change.get("tp", 1),
                        pp=change.get("pp", 1))[0])
    with pytest.raises(error, match=match):
        ModelRunner(cfg, device="cpu", **({} if groups is None else dict(
            tp=groups.tp, pp=groups.pp, sp=groups.sp)))


def test_deferred_kv_auto_is_off_under_cp_and_pp():
    from production_stack_tpu_torch.engine.server import (
        _resolve_deferred_kv,
        parse_args,
    )
    model = config.tiny_model_config("llama")
    for flags, want in ((["--decode-steps", "4"], True),
                        (["--decode-steps", "4", "--context-parallel-size",
                          "2"], False),
                        (["--decode-steps", "4", "--pipeline-parallel-size",
                          "2"], False)):
        assert _resolve_deferred_kv(parse_args(flags), model) is want


# ---- a real two-process server ----------------------------------------------


def test_two_process_cp_server_matches_jax(tmp_path):
    """``--context-parallel-size 2 --long-prefill-threshold 64 --device
    cpu`` over a llama checkpoint: a 100-token prompt in one ring
    dispatch and two short ones chunked, the greedy completions
    byte-identical to the JAX engine's at cp 2; the mesh on /metrics."""
    path, _ = parity._save_tiny_llama(tmp_path)
    prompts = [list(range(2, 102))] + pipe.PROMPTS[:2]
    theirs = pipe.jax_checkpoint_streams(
        path, prompts, dict(context_parallel_size=2,
                            long_prefill_threshold=64))
    texts, metrics, out = pipe.serve_two_ranks(
        path, ["--context-parallel-size", "2",
               "--long-prefill-threshold", "64"], prompts)
    tok = get_tokenizer("bench")
    assert texts == [tok.decode(ids) for ids in theirs], out[-3000:]
    assert 'vllm:engine_mesh_shape{axis="sp"} 2.0' in metrics
    assert "tp rank 1 shutting down" in out
