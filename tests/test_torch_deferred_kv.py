"""Deferred KV writes in decode bursts, the port against the JAX package.

A burst with deferred writes keeps each iteration's K/V in dense
per-layer tails and flushes them to the pages once, at its end (JAX's
``_decode_burst_deferred_impl``). Held here, on the CPU:

- ``write_to_tail`` and the tailed ``paged_attention`` against JAX's
  (f32 and int8 pages, per-layer and stacked), and the decode kernel's
  tail form (its plain version: the page walk, then the tail as one
  more split, merged in split order) against JAX's tailed attention;
  f32 at atol = rtol = 1e-5 (the sums run in another order);
- the deferred burst engine's greedy streams byte-identical to JAX's
  deferred burst and to the port's eager-write burst, with rows frozen
  mid-burst by a stop token and by their budget, across page
  boundaries and several bursts, int8 and stacked caches, and seeded
  rows against the eager burst;
- ``deferred_kv_eligible`` and the server's ``--deferred-kv-writes``
  resolution against JAX's over the full grid of their arguments, and
  the refusals of an explicit ``on`` that is not eligible.
"""

import argparse
import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine import model_runner as jax_runner
from production_stack_tpu.engine import server as jax_server
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu.ops import attention as jax_attention
from production_stack_tpu.ops.quant_kv import QuantKV as JaxQuantKV
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine import model_runner
from production_stack_tpu_torch.engine import server
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops import attention
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    MAX_TAIL,
    paged_decode_tail_attention,
    paged_decode_tail_attention_plain,
)
from production_stack_tpu_torch.ops.quant_kv import QuantKV

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


# ---- (f) the tail ops --------------------------------------------------------


def test_write_to_tail_matches_jax():
    """One token a row into its slot (slot = query position - frozen
    kv_len), frozen rows untouched; in place in the port."""
    rs = np.random.RandomState(0)
    b, s, kv, d = 5, 6, 2, 8
    tail = rs.randn(b, s, kv, d).astype(np.float32)
    new = rs.randn(b, 1, kv, d).astype(np.float32)
    slot = np.array([0, 3, 5, 2, 4], np.int32)
    active = np.array([True, True, False, True, False])
    want = jax_attention.write_to_tail(jnp.asarray(tail), jnp.asarray(new),
                                       jnp.asarray(slot), jnp.asarray(active))
    port = torch.from_numpy(tail.copy())
    out = attention.write_to_tail(port, torch.from_numpy(new),
                                  torch.from_numpy(slot),
                                  torch.from_numpy(active))
    assert out is port
    np.testing.assert_array_equal(port.numpy(), np.asarray(want))


def _tail_inputs(seed, int8, stacked, b=4, t=1, nh=4, kv=2, d=16, ps=8,
                 pages=32, s_len=4, layers=3, layer=1):
    """Random pages (one page table row a sequence), tails and query
    positions: row i holds kv_lens[i] tokens in its pages and attends
    to tail slots up to its position."""
    rs = np.random.RandomState(seed)
    shape = (kv, pages, d, ps)
    if stacked:
        shape = (layers,) + shape
    k = rs.randn(*shape).astype(np.float32)
    v = rs.randn(*shape).astype(np.float32)
    # Row 3 crosses the 128-token chunk: two splits of the page walk.
    kv_lens = np.array([13, 0, 8, 150][:b], np.int32)
    table = np.zeros((b, 24), np.int32)
    table[0, :2] = [1, 2]
    table[2, :1] = [3]
    table[3, :19] = np.arange(4, 23)
    q = rs.randn(b, t, nh, d).astype(np.float32)
    live = np.array([1, 3, 4, 2][:b], np.int32)
    q_pos = (kv_lens + live - 1)[:, None].astype(np.int32)
    kt = rs.randn(b, s_len, kv, d).astype(np.float32)
    vt = rs.randn(b, s_len, kv, d).astype(np.float32)
    out = dict(q=q, k=k, v=v, table=table, kv_lens=kv_lens, q_pos=q_pos,
               kt=kt, vt=vt, layer=layer if stacked else None)
    if int8:
        for name in ("k", "v"):
            data = rs.randint(-127, 128, size=shape).astype(np.int8)
            scale = (0.01 + 0.02 * rs.rand(*shape[:-2], ps)).astype(
                np.float32)
            out[name] = (data, scale)
    return out


def _caches(x, int8):
    if int8:
        return (JaxQuantKV(*(jnp.asarray(a) for a in x["k"])),
                JaxQuantKV(*(jnp.asarray(a) for a in x["v"])),
                QuantKV(*(torch.from_numpy(a) for a in x["k"])),
                QuantKV(*(torch.from_numpy(a) for a in x["v"])))
    return (jnp.asarray(x["k"]), jnp.asarray(x["v"]),
            torch.from_numpy(x["k"]), torch.from_numpy(x["v"]))


FORMS = list(itertools.product((False, True), (False, True)))


@pytest.mark.parametrize("int8,stacked", FORMS)
def test_tailed_paged_attention_matches_jax(int8, stacked):
    """The plain path's ``paged_attention`` with k/v tails: one softmax
    over the pages (positions < kv_lens) and the tail (slot s at
    kv_lens + s, while at most the query's position)."""
    x = _tail_inputs(1, int8, stacked)
    jk, jv, pk, pv = _caches(x, int8)
    want = jax_attention.paged_attention(
        jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["table"]),
        jnp.asarray(x["q_pos"]), jnp.asarray(x["kv_lens"]),
        layer=x["layer"], k_tail=jnp.asarray(x["kt"]),
        v_tail=jnp.asarray(x["vt"]))
    got = attention.paged_attention(
        torch.from_numpy(x["q"]), pk, pv, torch.from_numpy(x["table"]),
        torch.from_numpy(x["q_pos"]), torch.from_numpy(x["kv_lens"]),
        layer=x["layer"], k_tail=torch.from_numpy(x["kt"]),
        v_tail=torch.from_numpy(x["vt"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("int8,stacked", FORMS)
@pytest.mark.parametrize("splits", [1, 2])
def test_tail_form_of_the_decode_kernel_matches_jax(int8, stacked, splits):
    """The tail form's plain version (the CPU side of the wrapper: the
    page walk in ``splits`` ranges, then the tail as one more split)
    against JAX's tailed attention at T = 1; a pad row (kv_len 0)
    attends to its tail alone."""
    x = _tail_inputs(2, int8, stacked)
    jk, jv, pk, pv = _caches(x, int8)
    want = jax_attention.paged_attention(
        jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["table"]),
        jnp.asarray(x["q_pos"]), jnp.asarray(x["kv_lens"]),
        layer=x["layer"], k_tail=jnp.asarray(x["kt"]),
        v_tail=jnp.asarray(x["vt"]))[:, 0]
    args = (torch.from_numpy(x["q"][:, 0]), pk, pv,
            torch.from_numpy(x["table"]), torch.from_numpy(x["kv_lens"]),
            torch.from_numpy(x["kt"]), torch.from_numpy(x["vt"]),
            torch.from_numpy(x["q_pos"][:, 0]))
    got = paged_decode_tail_attention_plain(*args, layer=x["layer"],
                                            num_splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # The wrapper takes the plain version for CPU tensors.
    assert torch.equal(paged_decode_tail_attention(
        *args, layer=x["layer"], num_splits=splits), got)


def test_tail_operands_are_checked():
    x = _tail_inputs(3, False, False)
    args = [torch.from_numpy(x["q"][:, 0]), torch.from_numpy(x["k"]),
            torch.from_numpy(x["v"]), torch.from_numpy(x["table"]),
            torch.from_numpy(x["kv_lens"]), torch.from_numpy(x["kt"]),
            torch.from_numpy(x["vt"]), torch.from_numpy(x["q_pos"][:, 0])]
    too_long = torch.zeros((4, MAX_TAIL + 1, 2, 16))
    for i, bad in ((5, too_long), (6, too_long),
                   (7, args[7].long()), (5, args[5].double())):
        call = list(args)
        call[i] = bad
        with pytest.raises(ValueError):
            paged_decode_tail_attention(*call)


# ---- (g) the deferred burst engine ------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(21)).items()}


def _config(module, decode_steps, deferred, kv="auto", layout="auto"):
    return module.EngineConfig(
        model=module.tiny_model_config("llama"),
        cache=module.CacheConfig(page_size=8, num_pages=128,
                                 kv_cache_dtype=kv, cache_layout=layout),
        scheduler=module.SchedulerConfig(
            max_num_seqs=4, max_model_len=256, prefill_chunk_size=16,
            decode_steps=decode_steps, deferred_kv_writes=deferred))


def _prompts():
    rs = np.random.RandomState(3)
    return [[int(t) for t in rs.randint(1, 500, n)] for n in (7, 20, 41, 9)]


def _gen(engine, sampling_cls, kws):
    seqs = [engine.sequences[engine.add_request(p, sampling_cls(**kw))]
            for p, kw in zip(_prompts(), kws)]
    for _ in range(400):
        if not engine.has_work():
            break
        engine.step()
    return [list(s.output_token_ids) for s in seqs]


def _port(weights, decode_steps, deferred, **kw):
    cfg = _config(config, decode_steps, deferred, **kw)
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model, "cpu"),
                     device="cpu")


def _jax(weights, decode_steps, deferred, **kw):
    return JaxEngine(_config(jax_config, decode_steps, deferred, **kw),
                     params={k: jnp.asarray(v) for k, v in weights.items()})


def _stop_kws(weights, **kw):
    """Greedy rows that freeze mid-burst: two at a stop token (each
    row's 3rd and 6th greedy token, from a single-step run of the same
    cache), two at budgets that are no multiple of the burst (10 and
    13 tokens)."""
    ref = _gen(_port(weights, 1, False, **kw), SamplingParams,
               [dict(max_tokens=16, temperature=0.0, ignore_eos=True)] * 4)
    return [dict(max_tokens=16, temperature=0.0, stop_token_ids=[ref[0][2]]),
            dict(max_tokens=16, temperature=0.0, stop_token_ids=[ref[1][5]]),
            dict(max_tokens=10, temperature=0.0, ignore_eos=True),
            dict(max_tokens=13, temperature=0.0, ignore_eos=True)]


@pytest.mark.parametrize("kv,layout", [("auto", "per_layer"),
                                       ("auto", "stacked"),
                                       ("int8", "per_layer"),
                                       ("int8", "stacked")])
def test_deferred_bursts_match_jax_and_the_eager_burst(weights, kv, layout):
    kws = _stop_kws(weights, kv=kv, layout=layout)
    deferred = _gen(_port(weights, 4, True, kv=kv, layout=layout),
                    SamplingParams, kws)
    eager = _gen(_port(weights, 4, False, kv=kv, layout=layout),
                 SamplingParams, kws)
    theirs = _gen(_jax(weights, 4, True, kv=kv, layout=layout),
                  JaxSamplingParams, kws)
    assert deferred == theirs
    assert deferred == eager
    # The stops fired mid-burst, short of the budget; the budgets
    # froze rows mid-burst.
    for t, kw in zip(deferred[:2], kws):
        assert t[-1] == kw["stop_token_ids"][0] and len(t) < 16
    assert [len(t) for t in deferred[2:]] == [10, 13]


def test_deferred_bursts_cross_pages_and_bursts(weights):
    """Long rows: the tails flush across page boundaries (page 8) over
    several bursts of 8, then feed the next burst's pages."""
    kws = [dict(max_tokens=29, temperature=0.0, ignore_eos=True)] * 4
    deferred = _gen(_port(weights, 8, True), SamplingParams, kws)
    assert deferred == _gen(_port(weights, 8, False), SamplingParams, kws)
    assert deferred == _gen(_jax(weights, 8, True), JaxSamplingParams, kws)


def test_deferred_seeded_rows_match_the_eager_burst(weights):
    """A seeded row's draws depend only on (seed, emitted index), so the
    deferred burst samples what the eager burst samples."""
    kws = [dict(max_tokens=11, temperature=0.9, seed=1234 + i,
                ignore_eos=True) for i in range(4)]
    assert (_gen(_port(weights, 4, True), SamplingParams, kws)
            == _gen(_port(weights, 4, False), SamplingParams, kws))


def test_a_deferred_burst_is_a_graph_key_of_its_own(weights):
    """The burst's key carries the ``deferred`` mark (its tails are
    buffers of its own graph), and its tails' shape is the window."""
    engine = _port(weights, 4, True)
    seen = []
    dispatch = engine.runner._dispatch

    def record(kind, shape, payload, names, body, token_source=None,
               options=()):
        seen.append((kind, body, options))
        return dispatch(kind, shape, payload, names, body, token_source,
                        options)

    engine.runner._dispatch = record
    _gen(engine, SamplingParams,
         [dict(max_tokens=9, temperature=0.0, ignore_eos=True)] * 4)
    bursts = [s for s in seen if s[0] == "decode_burst"]
    assert bursts and all("deferred" in o for _, _, o in bursts)
    assert all(b == ("burst", 4) for _, b, _ in bursts)
    assert engine.runner._burst_tails(3, 4)[0][0].shape == (
        3, 4, engine.config.model.num_key_value_heads,
        engine.config.model.head_dim)


# ---- (h) eligibility and resolution -----------------------------------------


GRID = list(itertools.product(
    ("llama", "mistral", "qwen2", "opt", "gpt2", "mixtral"), (1, 2, 4),
    ("auto", "xla", "pallas", "pallas-interpret"), (1, 2), (1, 2), (0, 4)))


def test_eligibility_is_jaxs_over_the_whole_grid():
    for args in GRID:
        assert (model_runner.deferred_kv_eligible(*args)
                == jax_runner.deferred_kv_eligible(*args)), args
    assert model_runner.DEFERRED_KV_FAMILIES == jax_runner.DEFERRED_KV_FAMILIES


@pytest.mark.parametrize("flag", ["auto", "on", "off"])
def test_resolution_is_jaxs(flag):
    """--deferred-kv-writes auto|on|off over architecture, decode
    steps, attention impl and speculative k, as the JAX server resolves
    it (the port serves neither pp nor cp, which stay 1)."""
    for arch, steps, impl, spec in itertools.product(
            ("llama", "qwen2", "opt", "mixtral"), (1, 4),
            ("auto", "xla", "pallas"), (0, 4)):
        args = argparse.Namespace(
            deferred_kv_writes=flag, decode_steps=steps,
            attention_impl=impl, speculative_k=spec,
            pipeline_parallel_size=1, context_parallel_size=1)
        model = config.ModelConfig(architecture=arch)
        assert (server._resolve_deferred_kv(args, model)
                == jax_server._resolve_deferred_kv(args, model)), (
            flag, arch, steps, impl, spec)


def test_the_flag_parses_with_jaxs_choices_and_default():
    assert server.parse_args([]).deferred_kv_writes == "auto"
    assert server.parse_args(["--deferred-kv-writes", "on"]
                             ).deferred_kv_writes == "on"
    with pytest.raises(SystemExit):
        server.parse_args(["--deferred-kv-writes", "yes"])


def test_auto_resolves_on_for_a_llama_burst_server():
    args = server.parse_args(["--device", "cpu", "--decode-steps", "4"])
    engine, _ = server.build_engine_from_args(args)
    assert engine.config.scheduler.deferred_kv_writes
    args = server.parse_args(["--device", "cpu", "--decode-steps", "4",
                              "--model", "tiny-opt"])
    engine, _ = server.build_engine_from_args(args)
    assert not engine.config.scheduler.deferred_kv_writes


def _refusal(module, runner_cls, **kw):
    """The exception type an explicit deferred_kv_writes raises, or
    None."""
    model = module.tiny_model_config(kw.pop("arch", "llama"))
    impl = kw.pop("impl", None)
    if impl is not None:
        model.attention_impl = impl
    try:
        cfg = module.EngineConfig(
            model=model, cache=module.CacheConfig(page_size=16, num_pages=32),
            scheduler=module.SchedulerConfig(
                max_num_seqs=2, max_model_len=64, prefill_chunk_size=16,
                deferred_kv_writes=True, **kw))
        runner_cls(cfg)
    except (ValueError, NotImplementedError) as exc:
        return type(exc)
    return None


@pytest.mark.parametrize("kw", [
    dict(decode_steps=1), dict(decode_steps=4, arch="opt"),
    dict(decode_steps=4, arch="gpt2"), dict(decode_steps=4, impl="pallas"),
    dict(decode_steps=4, speculative_k=2), dict(decode_steps=4)])
def test_an_ineligible_explicit_on_raises_as_in_jax(kw):
    """decode_steps <= 1 is a ValueError, another family or a Pallas
    decode impl a NotImplementedError, speculative_k a ValueError at
    config time: JAX's refusals, type for type; an eligible one
    builds."""
    theirs = _refusal(jax_config, lambda c: JaxEngine(c), **dict(kw))
    ours = _refusal(config, lambda c: LLMEngine(c, device="cpu"), **dict(kw))
    assert ours == theirs
