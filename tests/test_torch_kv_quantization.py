"""The port's int8 paged KV cache against the JAX package's.

Inputs are made with numpy from a seed and go through both packages.
The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own int8 tests run them (``tests/test_pallas_attention.py``);
the port's wrappers take their plain versions for CPU tensors (the
CUDA kernels' int8 forms are held against those plain versions on the
card by ``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``).

Covered: ``quantize_kv`` and the quantized page write (bit for bit on
the valid slots), the three plain page walks and the gather reference
on ``QuantKV`` caches, the tiny llama forward with int8 KV, the
engine's greedy streams against the JAX engine's with int8 KV (sync
and async, unified step off and on, speculative decoding), the page
budget expansion, the server's flag and ``/metrics``, and the runner's
page read and write.

Tolerances: 1e-4 on f32 outputs (the same f32 arithmetic, sums in
another order); 2e-2 on bf16 outputs compared in f32 (one bf16
rounding of values of order 1). Greedy streams: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu.ops.attention import (
    paged_attention as jax_paged_attention,
    write_to_pages as jax_write_to_pages,
)
from production_stack_tpu.ops.paged_attention_pallas import (
    paged_decode_attention as jax_paged_decode_attention,
)
from production_stack_tpu.ops.prefill_attention_pallas import (
    paged_prefill_attention as jax_paged_prefill_attention,
)
from production_stack_tpu.ops.quant_kv import (
    QuantKV as JaxQuantKV,
    quant_cache_zeros as jax_quant_cache_zeros,
    quantize_kv as jax_quantize_kv,
)
from production_stack_tpu.ops.ragged_attention_pallas import (
    paged_ragged_attention as jax_paged_ragged_attention,
)
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import make_server, parse_args
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops.attention import (
    paged_attention,
    write_to_pages,
)
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.quant_kv import (
    QuantKV,
    quant_cache_zeros,
    quantize_kv,
)
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention,
    paged_ragged_attention_plain,
)
from tests.test_kv_quantization import _prompts

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(np.asarray(x))


def _quantized_pair(rng, kv_heads, num_pages, head_dim, page_size):
    """A random [kv, pages, d, ps] cache quantized per (page, slot, kv
    head) row, as the page writes lay it out: (int8 data, f32 scale)
    numpy arrays."""
    cache = (rng.randn(kv_heads, num_pages, head_dim, page_size)
             * np.exp(rng.randn(kv_heads, num_pages, 1, page_size))
             ).astype(np.float32)
    q8, scale = jax_quantize_kv(jnp.transpose(_j(cache), (0, 1, 3, 2)))
    return (np.asarray(jnp.transpose(q8, (0, 1, 3, 2))),
            np.asarray(scale))


def _caches(rng, kv_heads, num_pages, head_dim, page_size):
    """(JAX QuantKV k, v, port QuantKV k, v) of the same content."""
    (kd, ks), (vd, vs) = (_quantized_pair(rng, kv_heads, num_pages,
                                          head_dim, page_size)
                          for _ in range(2))
    return (JaxQuantKV(_j(kd), _j(ks)), JaxQuantKV(_j(vd), _j(vs)),
            QuantKV(_t(kd), _t(ks)), QuantKV(_t(vd), _t(vs)))


def _page_table(kv_lens, page_size, max_pages):
    """Distinct pages per row from page 1 on (page 0 is the trash page),
    zeros past each row's pages."""
    table = np.zeros((len(kv_lens), max_pages), np.int32)
    nxt = 1
    for i, n in enumerate(kv_lens):
        for j in range(-(-int(n) // page_size)):
            table[i, j] = nxt
            nxt += 1
    return table, nxt


def _close(got, expected, dtype):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(expected, np.float32),
        **(BF16_TOL if dtype == "bf16" else F32_TOL))


def _query(rng, shape, dtype):
    """A random query in f32 or bf16 for both packages (the same bits:
    both round f32 to bf16 to nearest even)."""
    q = rng.randn(*shape).astype(np.float32)
    if dtype == "bf16":
        return _j(q).astype(jnp.bfloat16), _t(q).to(torch.bfloat16)
    return _j(q), _t(q)


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---- quantize_kv and the quantized write --------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_kv_matches_jax_bit_for_bit(dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(6, 5, 2, 32)
         * np.exp(2 * rng.randn(6, 5, 2, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row keeps the 1e-8 floor
    x[1, 1, 1, :4] = [1e-3, -1e-3, 2.5e-3, 0.0]
    jx, tx = _j(x), _t(x)
    if dtype == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jq, js = jax_quantize_kv(jx)
    tq, ts = quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == x.shape[:-1]
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantkv_indexing_and_zeros():
    kv = quant_cache_zeros((2, 8, 16, 4))
    assert kv.shape == (2, 8, 16, 4) and kv.dim() == 4
    assert kv.dtype == torch.int8 and kv.scale.shape == (2, 8, 4)
    page = kv[:, 3]
    assert isinstance(page, QuantKV)
    assert page.data.shape == (2, 16, 4) and page.scale.shape == (2, 4)


@pytest.mark.parametrize("page_size", [16, 32])
def test_write_to_pages_quantized_matches_jax(page_size):
    rng = np.random.RandomState(2)
    kv_heads, head_dim, b, t, num_pages = 2, 32, 3, 5, 12
    new_kv = rng.randn(b, t, kv_heads, head_dim).astype(np.float32)
    page_table = np.array([[3, 7, 0], [5, 0, 0], [9, 11, 2]], np.int32)
    positions = np.array([[6, 7, 8, 9, 10],
                          [0, 1, 2, 3, 4],
                          [page_size - 2, page_size - 1, page_size,
                           page_size + 1, page_size + 2]], np.int32)
    valid = np.ones((b, t), bool)
    valid[1, 3:] = False  # pad slots land on trash page 0
    # Start from a written cache, so slots the write leaves alone keep
    # their values and scales.
    data, scale = _quantized_pair(rng, kv_heads, num_pages, head_dim,
                                  page_size)
    expected = jax_write_to_pages(
        JaxQuantKV(_j(data), _j(scale)), _j(new_kv), _j(page_table),
        _j(positions), _j(valid))
    cache = QuantKV(_t(data.copy()), _t(scale.copy()))
    out = write_to_pages(cache, _t(new_kv), _t(page_table), _t(positions),
                         _t(valid))
    assert out is cache  # in place
    # Page 0 takes the pad slots: which of them wins is unspecified.
    np.testing.assert_array_equal(cache.data.numpy()[:, 1:],
                                  np.asarray(expected.data)[:, 1:])
    np.testing.assert_array_equal(cache.scale.numpy()[:, 1:],
                                  np.asarray(expected.scale)[:, 1:])


# ---- the plain versions against the Pallas kernels -----------------------


@pytest.mark.parametrize("page_size,dtype",
                         [(16, "f32"), (32, "f32"), (16, "bf16")])
def test_decode_plain_int8_matches_pallas_interpret(page_size, dtype):
    rng = np.random.RandomState(5)
    kv_lens = np.array([1, 0, 150, 300, 37], np.int32)
    max_pages = 300 // page_size + 2
    table, used = _page_table(kv_lens, page_size, max_pages)
    jk, jv, tk, tv = _caches(rng, 2, used + 1, 64, page_size)
    jq, tq = _query(rng, (len(kv_lens), 8, 64), dtype)
    expected = jax_paged_decode_attention(jq, jk, jv, _j(table),
                                          _j(kv_lens), interpret=True)
    got = paged_decode_attention_plain(tq, tk, tv, _t(table), _t(kv_lens))
    assert got.dtype == tq.dtype
    _close(_np32(got), _np32(expected), dtype)
    assert not got[kv_lens == 0].any()  # a pad row writes exact 0


@pytest.mark.parametrize("page_size,dtype",
                         [(16, "f32"), (32, "f32"), (32, "bf16")])
def test_prefill_plain_int8_matches_pallas_interpret(page_size, dtype):
    """A second prefill chunk: cached context before the chunk, a row
    whose chunk is shorter than T (pad slots at its tail), a pad row."""
    rng = np.random.RandomState(7)
    chunk = 24
    lengths = np.array([chunk, chunk - 7, 0], np.int32)
    starts = np.array([140, 37, 0], np.int32)
    kv_lens = np.where(lengths > 0, starts + lengths, 0).astype(np.int32)
    positions = np.zeros((3, chunk), np.int32)
    for i in range(3):
        if lengths[i]:
            positions[i] = starts[i] + np.arange(chunk)
    max_pages = 192 // page_size
    table, used = _page_table(kv_lens, page_size, max_pages)
    jk, jv, tk, tv = _caches(rng, 2, used + 1, 64, page_size)
    jq, tq = _query(rng, (3, chunk, 8, 64), dtype)
    expected = jax_paged_prefill_attention(
        jq, jk, jv, _j(table), _j(positions), _j(kv_lens), interpret=True)
    got = paged_prefill_attention_plain(tq, tk, tv, _t(table),
                                        _t(positions), _t(kv_lens))
    _close(_np32(got), _np32(expected), dtype)
    assert not got[kv_lens == 0].any()


@pytest.mark.parametrize("page_size,dtype",
                         [(16, "f32"), (32, "f32"), (16, "bf16")])
def test_ragged_plain_int8_matches_pallas_interpret(page_size, dtype):
    """A unified block: decode rows, a verify row, a short and a full
    chunk row, a row over several 128-token walk chunks and pad rows.
    Every slot is compared; dead slots and pad rows are exact 0."""
    rng = np.random.RandomState(11)
    w = 8
    kv_lens = np.array([20, 23, 13, 30, 0, 0, 200], np.int32)
    last_index = np.array([0, 3, 4, 7, 0, -1, 5], np.int32)
    draft_lens = np.array([0, 3, 0, 0, 0, 0, 0], np.int32)
    max_pages = 200 // page_size + 2
    table, used = _page_table(kv_lens, page_size, max_pages)
    jk, jv, tk, tv = _caches(rng, 2, used + 1, 64, page_size)
    jq, tq = _query(rng, (len(kv_lens), w, 8, 64), dtype)
    # The Pallas kernel takes a pad row's last_index as given; the
    # engine's -1 is its 0 (both describe no live slot).
    expected = jax_paged_ragged_attention(
        jq, jk, jv, _j(table), _j(kv_lens), _j(np.maximum(last_index, 0)),
        _j(draft_lens), interpret=True)
    got = paged_ragged_attention_plain(tq, tk, tv, _t(table), _t(kv_lens),
                                       _t(last_index), _t(draft_lens))
    _close(_np32(got), _np32(expected), dtype)
    live = ((np.arange(w)[None] <= last_index[:, None])
            & (kv_lens[:, None] > 0))
    assert not got[torch.from_numpy(~live)].any()


@pytest.mark.parametrize("page_size", [16, 32])
def test_paged_attention_int8_matches_jax(page_size):
    rng = np.random.RandomState(13)
    kv_lens = np.array([33, 17, 90], np.int32)
    t = 6
    positions = (kv_lens - t)[:, None] + np.arange(t, dtype=np.int32)
    table, used = _page_table(kv_lens, page_size, 96 // page_size + 1)
    jk, jv, tk, tv = _caches(rng, 2, used + 1, 32, page_size)
    q = rng.randn(3, t, 8, 32).astype(np.float32)
    expected = jax_paged_attention(_j(q), jk, jv, _j(table), _j(positions),
                                   _j(kv_lens))
    got = paged_attention(_t(q), tk, tv, _t(table), _t(positions),
                          _t(kv_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(expected),
                               **F32_TOL)
    # The plain page walk agrees with the gather reference.
    walk = paged_prefill_attention_plain(_t(q), tk, tv, _t(table),
                                         _t(positions), _t(kv_lens))
    np.testing.assert_allclose(walk.numpy(), got.numpy(), **F32_TOL)


def test_wrappers_take_the_int8_plain_version_for_cpu_tensors():
    rng = np.random.RandomState(17)
    kv_lens = np.array([5, 40], np.int32)
    table, used = _page_table(kv_lens, 16, 4)
    _, _, tk, tv = _caches(rng, 2, used + 1, 32, 16)
    q = _t(rng.randn(2, 4, 32).astype(np.float32))
    COUNTERS.reset()
    torch.testing.assert_close(
        paged_decode_attention(q, tk, tv, _t(table), _t(kv_lens)),
        paged_decode_attention_plain(q, tk, tv, _t(table), _t(kv_lens)),
        rtol=0, atol=0)
    qr = _t(rng.randn(2, 3, 4, 32).astype(np.float32))
    last = torch.tensor([0, 2], dtype=torch.int32)
    torch.testing.assert_close(
        paged_ragged_attention(qr, tk, tv, _t(table), _t(kv_lens), last),
        paged_ragged_attention_plain(qr, tk, tv, _t(table), _t(kv_lens),
                                     last), rtol=0, atol=0)
    assert COUNTERS.launches == {} and COUNTERS.plain_cuda_calls == {}


def test_quantkv_scales_are_checked():
    data = torch.zeros(2, 4, 32, 16, dtype=torch.int8)
    pt = torch.zeros(1, 2, dtype=torch.int32)
    ones = torch.ones(1, dtype=torch.int32)
    q = torch.zeros(1, 4, 32)
    for scale in (torch.zeros(2, 4, 16, dtype=torch.float16),
                  torch.zeros(2, 4, 8)):
        cache = QuantKV(data, scale)
        with pytest.raises(ValueError, match="scales"):
            paged_decode_attention(q, cache, cache, pt, ones)
    good = QuantKV(data, torch.zeros(2, 4, 16))
    with pytest.raises(ValueError, match="both"):
        paged_decode_attention(q, good, torch.zeros(2, 4, 32, 16), pt, ones)


# ---- the model forward ------------------------------------------------------


def test_forward_int8_matches_jax():
    """The tiny f32 llama with int8 KV over a prefill chunk, a decode
    step and a mixed block, the JAX forward's stacked QuantKV cache
    beside the port's per-layer QuantKVs."""
    from tests.test_torch_llama import KINDS, _configs, _params, _steps
    jax_cfg, port_cfg = _configs("plain")
    np_params = _params(jax_cfg, "plain")
    jax_params = {k: jnp.asarray(v) for k, v in np_params.items()}
    port_params = params_from_numpy(np_params, port_cfg, "cpu")
    layers, kv, d = (port_cfg.num_hidden_layers,
                     port_cfg.num_key_value_heads, port_cfg.head_dim)
    shape = (kv, 16, d, 16)
    jax_k = jax_quant_cache_zeros((layers,) + shape)
    jax_v = jax_quant_cache_zeros((layers,) + shape)
    port_k = [quant_cache_zeros(shape) for _ in range(layers)]
    port_v = [quant_cache_zeros(shape) for _ in range(layers)]
    jax_forward = jax.jit(
        lambda *args: jax_llama.forward(args[0], jax_cfg, *args[1:]))
    for name, step in _steps().items():
        valid = step[4]
        expected, jax_k, jax_v = jax_forward(
            jax_params, *(jnp.asarray(x) for x in step), jax_k, jax_v)
        got = llama.forward(port_params, port_cfg,
                            *(torch.from_numpy(x) for x in step),
                            port_k, port_v, kind=KINDS[name])
        np.testing.assert_allclose(got.numpy()[valid],
                                   np.asarray(expected)[valid], **F32_TOL,
                                   err_msg=name)
        # The quantized writes: the same int8 values and scales, up to
        # a rounding flip where the f32 K/V differ in their last bit.
        for layer in range(layers):
            for port, ref in ((port_k[layer], jax_k[layer]),
                              (port_v[layer], jax_v[layer])):
                np.testing.assert_allclose(
                    port.data.numpy()[:, 1:].astype(np.int32),
                    np.asarray(ref.data)[:, 1:].astype(np.int32), atol=1)
                np.testing.assert_allclose(
                    port.scale.numpy()[:, 1:],
                    np.asarray(ref.scale)[:, 1:], rtol=1e-5, atol=0)


# ---- the engine -------------------------------------------------------------


def _engine_config(cfg, kv_dtype="int8", num_pages=64, **sched_kw):
    """The JAX int8 tests' engine (tests/test_kv_quantization.py)."""
    return cfg.EngineConfig(
        model=cfg.tiny_model_config("llama"),
        cache=cfg.CacheConfig(page_size=16, num_pages=num_pages,
                              kv_cache_dtype=kv_dtype),
        scheduler=cfg.SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                      prefill_chunk_size=32, **sched_kw))


def _greedy(engine, sampling_cls, prompts, max_tokens=12):
    return [list(engine.generate(p, sampling_cls(
        temperature=0.0, max_tokens=max_tokens,
        ignore_eos=True)).output_token_ids) for p in prompts]


def _greedy_batch(engine, sampling_cls, prompts, max_tokens=12):
    """All prompts admitted at once: the long prompt's later chunks
    ride decode steps when the unified step is on."""
    return [list(s.output_token_ids) for s in engine.generate_batch(
        prompts, sampling_cls(temperature=0.0, max_tokens=max_tokens,
                              ignore_eos=True))]


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(21)).items()}


def _port_engine(weights, **kw):
    cfg = _engine_config(config, **kw)
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                   "cpu"), device="cpu")


@pytest.fixture(scope="module")
def jax_int8_streams(weights):
    """The JAX engine's int8 greedy streams, unified step off and on,
    the prompts of the JAX package's int8 tests admitted together."""
    params = {k: jnp.asarray(v) for k, v in weights.items()}
    return {unified: _greedy_batch(JaxEngine(_engine_config(
        jax_config, unified_step=unified), params=params),
        JaxSamplingParams, _prompts()) for unified in (False, True)}


@pytest.mark.parametrize("unified,async_on,spec_k", [
    (False, False, 0), (True, False, 0), (False, True, 0), (True, True, 0),
    (False, False, 3), (True, False, 3)])
def test_int8_greedy_streams_match_jax(weights, jax_int8_streams, unified,
                                       async_on, spec_k):
    engine = _port_engine(weights, unified_step=unified,
                          async_scheduling=async_on, speculative_k=spec_k)
    assert engine.runner.kv_quantized
    got = _greedy_batch(engine, SamplingParams, _prompts())
    assert got == jax_int8_streams[unified]
    if unified:
        assert engine.metrics.ragged_steps_total > 0
    if spec_k:
        assert engine.metrics.spec_draft_tokens_total > 0


def test_jax_int8_modes_agree(jax_int8_streams):
    """The reference itself: its bimodal and unified int8 streams
    agree, so each port mode is held to one stream."""
    assert jax_int8_streams[False] == jax_int8_streams[True]


def test_prefix_cache_hit_on_quantized_pages(weights):
    engine = _port_engine(weights)
    prompt = list(range(2, 66))  # 4 full pages => 3 cacheable
    first = _greedy(engine, SamplingParams, [prompt], max_tokens=8)
    hits = engine.cache_manager.prefix_hit_tokens
    second = _greedy(engine, SamplingParams, [prompt], max_tokens=8)
    assert engine.cache_manager.prefix_hit_tokens > hits
    assert second == first


def test_spec_decode_on_quantized_pages(weights):
    prompt = list(range(5, 25)) + list(range(5, 25))
    plain = _greedy(_port_engine(weights), SamplingParams, [prompt],
                    max_tokens=16)
    spec = _port_engine(weights, speculative_k=3)
    assert _greedy(spec, SamplingParams, [prompt], max_tokens=16) == plain
    assert spec.metrics.spec_draft_tokens_total > 0


# ---- config -----------------------------------------------------------------


@pytest.mark.parametrize("model,dtype,num_pages", [
    ("tiny", "float32", 64), ("tiny", "bfloat16", 1024),
    ("bench-1b", "bfloat16", 512)])
def test_page_budget_expansion_matches_jax(model, dtype, num_pages):
    pages = []
    for cfg in (jax_config, config):
        m = (cfg.tiny_model_config("llama") if model == "tiny"
             else cfg.bench_1b_model_config())
        m.dtype = dtype
        ec = cfg.EngineConfig(
            model=m, cache=cfg.CacheConfig(page_size=16,
                                           num_pages=num_pages,
                                           kv_cache_dtype="int8"),
            scheduler=cfg.SchedulerConfig(max_num_seqs=4,
                                          max_model_len=256))
        # dataclasses.replace does not expand a second time.
        assert dataclasses.replace(ec).cache.num_pages == ec.cache.num_pages
        pages.append(ec.cache.num_pages)
    assert pages[0] == pages[1] > num_pages
    if model == "bench-1b":
        assert pages[1] == 512 * 128 // 68 == 963


def test_kv_dtype_validation_and_slot_bytes():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        _engine_config(config, kv_dtype="fp8")
    full = _engine_config(config, kv_dtype="auto")
    assert full.cache.num_pages == 64
    assert full.cache.resolved_kv_dtype() == "bf16"
    model = config.tiny_model_config("llama")  # f32, d = 32
    int8 = config.CacheConfig(page_size=16, kv_cache_dtype="int8")
    assert int8.resolved_kv_dtype() == "int8"
    assert int8.kv_slot_bytes(model) == model.head_dim + 4
    assert int8.kv_bytes_per_token(model) == (
        2 * model.num_hidden_layers * model.num_key_value_heads
        * (model.head_dim + 4))
    assert config.CacheConfig().kv_slot_bytes(model) == model.head_dim * 4


# ---- server -----------------------------------------------------------------


def test_server_flag_and_metrics():
    assert parse_args(["--kv-cache-dtype", "int8"]).kv_cache_dtype == "int8"
    assert parse_args([]).kv_cache_dtype == "auto"
    server = make_server(["--model", "tiny-llama", "--device", "cpu",
                          "--host", "127.0.0.1", "--port", "0",
                          "--num-pages", "64", "--max-model-len", "256",
                          "--kv-cache-dtype", "int8"])
    try:
        engine = server.app.engine
        text = server.app.metrics()
    finally:
        server.server_close()
    cache = engine.config.cache
    assert cache.num_pages == 64 * 128 // 36 == 227
    assert engine.runner.kv_quantized
    assert 'vllm:engine_kv_cache_dtype{kv_dtype="int8"} 1.0' in text
    assert f"vllm:engine_kv_cache_page_capacity {226.0}" in text
    per_step = (engine.config.scheduler.max_num_seqs
                * cache.kv_bytes_per_token(engine.config.model))
    assert f"vllm:engine_kv_bytes_per_decode_step {float(per_step)}" in text


# ---- page-granular IO -------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_read_write_page_round_trip(weights, kv_dtype):
    """A page read after a prefill, written into another page and read
    back, is the same page; an int8 page travels as the JAX engine's
    4-tuple (int8 pages, f32 [L, kv, page_size] scales)."""
    engine = _port_engine(weights, kv_dtype=kv_dtype)
    seq = engine.generate(list(range(3, 40)), SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
    del seq
    m = engine.config.model
    runner = engine.runner
    page = runner.read_page(1)
    layers, kv, d, ps = (m.num_hidden_layers, m.num_key_value_heads,
                         m.head_dim, engine.config.cache.page_size)
    if kv_dtype == "int8":
        assert len(page) == 4
        assert [(a.dtype, a.shape) for a in page] == [
            (np.int8, (layers, kv, d, ps))] * 2 + [
            (np.float32, (layers, kv, ps))] * 2
        assert np.abs(page[0]).max() == 127  # written and quantized
    else:
        assert len(page) == 2
        assert [(a.dtype, a.shape) for a in page] == [
            (np.float32, (layers, kv, d, ps))] * 2
        assert np.abs(page[0]).max() > 0
    target = engine.config.cache.num_pages - 1
    runner.write_page(target, *page)
    for a, b in zip(runner.read_page(target), page):
        np.testing.assert_array_equal(a, b)
    if kv_dtype == "int8":
        with pytest.raises(ValueError, match="k_scale"):
            runner.write_page(target, page[0], page[1])


def test_int8_page_matches_the_jax_wire_format(weights):
    """The port's int8 page, written into the JAX engine's runner,
    reads back from it unchanged: the same wire shapes and dtypes."""
    engine = _port_engine(weights)
    engine.generate(list(range(3, 40)), SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
    page = engine.runner.read_page(2)
    ref = JaxEngine(_engine_config(jax_config),
                    params={k: jnp.asarray(v) for k, v in weights.items()})
    ref.runner.write_page(2, *page)
    wire = ref.runner.read_page(2)
    assert len(wire) == len(page) == 4
    for a, b in zip(wire, page):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
