"""The stacked [L, kv, pages, d, page] KV cache layout in the port,
against the JAX package's.

Inputs are made with numpy from a seed and go through both packages.
The JAX Pallas kernels run in interpret mode on the CPU with ``layer=``,
as the JAX package's own stacked-form tests run them
(``tests/test_pallas_attention.py``); the port's wrappers take their
plain versions for CPU tensors (the CUDA kernels' stacked forms are
held against those plain versions, and against their per-layer
launches, on the card by ``tests/test_torch_cuda_kernels.py`` and
``chip_smoke.py``).

Covered: the plain stacked form of each of the three kernels at L = 3,
layer 2, in f32, bf16 and int8, against the Pallas kernel, against
JAX's gather reference ``paged_attention(..., layer=)`` and, bitwise,
against the port's per-layer call on the layer's view; the rank/layer
contract; the in-place stacked write against JAX's; the tiny llama
forward over a stacked cache against JAX's and, bitwise, against the
per-layer layout; the engine's greedy streams with
``cache_layout="stacked"`` against the JAX engine's with the same
layout (unified off and on, async off and on, ``speculative_k`` 3, int8
KV) and against the port's per_layer streams; the runner's page read
and write in the stacked layout and its wire format; the ``auto``
layout and the refusal of an unknown one; the server's flag.

Tolerances: f32 outputs at atol = rtol = 1e-5 (the same f32 arithmetic,
sums in another order), 1e-4 over an int8 cache and on the model's
logits (as the port's other int8 and forward tests), bf16 outputs at
2e-2 compared in f32 (one bf16 rounding of values of order 1). The
gather reference is compared in f32 and int8 (its bf16 arithmetic
rounds elsewhere). Bitwise where the port meets itself, and on the
valid slots of the page writes; greedy streams exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
    SequenceState as JaxSequenceState,
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
)
from production_stack_tpu.ops.ragged_attention_pallas import (
    paged_ragged_attention as jax_paged_ragged_attention,
)
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    SequenceState,
)
from production_stack_tpu_torch.engine.server import (
    build_engine_from_args,
    parse_args,
)
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
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.quant_kv import (
    QuantKV,
    quant_cache_zeros,
)
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention,
    paged_ragged_attention_plain,
)
from tests.test_torch_engine import _MAX_TOKENS, _run_mixed
from tests.test_torch_kv_quantization import _quantized_pair

torch.set_num_threads(2)

LAYERS, LAYER = 3, 2
TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
       "int8": dict(rtol=1e-4, atol=1e-4),
       "bf16": dict(rtol=2e-2, atol=2e-2)}
PAGE_SIZE = 16


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


def _j(x):
    return None if x is None else jnp.asarray(np.asarray(x))


def _np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _stacked(rng, form, kv_heads, num_pages, head_dim):
    """(JAX k, v, port k, v): stacked [L, kv, pages, d, page] caches of
    the same content; int8 as QuantKVs quantized per (page, slot, kv
    head) row, as the page writes lay them out."""
    if form == "int8":
        pairs = [[_quantized_pair(rng, kv_heads, num_pages, head_dim,
                                  PAGE_SIZE) for _ in range(LAYERS)]
                 for _ in range(2)]
        data = [np.stack([p[0] for p in plane]) for plane in pairs]
        scale = [np.stack([p[1] for p in plane]) for plane in pairs]
        return (JaxQuantKV(_j(data[0]), _j(scale[0])),
                JaxQuantKV(_j(data[1]), _j(scale[1])),
                QuantKV(_t(data[0]), _t(scale[0])),
                QuantKV(_t(data[1]), _t(scale[1])))
    shape = (LAYERS, kv_heads, num_pages, head_dim, PAGE_SIZE)
    k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    if form == "bf16":
        return (_j(k).astype(jnp.bfloat16), _j(v).astype(jnp.bfloat16),
                _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16))
    return _j(k), _j(v), _t(k), _t(v)


def _query(rng, shape, form):
    """The same query bits for both packages (both round f32 to bf16 to
    nearest even); an int8 cache is read by an f32 query."""
    q = rng.randn(*shape).astype(np.float32)
    if form == "bf16":
        return _j(q).astype(jnp.bfloat16), _t(q).to(torch.bfloat16)
    return _j(q), _t(q)


def _page_table(kv_lens, max_pages):
    table = np.zeros((len(kv_lens), max_pages), np.int32)
    nxt = 1
    for i, n in enumerate(kv_lens):
        for j in range(-(-int(n) // PAGE_SIZE)):
            table[i, j] = nxt
            nxt += 1
    return table, nxt


def _case(kernel, form, seed):
    """One case of ``kernel`` over stacked caches: the JAX and port
    operands, the port's plain version, its wrapper, and which slots
    the gather reference is compared on."""
    rng = np.random.RandomState(seed)
    if kernel == "decode":
        kv_lens = np.array([1, 0, 150, 300, 37], np.int32)
        table, used = _page_table(kv_lens, 300 // PAGE_SIZE + 2)
        caches = _stacked(rng, form, 2, used + 1, 64)
        jq, tq = _query(rng, (len(kv_lens), 8, 64), form)
        positions = np.maximum(kv_lens - 1, 0)[:, None]
        live = kv_lens > 0
        return dict(
            caches=caches, jq=jq[:, None], tq=tq,
            pallas=lambda jk, jv: jax_paged_decode_attention(
                jq, jk, jv, _j(table), _j(kv_lens), layer=LAYER,
                interpret=True)[0][:, None],
            xla_args=(_j(table), _j(positions), _j(kv_lens)),
            port_args=(_t(table), _t(kv_lens)),
            plain=paged_decode_attention_plain,
            wrapper=paged_decode_attention,
            expand=lambda out: out[:, None], live=live[:, None])
    if kernel == "prefill":
        chunk = 24
        lengths = np.array([chunk, chunk - 7, 0], np.int32)
        starts = np.array([140, 37, 0], np.int32)
        kv_lens = np.where(lengths > 0, starts + lengths, 0).astype(np.int32)
        positions = np.zeros((3, chunk), np.int32)
        valid = np.zeros((3, chunk), bool)
        for i in range(3):
            if lengths[i]:
                positions[i] = starts[i] + np.arange(chunk)
                valid[i, :lengths[i]] = True
        table, used = _page_table(kv_lens, 192 // PAGE_SIZE)
        caches = _stacked(rng, form, 2, used + 1, 64)
        jq, tq = _query(rng, (3, chunk, 8, 64), form)
        return dict(
            caches=caches, jq=jq, tq=tq,
            pallas=lambda jk, jv: jax_paged_prefill_attention(
                jq, jk, jv, _j(table), _j(positions), _j(kv_lens),
                layer=LAYER, interpret=True)[0],
            xla_args=(_j(table), _j(positions), _j(kv_lens)),
            port_args=(_t(table), _t(positions), _t(kv_lens)),
            plain=paged_prefill_attention_plain,
            wrapper=paged_prefill_attention,
            expand=lambda out: out, live=valid)
    w = 8
    kv_lens = np.array([20, 23, 13, 30, 0, 0, 200], np.int32)
    last_index = np.array([0, 3, 4, 7, 0, -1, 5], np.int32)
    draft_lens = np.array([0, 3, 0, 0, 0, 0, 0], np.int32)
    table, used = _page_table(kv_lens, 200 // PAGE_SIZE + 2)
    caches = _stacked(rng, form, 2, used + 1, 64)
    jq, tq = _query(rng, (len(kv_lens), w, 8, 64), form)
    positions = np.maximum((kv_lens - 1 - last_index)[:, None]
                           + np.arange(w)[None], 0).astype(np.int32)
    live = ((np.arange(w)[None] <= last_index[:, None])
            & (kv_lens[:, None] > 0))
    # The Pallas kernel takes a pad row's last_index as given; the
    # engine's -1 is its 0 (both describe no live slot).
    return dict(
        caches=caches, jq=jq, tq=tq,
        pallas=lambda jk, jv: jax_paged_ragged_attention(
            jq, jk, jv, _j(table), _j(kv_lens),
            _j(np.maximum(last_index, 0)), _j(draft_lens), layer=LAYER,
            interpret=True)[0],
        xla_args=(_j(table), _j(positions), _j(kv_lens)),
        port_args=(_t(table), _t(kv_lens), _t(last_index),
                   _t(draft_lens)),
        plain=paged_ragged_attention_plain,
        wrapper=paged_ragged_attention,
        expand=lambda out: out, live=live)


# ---- the three page walks in the stacked form ------------------------------


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("kernel", ["decode", "prefill", "ragged"])
def test_stacked_plain_matches_pallas_and_per_layer(kernel, form):
    c = _case(kernel, form, {"decode": 5, "prefill": 7, "ragged": 11}[kernel])
    jk, jv, tk, tv = c["caches"]
    got = c["plain"](c["tq"], tk, tv, *c["port_args"], layer=LAYER)
    assert got.dtype == c["tq"].dtype
    # The Pallas kernel in interpret mode, every slot.
    np.testing.assert_allclose(_np32(c["expand"](got)),
                               _np32(c["pallas"](jk, jv)), **TOL[form])
    # Bitwise the per-layer walk over the layer's view.
    assert torch.equal(got, c["plain"](c["tq"], tk[LAYER], tv[LAYER],
                                       *c["port_args"]))
    # The wrapper takes the plain version for CPU tensors, and counts
    # nothing.
    COUNTERS.reset()
    assert torch.equal(got, c["wrapper"](c["tq"], tk, tv, *c["port_args"],
                                         layer=LAYER))
    assert COUNTERS.launches == {} and COUNTERS.plain_cuda_calls == {}
    if form == "bf16":
        return
    # JAX's gather reference at the same layer, on the live slots.
    expected = jax_paged_attention(c["jq"], jk, jv, *c["xla_args"],
                                   layer=LAYER)
    live = c["live"]
    np.testing.assert_allclose(_np32(c["expand"](got))[live],
                               _np32(expected)[live], **TOL[form])
    port_xla = paged_attention(c["expand"](c["tq"]) if kernel == "decode"
                               else c["tq"], tk, tv,
                               *(_t(np.asarray(x)) for x in c["xla_args"]),
                               layer=LAYER)
    np.testing.assert_allclose(_np32(port_xla)[live],
                               _np32(expected)[live], **TOL[form])


@pytest.mark.parametrize("form", ["f32", "int8"])
def test_layer_and_cache_rank_must_agree(form):
    """Every writer and reader refuses a stacked cache without its
    layer index, a per-layer cache with one, and a layer outside the
    stack, with JAX's message."""
    c = _case("decode", form, 3)
    _, _, tk, tv = c["caches"]
    q, (table, lens) = c["tq"], c["port_args"]
    rank = pytest.raises(ValueError, match="layer index and cache rank")
    for fn in (paged_decode_attention, paged_decode_attention_plain):
        with rank:
            fn(q, tk, tv, table, lens)
        with rank:
            fn(q, tk[0], tv[0], table, lens, layer=0)
        for layer in (LAYERS, -1):
            with pytest.raises(ValueError, match="outside"):
                fn(q, tk, tv, table, lens, layer=layer)
    positions = torch.zeros((len(lens), 1), dtype=torch.int32)
    valid = torch.ones((len(lens), 1), dtype=torch.bool)
    new = torch.zeros((len(lens), 1, 2, 64))
    with rank:
        write_to_pages(tk, new, table, positions, valid)
    with rank:
        write_to_pages(tk[0], new, table, positions, valid, layer=1)
    with rank:
        paged_attention(q[:, None], tk, tv, table, positions, lens)
    with rank:
        paged_prefill_attention(q[:, None], tk[0], tv[0], table,
                                positions, lens, layer=0)
    with rank:
        paged_ragged_attention(q[:, None], tk, tv, table, lens,
                               torch.zeros_like(lens))


# ---- the in-place stacked write ---------------------------------------------


@pytest.mark.parametrize("form", ["f32", "bf16", "int8"])
def test_stacked_write_matches_jax_in_place(form):
    """``write_to_pages(..., layer=)`` scatters into the stacked cache
    IN PLACE: the same storage (no copy of the L layers), the other
    layers untouched, and the layer's valid slots bit-identical to
    JAX's."""
    rng = np.random.RandomState(2)
    kv_heads, head_dim, b, t, num_pages = 2, 64, 3, 5, 12
    new_kv = rng.randn(b, t, kv_heads, head_dim).astype(np.float32)
    page_table = np.array([[3, 7, 0], [5, 0, 0], [9, 11, 2]], np.int32)
    positions = np.array([[6, 7, 8, 9, 10], [0, 1, 2, 3, 4],
                          [14, 15, 16, 17, 18]], np.int32)
    valid = np.ones((b, t), bool)
    valid[1, 3:] = False  # pad slots land on trash page 0
    jk, _, tk, _ = _stacked(rng, form, kv_heads, num_pages, head_dim)
    new_t = _t(new_kv).to(torch.bfloat16) if form == "bf16" else _t(new_kv)
    new_j = (_j(new_kv).astype(jnp.bfloat16) if form == "bf16"
             else _j(new_kv))
    expected = jax_write_to_pages(jk, new_j, _j(page_table), _j(positions),
                                  _j(valid), layer=LAYER)
    leaves = ((tk.data, tk.scale) if form == "int8" else (tk,))
    before = [leaf.clone() for leaf in leaves]
    ptrs = [leaf.data_ptr() for leaf in leaves]
    out = write_to_pages(tk, new_t, _t(page_table), _t(positions),
                         _t(valid), layer=LAYER)
    assert out is tk
    assert [leaf.data_ptr() for leaf in leaves] == ptrs
    ref_leaves = ((expected.data, expected.scale) if form == "int8"
                  else (expected,))
    for leaf, old, ref in zip(leaves, before, ref_leaves):
        others = [i for i in range(LAYERS) if i != LAYER]
        assert torch.equal(leaf[others], old[others])
        # Page 0 takes the pad slots: which of them wins is unspecified.
        np.testing.assert_array_equal(_np32(leaf[LAYER])[:, 1:],
                                      _np32(ref[LAYER])[:, 1:])


# ---- the model forward ------------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_forward_stacked_matches_jax_and_per_layer(kv_dtype):
    """The tiny f32 llama over a stacked cache: a prefill chunk, a
    decode step and a mixed block against the JAX forward over its
    stacked cache, and bitwise against the port's per_layer layout."""
    from tests.test_torch_llama import KINDS, _configs, _params, _steps
    jax_cfg, port_cfg = _configs("plain")
    np_params = _params(jax_cfg, "plain")
    jax_params = {k: jnp.asarray(v) for k, v in np_params.items()}
    port_params = params_from_numpy(np_params, port_cfg, "cpu")
    layers, kv, d = (port_cfg.num_hidden_layers,
                     port_cfg.num_key_value_heads, port_cfg.head_dim)
    shape = (kv, 16, d, PAGE_SIZE)
    if kv_dtype == "int8":
        jax_k, jax_v = (jax_quant_cache_zeros((layers,) + shape)
                        for _ in range(2))
        stacked = [quant_cache_zeros((layers,) + shape) for _ in range(2)]
        per_layer = [[quant_cache_zeros(shape) for _ in range(layers)]
                     for _ in range(2)]
    else:
        jax_k, jax_v = (jnp.zeros((layers,) + shape, jnp.float32)
                        for _ in range(2))
        stacked = [torch.zeros((layers,) + shape) for _ in range(2)]
        per_layer = [[torch.zeros(shape) for _ in range(layers)]
                     for _ in range(2)]
    jax_forward = jax.jit(
        lambda *args: jax_llama.forward(args[0], jax_cfg, *args[1:]))
    for name, step in _steps().items():
        valid = step[4]
        expected, jax_k, jax_v = jax_forward(
            jax_params, *(jnp.asarray(x) for x in step), jax_k, jax_v)
        got = llama.forward(port_params, port_cfg,
                            *(torch.from_numpy(x) for x in step),
                            *stacked, kind=KINDS[name])
        ref = llama.forward(port_params, port_cfg,
                            *(torch.from_numpy(x) for x in step),
                            *per_layer, kind=KINDS[name])
        assert torch.equal(got, ref), name
        np.testing.assert_allclose(got.numpy()[valid],
                                   np.asarray(expected)[valid],
                                   **TOL["int8"], err_msg=name)


# ---- the engine -------------------------------------------------------------


def _config(cfg, layout="stacked", unified=False, async_on=False,
            spec_k=0, kv_dtype="auto"):
    return cfg.EngineConfig(
        model=cfg.tiny_model_config("llama"),
        cache=cfg.CacheConfig(page_size=16, num_pages=128,
                              cache_layout=layout, kv_cache_dtype=kv_dtype),
        scheduler=cfg.SchedulerConfig(
            max_num_seqs=4, max_model_len=256, prefill_chunk_size=32,
            unified_step=unified, async_scheduling=async_on,
            speculative_k=spec_k))


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _port_engine(weights, **kw):
    cfg = _config(config, **kw)
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                   "cpu"), device="cpu")


# mode -> (unified, async, speculative_k, kv dtype); each port mode is
# held to the JAX engine's stream of the same (unified, spec, kv dtype)
# with the stacked layout (JAX runs synchronously: its async pipeline
# is byte-identical to its sync loop).
MODES = {
    "bimodal": (False, False, 0, "auto"),
    "unified": (True, False, 0, "auto"),
    "bimodal_async": (False, True, 0, "auto"),
    "unified_async": (True, True, 0, "auto"),
    "spec3": (False, False, 3, "auto"),
    "int8": (False, False, 0, "int8"),
    "int8_unified_async": (True, True, 0, "int8"),
}


@pytest.fixture(scope="module")
def jax_stacked_streams(weights):
    params = {k: jnp.asarray(v) for k, v in weights.items()}
    streams = {}
    for unified, _, spec_k, kv_dtype in MODES.values():
        key = (unified, spec_k, kv_dtype)
        if key not in streams:
            engine = JaxEngine(_config(jax_config, "stacked", unified,
                                       False, spec_k, kv_dtype),
                               params=params)
            assert engine.runner.cache_layout == "stacked"
            streams[key] = _run_mixed(engine, JaxSamplingParams,
                                      JaxSequenceState.FINISHED)
    return streams


@pytest.mark.parametrize("mode", sorted(MODES))
def test_stacked_greedy_streams_match_jax(weights, jax_stacked_streams,
                                          mode):
    unified, async_on, spec_k, kv_dtype = MODES[mode]
    engine = _port_engine(weights, unified=unified, async_on=async_on,
                          spec_k=spec_k, kv_dtype=kv_dtype)
    assert engine.runner.cache_layout == "stacked"
    assert not isinstance(engine.runner.k_cache, list)
    got = _run_mixed(engine, SamplingParams, SequenceState.FINISHED)
    assert got == jax_stacked_streams[(unified, spec_k, kv_dtype)]
    assert [len(t) for t in got] == _MAX_TOKENS
    if unified:
        assert engine.metrics.ragged_steps_total > 0
    if spec_k:
        assert engine.metrics.spec_draft_tokens_total > 0


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_stacked_matches_per_layer(weights, kv_dtype):
    """Within the port the layout changes buffer granularity, not
    arithmetic: the same streams, and the same cached pages."""
    runs = {}
    for layout in ("stacked", "per_layer"):
        engine = _port_engine(weights, layout=layout, unified=True,
                              async_on=True, kv_dtype=kv_dtype)
        runs[layout] = (_run_mixed(engine, SamplingParams,
                                   SequenceState.FINISHED),
                        [engine.runner.read_page(p) for p in (1, 5, 9)])
    assert runs["stacked"][0] == runs["per_layer"][0]
    for a, b in zip(runs["stacked"][1], runs["per_layer"][1]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_stacked_page_round_trip_and_wire_format(weights, kv_dtype):
    """A page of the stacked layout reads as [L, kv, d, page] (int8: the
    4-tuple with f32 [L, kv, page] scales), writes back into another
    page in place, and travels unchanged through the JAX stacked
    runner's write_page/read_page."""
    engine = _port_engine(weights, kv_dtype=kv_dtype)
    engine.generate(list(range(3, 40)), SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
    runner = engine.runner
    m = engine.config.model
    layers, kv, d = (m.num_hidden_layers, m.num_key_value_heads,
                     m.head_dim)
    page = runner.read_page(2)
    shapes = [(layers, kv, d, PAGE_SIZE)] * 2
    if kv_dtype == "int8":
        shapes += [(layers, kv, PAGE_SIZE)] * 2
    assert [tuple(a.shape) for a in page] == shapes
    assert page[0].abs().max() > 0
    ptr = runner.k_cache.data_ptr() if kv_dtype == "auto" else (
        runner.k_cache.data.data_ptr())
    target = engine.config.cache.num_pages - 1
    runner.write_page(target, *page)
    for a, b in zip(runner.read_page(target), page):
        assert torch.equal(a, b)
    assert ptr == (runner.k_cache.data_ptr() if kv_dtype == "auto"
                   else runner.k_cache.data.data_ptr())
    ref = JaxEngine(_config(jax_config, kv_dtype=kv_dtype),
                    params={k: jnp.asarray(v) for k, v in weights.items()})
    ref.runner.write_page(2, *[a.numpy() for a in page])
    wire = ref.runner.read_page(2)
    assert len(wire) == len(page)
    for a, b in zip(wire, page):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape) and a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("layout", ["per_layer", "stacked"])
@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_read_page_is_a_copy_not_a_view(weights, kv_dtype, layout):
    """A page read on the CPU is a copy of the cache's bytes: writing
    another page into its slot, as a reused slot is written, leaves
    what was read unchanged (exact). A stacked page used to be a view of
    the cache, so a host pool holding it changed with the slot, and a
    preempted victim restored from the pool read another row's KV."""
    engine = _port_engine(weights, kv_dtype=kv_dtype, layout=layout)
    engine.generate(list(range(3, 60)), SamplingParams(
        temperature=0.0, max_tokens=2, ignore_eos=True))
    runner = engine.runner
    page = runner.read_page(0)
    kept = [t.clone() for t in page]
    other = runner.read_page(2)
    assert any(not torch.equal(a, b) for a, b in zip(page, other))
    runner.write_page(0, *other)
    for a, b in zip(runner.read_page(0), other):
        assert torch.equal(a, b)
    for a, b in zip(page, kept):
        assert torch.equal(a, b)


# ---- config and server ------------------------------------------------------


def test_auto_layout_resolves_per_layer_and_unknown_raises():
    engine = LLMEngine(_config(config, layout="auto"), device="cpu")
    assert engine.config.cache.cache_layout == "per_layer"
    assert engine.runner.cache_layout == "per_layer"
    assert isinstance(engine.runner.k_cache, list)
    with pytest.raises(ValueError, match="cache_layout"):
        LLMEngine(_config(config, layout="bogus"), device="cpu")


def test_server_cache_layout_flag():
    base = ["--model", "tiny-llama", "--device", "cpu"]
    assert parse_args(base).cache_layout == "auto"
    for layout, resolved in (("stacked", "stacked"),
                             ("per_layer", "per_layer"),
                             ("auto", "per_layer")):
        engine, _ = build_engine_from_args(
            parse_args(base + ["--cache-layout", layout]))
        assert engine.runner.cache_layout == resolved
    with pytest.raises(SystemExit):
        parse_args(base + ["--cache-layout", "bogus"])
