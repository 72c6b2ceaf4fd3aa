"""The port at the query groups, head dims and dtypes the JAX engine
serves, against the JAX package.

Inputs are made with numpy from a seed and go through both packages.
The JAX Pallas kernels run in interpret mode on the CPU, as the JAX
package's own tests run them, and its XLA reference beside them; the
port's wrappers take their plain versions for CPU tensors (the CUDA
kernels are held against those plain versions at every point of this
grid on the card by ``chip_smoke.py``'s geometries phase).

Covered: the three plain page walks (decode, prefill, ragged) per
layer, stacked and over an int8 cache, at query groups 3, 6, 8 and 16,
head_dim 80 and 128, in f16, bf16 and f32; greedy streams of the port's
engine against the JAX engine's at tiny widths (two layers): a llama at
group 8, head_dim 128 (bf16), an OPT at head_dim 80 (f16) and a qwen2
at group 7, head_dim 64 (f32); and the start-up rule
(``kernel_geometry_supported``) over published configurations.

Tolerances: f32 outputs at atol = rtol = 1e-4 (the same f32 arithmetic,
sums in another order: the port walks 128-token chunks, the Pallas
kernels 2- or 4-page chunks, the XLA reference one softmax); bf16 and
f16 outputs at atol = rtol = 2e-2, compared in f32 (the inputs carry
the type's rounding; each side rounds its output once). Greedy
streams: f32 byte-identical; bf16 and f16 byte-identical or parting
only where the JAX engine's own margin between its token and the
port's is under ``NEAR_TIE_LOGITS`` (0.125, chip_smoke.py's rule),
printed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine.engine import LLMEngine as JaxEngine
from production_stack_tpu.engine.sequence import (
    SamplingParams as JaxSamplingParams,
)
from production_stack_tpu.models import registry as jax_registry
from production_stack_tpu.ops.attention import (
    paged_attention as jax_paged_attention,
)
from production_stack_tpu.ops.paged_attention_pallas import (
    paged_decode_attention as jax_paged_decode_attention,
)
from production_stack_tpu.ops.prefill_attention_pallas import (
    paged_prefill_attention as jax_paged_prefill_attention,
)
from production_stack_tpu.ops.quant_kv import QuantKV as JaxQuantKV
from production_stack_tpu.ops.quant_kv import quantize_kv as jax_quantize_kv
from production_stack_tpu.ops.ragged_attention_pallas import (
    paged_ragged_attention as jax_paged_ragged_attention,
)
from production_stack_tpu_torch.engine import config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    decode_group_tile,
    paged_decode_attention_plain,
)
from production_stack_tpu_torch.ops.paged_kv_common import (
    KERNEL_HEAD_DIM_TILES,
    kernel_geometry_refusal,
    kernel_geometry_supported,
)
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.quant_kv import QuantKV
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention_plain,
)

torch.set_num_threads(2)

F32_TOL = dict(rtol=1e-4, atol=1e-4)
HALF_TOL = dict(rtol=2e-2, atol=2e-2)
NEAR_TIE_LOGITS = 0.125
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}
# (query group, head_dim, dtype): every group of 3, 6, 8, 16, both new
# head dims and all three dtypes, each at least twice.
POINTS = [(3, 80, "f16"), (6, 128, "bf16"), (8, 128, "f32"),
          (16, 80, "bf16"), (8, 80, "f16"), (3, 128, "f32"),
          (16, 128, "f16"), (6, 80, "f32")]
# The stacked and int8 forms at three points each: together every group,
# head_dim and dtype again.
FORM_POINTS = ([(g, d, t, "plain") for g, d, t in POINTS]
               + [(3, 80, "f16", "stacked"), (6, 128, "bf16", "stacked"),
                  (8, 128, "f32", "stacked"), (16, 80, "bf16", "int8"),
                  (8, 80, "f16", "int8"), (6, 128, "f32", "int8")])
FORM_IDS = [f"g{g}-d{d}-{t}-{f}" for g, d, t, f in FORM_POINTS]
KV_HEADS, PAGE = 2, 16


def _ids(points):
    return [f"g{g}-d{d}-{t}" for g, d, t in points]


def _j(x, dtype="f32"):
    """numpy f32 -> a JAX array in ``dtype`` (the same rounding to
    nearest even as torch's)."""
    return jnp.asarray(np.asarray(x, np.float32)).astype(DTYPES[dtype][1])


def _t(x, dtype="f32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(DTYPES[dtype][0])


def _i(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, expected, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(jnp.asarray(expected, jnp.float32)),
        **(F32_TOL if dtype == "f32" else HALF_TOL))


def _table(kv_lens, max_pages):
    """Distinct pages per row from page 1 on (page 0 is the trash
    page); returns the table and the pages used."""
    table = np.zeros((len(kv_lens), max_pages), np.int32)
    nxt = 1
    for i, n in enumerate(kv_lens):
        for j in range(-(-int(n) // PAGE)):
            table[i, j] = nxt
            nxt += 1
    return table, nxt


def _caches(rng, pages, d, form, dtype):
    """(JAX k, v, port k, v) of the same content: ``form`` "plain" in
    ``dtype``, "int8" quantized per (page, slot, kv head) row, or
    "stacked" as layer 1 of a [2, ...] stack."""
    def one():
        return rng.randn(KV_HEADS, pages, d, PAGE).astype(np.float32)
    if form == "int8":
        out = []
        for _ in range(2):
            q8, scale = jax_quantize_kv(jnp.transpose(_j(one()), (0, 1, 3,
                                                                  2)))
            data = np.asarray(jnp.transpose(q8, (0, 1, 3, 2)))
            out.append((data, np.asarray(scale)))
        return (JaxQuantKV(jnp.asarray(out[0][0]), jnp.asarray(out[0][1])),
                JaxQuantKV(jnp.asarray(out[1][0]), jnp.asarray(out[1][1])),
                QuantKV(_i(out[0][0]), _i(out[0][1])),
                QuantKV(_i(out[1][0]), _i(out[1][1])))
    k, v = one(), one()
    if form == "stacked":
        k = np.stack([one(), k])
        v = np.stack([one(), v])
    return _j(k, dtype), _j(v, dtype), _t(k, dtype), _t(v, dtype)


def _layer(form):
    return {"layer": 1} if form == "stacked" else {}


def _first(out):
    """The JAX stacked form returns (out, k, v)."""
    return out[0] if isinstance(out, tuple) else out


# ---- the plain page walks against the Pallas kernels and XLA -------------


@pytest.mark.parametrize("group,d,dtype,form", FORM_POINTS, ids=FORM_IDS)
def test_decode_plain_matches_pallas_interpret(group, d, dtype, form):
    """Rows past one and two 128-token chunks, a one-token row and a
    pad row; a pad row writes exact 0."""
    rng = np.random.RandomState(group * 1000 + d)
    kv_lens = np.array([130, 0, 1, 300], np.int32)
    table, used = _table(kv_lens, 20)
    jk, jv, tk, tv = _caches(rng, used + 1, d, form, dtype)
    q = rng.randn(4, KV_HEADS * group, d)
    expected = _first(jax_paged_decode_attention(
        _j(q, dtype), jk, jv, jnp.asarray(table), jnp.asarray(kv_lens),
        interpret=True, **_layer(form)))
    got = paged_decode_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                       _i(kv_lens), **_layer(form))
    assert got.dtype == DTYPES[dtype][0]
    _close(got, expected, dtype)
    assert not got[1].any()


@pytest.mark.parametrize("group,d,dtype,form", FORM_POINTS, ids=FORM_IDS)
def test_prefill_plain_matches_pallas_interpret(group, d, dtype, form):
    """A second chunk past the 128-token edge, a shorter chunk (pad
    slots at its tail) and a pad row."""
    rng = np.random.RandomState(group * 1000 + d + 1)
    chunk = 16
    lengths = np.array([chunk, chunk - 5, 0], np.int32)
    starts = np.array([120, 37, 0], np.int32)
    kv_lens = np.where(lengths > 0, starts + lengths, 0).astype(np.int32)
    positions = np.zeros((3, chunk), np.int32)
    for i in range(3):
        if lengths[i]:
            positions[i] = starts[i] + np.arange(chunk)
    table, used = _table(kv_lens, 12)
    jk, jv, tk, tv = _caches(rng, used + 1, d, form, dtype)
    q = rng.randn(3, chunk, KV_HEADS * group, d)
    expected = _first(jax_paged_prefill_attention(
        _j(q, dtype), jk, jv, jnp.asarray(table), jnp.asarray(positions),
        jnp.asarray(kv_lens), interpret=True, **_layer(form)))
    got = paged_prefill_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                        _i(positions), _i(kv_lens),
                                        **_layer(form))
    _close(got, expected, dtype)
    assert not got[2].any()


@pytest.mark.parametrize("group,d,dtype,form", FORM_POINTS, ids=FORM_IDS)
def test_ragged_plain_matches_pallas_interpret(group, d, dtype, form):
    """A decode row, a verify row, a chunk row past the 128-token edge
    and a pad row; dead slots and the pad row are exact 0. The port's
    plain version with the tensor-core walk's rounding for 16-bit
    queries (``p_dtype``), as the card's kernel rounds."""
    rng = np.random.RandomState(group * 1000 + d + 2)
    w = 6
    kv_lens = np.array([40, 23, 140, 0], np.int32)
    last_index = np.array([0, 3, 5, -1], np.int32)
    table, used = _table(kv_lens, 12)
    jk, jv, tk, tv = _caches(rng, used + 1, d, form, dtype)
    q = rng.randn(4, w, KV_HEADS * group, d)
    expected = _first(jax_paged_ragged_attention(
        _j(q, dtype), jk, jv, jnp.asarray(table), jnp.asarray(kv_lens),
        jnp.asarray(np.maximum(last_index, 0)), interpret=True,
        **_layer(form)))
    p16 = {} if dtype == "f32" else {"p_dtype": DTYPES[dtype][0]}
    got = paged_ragged_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                       _i(kv_lens), _i(last_index),
                                       **_layer(form), **p16)
    _close(got, expected, dtype)
    live = ((np.arange(w)[None] <= last_index[:, None])
            & (kv_lens[:, None] > 0))
    assert not got[torch.from_numpy(~live)].any()


@pytest.mark.parametrize("group,d,dtype", POINTS[:4], ids=_ids(POINTS[:4]))
def test_prefill_plain_matches_xla(group, d, dtype):
    """The XLA reference (one softmax over the gathered pages) on the
    live slots."""
    rng = np.random.RandomState(group * 1000 + d + 3)
    chunk = 12
    kv_lens = np.array([140, 12], np.int32)
    positions = (kv_lens - chunk)[:, None] + np.arange(chunk,
                                                      dtype=np.int32)
    table, used = _table(kv_lens, 12)
    jk, jv, tk, tv = _caches(rng, used + 1, d, "plain", dtype)
    q = rng.randn(2, chunk, KV_HEADS * group, d)
    expected = jax_paged_attention(_j(q, dtype), jk, jv, jnp.asarray(table),
                                   jnp.asarray(positions),
                                   jnp.asarray(kv_lens))
    got = paged_prefill_attention_plain(_t(q, dtype), tk, tv, _i(table),
                                        _i(positions), _i(kv_lens))
    _close(got, expected, dtype)


# ---- greedy streams against the JAX engine --------------------------------

# (label, architecture, q heads, kv heads, head_dim, hidden, dtype).
ENGINES = [("llama-g8-d128-bf16", "llama", 8, 1, 128, 128, "bfloat16"),
           ("opt-d80-f16", "opt", 2, 2, 80, 160, "float16"),
           ("qwen2-g7-d64-f32", "qwen2", 7, 1, 64, 128, "float32")]


def _model(cls, arch, nh, nkv, d, hidden, dtype):
    return cls(name=f"tiny-{arch}", architecture=arch, vocab_size=512,
               hidden_size=hidden, intermediate_size=192,
               num_hidden_layers=2, num_attention_heads=nh,
               num_key_value_heads=nkv, head_dim=d,
               max_position_embeddings=512,
               attention_bias=arch == "qwen2",
               activation="relu" if arch == "opt" else "silu",
               dtype=dtype)


def _engine_config(cfg, model):
    return cfg.EngineConfig(
        model=model,
        cache=cfg.CacheConfig(page_size=PAGE, num_pages=64),
        scheduler=cfg.SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                      prefill_chunk_size=32))


def _prompts():
    rng = np.random.RandomState(8)
    return [rng.randint(1, 500, size=n).tolist() for n in (5, 17, 40, 70)]


def _near_tie(engine, context, got_token):
    """The JAX engine's margin (its best logprob minus its logprob of
    ``got_token``) at the token after ``context``."""
    sid = engine.add_request(list(context), JaxSamplingParams(
        temperature=0.0, max_tokens=1, logprobs=True, top_logprobs=20,
        ignore_eos=True))
    entry = None
    while entry is None:
        for out in engine.step():
            if out.seq_id == sid and out.logprobs is not None:
                entry = out.logprobs
    while engine.has_work():
        engine.step()
    tops = dict(entry[1])
    return max(tops.values()) - tops.get(got_token, float("-inf"))


@pytest.mark.parametrize("label,arch,nh,nkv,d,hidden,dtype", ENGINES,
                         ids=[e[0] for e in ENGINES])
def test_greedy_streams_match_jax(label, arch, nh, nkv, d, hidden, dtype):
    jax_model = _model(jax_config.ModelConfig, arch, nh, nkv, d, hidden,
                       dtype)
    port_model = _model(config.ModelConfig, arch, nh, nkv, d, hidden, dtype)
    assert port_model.head_dim == d and jax_model.head_dim == d
    init, _ = jax_registry.get_model(jax_model)
    weights = {k: np.asarray(v, np.float32) for k, v in init(
        jax_model, jax.random.PRNGKey(17)).items()}
    rng = np.random.RandomState(9)
    for name, v in weights.items():
        if name.startswith("b") or name.endswith("_b"):
            weights[name] = (0.05 * rng.randn(*v.shape)).astype(np.float32)
    jax_params = {k: jnp.asarray(v).astype(jax_model.jax_dtype)
                  for k, v in weights.items()}
    ref_engine = JaxEngine(_engine_config(jax_config, jax_model),
                           params=jax_params)
    port = LLMEngine(_engine_config(config, port_model),
                     params=params_from_numpy(weights, port_model, "cpu"),
                     device="cpu")
    prompts = _prompts()
    sp = dict(temperature=0.0, max_tokens=12, ignore_eos=True)
    ref = [list(s.output_token_ids) for s in ref_engine.generate_batch(
        prompts, JaxSamplingParams(**sp))]
    got = [list(s.output_token_ids) for s in port.generate_batch(
        prompts, SamplingParams(**sp))]
    if dtype == "float32":
        assert got == ref
        return
    for i, (r, g) in enumerate(zip(ref, got)):
        assert len(g) == len(r)
        flip = next((j for j, (x, y) in enumerate(zip(r, g)) if x != y),
                    None)
        if flip is None:
            continue
        margin = _near_tie(ref_engine, prompts[i] + r[:flip], g[flip])
        print(f"{label}: stream {i} parts at token {flip}, JAX margin "
              f"{margin:.4f}")
        assert margin < NEAR_TIE_LOGITS, (label, i, flip, margin)


# ---- the start-up rule over published configurations ----------------------

# (source config.json, q heads, kv heads, head_dim): the public
# checkpoints the kernels serve since the rule replaced the fixed list.
PUBLISHED = [
    ("meta-llama/Llama-2-7b-hf", 32, 32, 128),
    ("meta-llama/Llama-2-13b-hf", 40, 40, 128),
    ("facebook/opt-6.7b", 32, 32, 128),
    ("facebook/opt-13b", 40, 40, 128),
    ("facebook/opt-30b", 56, 56, 128),
    ("facebook/opt-66b", 72, 72, 128),
    ("meta-llama/Llama-3.2-3B", 24, 8, 128),
    ("TinyLlama/TinyLlama-1.1B-Chat-v1.0", 32, 4, 64),
    ("Qwen/Qwen2-0.5B", 14, 2, 64),
    ("Qwen/Qwen2-1.5B", 12, 2, 128),
    ("Qwen/Qwen2.5-14B", 40, 8, 128),
    ("Qwen/Qwen2.5-32B", 40, 8, 128),
    ("meta-llama/Meta-Llama-3-70B", 64, 8, 128),
    ("meta-llama/Llama-2-70b-hf", 64, 8, 128),
    ("Qwen/Qwen2-72B", 64, 8, 128),
    ("facebook/opt-2.7b", 32, 32, 80),
    ("meta-llama/Llama-3.1-405B", 128, 8, 128),
]


@pytest.mark.parametrize("source,nh,nkv,d", PUBLISHED,
                         ids=[p[0] for p in PUBLISHED])
def test_published_configs_are_served(source, nh, nkv, d):
    """Every dtype the server takes, over a cache of the same type and
    over int8, at the checkpoint's group and head_dim; the decode
    kernel's group tile holds at most 8 heads and at most 4 above
    head_dim 64."""
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        for cache in (dtype, torch.int8):
            assert kernel_geometry_supported(dtype, cache, nh // nkv, d), (
                source, dtype, cache)
    tile = decode_group_tile(nh // nkv, d)
    assert tile in (1, 4, 8) and (tile <= 4 or d <= 64)
    assert tile >= min(nh // nkv, 4)


@pytest.mark.parametrize("dtype,cache,group,d,rule", [
    (torch.bfloat16, None, 4, 0, "every head_dim of 1 or more"),
    (torch.float16, torch.int8, 8, -1, "not -1"),
    (torch.float64, None, 4, 64, "bf16, f16 or f32 queries"),
    (torch.int8, None, 4, 64, "bf16, f16 or f32 queries"),
    (torch.bfloat16, torch.float16, 4, 64, "a cache of the query's type"),
    (torch.float32, None, 0, 64, "query group must be 1 or more"),
])
def test_geometries_outside_the_rule_are_refused(dtype, cache, group, d,
                                                 rule):
    assert not kernel_geometry_supported(dtype, cache, group, d)
    assert rule in kernel_geometry_refusal(dtype, cache, group, d)


def test_check_kernel_shapes_names_the_rule():
    """The start-up check raises before asking the library (which it
    never reaches here), naming the rule; the page rule accepts an int8
    page of 8 and refuses only a page under one token."""
    from production_stack_tpu_torch.ops.paged_kv_common import (
        check_kernel_shapes, kernel_page_size_supported)
    with pytest.raises(NotImplementedError, match="not -1"):
        check_kernel_shapes(8, 2, -1, 16, torch.bfloat16)
    assert kernel_page_size_supported(8)
    with pytest.raises(NotImplementedError, match="page_size 0"):
        check_kernel_shapes(8, 2, 64, 0, torch.float16, torch.int8)
    assert KERNEL_HEAD_DIM_TILES == (32, 64, 80, 128, 256)


@pytest.mark.parametrize("group,d,tile", [
    (1, 64, 1), (2, 64, 4), (4, 64, 4), (5, 64, 8), (8, 64, 8),
    (16, 64, 8), (1, 80, 1), (7, 80, 4), (8, 128, 4), (16, 128, 4),
    (3, 32, 4), (7, 32, 8), (1, 256, 1), (3, 256, 2), (8, 256, 2),
    (2, 100, 4), (8, 100, 4), (3, 160, 2), (5, 33, 8), (8, 65, 4)])
def test_decode_group_tile(group, d, tile):
    """The tile is the partials' GT (csrc/paged_decode.cu group_tile;
    the card checks the library's answer against this one)."""
    assert decode_group_tile(group, d) == tile


def test_decode_scratch_is_tile_major():
    """The wrapper's scratch shape: [B, kv_heads * tiles, slots, GT,
    head-dim tile + 2]."""
    from production_stack_tpu_torch.ops.paged_attention_cuda import (
        _partials)
    q = torch.zeros(3, 2 * 7, 128)
    assert tuple(_partials(q, 2, 5).shape) == (3, 4, 5, 4, 130)
    q = torch.zeros(3, 16, 64)
    assert tuple(_partials(q, 1, 2).shape) == (3, 2, 2, 8, 66)
    q = torch.zeros(3, 4 * 3, 256)  # Falcon3-7B: two tiles of 2
    assert tuple(_partials(q, 4, 2).shape) == (3, 8, 2, 2, 258)
    q = torch.zeros(3, 32, 100)  # OpenLLaMA-3B: padded to 128
    assert tuple(_partials(q, 32, 3).shape) == (3, 32, 3, 1, 130)


def test_tiny_engine_config_fields_match():
    """The tiny engines above are built field for field alike."""
    for label, arch, nh, nkv, d, hidden, dtype in ENGINES:
        a = dataclasses.asdict(_model(jax_config.ModelConfig, arch, nh, nkv,
                                      d, hidden, dtype))
        b = dataclasses.asdict(_model(config.ModelConfig, arch, nh, nkv, d,
                                      hidden, dtype))
        common = set(a) & set(b)
        assert {k: a[k] for k in common} == {k: b[k] for k in common}, label
