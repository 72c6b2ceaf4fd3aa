"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()``
is false (decided in the ``dev`` fixture, never at import). On a
machine with an NVIDIA GPU:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py -q

Covers every geometry the kernels are built for (bench-1b: bf16,
query group 4, head_dim 64; tiny-llama: f32, query group 2, head_dim
32), page sizes 8 to 128, pad rows, first and later prefill chunks,
ragged blocks (mixed decode, chunk and pad rows; verify spans; every
slot compared, dead ones exact 0), the int8 form of all three kernels
(a QuantKV cache quantized from the same K/V; page sizes 16 to 128),
the stacked form of all three in both dtypes (a stacked [L, ...] cache
read at its last layer: within tolerance of the plain version and
bitwise equal to the per-layer launch on the layer's view), the
wrappers' refusals, and the tiny engine's greedy streams on the card
against the CPU, with and without speculative decoding, with int8 KV,
with the stacked layout and with decode bursts. The redesigned
kernels add: the split decode kernel at batch 1, 4 and 32 over tables
of 1024 and 4096 tokens, at the split the wrapper picks and at forced
ones; the tensor-core prefill walk at every T bucket 16..512 and page
size 16..128 with row starts off the tile and the chunk; the ragged
kernel on the tensor-core walk at decode rows alone (every tile but the
first dead), a verify block at draft lens 0..4 and chunk rows whose
live slots end inside a tile, page sizes 16 to 128, bf16 and int8,
per-layer and stacked; and two launches of each giving equal bits.
The engine's step graphs: the tiny engine replaying its steps as CUDA
graphs gives the eager card run's and the CPU's greedy streams (main
path, bimodal, int8 stacked, speculative, bursts), its unseeded draws
differ step to step and repeat at one seed, and a seeded request's
steps run eagerly and are counted.

Tolerance: f32 at atol = rtol = 1e-4 (the same arithmetic, sums in
another order); bf16 at atol = rtol = 2e-2 (outputs rounded to bf16,
compared in f32). The bf16 ragged kernel is held against the plain
version with its rounding (``p_dtype=torch.bfloat16``: probabilities
enter p . v as bf16).
"""

import numpy as np
import pytest
import torch

from production_stack_tpu_torch.ops.paged_attention_cuda import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.quant_kv import QuantKV, quantize_kv
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention,
    paged_ragged_attention_plain,
)

pytestmark = pytest.mark.cuda

# (dtype, query group, head dim) of each model config the kernels are
# built for (csrc/paged_kv_common.cuh, PSTT_FOR_EACH_GEOMETRY).
GEOMETRIES = [(torch.bfloat16, 4, 64), (torch.float32, 2, 32)]

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


def _ragged_plain(*args, **kwargs):
    """The ragged kernel's plain version rounded as the kernel rounds:
    bf16 queries run the tensor-core walk, whose probabilities enter
    p . v as bf16; f32 queries the f32 walk."""
    if args[0].dtype == torch.bfloat16:
        kwargs["p_dtype"] = torch.bfloat16
    return paged_ragged_attention_plain(*args, **kwargs)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode; their plain versions are tested on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, dtype, b, kv_lens, group, kv_heads, head_dim, page_size,
            seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    max_pages = -(-max(max(kv_lens), 1) // page_size) + 1
    num_pages = b * max_pages + 1
    shape = (kv_heads, num_pages, head_dim, page_size)
    k = torch.randn(shape, generator=g).to(dev, dtype)
    v = torch.randn(shape, generator=g).to(dev, dtype)
    table = torch.zeros((b, max_pages), dtype=torch.int32)
    perm = torch.randperm(num_pages - 1, generator=g) + 1
    used = 0
    for i, n in enumerate(kv_lens):
        need = -(-n // page_size)
        table[i, :need] = perm[used:used + need]
        used += need
    lens = torch.tensor(kv_lens, dtype=torch.int32)
    return k, v, table.to(dev), lens.to(dev), g


@pytest.mark.parametrize("page_size", [16, 128])
@pytest.mark.parametrize("dtype,group,head_dim", GEOMETRIES)
def test_decode_kernel_matches_plain(dev, dtype, group, head_dim,
                                     page_size):
    kv_lens = [1, 0, 127, 128, 129, 300, 517]
    k, v, table, lens, g = _inputs(dev, dtype, len(kv_lens), kv_lens,
                                   group, 2, head_dim, page_size, 1)
    q = torch.randn((len(kv_lens), 2 * group, head_dim),
                    generator=g).to(dev, dtype)
    got = paged_decode_attention(q, k, v, table, lens)
    ref = paged_decode_attention_plain(q, k, v, table, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    assert not got[1].any()  # the pad row writes exact 0


@pytest.mark.parametrize("page_size", [8, 16, 32, 64, 128])
def test_decode_kernel_page_sizes(dev, page_size):
    kv_lens = [5, 0, 200, 640]
    k, v, table, lens, g = _inputs(dev, torch.bfloat16, 4, kv_lens, 4, 8,
                                   64, page_size, 2)
    q = torch.randn((4, 32, 64), generator=g).to(dev, torch.bfloat16)
    got = paged_decode_attention(q, k, v, table, lens)
    ref = paged_decode_attention_plain(q, k, v, table, lens)
    torch.testing.assert_close(got.float(), ref.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("page_size", [16, 128])
@pytest.mark.parametrize("first_chunk", [True, False])
@pytest.mark.parametrize("dtype,group,head_dim", GEOMETRIES)
def test_prefill_kernel_matches_plain(dev, dtype, group, head_dim,
                                      first_chunk, page_size):
    t = 80
    live = [80, 33, 0, 1]
    start = 0 if first_chunk else 150
    kv_lens = [start + n if n else 0 for n in live]
    k, v, table, lens, g = _inputs(dev, dtype, 4, kv_lens, group, 2,
                                   head_dim, page_size, 3)
    q = torch.randn((4, t, 2 * group, head_dim), generator=g).to(dev,
                                                                  dtype)
    starts = torch.tensor([start if n else 0 for n in live],
                          dtype=torch.int32, device=dev)
    pos = (starts[:, None] + torch.arange(t, dtype=torch.int32,
                                          device=dev)).contiguous()
    got = paged_prefill_attention(q, k, v, table, pos, lens)
    ref = paged_prefill_attention_plain(q, k, v, table, pos, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    assert not got[2].any()


# Ragged blocks as (kv_len, last_index) per row: a unified mixed step
# (decode rows, chunk rows of a first and a later chunk, a short chunk,
# pad rows) and a verify block (draft lens 0..4, pad rows).
RAGGED_BLOCKS = {
    # The last row's last_index lies past the block: every slot is
    # live, at kv_len - 1 - last_index + t.
    "mixed": (80, [(1, 0), (300, 0), (517, 0), (80, 79), (230, 79),
                   (170, 19), (0, -1), (129, 0), (400, 90)]),
    "verify": (5, [(1, 0), (130, 1), (300, 2), (517, 3), (640, 4),
                   (0, -1), (64, 4), (0, -1)]),
}


@pytest.mark.parametrize("block", sorted(RAGGED_BLOCKS))
@pytest.mark.parametrize("page_size", [16, 128])
@pytest.mark.parametrize("dtype,group,head_dim", GEOMETRIES)
def test_ragged_kernel_matches_plain(dev, dtype, group, head_dim,
                                     page_size, block):
    w, rows = RAGGED_BLOCKS[block]
    kv_lens = [n for n, _ in rows]
    k, v, table, lens, g = _inputs(dev, dtype, len(rows), kv_lens, group,
                                   2, head_dim, page_size, 6)
    last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                        device=dev)
    drafts = torch.clamp(last, min=0) if block == "verify" else None
    q = torch.randn((len(rows), w, 2 * group, head_dim),
                    generator=g).to(dev, dtype)
    got = paged_ragged_attention(q, k, v, table, lens, last, drafts)
    ref = _ragged_plain(q, k, v, table, lens, last, drafts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    dead = ((torch.arange(w, device=dev)[None] > last[:, None].long())
            | (lens[:, None] == 0))
    assert not got[dead].any()  # dead slots and pad rows: exact 0


def test_wrappers_launch_and_count(dev):
    COUNTERS.reset()
    k, v, table, lens, g = _inputs(dev, torch.bfloat16, 2, [3, 9], 4, 2,
                                   64, 16, 4)
    q = torch.randn((2, 8, 64), generator=g).to(dev, torch.bfloat16)
    paged_decode_attention(q, k, v, table, lens)
    assert COUNTERS.launches == {"paged_decode": 1}
    paged_decode_attention_plain(q, k, v, table, lens)
    assert COUNTERS.plain_cuda_calls == {"paged_decode": 1}
    qr = torch.randn((2, 3, 8, 64), generator=g).to(dev, torch.bfloat16)
    last = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    paged_ragged_attention(qr, k, v, table, lens, last)
    assert COUNTERS.launches == {"paged_decode": 1, "paged_ragged": 1}
    paged_ragged_attention_plain(qr, k, v, table, lens, last)
    assert COUNTERS.plain_cuda_calls == {"paged_decode": 1,
                                         "paged_ragged": 1}


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    k, v, table, lens, g = _inputs(dev, torch.bfloat16, 2, [3, 9], 4, 2,
                                   64, 16, 5)
    q = torch.randn((2, 8, 64), generator=g).to(dev, torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, k.transpose(2, 3).contiguous()
                               .transpose(2, 3), v, table, lens)
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(q, k, v, table.long(), lens)
    with pytest.raises(NotImplementedError, match="query group"):
        paged_decode_attention(q[:, :6].contiguous(), k, v, table, lens)
    with pytest.raises(NotImplementedError, match="not built for"):
        paged_decode_attention(q.float(), k.float(), v.float(), table,
                               lens)
    with pytest.raises(NotImplementedError):
        paged_decode_attention(q.half(), k.half(), v.half(), table, lens)
    qr = torch.randn((2, 3, 8, 64), generator=g).to(dev, torch.bfloat16)
    last = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        paged_ragged_attention(qr, k, v, table, lens, last.long())
    with pytest.raises(ValueError, match="rows"):
        paged_ragged_attention(qr, k, v, table, lens, last[:1])
    with pytest.raises(NotImplementedError, match="query group"):
        paged_ragged_attention(qr[:, :, :6].contiguous(), k, v, table,
                               lens, last)
    with pytest.raises(ValueError, match="scales"):
        paged_ragged_attention(qr, k.to(torch.int8), v.to(torch.int8),
                               table, lens, last)


# ---- the redesigned decode and prefill kernels ------------------------------


def _wide_inputs(dev, dtype, kv_lens, group, kv_heads, head_dim, page_size,
                 max_len, seed, int8=False):
    """Caches, a page table ``max_len`` tokens wide and kv lens: the
    table's width, not the rows' lengths, sets the decode split."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(kv_lens)
    max_pages = max_len // page_size
    used_pages = sum(-(-n // page_size) for n in kv_lens)
    num_pages = used_pages + 2
    shape = (kv_heads, num_pages, head_dim, page_size)
    k = torch.randn(shape, generator=g).to(dev, dtype)
    v = torch.randn(shape, generator=g).to(dev, dtype)
    table = torch.zeros((b, max_pages), dtype=torch.int32)
    perm = torch.randperm(num_pages - 1, generator=g) + 1
    used = 0
    for i, n in enumerate(kv_lens):
        need = -(-n // page_size)
        table[i, :need] = perm[used:used + need]
        used += need
    lens = torch.tensor(kv_lens, dtype=torch.int32)
    if int8:
        k, v = _quantize(k), _quantize(v)
    return k, v, table.to(dev), lens.to(dev), g


# (batch's kv lens, table width in tokens): batch 1, 4 and 32; rows
# ending inside the first split, on and around a chunk edge; pad rows.
DECODE_SPLIT_CASES = {
    "b1": ([1000], 1024),
    "b1-wide": ([3000], 4096),
    "b4": ([127, 128, 129, 0], 1024),
    "b4-wide": ([4096, 5, 0, 2049], 4096),
    "b32": ([int(n) for n in np.linspace(0, 1024, 32)], 1024),
    "b32-wide": ([int(n) for n in np.linspace(0, 4096, 32)], 4096),
}


@pytest.mark.parametrize("num_splits", [None, 1, 2, "most"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", sorted(DECODE_SPLIT_CASES))
def test_decode_split_matches_plain(dev, case, int8, num_splits):
    """The split decode kernel at the split ``decode_splits`` picks, at
    one split, two, and one chunk a split: each within tolerance of the
    plain version, pad rows exact 0, and two launches equal bit for
    bit."""
    from production_stack_tpu_torch.ops.paged_attention_cuda import (
        decode_splits)
    kv_lens, max_len = DECODE_SPLIT_CASES[case]
    k, v, table, lens, g = _wide_inputs(dev, torch.bfloat16, kv_lens, 4, 8,
                                        64, 128, max_len, 31, int8)
    q = torch.randn((len(kv_lens), 32, 64), generator=g).to(
        dev, torch.bfloat16)
    if num_splits == "most":
        num_splits = max_len // 128
    picked = decode_splits(len(kv_lens), 8, table.shape[1], 128)
    print(f"decode {case}: decode_splits -> {picked}")
    got = paged_decode_attention(q, k, v, table, lens,
                                 num_splits=num_splits)
    again = paged_decode_attention(q, k, v, table, lens,
                                   num_splits=num_splits)
    ref = paged_decode_attention_plain(q, k, v, table, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(got, again)
    assert not got[lens == 0].any()


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype,group,head_dim", GEOMETRIES)
def test_decode_split_small_pages_every_geometry(dev, dtype, group,
                                                 head_dim, int8):
    """Page size 16 over a 512-token table in both geometries, split in
    four: the f32 geometry at 1e-4."""
    kv_lens = [1, 0, 127, 128, 129, 300, 512]
    k, v, table, lens, g = _wide_inputs(dev, dtype, kv_lens, group, 2,
                                        head_dim, 16, 512, 32, int8)
    q = torch.randn((len(kv_lens), 2 * group, head_dim),
                    generator=g).to(dev, dtype)
    for num_splits in (None, 1, 4):
        got = paged_decode_attention(q, k, v, table, lens,
                                     num_splits=num_splits)
        ref = paged_decode_attention_plain(q, k, v, table, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
        assert not got[1].any()


def test_decode_refuses_a_split_past_the_table(dev):
    k, v, table, lens, g = _wide_inputs(dev, torch.bfloat16, [3, 9], 4, 2,
                                        64, 16, 256, 33)
    q = torch.randn((2, 8, 64), generator=g).to(dev, torch.bfloat16)
    for bad in (0, 3):
        with pytest.raises(ValueError, match="num_splits"):
            paged_decode_attention(q, k, v, table, lens, num_splits=bad)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [16, 32, 64, 128, 256, 512])
def test_prefill_mma_buckets_and_page_sizes(dev, t, page_size, int8):
    """Every T bucket and page size of the tensor-core prefill walk, at
    row starts off the tile and the chunk (37, 600), a kv_len one past
    a chunk edge, a one-token row and a pad row; two launches equal bit
    for bit."""
    rows = [(0, t), (37, t), (600, max(1, t - 7)), (128 - t + 1, t),
            (0, 0), (300, 1)]
    rows = [(max(s, 0), n) for s, n in rows]
    kv_lens = [s + n if n else 0 for s, n in rows]
    k, v, table, lens, g = _wide_inputs(dev, torch.bfloat16, kv_lens, 4, 8,
                                        64, page_size, 1152, 34, int8)
    q = torch.randn((len(rows), t, 32, 64), generator=g).to(
        dev, torch.bfloat16)
    starts = torch.tensor([s if n else 0 for s, n in rows],
                          dtype=torch.int32, device=dev)
    pos = (starts[:, None] + torch.arange(t, dtype=torch.int32,
                                          device=dev)).contiguous()
    got = paged_prefill_attention(q, k, v, table, pos, lens)
    again = paged_prefill_attention(q, k, v, table, pos, lens)
    ref = paged_prefill_attention_plain(q, k, v, table, pos, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(got, again)
    assert not got[4].any()


# Ragged blocks of the tensor-core walk at the bench-1b geometry, as
# (W, [(kv_len, last_index), ...]): decode rows alone over kv lens
# 1..1024 (every tile but the first dead; two pad rows); a verify block
# at draft lens 0..4 ((K + 1) * G live rows end inside a warp's 16);
# chunk rows whose live slots end inside a 64-row tile, at first and
# later chunks (148 .. 2044 live rows, none a multiple of 64).
RAGGED_MMA_BLOCKS = {
    "decode_rows": (512, [(int(n), 0) for n in np.linspace(1, 1024, 14)]
                    + [(0, -1), (0, -1)]),
    "verify": (5, [(max(int(n), i % 5 + 1), i % 5) for i, n in enumerate(
        np.linspace(1, 1024, 15))] + [(0, -1)]),
    "mid_tile": (512, [(s + n, n - 1) for s, n in (
        (0, 37), (200, 100), (700, 129), (0, 511), (1000, 3), (300, 250))]),
}


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size", [16, 32, 64, 128])
@pytest.mark.parametrize("block", sorted(RAGGED_MMA_BLOCKS))
def test_ragged_mma_blocks(dev, block, page_size, int8, stacked):
    """The bf16 ragged kernel on the tensor-core walk: within tolerance
    of the bf16-p plain version on every slot, dead slots and pad rows
    exact 0, two launches equal bit for bit and, stacked, bitwise equal
    to the per-layer launch on the layer's view."""
    w, rows = RAGGED_MMA_BLOCKS[block]
    kv_lens = [n for n, _ in rows]
    k, v, table, lens, g = _wide_inputs(dev, torch.bfloat16, kv_lens, 4, 8,
                                        64, page_size, 1024, 41, int8)
    last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                        device=dev)
    drafts = torch.clamp(last, min=0) if block == "verify" else None
    q = torch.randn((len(rows), w, 32, 64), generator=g).to(
        dev, torch.bfloat16)
    layer = {}
    if stacked:
        layers = 3
        layer = {"layer": layers - 1}
        k, v = (_stacked(c, layers, layers - 1, g) for c in (k, v))
    got = paged_ragged_attention(q, k, v, table, lens, last, drafts, **layer)
    again = paged_ragged_attention(q, k, v, table, lens, last, drafts,
                                   **layer)
    ref = _ragged_plain(q, k, v, table, lens, last, drafts, **layer)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(got, again)
    dead = ((torch.arange(w, device=dev)[None] > last[:, None].long())
            | (lens[:, None] == 0))
    assert not got[dead].any()  # dead slots and pad rows: exact 0
    if stacked:
        per_layer = paged_ragged_attention(q, k[-1], v[-1], table, lens,
                                           last, drafts)
        assert torch.equal(got, per_layer)


# ---- the int8 form ----------------------------------------------------------


def _quantize(cache):
    """A [kv, pages, d, ps] cache quantized per (page, slot, kv head)
    row, as the page writes lay it out."""
    q8, scale = quantize_kv(cache.permute(0, 1, 3, 2))
    return QuantKV(q8.permute(0, 1, 3, 2).contiguous(), scale.contiguous())


@pytest.mark.parametrize("page_size", [16, 32, 128])
@pytest.mark.parametrize("dtype,group,head_dim", GEOMETRIES)
def test_int8_decode_kernel_matches_plain(dev, dtype, group, head_dim,
                                          page_size):
    kv_lens = [1, 0, 127, 128, 129, 300, 517]
    k, v, table, lens, g = _inputs(dev, dtype, len(kv_lens), kv_lens,
                                   group, 2, head_dim, page_size, 11)
    k8, v8 = _quantize(k), _quantize(v)
    q = torch.randn((len(kv_lens), 2 * group, head_dim),
                    generator=g).to(dev, dtype)
    COUNTERS.reset()
    got = paged_decode_attention(q, k8, v8, table, lens)
    ref = paged_decode_attention_plain(q, k8, v8, table, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    assert not got[1].any()  # the pad row writes exact 0
    assert COUNTERS.launches == {"paged_decode_int8": 1}


@pytest.mark.parametrize("page_size", [16, 128])
@pytest.mark.parametrize("first_chunk", [True, False])
@pytest.mark.parametrize("dtype,group,head_dim", GEOMETRIES)
def test_int8_prefill_kernel_matches_plain(dev, dtype, group, head_dim,
                                           first_chunk, page_size):
    t = 80
    live = [80, 33, 0, 1]
    start = 0 if first_chunk else 150
    kv_lens = [start + n if n else 0 for n in live]
    k, v, table, lens, g = _inputs(dev, dtype, 4, kv_lens, group, 2,
                                   head_dim, page_size, 13)
    k8, v8 = _quantize(k), _quantize(v)
    q = torch.randn((4, t, 2 * group, head_dim), generator=g).to(dev,
                                                                  dtype)
    starts = torch.tensor([start if n else 0 for n in live],
                          dtype=torch.int32, device=dev)
    pos = (starts[:, None] + torch.arange(t, dtype=torch.int32,
                                          device=dev)).contiguous()
    got = paged_prefill_attention(q, k8, v8, table, pos, lens)
    ref = paged_prefill_attention_plain(q, k8, v8, table, pos, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    assert not got[2].any()


@pytest.mark.parametrize("block", sorted(RAGGED_BLOCKS))
@pytest.mark.parametrize("page_size", [16, 128])
@pytest.mark.parametrize("dtype,group,head_dim", GEOMETRIES)
def test_int8_ragged_kernel_matches_plain(dev, dtype, group, head_dim,
                                          page_size, block):
    w, rows = RAGGED_BLOCKS[block]
    kv_lens = [n for n, _ in rows]
    k, v, table, lens, g = _inputs(dev, dtype, len(rows), kv_lens, group,
                                   2, head_dim, page_size, 16)
    k8, v8 = _quantize(k), _quantize(v)
    last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                        device=dev)
    drafts = torch.clamp(last, min=0) if block == "verify" else None
    q = torch.randn((len(rows), w, 2 * group, head_dim),
                    generator=g).to(dev, dtype)
    got = paged_ragged_attention(q, k8, v8, table, lens, last, drafts)
    ref = _ragged_plain(q, k8, v8, table, lens, last, drafts)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    dead = ((torch.arange(w, device=dev)[None] > last[:, None].long())
            | (lens[:, None] == 0))
    assert not got[dead].any()  # dead slots and pad rows: exact 0


def test_int8_wrappers_refuse_what_the_kernels_do_not_take(dev):
    k, v, table, lens, g = _inputs(dev, torch.bfloat16, 2, [3, 9], 4, 2,
                                   64, 8, 17)
    q = torch.randn((2, 8, 64), generator=g).to(dev, torch.bfloat16)
    # Page size 8: an int8 page row is 8 bytes, short of a 16-byte load.
    with pytest.raises(NotImplementedError, match="multiple of 16"):
        paged_decode_attention(q, _quantize(k), _quantize(v), table, lens)
    k, v, table, lens, g = _inputs(dev, torch.bfloat16, 2, [3, 9], 4, 2,
                                   64, 16, 18)
    k8, v8 = _quantize(k), _quantize(v)
    bad = QuantKV(k8.data, k8.scale[:, :, :8].contiguous())
    with pytest.raises(ValueError, match="scales"):
        paged_decode_attention(q, bad, v8, table, lens)
    cpu_scale = QuantKV(k8.data, k8.scale.cpu())
    with pytest.raises(ValueError, match="k_scale"):
        paged_decode_attention(q, cpu_scale, v8, table, lens)


# ---- the stacked form -------------------------------------------------------


def _stacked(cache, layers, layer, g):
    """A stacked [layers, ...] cache (a QuantKV's data and scales
    alike) holding ``cache`` at ``layer`` and other values elsewhere."""
    def stack(t):
        noise = torch.randn((layers,) + tuple(t.shape), generator=g)
        out = (noise * 8).to(t.dtype).to(t.device)
        out[layer] = t
        return out
    if isinstance(cache, QuantKV):
        return QuantKV(stack(cache.data), stack(cache.scale).abs())
    return stack(cache)


def _kernel_call(kernel, dev, dtype, group, head_dim, page_size, g):
    """(wrapper, plain version, their arguments before the caches,
    after them, and the kv lens) of one case of ``kernel``."""
    if kernel == "decode":
        kv_lens = [1, 0, 127, 128, 129, 300, 517]
        k, v, table, lens, _ = _inputs(dev, dtype, len(kv_lens), kv_lens,
                                       group, 2, head_dim, page_size, 21)
        q = torch.randn((len(kv_lens), 2 * group, head_dim),
                        generator=g).to(dev, dtype)
        return (paged_decode_attention, paged_decode_attention_plain,
                (q,), (table, lens), k, v)
    if kernel == "prefill":
        live, start, t = [80, 33, 0, 1], 150, 80
        kv_lens = [start + n if n else 0 for n in live]
        k, v, table, lens, _ = _inputs(dev, dtype, 4, kv_lens, group, 2,
                                       head_dim, page_size, 22)
        q = torch.randn((4, t, 2 * group, head_dim),
                        generator=g).to(dev, dtype)
        starts = torch.tensor([start if n else 0 for n in live],
                              dtype=torch.int32, device=dev)
        pos = (starts[:, None] + torch.arange(t, dtype=torch.int32,
                                              device=dev)).contiguous()
        return (paged_prefill_attention, paged_prefill_attention_plain,
                (q,), (table, pos, lens), k, v)
    w, rows = RAGGED_BLOCKS["verify"]
    kv_lens = [n for n, _ in rows]
    k, v, table, lens, _ = _inputs(dev, dtype, len(rows), kv_lens, group,
                                   2, head_dim, page_size, 23)
    last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                        device=dev)
    q = torch.randn((len(rows), w, 2 * group, head_dim),
                    generator=g).to(dev, dtype)
    return (paged_ragged_attention, _ragged_plain, (q,),
            (table, lens, last, torch.clamp(last, min=0)), k, v)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("kernel", ["decode", "prefill", "ragged"])
@pytest.mark.parametrize("dtype,group,head_dim", GEOMETRIES)
def test_stacked_kernel_matches_plain_and_per_layer(dev, dtype, group,
                                                     head_dim, kernel,
                                                     int8):
    """The stacked form at the last of 3 layers: within tolerance of
    its plain version, bitwise equal to the per-layer launch on the
    layer's view (the same walk over the same bytes), and counted as
    its own form."""
    g = torch.Generator(device="cpu").manual_seed(24)
    fn, plain, pre, post, k, v = _kernel_call(kernel, dev, dtype, group,
                                              head_dim, 16, g)
    if int8:
        k, v = _quantize(k), _quantize(v)
    layers, layer = 3, 2
    k5, v5 = _stacked(k, layers, layer, g), _stacked(v, layers, layer, g)
    COUNTERS.reset()
    got = fn(*pre, k5, v5, *post, layer=layer)
    per_layer = fn(*pre, k5[layer], v5[layer], *post)
    ref = plain(*pre, k5, v5, *post, layer=layer)
    torch.cuda.synchronize()
    name = f"paged_{kernel}" + ("_int8" if int8 else "")
    assert COUNTERS.launches == {name + "_stacked": 1, name: 1}
    assert torch.equal(got, per_layer)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


def test_stacked_wrappers_refuse_what_the_kernels_do_not_take(dev):
    k, v, table, lens, g = _inputs(dev, torch.bfloat16, 2, [3, 9], 4, 2,
                                   64, 16, 25)
    q = torch.randn((2, 8, 64), generator=g).to(dev, torch.bfloat16)
    k5, v5 = _stacked(k, 2, 1, g), _stacked(v, 2, 1, g)
    with pytest.raises(ValueError, match="layer index and cache rank"):
        paged_decode_attention(q, k5, v5, table, lens)
    with pytest.raises(ValueError, match="layer index and cache rank"):
        paged_decode_attention(q, k, v, table, lens, layer=0)
    for layer in (2, -1):
        with pytest.raises(ValueError, match="outside"):
            paged_decode_attention(q, k5, v5, table, lens, layer=layer)
    with pytest.raises(ValueError, match="contiguous"):
        paged_decode_attention(q, k5.transpose(0, 1), v5.transpose(0, 1),
                               table, lens, layer=1)


def _engine_streams(kv_cache_dtype="auto", speculative_k=0,
                    cache_layout="auto", decode_steps=1):
    """The tiny engine's greedy streams on the CPU and on the card,
    with the launch counters of the card's run."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig, tiny_model_config)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.models.llama import init_params

    cfg = EngineConfig(
        model=tiny_model_config("llama"),
        cache=CacheConfig(page_size=16, num_pages=128,
                          cache_layout=cache_layout,
                          kv_cache_dtype=kv_cache_dtype),
        scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                  prefill_chunk_size=32,
                                  unified_step=True,
                                  async_scheduling=True,
                                  decode_steps=decode_steps,
                                  speculative_k=speculative_k))
    params = init_params(cfg.model, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    rs = np.random.RandomState(7)
    prompts = [[4, 5, 6] * 13, [8] * 10, [21, 22, 23, 24] * 20,
               [int(x) for x in rs.randint(1, 500, size=41)]]
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    streams, drafted = [], []
    COUNTERS.reset()
    for device in ("cpu", "cuda"):
        engine = LLMEngine(cfg, params=params, device=device)
        streams.append([s.output_token_ids
                        for s in engine.generate_batch(prompts, sp)])
        drafted.append(engine.metrics.spec_draft_tokens_total)
    return streams, drafted, dict(COUNTERS.launches)


@pytest.mark.parametrize("speculative_k", [0, 4])
def test_engine_greedy_streams_on_the_card_match_the_cpu(dev,
                                                         speculative_k):
    streams, drafted, launches = _engine_streams(
        speculative_k=speculative_k)
    assert streams[0] == streams[1]
    assert launches["paged_prefill"] > 0
    assert launches["paged_decode"] > 0
    assert launches["paged_ragged"] > 0
    assert not COUNTERS.plain_cuda_calls
    if speculative_k:
        assert drafted[0] > 0 and drafted[1] > 0


def test_engine_int8_greedy_streams_on_the_card_match_the_cpu(dev):
    """With int8 KV the card runs the int8 form of all three kernels
    (and no other form), and its greedy streams are the CPU's."""
    streams, _, launches = _engine_streams(kv_cache_dtype="int8")
    assert streams[0] == streams[1]
    assert set(launches) == {"paged_prefill_int8", "paged_decode_int8",
                             "paged_ragged_int8"}
    assert all(n > 0 for n in launches.values())
    assert not COUNTERS.plain_cuda_calls


@pytest.mark.parametrize("kv_cache_dtype,decode_steps", [
    ("auto", 1), ("auto", 4), ("int8", 4)])
def test_engine_stacked_greedy_streams_on_the_card_match_the_cpu(
        dev, kv_cache_dtype, decode_steps):
    """With the stacked layout the card runs the stacked form of all
    three kernels and no per-layer form, bursts or not, and its greedy
    streams are the CPU's."""
    streams, _, launches = _engine_streams(
        kv_cache_dtype=kv_cache_dtype, cache_layout="stacked",
        decode_steps=decode_steps)
    assert streams[0] == streams[1]
    suffix = ("_int8" if kv_cache_dtype == "int8" else "") + "_stacked"
    assert set(launches) == {f"paged_{k}{suffix}"
                             for k in ("prefill", "decode", "ragged")}
    assert all(n > 0 for n in launches.values())
    assert not COUNTERS.plain_cuda_calls


# ---- the engine's step graphs on the card -----------------------------------


def _tiny_engine(cuda_graphs, device="cuda", **sched):
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig, tiny_model_config)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.models.llama import init_params

    cache = {k: sched.pop(k) for k in ("kv_cache_dtype", "cache_layout")
             if k in sched}
    cfg = EngineConfig(
        model=tiny_model_config("llama"),
        cache=CacheConfig(page_size=16, num_pages=128, **cache),
        scheduler=SchedulerConfig(max_num_seqs=4, max_model_len=256,
                                  prefill_chunk_size=32, **sched))
    params = init_params(cfg.model, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    return LLMEngine(cfg, params=params, device=device,
                     cuda_graphs=cuda_graphs)


def _tiny_prompts():
    rs = np.random.RandomState(7)
    return [[4, 5, 6] * 13, [8] * 10, [21, 22, 23, 24] * 20,
            [int(x) for x in rs.randint(1, 500, size=41)]]


@pytest.mark.parametrize("sched", [
    dict(unified_step=True, async_scheduling=True),
    dict(unified_step=False, async_scheduling=True),
    dict(unified_step=True, async_scheduling=True, kv_cache_dtype="int8",
         cache_layout="stacked"),
    dict(unified_step=True, async_scheduling=False, speculative_k=4),
    dict(unified_step=True, async_scheduling=False, decode_steps=4,
         cache_layout="stacked"),
], ids=["main", "bimodal", "int8-stacked", "spec", "bursts"])
def test_graphed_engine_matches_eager_and_the_cpu(dev, sched):
    """Greedy streams replayed from step graphs on the card are those
    of the eager card run and of the CPU; every key captured once, no
    step eager, and the launch counters (replay accounting) equal the
    eager run's."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    streams, launches = {}, {}
    for path, graphs, device in (("graphs", True, "cuda"),
                                 ("eager", False, "cuda"),
                                 ("cpu", False, "cpu")):
        COUNTERS.reset()
        engine = _tiny_engine(graphs, device, **dict(sched))
        streams[path] = [s.output_token_ids for s in
                         engine.generate_batch(_tiny_prompts(), sp)]
        launches[path] = dict(COUNTERS.launches)
        if graphs:
            g = engine.runner.graphs
            assert sum(g.captures.values()) == len(g.keys()) > 0
            assert sum(g.replays.values()) > len(g.keys())
            assert g.eager_steps == {"seeded": 0}
        assert not COUNTERS.plain_cuda_calls
    assert streams["graphs"] == streams["eager"] == streams["cpu"]
    # The warm-up runs each key once more than the eager path does.
    assert set(launches["graphs"]) == set(launches["eager"])
    assert all(launches["graphs"][k] >= launches["eager"][k]
               for k in launches["eager"])


def test_unseeded_draws_under_graphs_differ_by_step_and_repeat_by_seed(dev):
    """The engine's generator is registered with every graph: replays
    draw new noise each step, and a run at the same seed repeats."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams

    sp = SamplingParams(temperature=1.0, max_tokens=24, ignore_eos=True)
    runs = []
    for _ in range(2):
        engine = _tiny_engine(True, unified_step=True,
                              async_scheduling=True)
        runs.append([s.output_token_ids for s in engine.generate_batch(
            [[8] * 10] * 4, sp)])
        assert engine.runner.graphs.eager_steps == {"seeded": 0}
    assert runs[0] == runs[1]
    # Four rows of one prompt, each step a fresh draw: the rows part,
    # and no row repeats one token throughout.
    assert len({tuple(r) for r in runs[0]}) > 1
    assert all(len(set(r)) > 1 for r in runs[0])


def test_a_seeded_step_runs_eagerly_on_the_card(dev):
    from production_stack_tpu_torch.engine.sequence import SamplingParams

    sp = SamplingParams(temperature=0.8, top_p=0.95, max_tokens=8, seed=5,
                        ignore_eos=True)
    tokens = {}
    for graphs in (True, False):
        engine = _tiny_engine(graphs, unified_step=True,
                              async_scheduling=True)
        tokens[graphs] = engine.generate([4, 5, 6] * 10, sp).output_token_ids
        if graphs:
            assert engine.runner.graphs.eager_steps["seeded"] == 8
    assert tokens[True] == tokens[False]
