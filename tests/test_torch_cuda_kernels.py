"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()``
is false (decided in the ``dev`` fixture, never at import). On a
machine with an NVIDIA GPU:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py -q

Covers published geometries in each dtype (bench-1b: bf16, query
group 4, head_dim 64; Mixtral-8x7B, Mistral-7B and Llama-3-8B: bf16,
group 4, head_dim 128; Qwen2-7B: bf16, group 7, head_dim 128; OPT and
GPT-2: bf16, group 1, head_dim 64; tiny-llama: f32, query group 2,
head_dim 32; tiny-opt and tiny-gpt2: f32, group 1, head_dim 32;
Llama-3-70B: bf16, group 8, head_dim 128; OPT-2.7b: f16, group 1,
head_dim 80; Qwen2-0.5B: f32, group 7, head_dim 64; Llama-2-7B: bf16,
group 1, head_dim 128; f16 at group 3, head_dim 128; bf16 at group 16;
chip_smoke.py's geometries phase sweeps the whole grid), page sizes 1
to 512 (pages that divide 128, pages that straddle chunk edges, pages
of two to four chunks), pad rows, first and later prefill chunks,
ragged blocks (mixed decode, chunk and pad rows; verify spans; every
slot compared, dead ones exact 0), the int8 form of all three kernels
(a QuantKV cache quantized from the same K/V; page sizes 1 to 384),
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
per-layer and stacked; and two launches of each giving equal bits. The
prefill kernel's wgmma walk (csrc/paged_walk_wgmma.cuh) at every
head-dim tile and two padded head dims, pages 1 to 256, bf16, f16 and
int8 caches per layer and stacked, T buckets 16 to 512 over first and
second chunks (``-k wgmma``): written into a NaN-guarded buffer, every
slot written, kv_len-0 rows exact 0, nothing past the output.
The engine's step graphs: the tiny engine replaying its steps as CUDA
graphs gives the eager card run's and the CPU's greedy streams (main
path, bimodal, int8 stacked, speculative, bursts), its unseeded draws
differ step to step and repeat at one seed, and a seeded request's
steps run eagerly and are counted. The decode kernel's burst-tail form
at every geometry, bf16/f32 and int8 pages, stacked and split, tails
of 1 to 32 slots; deferred-write bursts of the tiny engine against the
CPU and the eager burst; the tp runner over a one-rank NCCL group
replaying its collectives inside the step graphs. Pipeline and context
parallelism: ring attention over two fake sp ranks on the card against
its dense reference at bench-1b's heads; the staged forward over a
one-rank NCCL pp group keeping its masked sum inside every graph; the
context-parallel prefill over a one-rank NCCL sp group running eagerly
and counted, every other step graphed.

Tolerance: f32 at atol = rtol = 1e-4 (the same arithmetic, sums in
another order); bf16 and f16 at atol = rtol = 2e-2 (outputs rounded to
their type, compared in f32). The 16-bit ragged kernel is held against
the plain version with its rounding (``p_dtype``: probabilities enter
p . v in the query's type).
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

# (dtype, query group, head dim) of model configs the kernels serve
# (csrc/paged_kv_common.cuh, PSTT_FOR_EACH_GEOMETRY: any group, any
# head_dim from 1 to 256 at its tile of 32, 64, 80, 128 or 256, and
# above 256 as slabs of 128):
# bench-1b, Mixtral-8x7B, Qwen2-7B, OPT-1.3b, the tiny configs,
# Llama-3-70B (group 8), OPT-2.7b at f16 (head_dim 80), Qwen2-0.5B at
# f32 (group 7), Llama-2-7B (group 1 at 128), Llama-3.2-3B at f16
# (group 3), Llama-3.1-405B (group 16); Falcon3-7B (group 3 at the tile
# 256, bf16 and f32), OpenLLaMA-3B at f16 and f32 (head_dim 100, padded
# to 128), and padded points: 160 (tile 256) and an odd 33 (tile 64);
# slabs: 512 at group 3 in bf16 (four whole slabs), 320 in f16 and an
# odd 289 in f32 (the last slab padded).
GEOMETRIES = [(torch.bfloat16, 4, 64), (torch.bfloat16, 4, 128),
              (torch.bfloat16, 7, 128), (torch.bfloat16, 1, 64),
              (torch.float32, 2, 32), (torch.float32, 1, 32),
              (torch.bfloat16, 8, 128), (torch.float16, 1, 80),
              (torch.float32, 7, 64), (torch.bfloat16, 1, 128),
              (torch.float16, 3, 128), (torch.bfloat16, 16, 128),
              (torch.bfloat16, 3, 256), (torch.float32, 3, 256),
              (torch.float16, 1, 100), (torch.float32, 1, 100),
              (torch.bfloat16, 2, 160), (torch.float16, 2, 33),
              (torch.bfloat16, 3, 512), (torch.float16, 1, 320),
              (torch.float32, 3, 289)]
# The tensor-core walk's published geometries: (query group, kv heads,
# head_dim) of bench-1b, Mixtral-8x7B, OPT-1.3b, Llama-3-70B, OPT-2.7b,
# TinyLlama-1.1B, Falcon3-7B and OpenLLaMA-3B; the slab walk at 512
# (group 3 over 2 kv heads) and 320.
MMA_GEOMETRIES = [(4, 8, 64), (4, 8, 128), (1, 32, 64), (8, 8, 128),
                  (1, 32, 80), (8, 4, 64), (3, 4, 256), (1, 32, 100),
                  (3, 2, 512), (1, 16, 320)]

TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4),
       torch.bfloat16: dict(atol=2e-2, rtol=2e-2),
       torch.float16: dict(atol=2e-2, rtol=2e-2)}


def _ragged_plain(*args, **kwargs):
    """The ragged kernel's plain version rounded as the kernel rounds:
    bf16 and f16 queries run the tensor-core walk, whose probabilities
    enter p . v in the query's type; f32 queries the f32 walk."""
    if args[0].dtype != torch.float32:
        kwargs["p_dtype"] = args[0].dtype
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


@pytest.mark.parametrize("page_size", [1, 8, 12, 16, 24, 32, 48, 64, 96,
                                       128, 200, 256, 384, 512])
def test_decode_kernel_page_sizes(dev, page_size):
    kv_lens = [5, 0, 200, 640]
    k, v, table, lens, g = _inputs(dev, torch.bfloat16, 4, kv_lens, 4, 8,
                                   64, page_size, 2)
    q = torch.randn((4, 32, 64), generator=g).to(dev, torch.bfloat16)
    got = paged_decode_attention(q, k, v, table, lens)
    ref = paged_decode_attention_plain(q, k, v, table, lens)
    torch.testing.assert_close(got.float(), ref.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("page_size", [16, 48, 128, 256])
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
@pytest.mark.parametrize("page_size", [16, 48, 128, 256])
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
    with pytest.raises(ValueError, match="multiple of kv heads"):
        paged_decode_attention(q[:, :3].contiguous(), k, v, table, lens)
    # Any query group, every dtype and every head_dim of 1 or more is
    # served: 288, past the widest tile, runs as three slabs of 128 and
    # matches its plain version in bf16, f32 and f16 alike.
    k96, v96, table96, lens96, _ = _inputs(dev, torch.bfloat16, 2, [3, 9],
                                           4, 2, 288, 16, 5)
    q96 = torch.randn((2, 8, 288), generator=g).to(dev, torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        args = (q96.to(dtype), k96.to(dtype), v96.to(dtype), table96,
                lens96)
        got = paged_decode_attention(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), paged_decode_attention_plain(
            *args).float(), **TOL[dtype])
    qr = torch.randn((2, 3, 8, 64), generator=g).to(dev, torch.bfloat16)
    last = torch.tensor([2, 0], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):
        paged_ragged_attention(qr, k, v, table, lens, last.long())
    with pytest.raises(ValueError, match="rows"):
        paged_ragged_attention(qr, k, v, table, lens, last[:1])
    with pytest.raises(ValueError, match="multiple of kv heads"):
        paged_ragged_attention(qr[:, :, :3].contiguous(), k, v, table,
                               lens, last)
    with pytest.raises(ValueError, match="scales"):
        paged_ragged_attention(qr, k.to(torch.int8), v.to(torch.int8),
                               table, lens, last)


def test_library_serves_every_head_dim_to_256(dev):
    """The built library answers the Python rule at every head_dim 0 to
    1100 (slabs of 128 past 256), in every dtype over both caches, and
    the decode kernel's group tile is the host's wherever a tile or a
    slab holds the head_dim."""
    from production_stack_tpu_torch.ops import paged_kv_common as pkc
    from production_stack_tpu_torch.ops.paged_attention_cuda import (
        decode_group_tile)
    lib = pkc.kernel_lib()
    for d in range(0, 1101):
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            for cache in (dtype, torch.int8):
                assert bool(lib.pstt_kernel_supports(
                    pkc.dtype_code(dtype), pkc.cache_code(cache), 3, d)) == (
                    pkc.kernel_geometry_supported(dtype, cache, 3, d)), (
                    d, dtype, cache)
        if pkc.kernel_head_dim_tile(d) is not None:
            for group in (1, 2, 3, 4, 5, 8, 16):
                assert (lib.pstt_decode_group_tile(group, d)
                        == decode_group_tile(group, d)), (group, d)


# ---- the redesigned decode and prefill kernels ------------------------------


def _wide_inputs(dev, dtype, kv_lens, group, kv_heads, head_dim, page_size,
                 max_len, seed, int8=False):
    """Caches, a page table ``max_len`` tokens wide and kv lens: the
    table's width, not the rows' lengths, sets the decode split."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(kv_lens)
    max_pages = -(-max_len // page_size)
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


@pytest.mark.parametrize("group,kv_heads,head_dim", MMA_GEOMETRIES)
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size", [8, 16, 24, 32, 48, 64, 128, 200,
                                       256])
@pytest.mark.parametrize("t", [16, 32, 64, 128, 256, 512])
def test_prefill_mma_buckets_and_page_sizes(dev, t, page_size, int8, group,
                                            kv_heads, head_dim):
    """Every T bucket and page size of the tensor-core prefill walk, at
    row starts off the tile and the chunk (37, 600), a kv_len one past
    a chunk edge, a one-token row and a pad row; two launches equal bit
    for bit."""
    rows = [(0, t), (37, t), (600, max(1, t - 7)), (128 - t + 1, t),
            (0, 0), (300, 1)]
    rows = [(max(s, 0), n) for s, n in rows]
    kv_lens = [s + n if n else 0 for s, n in rows]
    k, v, table, lens, g = _wide_inputs(dev, torch.bfloat16, kv_lens, group,
                                        kv_heads, head_dim, page_size, 1152,
                                        34, int8)
    q = torch.randn((len(rows), t, group * kv_heads, head_dim),
                    generator=g).to(dev, torch.bfloat16)
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


# The prefill kernel's wgmma walk (csrc/paged_walk_wgmma.cuh): every
# head-dim tile and two padded head dims, pages 1 to 256, bf16, f16 and
# int8 caches per layer and stacked; each case one T bucket of 16..512
# (rotating over the cases), rows of a first and a second chunk, a
# one-token row and a kv_len-0 row.
WGMMA_HEAD_DIMS = [32, 64, 80, 128, 256, 100, 160]
WGMMA_PAGES = [1, 8, 16, 48, 128, 256]
WGMMA_FORMS = {"bf16": (torch.bfloat16, False, False),
               "f16": (torch.float16, False, False),
               "bf16_int8": (torch.bfloat16, True, False),
               "f16_int8": (torch.float16, True, False),
               "bf16_stacked": (torch.bfloat16, False, True),
               "bf16_int8_stacked": (torch.bfloat16, True, True)}
WGMMA_T = [16, 32, 64, 128, 256, 512]


def _prefill_into(out, q, k, v, table, pos, lens, layer=None):
    """The prefill kernel's launch as the wrapper makes it, into a
    given ``out`` (a view of a larger buffer)."""
    from production_stack_tpu_torch.ops import paged_kv_common as pkc
    kc, vc, ks, vs = pkc.split_cache(k, v)
    b, t, nh, d = q.shape
    kvh, num_pages, _, ps = kc.shape[-4:]
    err = pkc.kernel_lib().pstt_paged_prefill(
        pkc.dtype_code(q.dtype), pkc.cache_code(kc.dtype), q.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), pkc.data_ptr(ks), pkc.data_ptr(vs),
        table.data_ptr(), pos.data_ptr(), lens.data_ptr(), out.data_ptr(),
        b, t, nh, kvh, d, num_pages, ps, table.shape[1],
        *pkc.layer_args(kc, ks, layer), pkc.stream_ptr())
    assert err == 0


@pytest.mark.parametrize("form", sorted(WGMMA_FORMS))
@pytest.mark.parametrize("page_size", WGMMA_PAGES)
@pytest.mark.parametrize("head_dim", WGMMA_HEAD_DIMS)
def test_prefill_wgmma_walk_matches_plain(dev, head_dim, page_size, form):
    """Group 3 over 2 kv heads (G * T rows: 48 at T = 16, one consumer
    warpgroup and a 64-row tile with 16 pad rows; 96 and up, two and a
    128-row tile). The launch writes into a view of a NaN-filled buffer:
    every slot is written, kv_len-0 rows exact 0, and nothing past the
    output (the last tile's pad rows) is; two launches equal bit for
    bit."""
    dtype, int8, stacked = WGMMA_FORMS[form]
    case = (WGMMA_HEAD_DIMS.index(head_dim) * len(WGMMA_PAGES)
            + WGMMA_PAGES.index(page_size)) * len(WGMMA_FORMS) + sorted(
                WGMMA_FORMS).index(form)
    t = WGMMA_T[case % len(WGMMA_T)]
    rows = [(0, t), (600, max(1, t - 3)), (0, 0), (37, 1)]
    kv_lens = [s + n if n else 0 for s, n in rows]
    k, v, table, lens, g = _wide_inputs(dev, dtype, kv_lens, 3, 2,
                                        head_dim, page_size, 1152, case,
                                        int8)
    layer = None
    if stacked:
        layer = 2
        k, v = _stacked(k, 3, layer, g), _stacked(v, 3, layer, g)
    q = torch.randn((len(rows), t, 6, head_dim), generator=g).to(dev, dtype)
    starts = torch.tensor([s if n else 0 for s, n in rows],
                          dtype=torch.int32, device=dev)
    pos = (starts[:, None] + torch.arange(t, dtype=torch.int32,
                                          device=dev)).contiguous()
    guard = 3 * 64 * 6 * head_dim
    buf = torch.full((q.numel() + guard,), float("nan"), dtype=dtype,
                     device=dev)
    got = buf[:q.numel()].view(q.shape)
    _prefill_into(got, q, k, v, table, pos, lens, layer)
    again = paged_prefill_attention(q, k, v, table, pos, lens, layer=layer)
    ref = paged_prefill_attention_plain(q, k, v, table, pos, lens,
                                        layer=layer)
    torch.cuda.synchronize()
    assert not got.isnan().any()
    assert buf[q.numel():].isnan().all()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    assert torch.equal(got, again)
    assert torch.equal(got[2], torch.zeros_like(got[2]))


# The wgmma walk's wide form (head dims 257 to 512: widths 384 and 512,
# two consumer warpgroups on a 64-row tile, each owning half the output
# dims): the widths and head dims padded below them, query groups 1, 3
# and 8 over 2 kv heads, pages 8 to 256, bf16 and f16 over their own
# type and over int8, per layer and stacked; each case one T bucket of
# 16..512 (rotating), rows of a first and a second chunk, a one-token
# row and a kv_len-0 row.
WIDE_HEAD_DIMS = [257, 320, 384, 448, 512]
WIDE_GROUPS = [1, 3, 8]
WIDE_PAGES = [8, 16, 48, 128, 256]
WIDE_FORMS = {"bf16": (torch.bfloat16, False, False),
              "f16": (torch.float16, False, False),
              "bf16_int8": (torch.bfloat16, True, False),
              "f16_int8": (torch.float16, True, False),
              "bf16_stacked": (torch.bfloat16, False, True),
              "f16_int8_stacked": (torch.float16, True, True)}


@pytest.mark.parametrize("form", sorted(WIDE_FORMS))
@pytest.mark.parametrize("page_size", WIDE_PAGES)
@pytest.mark.parametrize("group", WIDE_GROUPS)
@pytest.mark.parametrize("head_dim", WIDE_HEAD_DIMS)
def test_prefill_wgmma_wide_walk_matches_plain(dev, head_dim, group,
                                               page_size, form):
    """Written into a view of a NaN-filled buffer: every slot is
    written (both warpgroups' halves of every row), kv_len-0 rows exact
    0, nothing past the output; two launches equal bit for bit."""
    dtype, int8, stacked = WIDE_FORMS[form]
    case = ((WIDE_HEAD_DIMS.index(head_dim) * len(WIDE_GROUPS)
             + WIDE_GROUPS.index(group)) * len(WIDE_PAGES)
            + WIDE_PAGES.index(page_size)) * len(WIDE_FORMS) + sorted(
                WIDE_FORMS).index(form)
    t = WGMMA_T[case % len(WGMMA_T)]
    rows = [(0, t), (600, max(1, t - 3)), (0, 0), (37, 1)]
    kv_lens = [s + n if n else 0 for s, n in rows]
    k, v, table, lens, g = _wide_inputs(dev, dtype, kv_lens, group, 2,
                                        head_dim, page_size, 1152, case,
                                        int8)
    layer = None
    if stacked:
        layer = 1
        k, v = _stacked(k, 2, layer, g), _stacked(v, 2, layer, g)
    nh = 2 * group
    q = torch.randn((len(rows), t, nh, head_dim), generator=g).to(dev,
                                                                  dtype)
    starts = torch.tensor([s if n else 0 for s, n in rows],
                          dtype=torch.int32, device=dev)
    pos = (starts[:, None] + torch.arange(t, dtype=torch.int32,
                                          device=dev)).contiguous()
    guard = 64 * nh * head_dim
    buf = torch.full((q.numel() + guard,), float("nan"), dtype=dtype,
                     device=dev)
    got = buf[:q.numel()].view(q.shape)
    _prefill_into(got, q, k, v, table, pos, lens, layer)
    again = paged_prefill_attention(q, k, v, table, pos, lens, layer=layer)
    ref = paged_prefill_attention_plain(q, k, v, table, pos, lens,
                                        layer=layer, p_dtype=dtype)
    torch.cuda.synchronize()
    assert not got.isnan().any()
    assert buf[q.numel():].isnan().all()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    assert torch.equal(got, again)
    assert torch.equal(got[2], torch.zeros_like(got[2]))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype,head_dim,walk", [
    (torch.bfloat16, 320, "_wgmma_wide_kernel"),
    (torch.float16, 512, "_wgmma_wide_kernel"),
    (torch.bfloat16, 513, "_mma_slab_kernel"),
    (torch.float16, 576, "_mma_slab_kernel")])
def test_prefill_wide_head_dims_run_their_walk(dev, dtype, head_dim, walk,
                                               int8):
    """The device kernel a launch runs, by name: the wide form for
    16-bit head dims 257 to 512 (its plan, ``prefill_walk_plan``,
    ``wgmma_wide``), the slab walk above; one kernel a launch, no other
    walk and no plain version on the way."""
    from torch.profiler import ProfilerActivity, profile

    from production_stack_tpu_torch.ops.prefill_attention_cuda import (
        prefill_walk_plan)
    rows = [(0, 64), (100, 30)]
    kv_lens = [s + n for s, n in rows]
    k, v, table, lens, g = _wide_inputs(dev, dtype, kv_lens, 3, 2,
                                        head_dim, 16, 256, 7, int8)
    q = torch.randn((2, 64, 6, head_dim), generator=g).to(dev, dtype)
    pos = (torch.tensor([0, 100], dtype=torch.int32, device=dev)[:, None]
           + torch.arange(64, dtype=torch.int32, device=dev)).contiguous()
    paged_prefill_attention(q, k, v, table, pos, lens)
    torch.cuda.synchronize()
    COUNTERS.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = paged_prefill_attention(q, k, v, table, pos, lens)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if "paged_prefill" in e.key]
    assert len(names) == 1 and walk in names[0], names
    assert not COUNTERS.plain_cuda_calls
    plan = prefill_walk_plan(dtype, torch.int8 if int8 else dtype, 3, 64,
                             head_dim, 16)
    assert plan["walk"] == ("wgmma_wide" if "wide" in walk else "mma_slab")
    ref = paged_prefill_attention_plain(q, k, v, table, pos, lens,
                                        p_dtype=dtype)
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])


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


@pytest.mark.parametrize("group,kv_heads,head_dim", MMA_GEOMETRIES)
@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("page_size", [8, 16, 32, 48, 64, 128, 256])
@pytest.mark.parametrize("block", sorted(RAGGED_MMA_BLOCKS))
def test_ragged_mma_blocks(dev, block, page_size, int8, stacked, group,
                           kv_heads, head_dim):
    """The bf16 ragged kernel on the tensor-core walk: within tolerance
    of the bf16-p plain version on every slot, dead slots and pad rows
    exact 0, two launches equal bit for bit and, stacked, bitwise equal
    to the per-layer launch on the layer's view."""
    w, rows = RAGGED_MMA_BLOCKS[block]
    kv_lens = [n for n, _ in rows]
    k, v, table, lens, g = _wide_inputs(dev, torch.bfloat16, kv_lens, group,
                                        kv_heads, head_dim, page_size, 1024,
                                        41, int8)
    last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                        device=dev)
    drafts = torch.clamp(last, min=0) if block == "verify" else None
    q = torch.randn((len(rows), w, group * kv_heads, head_dim),
                    generator=g).to(dev, torch.bfloat16)
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


# The ragged kernel's 16-bit head dims 129 to 512 on the wgmma walk (the
# tile 256; the wide form at widths 384 and 512), as (W, [(kv_len,
# last_index), ...]) at group 3 over 2 kv heads: a unified block (decode
# rows, chunk rows of first and later chunks whose live slots end inside
# a tile, a pad row), a verify block (draft lens 0..4: one tile a pair,
# one consumer warpgroup), a block of pad rows only (every tile dead)
# and decode rows alone, whose one live slot is slot 0 (every tile but
# the first dead; named so that the card tests' -k partitions keep it
# with the other ragged cases).
RAGGED_WG_BLOCKS = {
    "unified": (160, [(1, 0), (130, 0), (700, 0), (37, 36), (300, 99),
                      (660, 159), (0, -1)]),
    "verify": (5, [(max(n, i % 5 + 1), i % 5) for i, n in enumerate(
        (1, 64, 129, 300, 511, 1024))] + [(0, -1)]),
    "all_dead": (160, [(0, -1)] * 4),
    "single_slot": (160, [(n, 0) for n in (1, 65, 200, 1024)]
                    + [(0, -1)]),
}
RAGGED_WG_HEAD_DIMS = (200, 256, 257, 320, 384, 512)
RAGGED_WG_PAGES = (8, 16, 48, 128)
# Each (head_dim, block) in bf16 or f16 (alternating) at one page size
# (rotating): every head dim meets both query types, every block and
# every page.
RAGGED_WG_CASES = [
    (d, block, (torch.bfloat16, torch.float16)[i % 2],
     RAGGED_WG_PAGES[(i // 2) % len(RAGGED_WG_PAGES)])
    for i, (d, block) in enumerate(
        (d, b) for d in RAGGED_WG_HEAD_DIMS for b in sorted(RAGGED_WG_BLOCKS))]


def _ragged_into(out, q, k, v, table, lens, last, drafts, layer=None):
    """The ragged kernel's launch as the wrapper makes it, into a given
    ``out`` (a view of a larger buffer)."""
    from production_stack_tpu_torch.ops import paged_kv_common as pkc
    kc, vc, ks, vs = pkc.split_cache(k, v)
    r, w, nh, d = q.shape
    kvh, num_pages, _, ps = kc.shape[-4:]
    err = pkc.kernel_lib().pstt_paged_ragged(
        pkc.dtype_code(q.dtype), pkc.cache_code(kc.dtype), q.data_ptr(),
        kc.data_ptr(), vc.data_ptr(), pkc.data_ptr(ks), pkc.data_ptr(vs),
        table.data_ptr(), lens.data_ptr(), last.data_ptr(),
        pkc.data_ptr(drafts), out.data_ptr(), r, w, nh, kvh, d, num_pages,
        ps, table.shape[1], *pkc.layer_args(kc, ks, layer), pkc.stream_ptr())
    assert err == 0


def _ragged_walks(fn):
    """{walk: launches} of the ragged kernel while ``fn`` runs, from the
    library's count of each walk's launches."""
    from production_stack_tpu_torch.ops import paged_kv_common as pkc
    from production_stack_tpu_torch.ops.ragged_attention_cuda import (
        RAGGED_WALKS)
    lib = pkc.kernel_lib()
    before = [lib.pstt_ragged_walk_launches(i)
              for i in range(len(RAGGED_WALKS))]
    fn()
    torch.cuda.synchronize()
    after = [lib.pstt_ragged_walk_launches(i)
             for i in range(len(RAGGED_WALKS))]
    return {w: n1 - n0 for w, n0, n1 in zip(RAGGED_WALKS, before, after)
            if n1 != n0}


@pytest.mark.parametrize("stacked", [False, True])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("head_dim,block,dtype,page_size", RAGGED_WG_CASES,
                         ids=[f"d{d}-{b}-{str(t)[6:]}-ps{ps}"
                              for d, b, t, ps in RAGGED_WG_CASES])
def test_ragged_wgmma_blocks(dev, head_dim, block, dtype, page_size, int8,
                             stacked):
    """The 16-bit ragged kernel at head dims 129 to 512 runs the wgmma
    walk its plan names (``ragged_walk_plan``: ``wgmma`` to 256,
    ``wgmma_wide`` above; the library's count of each walk's launches).
    Written into a view of a NaN-filled buffer: every slot written,
    within tolerance of the plain version with the kernel's rounding,
    dead slots and pad rows exact 0, nothing past the output; two
    launches equal bit for bit; stacked, bitwise the per-layer launch on
    the layer's view."""
    from production_stack_tpu_torch.ops.ragged_attention_cuda import (
        ragged_walk_plan)
    w, rows = RAGGED_WG_BLOCKS[block]
    kv_lens = [n for n, _ in rows]
    k, v, table, lens, g = _wide_inputs(dev, dtype, kv_lens, 3, 2, head_dim,
                                        page_size, 1024, 51, int8)
    last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                        device=dev)
    drafts = torch.clamp(last, min=0) if block == "verify" else None
    q = torch.randn((len(rows), w, 6, head_dim), generator=g).to(dev, dtype)
    layer = {}
    if stacked:
        layer = {"layer": 1}
        k, v = (_stacked(c, 2, 1, g) for c in (k, v))
    guard = 2 * 64 * 6 * head_dim
    buf = torch.full((q.numel() + guard,), float("nan"), dtype=dtype,
                     device=dev)
    got = buf[:q.numel()].view(q.shape)
    walks = _ragged_walks(lambda: _ragged_into(
        got, q, k, v, table, lens, last, drafts, layer.get("layer")))
    plan = ragged_walk_plan(dtype, torch.int8 if int8 else dtype, 3, w,
                            head_dim, page_size)
    assert plan["walk"] == ("wgmma" if head_dim <= 256 else "wgmma_wide")
    assert walks == {plan["walk"]: 1}
    again = paged_ragged_attention(q, k, v, table, lens, last, drafts,
                                   **layer)
    ref = _ragged_plain(q, k, v, table, lens, last, drafts, **layer)
    torch.cuda.synchronize()
    assert not got.isnan().any()
    assert buf[q.numel():].isnan().all()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    assert torch.equal(got, again)
    dead = ((torch.arange(w, device=dev)[None] > last[:, None].long())
            | (lens[:, None] == 0))
    assert not got[dead].any()  # dead slots and pad rows: exact 0
    if stacked:
        per_layer = paged_ragged_attention(q, k[1], v[1], table, lens, last,
                                           drafts)
        assert torch.equal(got, per_layer)


# ---- the int8 form ----------------------------------------------------------


def _quantize(cache):
    """A [kv, pages, d, ps] cache quantized per (page, slot, kv head)
    row, as the page writes lay it out."""
    q8, scale = quantize_kv(cache.permute(0, 1, 3, 2))
    return QuantKV(q8.permute(0, 1, 3, 2).contiguous(), scale.contiguous())


@pytest.mark.parametrize("page_size", [1, 8, 12, 16, 24, 32, 48, 128, 200,
                                       256, 384])
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


@pytest.mark.parametrize("page_size", [8, 12, 16, 48, 128, 256])
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
@pytest.mark.parametrize("page_size", [8, 12, 16, 48, 128, 256])
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
    # Page size 8: an int8 page row of 8 bytes is served (8-byte copies).
    k8, v8 = _quantize(k), _quantize(v)
    torch.testing.assert_close(
        paged_decode_attention(q, k8, v8, table, lens).float(),
        paged_decode_attention_plain(q, k8, v8, table, lens).float(),
        **TOL[torch.bfloat16])
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
                    cache_layout="auto", decode_steps=1, arch="llama"):
    """The tiny engine's greedy streams on the CPU and on the card,
    with the launch counters of the card's run."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig, tiny_model_config)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.models.registry import get_model

    init_params = get_model(tiny_model_config(arch))[0]
    cfg = EngineConfig(
        model=tiny_model_config(arch),
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


@pytest.mark.parametrize("arch", ["llama", "opt", "gpt2"])
@pytest.mark.parametrize("speculative_k", [0, 4])
def test_engine_greedy_streams_on_the_card_match_the_cpu(dev,
                                                         speculative_k,
                                                         arch):
    """tiny-llama (group 2), tiny-opt and tiny-gpt2 (group 1, learned
    positions): the card's greedy streams are the CPU's."""
    streams, drafted, launches = _engine_streams(
        speculative_k=speculative_k, arch=arch)
    assert streams[0] == streams[1]
    assert launches["paged_prefill"] > 0
    assert launches["paged_decode"] > 0
    assert launches["paged_ragged"] > 0
    assert not COUNTERS.plain_cuda_calls
    if speculative_k:
        assert drafted[0] > 0 and drafted[1] > 0


@pytest.mark.parametrize("arch", ["llama", "opt"])
def test_engine_int8_greedy_streams_on_the_card_match_the_cpu(dev, arch):
    """With int8 KV the card runs the int8 form of all three kernels
    (and no other form), and its greedy streams are the CPU's."""
    streams, _, launches = _engine_streams(kv_cache_dtype="int8",
                                           arch=arch)
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
        scheduler=SchedulerConfig(**{"max_num_seqs": 4, "max_model_len": 256,
                                     "prefill_chunk_size": 32, **sched}))
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
            assert g.eager_steps == {"seeded": 0, "embed": 0}
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
        assert engine.runner.graphs.eager_steps == {"seeded": 0, "embed": 0}
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


@pytest.mark.parametrize("decode_steps", [1, 4])
def test_sampling_options_graphed_match_eager_and_the_cpu(dev, decode_steps):
    """Every per-row option (penalties, logit_bias, min_tokens, guided
    JSON, top-20 logprobs) beside plain rows, on the card graphed and
    eager and on the CPU: the same greedy streams, logprobs within 1e-4
    (f32 tiny-llama), one capture a (kind, shape, mode, option set)
    key and no eager step."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams

    base = dict(temperature=0.0, max_tokens=12)
    rows = [dict(base, ignore_eos=True),
            dict(base, ignore_eos=True, presence_penalty=1.0,
                 frequency_penalty=0.5, repetition_penalty=1.2,
                 logprobs=True, top_logprobs=20),
            dict(base, ignore_eos=True, logit_bias={123: 100.0}),
            dict(base, min_tokens=5, logit_bias={257: 100.0}),
            dict(base, max_tokens=30, guided="json",
                 logit_bias={ord("{"): 60.0, ord('"'): 100.0,
                             ord(":"): 80.0, ord("}"): 50.0, 257: 100.0})]
    prompts = [[4, 5, 6] * 7, [8] * 10, [21, 22, 23, 24] * 5, [9] * 13,
               [30, 31] * 9]
    out = {}
    for path, graphs, device in (("graphs", True, "cuda"),
                                 ("eager", False, "cuda"),
                                 ("cpu", False, "cpu")):
        engine = _tiny_engine(graphs, device, max_num_seqs=8,
                              prefill_batch_size=8, unified_step=True,
                              async_scheduling=decode_steps == 1,
                              decode_steps=decode_steps)
        ids = [engine.add_request(p, SamplingParams(**kw))
               for p, kw in zip(prompts, rows)]
        got = {sid: [] for sid in ids}
        while engine.has_work():
            for o in engine.step():
                if o.new_token is not None:
                    got[o.seq_id].append((o.new_token, o.logprobs))
        out[path] = [got[sid] for sid in ids]
        if graphs:
            g = engine.runner.graphs
            assert sum(g.captures.values()) == len(g.keys()) > 0
            assert g.eager_steps == {"seeded": 0, "embed": 0}
            assert any(k[3] for k in g.keys())
    tokens = {p: [[t for t, _ in r] for r in rs] for p, rs in out.items()}
    assert tokens["graphs"] == tokens["eager"] == tokens["cpu"]
    assert tokens["graphs"][2] == [123] * 12
    assert tokens["graphs"][3][-1] == 257 and len(tokens["graphs"][3]) == 6
    for a, b in ((out["graphs"][1], out["eager"][1]),
                 (out["graphs"][1], out["cpu"][1])):
        for (_, (slp, tops)), (_, (e_slp, e_tops)) in zip(a, b):
            assert abs(slp - e_slp) <= 1e-4
            assert max(abs(x[1] - y[1]) for x, y in zip(tops, e_tops)) <= 1e-4


# ---- the offload tier on the card: ship and restore under graphs -----------


def _offload_engine(device, remote=None, checkpoint=4, host_pool_bytes=None,
                    **sched):
    """The tiny engine with an offload tier and stream checkpoints."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, OffloadConfig, SchedulerConfig,
        tiny_model_config)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.models.llama import init_params

    cache = {k: sched.pop(k) for k in ("kv_cache_dtype", "cache_layout")
             if k in sched}
    cfg = EngineConfig(
        model=tiny_model_config("llama"),
        cache=CacheConfig(page_size=16, num_pages=128, **cache),
        scheduler=SchedulerConfig(**{"max_num_seqs": 4, "max_model_len": 256,
                                     "prefill_chunk_size": 32, **sched}),
        offload=OffloadConfig(
            enable=True, remote_url=remote,
            host_pool_bytes=(256 * 1024 ** 2 if host_pool_bytes is None
                             else host_pool_bytes)),
        checkpoint_interval_tokens=checkpoint)
    params = init_params(cfg.model, torch.Generator().manual_seed(0),
                         torch.device("cpu"))
    return LLMEngine(cfg, params=params, device=device)


OFFLOAD_SCHEDS = [
    dict(unified_step=True, async_scheduling=True),
    dict(unified_step=True, async_scheduling=False, decode_steps=4,
         cache_layout="stacked", kv_cache_dtype="int8"),
]


@pytest.mark.parametrize("sched", OFFLOAD_SCHEDS, ids=["async", "bursts"])
def test_checkpoint_pages_read_in_flight_equal_the_settled_cache(dev,
                                                                 sched):
    """Checkpoints ship pages while a graphed step is in flight (the
    async pipeline) or right after a burst: every shipped page equals
    the page read back once the card has settled, and the streams equal
    the CPU's (the plain path)."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
    engine = _offload_engine("cuda", **dict(sched))
    shipped = {}
    offload_page = engine.offload.offload_page

    def record(page_hash, *payload, chain=None):
        shipped[page_hash] = [t.clone() for t in payload]
        offload_page(page_hash, *payload, chain=chain)

    engine.offload.offload_page = record
    streams = [s.output_token_ids for s in
               engine.generate_batch(_tiny_prompts(), sp)]
    torch.cuda.synchronize()
    assert engine.checkpoint_ships > 0 and shipped
    for page_hash, payload in shipped.items():
        page_id = engine.cache_manager._hash_to_page[page_hash]
        settled = engine.runner.read_page(page_id)
        assert all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(payload, settled))
    cpu = _offload_engine("cpu", **dict(sched))
    assert streams == [s.output_token_ids for s in
                       cpu.generate_batch(_tiny_prompts(), sp)]
    assert not COUNTERS.plain_cuda_calls


@pytest.mark.parametrize("sched", OFFLOAD_SCHEDS, ids=["async", "bursts"])
def test_resume_restores_pages_under_graphs(dev, sched):
    """A stream checkpointed by one graphed engine over a remote tier
    (the port's cache server, host pool 0) resumes on a second: its
    restored pages equal the shipped bytes, the kernels read them, and
    the continuation equals the first engine's greedy stream."""
    import threading

    from production_stack_tpu_torch.engine.cache_server import (
        build_cache_server)
    from production_stack_tpu_torch.engine.offload import RemoteKVClient
    from production_stack_tpu_torch.engine.sequence import (
        SamplingParams, SequenceState)

    server = build_cache_server(256 * 1024 ** 2)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        sp = SamplingParams(temperature=0.0, max_tokens=24, ignore_eos=True)
        prompt = [21, 22, 23, 24] * 20
        a = _offload_engine("cuda", remote=server.url, host_pool_bytes=0,
                            **dict(sched))
        sid = a.add_request(list(prompt), sp)
        seq, frames = a.sequences[sid], []
        while seq.state != SequenceState.FINISHED:
            a.step()
            ckpt = a.take_checkpoint(sid)
            if ckpt is not None:
                frames.append(ckpt)
        full = list(seq.output_token_ids)
        desc = next(f for f in frames if f["output_tokens"] < 24
                    and len(f["tokens"]) % 16)
        b = _offload_engine("cuda", remote=server.url, host_pool_bytes=0,
                            checkpoint=0, **dict(sched))
        restored = []
        register = b.cache_manager.register_restored_page

        def record(page_id, page_hash):
            restored.append((page_id, page_hash))
            register(page_id, page_hash)

        b.cache_manager.register_restored_page = record
        COUNTERS.reset()
        sid = b.add_resume(desc["tokens"], desc["output_tokens"],
                           SamplingParams(temperature=0.0, max_tokens=24,
                                          ignore_eos=True))
        resumed = b.sequences[sid]
        while resumed.state != SequenceState.FINISHED:
            b.step()
        assert desc["tokens"][len(prompt):] + resumed.output_token_ids == full
        assert b.offload.restored_pages == len(restored) > 0
        assert sum(COUNTERS.launches.values()) > 0
        assert not COUNTERS.plain_cuda_calls
        client = RemoteKVClient(server.url)
        for page_id, page_hash in restored:
            wire = client.get(b.offload.key_for(page_hash))
            assert all(torch.equal(x, y) for x, y in
                       zip(wire, b.runner.read_page(page_id)))
    finally:
        server.shutdown()


# ---- disaggregation on the card: a handoff in each cache form -----------------


@pytest.mark.parametrize("cache", [
    {}, {"kv_cache_dtype": "int8"}, {"cache_layout": "stacked"},
    {"cache_layout": "stacked", "kv_cache_dtype": "int8"}],
    ids=["per_layer", "int8", "stacked", "int8_stacked"])
def test_handoff_restores_the_shipped_pages(dev, cache):
    """A prefill-role engine on the card ships a prompt's pages to the
    port's cache server; a decode-role engine restores them under its
    graphs. The restored pages equal the shipped bytes, the kernels read
    them, and the stream equals a monolithic engine's on the card."""
    import threading

    from production_stack_tpu_torch.engine.cache_server import (
        build_cache_server)
    from production_stack_tpu_torch.engine.offload import RemoteKVClient
    from production_stack_tpu_torch.engine.sequence import (
        SamplingParams, SequenceState)

    server = build_cache_server(256 * 1024 ** 2)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        prompt = [31, 32, 33, 34, 35] * 13  # 4 full pages of 16, a tail
        sp = dict(temperature=0.0, max_tokens=16, ignore_eos=True)
        mono = _offload_engine("cuda", checkpoint=0, **dict(cache))
        ref = mono.generate(list(prompt), SamplingParams(**sp))
        tier = dict(remote=server.url, host_pool_bytes=0, checkpoint=0,
                    **cache)
        pre = _offload_engine("cuda", **tier)
        sid = pre.add_request(list(prompt), SamplingParams(**sp),
                              handoff_prefill=True)
        outs = []
        while not outs or not outs[-1].finished:
            outs.extend(pre.step())
        first, info = outs[-1].new_token, pre.take_handoff_info(sid)
        assert outs[-1].finish_reason == "handoff"
        assert info["num_pages"] == 4 and info["kv_bytes"] > 0
        dec = _offload_engine("cuda", **tier)
        restored = []
        register = dec.cache_manager.register_restored_page

        def record(page_id, page_hash):
            restored.append((page_id, page_hash))
            register(page_id, page_hash)

        dec.cache_manager.register_restored_page = record
        COUNTERS.reset()
        seq = dec.sequences[dec.add_handoff(list(prompt), first,
                                            SamplingParams(**sp))]
        while seq.state != SequenceState.FINISHED:
            dec.step()
        torch.cuda.synchronize()
        assert [first] + seq.output_token_ids == ref.output_token_ids
        assert len(restored) == 4
        assert sum(COUNTERS.launches.values()) > 0
        assert not COUNTERS.plain_cuda_calls
        client = RemoteKVClient(server.url)
        keys = [dec.offload.key_for(h) for _, h in restored]
        assert keys == info["page_keys"]
        for (page_id, page_hash), key in zip(restored, keys):
            wire = client.get(key)
            assert all(torch.equal(x, y) for x, y in
                       zip(wire, dec.runner.read_page(page_id)))
    finally:
        server.shutdown()


# ---- the int8-weight GEMM (ops/int8_matmul_cuda.py) ------------------------

# The four projections of bench-1b as (K, N) (qkv, o, gate_up, down),
# tile-edge ones (N not a multiple of a block's rows; 203: nor of the
# epilogue's four-row stores), K tails inside a 128-value stage (192:
# half a stage; 144: the stage's second box wholly past K) and a tp-2
# ``down`` (2816), and the tiny model's f32 ones.
W8_BF16_SHAPES = [(2048, 3072), (2048, 2048), (2048, 11264), (5632, 2048),
                  (128, 200), (128, 203), (192, 2048), (144, 328),
                  (2816, 2048)]
W8_F32_SHAPES = [(128, 256), (128, 128), (128, 512), (256, 128)]
# Every edge of the 16-bit kernel's activation buckets (8, 16, 32, 64,
# 128, 160), and rows between them.
W8_ROWS = [1, 8, 9, 16, 17, 32, 33, 37, 64, 65, 100, 128, 129, 160]


def _w8_inputs(dev, dtype, m, k, n, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((m, k), generator=g).to(dev, dtype)
    q = torch.randint(-127, 128, (n, k), generator=g,
                      dtype=torch.int8).to(dev)
    scale = (torch.rand((n,), generator=g) * 0.02 / 127 + 1e-4).to(dev)
    return x, q, scale


def _w8_check(dev, dtype, m, k, n):
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        int8_weight_matmul,
        int8_weight_matmul_plain,
    )
    x, q, scale = _w8_inputs(dev, dtype, m, k, n, seed=m + n + k)
    COUNTERS.reset()
    got = int8_weight_matmul(x, q, scale)
    again = int8_weight_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert COUNTERS.launches == {"int8_weight_matmul": 2}
    want = int8_weight_matmul_plain(x, q, scale)
    assert got.dtype == dtype and got.shape == (m, n)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.equal(got, again)


@pytest.mark.parametrize("m", W8_ROWS)
@pytest.mark.parametrize("k,n", W8_BF16_SHAPES)
def test_int8_weight_matmul_kernel_matches_plain(dev, k, n, m):
    _w8_check(dev, torch.bfloat16, m, k, n)


# OPT-2.7b's fc1 and fc2 (K, N) in f16, and a K tail.
@pytest.mark.parametrize("m", [1, 8, 32, 65, 160])
@pytest.mark.parametrize("k,n", [(2560, 10240), (10240, 2560), (192, 200)])
def test_int8_weight_matmul_f16_kernel_matches_plain(dev, k, n, m):
    _w8_check(dev, torch.float16, m, k, n)


def test_int8_weight_matmul_is_one_launch_of_the_wgmma_kernel(dev):
    from torch.profiler import ProfilerActivity, profile

    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        int8_weight_matmul,
    )
    for m, (k, n) in ((1, (2048, 3072)), (32, (2048, 11264)),
                      (160, (5632, 2048))):
        x, q, scale = _w8_inputs(dev, torch.bfloat16, m, k, n, seed=m)
        int8_weight_matmul(x, q, scale)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            int8_weight_matmul(x, q, scale)
            torch.cuda.synchronize()
        # Every kernel of csrc/int8_weight_gemm.cu is named w8_...
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.count and "w8_" in e.key}
        assert len(kernels) == 1, kernels
        name, count = next(iter(kernels.items()))
        assert "w8_wgmma_kernel" in name and count == 1


def test_int8_weight_matmul_replays_inside_a_cuda_graph(dev):
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        int8_weight_matmul,
    )
    for m, (k, n) in ((8, (2048, 3072)), (32, (2048, 2048)),
                      (160, (2048, 11264))):
        x, q, scale = _w8_inputs(dev, torch.bfloat16, m, k, n, seed=n)
        eager = int8_weight_matmul(x, q, scale)  # warms the launch up
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = int8_weight_matmul(x, q, scale)
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        x.copy_(torch.randn_like(x))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, int8_weight_matmul(x, q, scale))


def test_int8_weight_plans_fit_the_cards_clusters(dev):
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        MAX_ACTIVE_CLUSTERS,
        int8_weight_plan,
    )
    from production_stack_tpu_torch.ops.paged_kv_common import (
        dtype_code,
        kernel_lib,
    )
    lib = kernel_lib()
    for k, n in W8_BF16_SHAPES + [(2560, 10240)]:
        for m in W8_ROWS:
            for dtype in (torch.bfloat16, torch.float16):
                p = int8_weight_plan(m, n, k, dtype)
                active = lib.pstt_int8_weight_active_clusters(
                    dtype_code(dtype), p["bucket"], p["warpgroups"],
                    p["cluster"], p["smem"])
                assert active == MAX_ACTIVE_CLUSTERS[p["cluster"]], (p,
                                                                     active)


@pytest.mark.parametrize("m", [1, 5, 64, 160])
@pytest.mark.parametrize("k,n", W8_F32_SHAPES)
def test_int8_weight_matmul_f32_kernel_matches_plain(dev, k, n, m):
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        int8_weight_matmul,
        int8_weight_matmul_plain,
    )
    x, q, scale = _w8_inputs(dev, torch.float32, m, k, n, seed=k + m)
    got = int8_weight_matmul(x[None], q, scale)
    torch.cuda.synchronize()
    assert got.shape == (1, m, n)
    torch.testing.assert_close(got[0], int8_weight_matmul_plain(x, q, scale),
                               **TOL[torch.float32])
    assert torch.equal(got, int8_weight_matmul(x[None], q, scale))


def test_int8_weight_matmul_refuses_what_the_kernel_does_not_take(dev):
    from production_stack_tpu_torch.ops.int8_matmul_cuda import (
        INT8_KERNEL_MAX_ROWS,
        int8_weight_matmul,
    )
    x, q, scale = _w8_inputs(dev, torch.bfloat16, 8, 128, 64, seed=3)
    with pytest.raises(ValueError, match="INT8_KERNEL_MAX_ROWS"):
        int8_weight_matmul(x.new_zeros((INT8_KERNEL_MAX_ROWS + 1, 128)), q,
                           scale)
    with pytest.raises(ValueError, match="multiple of 16"):
        int8_weight_matmul(x[:, :120].contiguous(), q[:, :120].contiguous(),
                           scale)
    with pytest.raises(ValueError, match="int8"):
        int8_weight_matmul(x, q.float(), scale)
    with pytest.raises(ValueError, match="float32"):
        int8_weight_matmul(x, q, scale.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        int8_weight_matmul(x, q.t().contiguous().t(), scale)
    with pytest.raises(ValueError, match="bfloat16, float16 or float32"):
        int8_weight_matmul(x.double(), q, scale)


# ---- the decode kernel's burst-tail form --------------------------------------


def _tail_case(dev, dtype, group, head_dim, page_size, int8, s_len, seed):
    """(q, k, v, table, kv_lens, k_tail, v_tail, q_pos): rows frozen
    after 1..s_len tail slots, a pad row (kv_len 0) among them."""
    kv_lens = [1, 0, 127, 128, 129, 300, 517]
    k, v, table, lens, g = _inputs(dev, dtype, len(kv_lens), kv_lens,
                                   group, 2, head_dim, page_size, seed)
    if int8:
        k, v = _quantize(k), _quantize(v)
    b = len(kv_lens)
    q = torch.randn((b, 2 * group, head_dim), generator=g).to(dev, dtype)
    k_tail = torch.randn((b, s_len, 2, head_dim), generator=g).to(dev, dtype)
    v_tail = torch.randn((b, s_len, 2, head_dim), generator=g).to(dev, dtype)
    live = torch.randint(1, s_len + 1, (b,), generator=g,
                         dtype=torch.int32).to(dev)
    q_pos = (lens + live - 1).contiguous()
    return q, k, v, table, lens, k_tail, v_tail, q_pos


@pytest.mark.parametrize("s_len", [1, 4, 32])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype,group,head_dim", GEOMETRIES)
def test_decode_tail_form_matches_plain(dev, dtype, group, head_dim, int8,
                                        s_len):
    """The tail form at every geometry, bf16/f32 and int8 pages, tails
    of 1, 4 and 32 slots: within tolerance of its plain version (the
    page walk, then the tail as one more split), the same bits launch
    to launch, counted under its own name."""
    from production_stack_tpu_torch.ops.paged_attention_cuda import (
        paged_decode_tail_attention, paged_decode_tail_attention_plain)
    args = _tail_case(dev, dtype, group, head_dim, 16, int8, s_len, 31)
    COUNTERS.reset()
    got = paged_decode_tail_attention(*args)
    again = paged_decode_tail_attention(*args)
    ref = paged_decode_tail_attention_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), **TOL[dtype])
    assert torch.equal(got, again)
    name = "paged_decode_tail" + ("_int8" if int8 else "")
    assert COUNTERS.launches == {name: 2}


@pytest.mark.parametrize("num_splits", [1, 2, 5])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_tail_form_stacked_and_split(dev, int8, num_splits):
    """A stacked cache read at its last layer: within tolerance of the
    plain version and bitwise the per-layer launch on the layer's
    view, at forced splits of the walk (the tail the split after)."""
    from production_stack_tpu_torch.ops.paged_attention_cuda import (
        paged_decode_tail_attention, paged_decode_tail_attention_plain)
    q, k, v, table, lens, kt, vt, q_pos = _tail_case(
        dev, torch.bfloat16, 4, 64, 16, int8, 4, 32)
    g = torch.Generator(device="cpu").manual_seed(33)
    k5, v5 = _stacked(k, 3, 2, g), _stacked(v, 3, 2, g)
    rest = (table, lens, kt, vt, q_pos)
    got = paged_decode_tail_attention(q, k5, v5, *rest, layer=2,
                                      num_splits=num_splits)
    ref = paged_decode_tail_attention_plain(q, k5, v5, *rest, layer=2,
                                            num_splits=num_splits)
    view = paged_decode_tail_attention(q, k5[2], v5[2], *rest,
                                       num_splits=num_splits)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(),
                               **TOL[torch.bfloat16])
    assert torch.equal(got, view)


def test_decode_tail_form_refuses_what_it_does_not_take(dev):
    from production_stack_tpu_torch.ops.paged_attention_cuda import (
        paged_decode_tail_attention)
    q, k, v, table, lens, kt, vt, q_pos = _tail_case(
        dev, torch.bfloat16, 4, 64, 16, False, 4, 34)
    for bad in (dict(k_tail=kt.float()), dict(q_pos=q_pos.long()),
                dict(k_tail=kt[:, :, :1].contiguous())):
        call = dict(k_tail=kt, v_tail=vt, q_pos=q_pos)
        call.update(bad)
        with pytest.raises(ValueError):
            paged_decode_tail_attention(q, k, v, table, lens, **call)


@pytest.mark.parametrize("kv_cache_dtype,cache_layout", [
    ("auto", "per_layer"), ("auto", "stacked"), ("int8", "per_layer"),
    ("int8", "stacked")])
def test_engine_deferred_bursts_on_the_card_match_the_cpu(
        dev, kv_cache_dtype, cache_layout):
    """Decode bursts with deferred KV writes: the card runs the tail
    form of the decode kernel (in the cache's form) inside the burst
    graphs, and its greedy streams are the CPU's and the eager
    burst's."""
    prompts = _tiny_prompts()
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    sp = SamplingParams(temperature=0.0, max_tokens=19, ignore_eos=True)
    streams = []
    for device, deferred in (("cpu", True), ("cuda", True),
                             ("cuda", False)):
        COUNTERS.reset()
        engine = _tiny_engine(True, device=device, decode_steps=4,
                              deferred_kv_writes=deferred,
                              kv_cache_dtype=kv_cache_dtype,
                              cache_layout=cache_layout)
        streams.append([s.output_token_ids
                        for s in engine.generate_batch(prompts, sp)])
        if device == "cuda" and deferred:
            suffix = ("_int8" if kv_cache_dtype == "int8" else "") + (
                "_stacked" if cache_layout == "stacked" else "")
            assert COUNTERS.launches.get("paged_decode_tail" + suffix, 0)
            assert not COUNTERS.plain_cuda_calls
    assert streams[0] == streams[1] == streams[2]


@pytest.mark.parametrize("tp", (2, 4))
def test_a_rank_makes_its_shard_without_the_whole_model(dev, tp):
    """bench-1b's rank 1 at tp 2 and 4, random weights made as the
    runner makes them (``mesh.build_rank_params``): the card's peak
    while they are made is the rank's shard plus one leaf's f32 draw
    and its bf16 copy, below the whole model's bytes."""
    from production_stack_tpu_torch.engine.config import (
        bench_1b_model_config)
    from production_stack_tpu_torch.models.llama import random_leaf
    from production_stack_tpu_torch.models.registry import params_class
    from production_stack_tpu_torch.parallel import mesh
    cfg = bench_1b_model_config()
    meta = list(params_class(cfg)(cfg, torch.device("meta")).parameters())
    full = sum(p.numel() * p.element_size() for p in meta)
    largest = max(p.numel() for p in meta)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    shard = mesh.build_rank_params(
        cfg, lambda path, shape, dtype: random_leaf(path, shape, dtype, gen,
                                                    dev), 1, tp)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    held = sum(p.numel() * p.element_size() for p in shard.parameters())
    print(f"bench-1b rank 1 of tp {tp}: peak {peak} bytes while made, "
          f"shard {held}, whole model {full}")
    assert held < full
    assert peak <= held + 6 * largest
    assert peak < full


def test_tp_runner_over_one_nccl_rank_replays_its_collectives(dev):
    """The tp runner over a one-rank NCCL group, graphs on: the tiny
    engine's greedy streams are the non-tp engine's, and every captured
    graph holds its all-reduces and its logits gather."""
    import torch.distributed as dist
    from production_stack_tpu_torch.parallel.collectives import (
        TPGroup, init_mesh_groups)
    from production_stack_tpu_torch.parallel.distributed import free_port
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    prompts = _tiny_prompts()
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    want = [s.output_token_ids for s in _tiny_engine(
        True, unified_step=True, async_scheduling=True).generate_batch(
            prompts, sp)]
    init_mesh_groups(0, "nccl", f"tcp://127.0.0.1:{free_port()}", dev)
    group = TPGroup(0, 1, "nccl")
    try:
        from production_stack_tpu_torch.engine.engine import LLMEngine
        base = _tiny_engine(True, device="cpu", unified_step=True,
                            async_scheduling=True)
        engine = LLMEngine(base.config, params=base.runner.params,
                           device="cuda", tp=group)
        got = [s.output_token_ids
               for s in engine.generate_batch(prompts, sp)]
        recorded = engine.runner.graphs.recorded_launches()
    finally:
        dist.destroy_process_group()
    assert got == want
    assert recorded and all(
        c.get("tp_all_reduce") and c.get("tp_all_gather")
        for c in recorded.values())


def test_ring_attention_at_bench_1b_heads(dev):
    """Two fake sp ranks on the card, bench-1b's heads (32 q / 8 kv of
    64), f32, T = 2048: within 1e-4 of the dense reference."""
    from production_stack_tpu_torch.ops.ring_attention import (
        ring_attention, ring_attention_dense)
    from production_stack_tpu_torch.parallel.collectives import (
        FakeTPGroup, run_ranks)
    gen = torch.Generator(device=dev).manual_seed(11)
    q, k, v = (torch.randn((1, 2048, h, 64), generator=gen, device=dev)
               for h in (32, 8, 8))
    outs = run_ranks(FakeTPGroup.world(2, axis="sp"), lambda g: (
        ring_attention(*(x[:, g.rank * 1024:(g.rank + 1) * 1024]
                         for x in (q, k, v)), g)))
    torch.testing.assert_close(torch.cat(outs, dim=1),
                               ring_attention_dense(q, k, v), rtol=1e-4,
                               atol=1e-4)


def _one_rank_axis_engine(dev, axis, **sched):
    """The tiny engine (stacked cache) and the same engine over a
    one-rank NCCL ``axis`` group, graphs on."""
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.parallel.collectives import (
        TPGroup, init_mesh_groups)
    from production_stack_tpu_torch.parallel.distributed import free_port
    plain = _tiny_engine(True, cache_layout="stacked", **sched)
    init_mesh_groups(0, "nccl", f"tcp://127.0.0.1:{free_port()}", dev)
    base = _tiny_engine(True, device="cpu", cache_layout="stacked", **sched)
    engine = LLMEngine(base.config, params=base.runner.params,
                       device="cuda",
                       **{axis: TPGroup(0, 1, "nccl", axis=axis)})
    return plain, engine


def test_pp_runner_over_one_nccl_rank_keeps_its_sum_in_the_graphs(dev):
    """The staged forward over a one-rank NCCL pp group: greedy streams
    those of the plain stacked engine, every captured graph holding the
    stage's masked sum."""
    import torch.distributed as dist
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    try:
        plain, engine = _one_rank_axis_engine(dev, "pp", unified_step=True,
                                              async_scheduling=True)
        want = [s.output_token_ids
                for s in plain.generate_batch(_tiny_prompts(), sp)]
        got = [s.output_token_ids
               for s in engine.generate_batch(_tiny_prompts(), sp)]
        recorded = engine.runner.graphs.recorded_launches()
    finally:
        dist.destroy_process_group()
    assert got == want
    assert recorded and all(c.get("pp_sum") for c in recorded.values())


def test_sp_prefill_over_one_nccl_rank_runs_eagerly_and_counts(dev):
    """A one-rank NCCL sp group: a prompt over the threshold prefills in
    one ring dispatch, eagerly and counted (reason ``sp_prefill``);
    every other step replays its graph; the greedy streams are those of
    the plain stacked engine, which prefills in chunks."""
    import torch.distributed as dist
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    prompts = _tiny_prompts()
    try:
        plain, engine = _one_rank_axis_engine(dev, "sp")
        engine.scheduler.sp_threshold = 64
        want = [s.output_token_ids for s in plain.generate_batch(prompts, sp)]
        got = [s.output_token_ids for s in engine.generate_batch(prompts, sp)]
        eager = dict(engine.runner.graphs.eager_steps)
    finally:
        dist.destroy_process_group()
    long_prompts = sum(len(p) >= 64 for p in prompts)
    assert long_prompts == 1
    assert engine.runner.sp_prefill_steps == long_prompts
    assert eager["sp_prefill"] == long_prompts
    assert got == want


def split_against_whole(device, sp=2, kv="auto"):
    """One ragged [R, W] block (decode rows with drafts, a prefill chunk
    row, pad rows; R = 6, W = 16) through ``shard_rows_forward`` over
    ``sp`` fake ranks in threads, each with its own stacked cache,
    against the model's forward over the whole block on one cache: (the
    split logits, the whole logits, each rank's k and v caches, the
    whole run's), the model tiny-llama f32 on ``device``."""
    from production_stack_tpu_torch.engine.config import tiny_model_config
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops.quant_kv import quant_cache_zeros
    from production_stack_tpu_torch.parallel.collectives import (
        FakeTPGroup, run_ranks)
    from production_stack_tpu_torch.parallel.context_serving import (
        share_slots, shard_rows_forward)
    cfg = tiny_model_config("llama")
    params = llama.init_params(cfg, torch.Generator().manual_seed(1),
                               torch.device("cpu")).to(device)
    r, w, ps, pages = 6, 16, 16, 24
    rng = np.random.RandomState(2)
    tokens = rng.randint(1, 500, size=(r, w)).astype(np.int32)
    positions = np.zeros((r, w), np.int32)
    valid = np.zeros((r, w), bool)
    table = np.zeros((r, 4), np.int32)
    table[:4] = np.arange(1, 17).reshape(4, 4)
    # Rows 0-2 decode with 0, 2 and 3 drafts at 20, 35 and 50 tokens;
    # row 3 a 16-token chunk from 32; rows 4, 5 pad.
    for i, (start, n) in enumerate([(20, 1), (35, 3), (50, 4), (32, 16)]):
        positions[i, :n] = np.arange(start, start + n)
        valid[i, :n] = True
    kv_lens = np.where(valid.any(1), positions.max(1) + 1, 0)
    kv_lens = kv_lens.astype(np.int32)
    last = (valid.sum(1) - 1).clip(0)
    select = np.minimum(np.maximum(last[:, None] - 3, 0)
                        + np.arange(4)[None, :], w - 1)
    t = {k: torch.from_numpy(v).to(device) for k, v in dict(
        tokens=tokens, positions=positions, valid=valid, table=table,
        kv_lens=kv_lens, select=select.astype(np.int64)).items()}
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, pages,
             cfg.head_dim, ps)
    gen = torch.Generator().manual_seed(4)
    history = torch.randn(shape, generator=gen).to(device)

    def caches():
        if kv == "int8":
            out = [quant_cache_zeros(shape, device) for _ in range(2)]
            for c in out:
                c.data.copy_((history * 50).to(torch.int8))
                c.scale.fill_(0.02)
            return out
        return [history.clone(), history.clone()]

    def run(forward, kc, vc, **kw):
        return forward(params, cfg, t["tokens"], t["positions"], t["table"],
                       t["kv_lens"], t["valid"], kc, vc, select=t["select"],
                       kind="ragged", **kw)

    whole_k, whole_v = caches()
    whole = run(llama.forward, whole_k, whole_v)
    slots = torch.from_numpy(share_slots(valid, sp)).to(device)
    ranks = [caches() for _ in range(sp)]
    split = run_ranks(FakeTPGroup.world(sp, axis="sp"), lambda g: run(
        shard_rows_forward(llama.forward, g), *ranks[g.rank],
        share_slots=slots))
    return split, whole, ranks, (whole_k, whole_v)


def test_cp_split_ragged_block_on_the_card_is_the_replicated_blocks(dev):
    """``shard_rows_forward`` over two fake sp ranks on the card (the
    ragged kernel on each rank's rows, K/V shared over the ranks)
    against the replicated path, the whole block through the ragged
    kernel on one cache: logits within 1e-4 (f32 tiny-llama), and each
    rank's cache the whole run's (the trash page aside)."""
    split, whole, ranks, whole_caches = split_against_whole(dev)
    for logits in split:
        torch.testing.assert_close(logits, whole, rtol=1e-4, atol=1e-4)
    for caches in ranks:
        for got, want in zip(caches, whole_caches):
            torch.testing.assert_close(got[:, :, 1:], want[:, :, 1:],
                                       rtol=1e-4, atol=1e-4)


def test_sp_unified_and_verify_over_one_nccl_rank_replay_their_graphs(dev):
    """A one-rank NCCL sp group with the unified step and speculative
    drafts, graphs on: each unified and verify dispatch runs through the
    row split (its K/V share and logits gather captured in the step's
    graph), and the greedy streams are the plain stacked engine's."""
    import torch.distributed as dist
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    prompts = _tiny_prompts()
    try:
        plain, engine = _one_rank_axis_engine(
            dev, "sp", unified_step=True, speculative_k=3)
        want = [s.output_token_ids for s in plain.generate_batch(prompts, sp)]
        got = [s.output_token_ids for s in engine.generate_batch(prompts, sp)]
        recorded = engine.runner.graphs.recorded_launches()
        split = dict(engine.runner.sp_split_rows)
    finally:
        dist.destroy_process_group()
    assert got == want
    assert set(split) == {"unified", "spec_verify"}, split
    ragged = [c for key, c in recorded.items()
              if key[0] in ("unified", "spec_verify")]
    assert ragged and all(c.get("sp_all_gather") for c in ragged)
