"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout, needs one CUDA card and builds the
kernels from the checkout's sources (``csrc/``, with ``nvcc``). Every
phase raises on failure and the script then exits non-zero without
its result line:

1. the card's name and power limit (``nvidia-smi``);
2. the kernel build, with its time and ``ptxas`` report;
3. kernels: each hand-written kernel against its plain PyTorch version
   on the same bf16 inputs at the serving path's shapes (decode at
   B = 32 with kv lens over 1..1024 and pad rows; chunked prefill at
   B = 8, T = 512, first and second chunk, and at the widest unified
   mixed step, R = 40 rows at W = 512; ragged at that same unified
   step, at a verify block, B = 32, W = 5, draft lens 0..4, at decode
   rows alone (every tile but the first dead) and at chunk rows whose
   live slots end inside a tile; page sizes 128, 64, 32 and 16), plus
   a small f32 case each at the tiny-llama geometry. Every output slot
   is compared, and the ragged kernel's dead slots and pad rows must be
   exact 0. The bf16 ragged cases are held against the plain version
   with the tensor-core walk's rounding (probabilities enter p . v as
   bf16: ``p_dtype``). Tolerance: atol = rtol = 2e-2 on bf16 outputs
   compared in f32 (one bf16 rounding of values of order 1, and sums
   taken in another order), 1e-4 on f32 outputs. A timed ragged case
   also prints the bound of writing its output alone
   (``output_bound_ms``); the dead-tile case (the headline block's 28
   decode rows and 12 pad rows, about 8,900 tiles that only write
   zeros) puts the dead tiles' cost on record. Each kernel is timed
   with CUDA events (device time: the launch is queued behind a short
   device-side wait) against its plain
   version, one ``scaled_dot_product_attention`` call over gathered
   dense K/V (a yardstick only: the port never calls it) and its bound
   on the card. A prefill or ragged case also prints the bound of its
   live slots alone (``live_bound_ms``), the part of the work a step
   uses. The headline case of each kernel runs again on an int8 cache
   (a QuantKV) quantized from the same bf16 K/V, held against the plain
   version at the same 2e-2 and timed the same way; its bound counts
   head_dim + 4 bytes (int8 values and an f32 scale) per cached token
   per kv head and plane, and SDPA runs over the dequantized dense K/V.
   Untimed int8 cases cover page size 16 and the f32 tiny-llama
   geometry (1e-4). The headline case of each kernel runs again in the
   stacked form, bf16 and int8: the case's K/V at layer 15 of a stacked
   [16, kv, pages, d, ps] cache whose other layers are random. Each is
   held against its plain version (same tolerance) and, bitwise,
   against the per-layer launch on the layer's view, and timed beside
   that per-layer launch (``per_layer_ms``); its bound and SDPA time are
   the per-layer case's. One untimed stacked decode case sits at layer
   15 of 2304 pages, an element offset past 2^31. The split decode
   kernel runs at batch 1, 4 and 32 over tables of 1024 and 4096
   tokens, at the split the wrapper picks (printed per case) and at one
   split, with rows ending inside the first split, kv lens 127, 128
   and 129 and pad rows, and its headline case is timed at 1, 2, 3, 4
   and 8 splits. The tensor-core prefill walk runs at T = 16 and 64,
   row starts off the tile and the chunk (37, 600), a kv_len one past a
   chunk edge and page sizes 32 and 64, over bf16 and int8. Two
   launches of every decode, prefill and ragged case must give equal
   bits. Each headline case also prints the time this script recorded
   for the kernel before its redesign (``before_redesign_ms``, a
   record, not a measurement of this run);
4. model: the bench-1b llama at full width, random weights, one
   512-token prefill chunk, one decode step and one 5-token verify
   block (the ragged route) through ``forward`` with the kernels and
   with their plain versions rounded as the kernels round (``impl``
   ``plain_bf16p``: bf16 probabilities into p . v in prefill and
   ragged), over a bf16 and over an int8 KV cache. Logits must agree
   to 5% of the largest, and a top-1 flip passes only where the
   reference's own margin to the kernels' pick is under
   ``NEAR_TIE_LOGITS``; flips and margins are printed. Then the same
   through the kernels over a stacked cache, whose logits must be
   bitwise those over the per-layer caches;
5. engine, no HTTP: bench-1b with the stacked layout, unified step and
   async off, 8 greedy prompts submitted together, decode_steps 1 and
   then 4 (bursts): the token streams must be byte-identical;
6. graphs, no HTTP: bench-1b, 16 greedy prompts of 64..700 tokens
   submitted together (a prefill step, unified mixed steps, then
   decode), each step replayed as a CUDA graph of its kind and bucket
   shape against the same run eager (``cuda_graphs=False``), in four
   cases: per_layer bf16 and stacked int8 KV with the unified step and
   async on, ``speculative_k`` 4 on prompts that repeat a block, and
   ``decode_steps`` 4. The greedy streams must be byte-identical, each
   key captured once, every step replayed, no step eager. In the first
   case both runs go under ``torch.profiler``: the kernels the card ran
   must be, kernel by kernel, what the launch counters say (the
   graphed run's from the replay accounting), and the host calls that
   queue work (launches, graph launches, copies) are counted per steady
   decode step both ways. A seeded request then runs alone in both
   engines: its steps run eagerly, are counted as such, and give the
   same tokens. Captures by kind, capture seconds, graph-pool bytes and
   host launches per decode step are printed;
7. sampling options, no HTTP: bench-1b, 16 prompts of 64..700 tokens
   whose rows carry the per-row options (presence and frequency
   penalties with top-20 logprobs, a repetition penalty, a +100
   ``logit_bias`` on one token, ``min_tokens`` 8 with EOS biased up,
   guided JSON whose structural bytes are biased so that it closes,
   top-20 logprobs alone) beside plain greedy rows, 32 tokens each,
   graphed and eager at decode_steps 1 and 4. The greedy streams must be
   byte-identical graphed and eager and at both decode_steps, logprobs
   within 1e-3 graphed and eager (top ids equal but at ties), every key
   captured once with no eager step, the guided rows must parse as JSON,
   the ``min_tokens`` rows hold EOS back to their minimum and the
   biased token be emitted. Captures are printed by option set;
8. serving: the port's HTTP server in-process with bench-1b at full
   width, 16 concurrent completions plus a repeated greedy one, with
   the kernels' launch counters read around the run (all three kernels
   must launch: prefill steps, unified mixed steps, decode steps). The
   server replays its steps as graphs, so the counts come from the
   replay accounting; each serving run must have captured graphs,
   replayed them and run no step eagerly, and prints its captures by
   kind. After its timed window the first run also answers one
   request with ``n`` 3, ``best_of`` 4 and ``logprobs`` 5: three
   choices in order of mean token logprob, each with its legacy
   logprobs, and the four candidates' tokens in the usage;
9. speculative serving: the same server with ``--speculative-k 4``
   (async 'auto' then resolves off), 16 concurrent greedy completions
   on prompts that repeat a block, so the n-gram proposer drafts even
   under random weights. It must draft, launch the ragged kernel
   (mixed and verify steps) and reproduce a repeated greedy request;
   it prints the draft and accepted counts, tok/s and the share of
   completion characters (one per token under the bench tokenizer)
   that agree with the spec-off server on the same prompts. That share
   is printed, not asserted: bf16 kernels may flip near-ties;
10. int8 serving: the first run's server with ``--kv-cache-dtype
    int8`` and the same 16 requests. It must launch the int8 form of
    all three kernels, make no plain call on CUDA tensors, repeat a
    greedy request exactly and show ``kv_dtype="int8"`` and the
    expanded page capacity (962 of 963 pages) on ``/metrics``; it
    prints tok/s and the share of greedy characters that agree with the
    bf16 run (printed, not asserted: int8 KV changes tokens);
11. stacked serving: the first run's server with ``--cache-layout
    stacked`` and the same requests. It must launch the stacked form of
    all three kernels and no per-layer form, make no plain call on CUDA
    tensors and repeat a greedy request exactly; it prints the share of
    greedy characters that agree with the first run (printed, not
    asserted: request timing changes the steps' composition);
12. burst serving: ``--cache-layout stacked --kv-cache-dtype int8
    --decode-steps 4`` (async ``auto`` then off) and the same requests.
    It must launch the int8 stacked forms only, no completion may pass
    its ``max_tokens``, the repeated greedy request must reproduce, and
    its decode dispatches must commit at least 3 tokens a row on
    average (a burst commits up to 4).

The line before the last is the ``kernels`` JSON summary, one entry a
kernel with its bf16 per-layer numbers and ``int8``, ``stacked`` and
``int8_stacked`` objects of the same keys; ``launches`` is the kernel's
count in the first serving run (the main path: per_layer bf16, async
and unified on), ``launches_by_run`` its count in every run. The last
line is the ``ok`` JSON line.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# Published peaks of one H100 SXM (dense), the denominators of the
# bound: HBM bytes per second and bf16 tensor-core operations per
# second.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
BF16_TOL = dict(atol=2e-2, rtol=2e-2)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
L2_FLUSH_BYTES = 128 << 20  # > the H100's 50 MB L2

SERVER_ARGS = ["--model", "bench-1b", "--random-weights",
               "--page-size", "128", "--num-pages", "512",
               "--max-num-seqs", "32", "--max-model-len", "1024",
               "--prefill-chunk-size", "512", "--prefill-batch-size", "8",
               "--async-scheduling", "auto", "--unified-step", "auto"]

KERNELS = {
    "paged_decode": dict(
        route="cuda",
        source="production_stack_tpu_torch/csrc/paged_decode.cu",
        replaces="production_stack_tpu/ops/paged_attention_pallas.py:147"),
    "paged_prefill": dict(
        route="cuda",
        source="production_stack_tpu_torch/csrc/paged_prefill.cu",
        replaces="production_stack_tpu/ops/prefill_attention_pallas.py:149"),
    "paged_ragged": dict(
        route="cuda",
        source="production_stack_tpu_torch/csrc/paged_ragged.cu",
        replaces="production_stack_tpu/ops/ragged_attention_pallas.py:174"),
}
# The serving run whose launch count a kernel's line reports: the first
# (the main path: per_layer bf16, async and unified on), for every
# kernel; ``launches_by_run`` lists the others.
MAIN_RUN = "serve"
# Headline times of each kernel as this script recorded them before its
# redesign (f32 FMA over f32 tiles; one block a (row, kv head) pair in
# decode; one 116 KB block an SM in ragged), on an NVIDIA H100 80GB HBM3
# at 700 W: printed beside the new times, never part of the ``kernels``
# line.
BEFORE_REDESIGN_MS = {
    "paged_decode": {"bf16": 0.08956, "int8": 0.06844,
                     "stacked": 0.08287, "int8_stacked": 0.06875},
    "paged_prefill": {"bf16": 0.5286, "int8": 0.5375,
                      "stacked": 0.5248, "int8_stacked": 0.5376},
    "paged_ragged": {"bf16": 0.7057, "int8": 0.7175,
                     "stacked": 0.7080, "int8_stacked": 0.7169},
}
INT8_RUN = "serve_int8"  # the run of the int8 forms
STACKED_RUN = "serve_stacked"  # the run of the stacked forms
BURST_RUN = "serve_burst"  # the run of the int8 stacked forms
# A stacked case: the layer count of bench-1b and its last layer.
STACK = (16, 15)
# The int8 serving run's page budget: --num-pages 512 at bf16 widths,
# expanded to the same bytes of int8 pages (512 * 128 // 68), less the
# trash page.
INT8_PAGE_CAPACITY = 512 * 2 * 64 // (64 + 4) - 1


def log(msg: str) -> None:
    print(msg, flush=True)


# ---- timing -----------------------------------------------------------------


class Timer:
    """Per-launch device time from CUDA events, with the L2 flushed
    before each launch, as the serving path finds it (every layer reads
    another layer's cache). Each timed launch is queued behind a short
    device-side wait, so that the host has queued it before the card
    reaches it: the events then bracket the kernels alone, and not the
    time the card waits for the wrapper's Python."""

    # About 2 ms of the card's clock: a host thread that stalls for
    # less than that between queueing the wait and the launch (a shared
    # host's other processes) still has the launch queued in time.
    HEAD_START_CYCLES = 4_000_000

    def __init__(self, dev):
        self.flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                     device=dev)
        # Half a second of dense work first: the first timed case of a
        # process otherwise reads up to 1.6x high (the card's clocks).
        x = torch.randn((4096, 4096), device=dev).to(torch.bfloat16)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 0.5:
            for _ in range(20):
                x @ x
            torch.cuda.synchronize()

    def ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        for _ in range(warmup):
            fn()
        total = 0.0
        pairs = []
        for _ in range(iters):
            torch.cuda._sleep(self.HEAD_START_CYCLES)
            self.flush_buf.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
            torch.cuda.synchronize()
        for start, end in pairs:
            total += start.elapsed_time(end)
        return total / iters


# ---- kernel phase -----------------------------------------------------------


def _cache(kv, pages, d, ps, dtype, dev, gen):
    return (torch.randn((kv, pages, d, ps), generator=gen, device=dev)
            .to(dtype))


def _quantize(cache):
    """A [kv, pages, d, ps] cache quantized per (page, slot, kv head)
    row, as the engine's page writes lay it out."""
    from production_stack_tpu_torch.ops.quant_kv import QuantKV, quantize_kv
    q8, scale = quantize_kv(cache.permute(0, 1, 3, 2))
    return QuantKV(q8.permute(0, 1, 3, 2).contiguous(), scale.contiguous())


def _caches(kv, pages, d, ps, dtype, dev, gen, int8):
    """(k, v) for the kernels and (k, v) dense in ``dtype`` for SDPA:
    the int8 caches are quantized from the same random K/V, and SDPA
    reads them dequantized."""
    kc = _cache(kv, pages, d, ps, dtype, dev, gen)
    vc = _cache(kv, pages, d, ps, dtype, dev, gen)
    if not int8:
        return (kc, vc), (kc, vc)
    k8, v8 = _quantize(kc), _quantize(vc)
    return (k8, v8), tuple(
        (c.data.float() * c.scale[:, :, None, :]).to(dtype)
        for c in (k8, v8))


def _stack_at(cache, layers, layer, gen):
    """A stacked [layers, ...] cache (a QuantKV's data and scales
    alike) holding ``cache`` at ``layer`` and random values in the other
    layers, filled in place (no f32 copy of the stack)."""
    from production_stack_tpu_torch.ops.quant_kv import QuantKV

    def stack(t):
        out = torch.empty((layers,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        if t.is_floating_point():
            out.normal_(generator=gen)
        else:
            out.random_(-127, 128, generator=gen)
        out[layer] = t
        return out
    if isinstance(cache, QuantKV):
        return QuantKV(stack(cache.data), stack(cache.scale).abs_())
    return stack(cache)


def _form(name, args, stack, gen):
    """``(call, view, layer offset)`` for a case's arguments ``args`` =
    (q, k, v, ...): ``call(fn)`` runs a wrapper or plain version in the
    case's form, as given or (``stack`` = (layers, layer)) over K/V
    embedded at ``layer`` of stacked caches; for the stacked form,
    ``view(fn)`` runs ``fn`` per layer on the layer's view, and the
    layer's element offset is returned."""
    if stack is None:
        return (lambda fn: fn(*args)), None, None
    layers, layer = stack
    k5 = _stack_at(args[1], layers, layer, gen)
    v5 = _stack_at(args[2], layers, layer, gen)
    stacked = (args[0], k5, v5) + tuple(args[3:])
    view = (args[0], k5[layer], v5[layer]) + tuple(args[3:])
    offset = layer * args[1].shape.numel()
    log(f"{name}: stacked cache {tuple(k5.shape)}, layer {layer} at "
        f"element offset {offset} ({offset / 2**31:.2f} x 2^31)")
    return ((lambda fn: fn(*stacked, layer=layer)),
            (lambda fn: fn(*view)), offset)


def _check_view(name, got, view, fn) -> None:
    """The stacked launch must be bitwise the per-layer launch on the
    layer's view: the same walk over the same bytes."""
    if view is None:
        return
    same = view(fn)
    torch.cuda.synchronize()
    if not torch.equal(got, same):
        raise AssertionError(f"{name}: the stacked launch differs from "
                             "the per-layer launch on the layer's view")


def _kv_slot_bytes(d, esz, int8):
    """Bytes of one cached token of one kv head in one plane."""
    return d + 4 if int8 else d * esz


def _page_table(kv_lens, ps, max_pages, num_pages, gen, dev):
    """Distinct random physical pages per row (page 0 stays the trash
    page), zeros past each row's pages."""
    b = len(kv_lens)
    perm = torch.randperm(num_pages - 1, generator=gen,
                          device=gen.device).cpu() + 1
    table = torch.zeros((b, max_pages), dtype=torch.int32)
    used = 0
    for i, n in enumerate(kv_lens):
        need = -(-int(n) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    if used >= num_pages:
        raise ValueError("page budget too small for the case")
    return table.to(dev)


def _dense_kv(cache, table, kv_len_max, group):
    """[kv, pages, d, ps] gathered per row to dense [B, nh, L, d]."""
    g = cache[:, table.long()]  # [kv, B, P, d, ps]
    kv, b, p, d, ps = g.shape
    dense = g.permute(1, 0, 2, 4, 3).reshape(b, kv, p * ps, d)
    return dense[:, :, :kv_len_max].repeat_interleave(group, dim=1)


def decode_case(name, b, kv_lens, ps, dtype, dev, gen, timer=None,
                nh=32, kv=8, d=64, max_len=1024, num_pages=None,
                int8=False, stack=None, num_splits=None, sweep=()):
    """``num_splits``: the split to force (default: the wrapper's
    choice, from shapes). ``sweep``: splits to time the case at."""
    from production_stack_tpu_torch.ops import paged_attention_cuda
    paged_decode_attention_plain = (
        paged_attention_cuda.paged_decode_attention_plain)

    def paged_decode_attention(*args, **kwargs):
        return paged_attention_cuda.paged_decode_attention(
            *args, num_splits=num_splits, **kwargs)

    max_pages = max_len // ps
    num_pages = num_pages or (b * max_pages + 1)
    (kc, vc), dense = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
    q = torch.randn((b, nh, d), generator=gen, device=dev).to(dtype)
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    table = _page_table(kv_lens, ps, max_pages, num_pages, gen, dev)
    call, view, offset = _form(name, (q, kc, vc, table, lens), stack, gen)
    got = call(paged_decode_attention)
    ref = call(paged_decode_attention_plain)
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err = (got.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    pad = lens == 0
    if pad.any() and got[pad].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: pad rows must write exact 0")
    _check_view(name, got, view, paged_decode_attention)
    again = call(paged_decode_attention)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    picked = paged_attention_cuda.decode_splits(b, kv, max_pages, ps)
    out = {"case": name, "max_abs_err": err,
           "splits": num_splits or picked[0], "picked_splits": picked[0],
           "chunks_per_split": picked[1]}
    if offset is not None:
        out["layer_offset_elems"] = offset
    if timer is not None:
        # What the function must move: K/V of each row's cached tokens,
        # q of the live rows, every output row, the live page-table
        # entries and kv_lens.
        tokens = int(lens.sum())
        esz = q.element_size()
        live_rows = sum(1 for n in kv_lens if n)
        entries = sum(-(-n // ps) for n in kv_lens)
        nbytes = (2 * tokens * kv * _kv_slot_bytes(d, esz, int8)
                  + live_rows * nh * d * esz + q.numel() * esz
                  + entries * 4 + b * 4)
        flops = 4 * nh * d * tokens
        kmax = max(kv_lens)
        kd = _dense_kv(dense[0], table, kmax, nh // kv)
        vd = _dense_kv(dense[1], table, kmax, nh // kv)
        mask = (torch.arange(kmax, device=dev)[None, :]
                < lens[:, None].long())[:, None, None, :]
        qd = q[:, :, None, :]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out.update(
            ms=timer.ms(lambda: call(paged_decode_attention)),
            plain_ms=timer.ms(lambda: call(paged_decode_attention_plain),
                              iters=5),
            library_ms=timer.ms(lambda: sdpa(qd, kd, vd, attn_mask=mask)),
            **_bound(nbytes, flops))
        if view is not None:
            out["per_layer_ms"] = timer.ms(
                lambda: view(paged_decode_attention))
        if sweep:
            out["ms_by_splits"] = {
                n: timer.ms(lambda: call(
                    lambda *a, **k: paged_attention_cuda
                    .paged_decode_attention(*a, num_splits=n, **k)))
                for n in sweep}
    return out


def prefill_case(name, rows, t, ps, dtype, dev, gen, timer=None, nh=32,
                 kv=8, d=64, max_len=1024, int8=False, stack=None):
    """Row i holds ``rows[i] = (start, n)``: n real tokens of a chunk
    starting at ``start`` (n = 0: a pad row). Every slot t sits at
    start + t, as the kernel rebuilds it, so a row's slots past n are
    pad slots that still attend up to kv_len = start + n."""
    from production_stack_tpu_torch.ops.prefill_attention_cuda import (
        paged_prefill_attention, paged_prefill_attention_plain)
    b = len(rows)
    max_pages = max_len // ps
    num_pages = b * max_pages + 1
    (kc, vc), dense = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
    q = torch.randn((b, t, nh, d), generator=gen, device=dev).to(dtype)
    kv_lens = [start + n if n else 0 for start, n in rows]
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    starts = torch.tensor([start if n else 0 for start, n in rows],
                          dtype=torch.int32, device=dev)
    pos = (starts[:, None] + torch.arange(t, dtype=torch.int32,
                                          device=dev)[None]).contiguous()
    table = _page_table(kv_lens, ps, max_pages, num_pages, gen, dev)
    call, view, offset = _form(name, (q, kc, vc, table, pos, lens), stack,
                               gen)
    got = call(paged_prefill_attention)
    ref = call(paged_prefill_attention_plain)
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err = (got.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    pad = lens == 0
    if pad.any() and got[pad].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: pad rows must write exact 0")
    _check_view(name, got, view, paged_prefill_attention)
    again = call(paged_prefill_attention)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    out = {"case": name, "max_abs_err": err}
    if offset is not None:
        out["layer_offset_elems"] = offset
    if timer is not None:
        esz = q.element_size()
        slot_bytes = nh * d * esz
        live_rows = sum(1 for n in kv_lens if n)
        entries = sum(-(-n // ps) for n in kv_lens)
        kv_bytes = 2 * sum(kv_lens) * kv * _kv_slot_bytes(d, esz, int8)
        small = entries * 4 + 2 * b * 4  # page table, row starts, kv_lens
        # Operations this data needs: slot t of row i sees
        # min(start_i + t + 1, kv_len_i) tokens.
        visible = torch.minimum(pos.long() + 1, lens[:, None].long())
        flops = 4 * nh * d * int(visible.sum())
        # The function as called: q of the live rows (all t slots, pad
        # slots included), every output slot.
        nbytes = kv_bytes + (live_rows + b) * t * slot_bytes + small
        # The part of it the step uses: the live slots (t < n) only.
        live = (torch.arange(t, device=dev)[None]
                < torch.tensor([n for _, n in rows], device=dev)[:, None])
        n_slots = int(live.sum())
        live_bound = _bound(kv_bytes + 2 * n_slots * slot_bytes + small,
                            4 * nh * d * int(visible[live].sum()))
        kmax = max(kv_lens)
        kd = _dense_kv(dense[0], table, kmax, nh // kv)
        vd = _dense_kv(dense[1], table, kmax, nh // kv)
        tok = torch.arange(kmax, device=dev)
        mask = ((tok[None, None, :] <= pos.long()[:, :, None])
                & (tok[None, None, :] < lens.long()[:, None, None]))
        qd = q.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out.update(
            ms=timer.ms(lambda: call(paged_prefill_attention)),
            plain_ms=timer.ms(lambda: call(paged_prefill_attention_plain),
                              iters=5),
            library_ms=timer.ms(
                lambda: sdpa(qd, kd, vd, attn_mask=mask[:, None])),
            **_bound(nbytes, flops),
            live_bound_ms=live_bound["bound_ms"],
            live_bound_by=live_bound["bound_by"])
        if view is not None:
            out["per_layer_ms"] = timer.ms(
                lambda: view(paged_prefill_attention))
    return out


def ragged_case(name, rows, w, ps, dtype, dev, gen, timer=None, nh=32,
                kv=8, d=64, max_len=1024, verify=False, int8=False,
                stack=None):
    """Row i holds ``rows[i] = (kv_len, last_index)``: slots 0..last_index
    are live and sit at kv_len - 1 - last_index + t (kv_len 0: a pad
    row). ``verify``: the rows are verify rows, draft_len = last_index."""
    from production_stack_tpu_torch.ops.ragged_attention_cuda import (
        paged_ragged_attention, paged_ragged_attention_plain)
    b = len(rows)
    max_pages = max_len // ps
    num_pages = b * max_pages + 1
    (kc, vc), dense = _caches(kv, num_pages, d, ps, dtype, dev, gen, int8)
    q = torch.randn((b, w, nh, d), generator=gen, device=dev).to(dtype)
    kv_lens = [n for n, _ in rows]
    lens = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                        device=dev)
    drafts = torch.clamp(last, min=0) if verify else None
    table = _page_table(kv_lens, ps, max_pages, num_pages, gen, dev)
    call, view, offset = _form(name, (q, kc, vc, table, lens, last, drafts),
                               stack, gen)

    def plain(*args, **kwargs):
        # The bf16 kernel feeds its probabilities to p . v as bf16.
        if dtype == torch.bfloat16:
            kwargs["p_dtype"] = torch.bfloat16
        return paged_ragged_attention_plain(*args, **kwargs)

    got = call(paged_ragged_attention)
    ref = call(plain)
    torch.cuda.synchronize()
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    err = (got.float() - ref.float()).abs().max().item()
    torch.testing.assert_close(got.float(), ref.float(), **tol,
                               msg=lambda m: f"{name}: {m}")
    slot = torch.arange(w, device=dev)[None]
    live = (slot <= last[:, None].long()) & (lens[:, None] > 0)  # [B, W]
    if (~live).any() and got[~live].abs().max().item() != 0.0:
        raise AssertionError(f"{name}: dead slots and pad rows must "
                             "write exact 0")
    _check_view(name, got, view, paged_ragged_attention)
    again = call(paged_ragged_attention)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches gave different bits")
    out = {"case": name, "max_abs_err": err}
    if offset is not None:
        out["layer_offset_elems"] = offset
    if timer is not None:
        esz = q.element_size()
        slot_bytes = nh * d * esz
        entries = sum(-(-n // ps) for n in kv_lens)
        kv_bytes = 2 * sum(kv_lens) * kv * _kv_slot_bytes(d, esz, int8)
        small = entries * 4 + 3 * b * 4  # page table, kv_lens, last_index
        # Operations this data needs: live slot t of row i sits at
        # q_start_i + t and sees min(q_start_i + t + 1, kv_len_i) tokens.
        pos = (lens - 1 - last)[:, None].long() + slot
        visible = torch.minimum(pos + 1, lens[:, None].long())
        flops = 4 * nh * d * int(visible[live].sum())
        n_live = int(live.sum())
        # The function as called reads q of the live slots and writes
        # every output slot (dead ones as 0); its live slots alone read
        # and write only theirs.
        bound = _bound(kv_bytes + (n_live + b * w) * slot_bytes + small,
                       flops)
        live_bound = _bound(kv_bytes + 2 * n_live * slot_bytes + small,
                            flops)
        kmax = max(kv_lens)
        kd = _dense_kv(dense[0], table, kmax, nh // kv)
        vd = _dense_kv(dense[1], table, kmax, nh // kv)
        tok = torch.arange(kmax, device=dev)
        mask = (live[:, :, None] & (tok[None, None, :] <= pos[:, :, None])
                & (tok[None, None, :] < lens.long()[:, None, None]))
        qd = q.transpose(1, 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        out.update(
            ms=timer.ms(lambda: call(paged_ragged_attention)),
            plain_ms=timer.ms(lambda: call(plain), iters=5),
            library_ms=timer.ms(
                lambda: sdpa(qd, kd, vd, attn_mask=mask[:, None])),
            **bound, live_bound_ms=live_bound["bound_ms"],
            live_bound_by=live_bound["bound_by"],
            # Writing the output alone (every slot, dead ones as 0).
            output_bound_ms=_bound(b * w * slot_bytes, 0)["bound_ms"])
        if view is not None:
            out["per_layer_ms"] = timer.ms(
                lambda: view(paged_ragged_attention))
    return out


def _bound(nbytes: int, flops: int) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def kernel_phase(dev) -> dict:
    """Returns {kernel name: {form: headline case}} for the forms
    "bf16", "int8", "stacked" and "int8_stacked", after checking every
    case."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = Timer(dev)
    bf16 = torch.bfloat16
    # Decode: 32 rows, kv lens spread over 1..1024, rows 7 and 21 pad.
    lens = np.linspace(1, 1024, 32).round().astype(int).tolist()
    lens[7] = lens[21] = 0
    # Prefill: 8 rows of a 512-token bucket, live lengths spread over
    # 64..512, row 5 pad.
    live = [512, 448, 384, 320, 256, 0, 128, 64]
    first = [(0, n) for n in live]
    second = [(512, n) for n in live]
    # The widest unified mixed step of the serving configuration: R =
    # max_num_seqs + prefill_batch_size = 40 rows at W = 512. 28 decode
    # rows (one live slot at kv_len - 1, 511 pad slots), 8 prefill-chunk
    # rows (first and second chunks), 4 pad rows.
    decode_lens = np.linspace(70, 1024, 28).round().astype(int).tolist()
    unified = ([(n - 1, 1) for n in decode_lens]
               + [(0, 512), (0, 448), (0, 300), (0, 64), (512, 188),
                  (512, 100), (512, 500), (0, 200)] + [(0, 0)] * 4)
    # The same step as the ragged kernel takes it: (kv_len, last_index)
    # per row, pad rows at kv_len 0 and last_index -1 as the runner
    # lays them out.
    unified_ragged = [(start + n, n - 1) if n else (0, -1)
                      for start, n in unified]
    # A verify block of the speculative path at K = 4: 32 rows with kv
    # lens over 1..1024 (drafts included), draft lens 0..4, rows 9 and
    # 26 pad.
    verify = [(max(n, i % 5 + 1), i % 5) for i, n in enumerate(
        np.linspace(1, 1024, 32).round().astype(int).tolist())]
    verify[9] = verify[26] = (0, -1)
    # The headline block without its chunk rows: 28 decode rows and 12
    # pad rows, so about 8,900 of its 10,240 tiles only write zeros
    # (every tile of a decode row but its first, every tile of a pad
    # row). Its time beside the bound of its output bytes is the cost
    # of the dead tiles.
    dead_tiles = [(n, 0) for n in decode_lens] + [(0, -1)] * 12
    # Decode rows only (kv lens 1..1024; pad rows 7 and 21 at
    # last_index 0, as the JAX tests lay them out): every tile but the
    # first dead.
    decode_only = [(n, 0) for n in lens]
    # Chunk rows whose live slots end inside a tile (37, 100, 129, 511,
    # 3, 250 slots: 148 .. 2044 live query rows, none a multiple of 64)
    # at first and later chunks.
    mid_tile = [(s + n, n - 1) for s, n in ((0, 37), (200, 100), (700, 129),
                                            (0, 511), (1000, 3), (300, 250))]
    # f32 cases at the tiny-llama geometry (4 q heads, 2 kv heads,
    # head_dim 32), the f32 config the kernels are built for.
    tiny = dict(nh=4, kv=2, d=32)
    f32 = torch.float32
    # The split decode kernel: batch 1, 4 and 32 over tables of 1024
    # and 4096 tokens. Rows end inside the first split (5, 127), on a
    # chunk edge (128, 4096), one past (129, 2049); pad rows.
    wide = np.linspace(1, 4096, 32).round().astype(int).tolist()
    wide[3] = wide[30] = 0
    split_cases = [
        ("B=1 table 1024", [1000], 1024, None),
        ("B=1 table 1024, one split", [1000], 1024, 1),
        ("B=1 table 4096", [3000], 4096, None),
        ("B=4 table 1024", [127, 128, 129, 0], 1024, None),
        ("B=4 table 4096", [4096, 5, 0, 2049], 4096, None),
        ("B=4 table 4096, one split", [4096, 5, 0, 2049], 4096, 1),
        ("B=32 table 4096", wide, 4096, None),
        ("B=32 table 4096, one split", wide, 4096, 1),
    ]

    def split_decode_cases(int8):
        tag = "bf16/int8" if int8 else "bf16"
        return [decode_case(f"decode {tag} {label} ps=128", len(rows), rows,
                            128, bf16, dev, gen, timer, max_len=width,
                            int8=int8, num_splits=n)
                for label, rows, width, n in split_cases]

    # The tensor-core prefill walk off its easy shapes: T = 16 and 64,
    # row starts off the tile and the chunk (37, 600), a kv_len one
    # past a chunk edge (129), a one-token row, a pad row; page sizes
    # 128, 32 and 64.
    def edge_prefill_cases(int8):
        tag = "bf16/int8" if int8 else "bf16"
        out = []
        for t, ps in ((16, 128), (64, 32), (64, 64)):
            rows = [(37, t), (600, t - 7), (129 - t, t), (0, 0), (300, 1),
                    (0, t), (1024 - t, t)]
            out.append(prefill_case(
                f"prefill {tag} T={t} ps={ps} starts 37, 600, kv_len 129",
                rows, t, ps, bf16, dev, gen, int8=int8))
        return out
    # The first case of each list is the kernel's headline case.
    cases = {"bf16": {
        "paged_decode": [
            decode_case("decode bf16 B=32 ps=128", 32, lens, 128, bf16,
                        dev, gen, timer, num_pages=512,
                        sweep=(1, 2, 3, 4, 8)),
            decode_case("decode bf16 B=32 ps=16", 32, lens, 16, bf16,
                        dev, gen, timer),
            *split_decode_cases(False),
            decode_case("decode f32 tiny B=4 ps=16", 4, [1, 0, 37, 300],
                        16, torch.float32, dev, gen, max_len=512, **tiny),
        ],
        "paged_prefill": [
            prefill_case("prefill bf16 B=8 T=512 first chunk ps=128", first,
                         512, 128, bf16, dev, gen, timer),
            prefill_case("prefill bf16 B=8 T=512 second chunk ps=128",
                         second, 512, 128, bf16, dev, gen, timer),
            prefill_case("prefill bf16 B=8 T=512 second chunk ps=16",
                         second, 512, 16, bf16, dev, gen, timer),
            prefill_case("prefill bf16 unified R=40 W=512 ps=128", unified,
                         512, 128, bf16, dev, gen, timer),
            prefill_case("prefill f32 tiny B=2 T=64 ps=16",
                         [(40, 64), (40, 9)], 64, 16, torch.float32, dev,
                         gen, max_len=256, **tiny),
            *edge_prefill_cases(False),
        ],
        "paged_ragged": [
            ragged_case("ragged bf16 unified R=40 W=512 ps=128",
                        unified_ragged, 512, 128, bf16, dev, gen, timer),
            ragged_case("ragged bf16 verify B=32 W=5 ps=128", verify, 5,
                        128, bf16, dev, gen, timer, verify=True),
            ragged_case("ragged bf16 dead tiles R=40 W=512 ps=128 (28 "
                        "decode rows, 12 pad rows)", dead_tiles, 512, 128,
                        bf16, dev, gen, timer),
            ragged_case("ragged bf16 decode rows R=32 W=512 ps=64",
                        decode_only, 512, 64, bf16, dev, gen),
            ragged_case("ragged bf16 chunk rows ending mid-tile R=6 W=512 "
                        "ps=32", mid_tile, 512, 32, bf16, dev, gen),
            ragged_case("ragged bf16 verify B=32 W=5 ps=16", verify, 5, 16,
                        bf16, dev, gen, timer, verify=True),
            ragged_case("ragged f32 tiny R=4 W=16 ps=16",
                        [(1, 0), (77, 15), (0, -1), (200, 3)], 16, 16,
                        torch.float32, dev, gen, max_len=256, **tiny),
        ],
    }, "int8": {
        # The headline cases again over an int8 cache quantized from the
        # same kind of bf16 K/V, then page size 16 and the f32 tiny-llama
        # geometry over int8 caches.
        "paged_decode": [
            decode_case("decode bf16/int8 B=32 ps=128", 32, lens, 128, bf16,
                        dev, gen, timer, num_pages=512, int8=True,
                        sweep=(1, 2, 3, 4, 8)),
            *split_decode_cases(True),
            decode_case("decode bf16/int8 B=32 ps=16", 32, lens, 16, bf16,
                        dev, gen, int8=True),
            decode_case("decode f32/int8 tiny B=4 ps=16", 4,
                        [1, 0, 37, 300], 16, f32, dev, gen, max_len=512,
                        int8=True, **tiny),
        ],
        "paged_prefill": [
            prefill_case("prefill bf16/int8 B=8 T=512 first chunk ps=128",
                         first, 512, 128, bf16, dev, gen, timer, int8=True),
            prefill_case("prefill bf16/int8 B=8 T=512 second chunk ps=16",
                         second, 512, 16, bf16, dev, gen, int8=True),
            prefill_case("prefill f32/int8 tiny B=2 T=64 ps=16",
                         [(40, 64), (40, 9)], 64, 16, f32, dev, gen,
                         max_len=256, int8=True, **tiny),
            *edge_prefill_cases(True),
        ],
        "paged_ragged": [
            ragged_case("ragged bf16/int8 unified R=40 W=512 ps=128",
                        unified_ragged, 512, 128, bf16, dev, gen, timer,
                        int8=True),
            ragged_case("ragged bf16/int8 verify B=32 W=5 ps=16", verify, 5,
                        16, bf16, dev, gen, timer, verify=True, int8=True),
            ragged_case("ragged bf16/int8 decode rows R=32 W=512 ps=64",
                        decode_only, 512, 64, bf16, dev, gen, int8=True),
            ragged_case("ragged bf16/int8 chunk rows ending mid-tile R=6 "
                        "W=512 ps=32", mid_tile, 512, 32, bf16, dev, gen,
                        int8=True),
            ragged_case("ragged f32/int8 tiny R=4 W=16 ps=16",
                        [(1, 0), (77, 15), (0, -1), (200, 3)], 16, 16, f32,
                        dev, gen, max_len=256, int8=True, **tiny),
        ],
    }, "stacked": {
        # The headline cases at the last layer of a bench-1b-deep
        # stacked cache; then decode over 2304 pages a layer, where the
        # layer's element offset passes 2^31 (about 4.8 GB a bf16 k
        # cache).
        "paged_decode": [
            decode_case("decode bf16 stacked L=16 layer 15 B=32 ps=128", 32,
                        lens, 128, bf16, dev, gen, timer, num_pages=512,
                        stack=STACK),
            decode_case("decode bf16 stacked L=16 layer 15 B=32 ps=128, "
                        "2304 pages", 32, lens, 128, bf16, dev, gen,
                        num_pages=2304, stack=STACK),
        ],
        "paged_prefill": [
            prefill_case("prefill bf16 stacked L=16 layer 15 B=8 T=512 first "
                         "chunk ps=128", first, 512, 128, bf16, dev, gen,
                         timer, stack=STACK),
        ],
        "paged_ragged": [
            ragged_case("ragged bf16 stacked L=16 layer 15 unified R=40 "
                        "W=512 ps=128", unified_ragged, 512, 128, bf16, dev,
                        gen, timer, stack=STACK),
        ],
    }, "int8_stacked": {
        "paged_decode": [
            decode_case("decode bf16/int8 stacked L=16 layer 15 B=32 ps=128",
                        32, lens, 128, bf16, dev, gen, timer, num_pages=512,
                        int8=True, stack=STACK),
        ],
        "paged_prefill": [
            prefill_case("prefill bf16/int8 stacked L=16 layer 15 B=8 T=512 "
                         "first chunk ps=128", first, 512, 128, bf16, dev,
                         gen, timer, int8=True, stack=STACK),
        ],
        "paged_ragged": [
            ragged_case("ragged bf16/int8 stacked L=16 layer 15 unified "
                        "R=40 W=512 ps=128", unified_ragged, 512, 128, bf16,
                        dev, gen, timer, int8=True, stack=STACK),
        ],
    }}
    headline = {name: {} for name in KERNELS}
    for form, by_kernel in cases.items():
        for name, results in by_kernel.items():
            for r in results:
                log("kernel case " + json.dumps(r))
            head = dict(results[0])
            head["max_abs_err"] = max(r["max_abs_err"] for r in results)
            headline[name][form] = head
            before = BEFORE_REDESIGN_MS.get(name, {}).get(form)
            if before is not None:
                log(f"kernel {name} {form}: {head['ms']:.5f} ms now, "
                    f"before_redesign_ms {before} (recorded, not measured "
                    f"in this run): {before / head['ms']:.2f}x")
    return headline


# ---- model phase ------------------------------------------------------------


def model_phase(dev) -> None:
    from production_stack_tpu_torch.engine.config import (
        bench_1b_model_config)
    from production_stack_tpu_torch.models import llama

    cfg = bench_1b_model_config()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = llama.init_params(cfg, gen, dev)
    tokens = torch.randint(1, cfg.vocab_size, (1, 512 + 6), generator=gen,
                           device=dev, dtype=torch.int32)
    for kv_dtype in ("bf16", "int8"):
        per_layer = _model_forwards(dev, cfg, params, tokens, kv_dtype)
        stacked = _forwards(dev, cfg, params, tokens,
                            _model_caches(dev, cfg, kv_dtype, "stacked"),
                            "cuda")
        for phase, a, b in zip(PHASES, stacked, per_layer):
            if not torch.equal(a, b):
                raise AssertionError(
                    f"model {kv_dtype} KV {phase}: logits over the stacked "
                    "cache differ from those over the per-layer caches")
        log(f"model bench-1b {kv_dtype} KV: stacked-cache logits bitwise "
            f"equal to per-layer ones ({', '.join(PHASES)})")
    del params
    torch.cuda.empty_cache()


PHASES = ("prefill T=512", "decode T=1", "verify T=5 (ragged)")


def _model_caches(dev, cfg, kv_dtype, layout):
    """Fresh k and v caches of 8 pages of 128 tokens: a list of
    per-layer buffers, or one stacked buffer each."""
    from production_stack_tpu_torch.ops.quant_kv import quant_cache_zeros

    shape = (cfg.num_key_value_heads, 8, cfg.head_dim, 128)
    layers = cfg.num_hidden_layers

    def cache(shape):
        if kv_dtype == "int8":
            return quant_cache_zeros(shape, dev)
        return torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)

    if layout == "stacked":
        return cache((layers,) + shape), cache((layers,) + shape)
    return ([cache(shape) for _ in range(layers)],
            [cache(shape) for _ in range(layers)])


def _forwards(dev, cfg, params, tokens, caches, impl):
    """The prefill chunk, decode step and verify block through
    ``forward`` over ``caches``; returns their logits."""
    from production_stack_tpu_torch.models import llama

    t = 512
    table = torch.tensor([[1, 2, 3, 4, 5]], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        prefill = llama.forward(
            params, cfg, tokens[:, :t],
            torch.arange(t, device=dev, dtype=torch.int32)[None],
            table, torch.tensor([t], dtype=torch.int32, device=dev),
            torch.ones((1, t), dtype=torch.bool, device=dev),
            *caches, kind="prefill", impl=impl)
        decode = llama.forward(
            params, cfg, tokens[:, t:t + 1],
            torch.tensor([[t]], dtype=torch.int32, device=dev), table,
            torch.tensor([t + 1], dtype=torch.int32, device=dev),
            torch.ones((1, 1), dtype=torch.bool, device=dev),
            *caches, kind="decode", impl=impl)
        verify = llama.forward(
            params, cfg, tokens[:, t + 1:],
            torch.arange(t + 1, t + 6, device=dev,
                         dtype=torch.int32)[None], table,
            torch.tensor([t + 6], dtype=torch.int32, device=dev),
            torch.ones((1, 5), dtype=torch.bool, device=dev),
            *caches, kind="ragged", impl=impl)
    torch.cuda.synchronize()
    return prefill[0], decode[0], verify[0]


# A top-1 flip between the kernels' forward and its plain reference is
# allowed only as a near-tie: where the reference's margin between its
# own best token and the kernels' pick is under this many logits. The
# two forwards run the same bf16 model with the same roundings and
# differ only in the order of each attention's f32 sums; on the card
# that order alone moved a logit by up to 0.094 (the f32 FMA kernels
# against the f32 plain walk, before the tensor-core redesigns). This
# bound is that, rounded up to a power of two. Fixed: a larger logit
# difference does not excuse a larger flip, and there is no allowance
# on the number of flips.
NEAR_TIE_LOGITS = 0.125


def compare_logits(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """``got`` against ``ref`` ([..., vocab] logits): the largest
    difference, the largest |logit| of ``ref``, the top-1 flips and, at
    each flip, the reference's margin (its best logit minus its logit at
    ``got``'s pick), largest first. ``ok``: every logit finite, within 5%
    of the largest, and every flip a near-tie (margin under
    NEAR_TIE_LOGITS)."""
    finite = bool(torch.isfinite(got).all() and torch.isfinite(ref).all())
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    pick = got.argmax(-1, keepdim=True)
    flipped = pick[..., 0] != ref.argmax(-1)
    margin = ref.max(-1).values - ref.gather(-1, pick)[..., 0]
    margins = sorted(margin[flipped].float().tolist(), reverse=True)
    ok = (finite and diff <= 0.05 * scale
          and all(m < NEAR_TIE_LOGITS for m in margins))
    return {"ok": ok, "finite": finite, "diff": diff, "scale": scale,
            "positions": flipped.numel(), "flips": len(margins),
            "margins": margins}


def _model_forwards(dev, cfg, params, tokens, kv_dtype):
    """The prefill chunk, decode step and verify block through the
    kernels and through their plain versions over a fresh ``kv_dtype``
    per-layer cache each, compared; returns the kernels' logits. The
    reference is the plain versions rounded as the kernels round
    (``plain_bf16p``: the prefill and ragged walks feed bf16
    probabilities to p . v, as the tensor-core walk does)."""
    results = {impl: _forwards(dev, cfg, params, tokens,
                               _model_caches(dev, cfg, kv_dtype,
                                             "per_layer"), impl)
               for impl in ("cuda", "plain_bf16p")}
    for i, phase in enumerate(PHASES):
        c = compare_logits(results["cuda"][i], results["plain_bf16p"][i])
        log(f"model bench-1b {kv_dtype} KV {phase}: logits "
            f"{tuple(results['cuda'][i].shape)}, finite {c['finite']}, max "
            f"|cuda - plain| {c['diff']:.3e} (max |logit| "
            f"{c['scale']:.3e}), top-1 agreement "
            f"{1 - c['flips'] / c['positions']:.4f} ({c['flips']} flips), "
            f"margins of the flips {[f'{m:.3e}' for m in c['margins']]}")
        # Over int8 KV each side also quantizes the K/V its own layers
        # produced, so the logits move more; the same bound holds.
        if not c["ok"]:
            raise AssertionError(
                f"model {kv_dtype} KV {phase}: cuda and plain forwards "
                f"disagree (non-finite logits, logits apart by more than "
                f"5%, or a flip past the near-tie bound {NEAR_TIE_LOGITS})")
    return results["cuda"]


# ---- engine phase -----------------------------------------------------------


def engine_phase(vocab: int) -> None:
    """bench-1b, stacked layout, unified step and async off: 8 greedy
    prompts submitted before the first step, decoded single-step and
    in bursts of 4. Every GEMM keeps its padded shape and the rows do
    not interact, so the streams must be byte-identical."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig, bench_1b_model_config)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

    rng = np.random.RandomState(2)
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(64, 500, 8).round().astype(int)]
    streams = {}
    for k in (1, 4):
        cfg = EngineConfig(
            model=bench_1b_model_config(),
            cache=CacheConfig(page_size=128, num_pages=512,
                              cache_layout="stacked"),
            scheduler=SchedulerConfig(
                max_num_seqs=32, max_model_len=1024,
                prefill_chunk_size=512, prefill_batch_size=8,
                decode_steps=k, async_scheduling=False,
                unified_step=False))
        engine = LLMEngine(cfg, device="cuda")
        torch.cuda.synchronize()
        COUNTERS.reset()
        t0 = time.perf_counter()
        seqs = engine.generate_batch(prompts, SamplingParams(
            temperature=0.0, max_tokens=32, ignore_eos=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(COUNTERS.launches)
        streams[k] = [list(s.output_token_ids) for s in seqs]
        steps = engine.metrics.pipeline_steps_total
        del engine, seqs
        torch.cuda.empty_cache()
        log(f"engine bench-1b stacked decode_steps={k}: 8 prompts x 32 "
            f"tokens in {wall:.3f} s over {steps} steps; launches "
            f"{launches}")
        if set(launches) != {"paged_prefill_stacked",
                             "paged_decode_stacked"}:
            raise AssertionError(f"engine decode_steps={k}: launched "
                                 f"{launches}, expected the stacked "
                                 "prefill and decode forms only")
    if streams[1] != streams[4]:
        diff = [i for i, (a, b) in enumerate(zip(streams[1], streams[4]))
                if a != b]
        raise AssertionError(f"engine: decode_steps 4 streams differ from "
                             f"single-step ones in rows {diff}")
    log("engine bench-1b stacked: decode_steps 4 streams byte-identical to "
        "decode_steps 1 (8 rows x 32 tokens)")


# ---- graph phase ------------------------------------------------------------


# The engine comparison's cases: (label, cache options, scheduler
# options). Spec and bursts run synchronously, as the server's async
# ``auto`` resolves them.
GRAPH_CASES = [
    ("per_layer bf16, unified, async", {"cache_layout": "per_layer"},
     {"unified_step": True, "async_scheduling": True}),
    ("stacked int8, unified, async",
     {"cache_layout": "stacked", "kv_cache_dtype": "int8"},
     {"unified_step": True, "async_scheduling": True}),
    ("spec k=4, unified", {"cache_layout": "per_layer"},
     {"unified_step": True, "async_scheduling": False,
      "speculative_k": 4}),
    ("decode_steps 4, unified", {"cache_layout": "per_layer"},
     {"unified_step": True, "async_scheduling": False, "decode_steps": 4}),
]
# Steady decode steps whose host calls are counted (first case).
HOST_WINDOW_STEPS = 4


def _kernel_family(name: str):
    """The launch counter a device kernel's name belongs to (its forms
    summed), or None: the decode kernel's merge is not a counted
    launch."""
    for kernel in KERNELS:
        if kernel + "_kernel" in name or kernel + "_mma_kernel" in name:
            return kernel
    return None


def _engine_run(cfg, prompts, cuda_graphs, profiled):
    """Run ``prompts`` (greedy, 32 tokens each, submitted together)
    through a fresh engine; returns its streams and what it counted.
    ``profiled``: the run goes under torch.profiler, which gives the
    kernels the card ran, by counter, and the host calls queued in a
    window of steady decode steps."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
    from production_stack_tpu_torch.tools.profile_steps import (
        is_host_launch)

    engine = LLMEngine(cfg, device="cuda", cuda_graphs=cuda_graphs)
    torch.cuda.synchronize()
    COUNTERS.reset()
    seqs = [engine.sequences[engine.add_request(p, SamplingParams(
        temperature=0.0, max_tokens=32, ignore_eos=True))] for p in prompts]

    def run():
        window = False
        while engine.has_work():
            # The window: once every row is decoding, mid-run.
            if (profiled and not window
                    and all(len(q.output_token_ids) >= 8 for q in seqs)):
                window = True
                with record_function("host window"):
                    for _ in range(HOST_WINDOW_STEPS):
                        engine.step()
                    torch.cuda.synchronize()
            else:
                engine.step()
        torch.cuda.synchronize()

    out = {}
    t0 = time.perf_counter()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
        ran = {}
        for e in prof.key_averages():
            family = (_kernel_family(e.key)
                      if str(e.device_type).endswith("CUDA") else None)
            if family:
                ran[family] = ran.get(family, 0) + e.count
        events = prof.events()
        span = next(e.time_range for e in events if e.name == "host window")
        calls = {}
        for e in events:
            if (is_host_launch(e.name) and span.start <= e.time_range.start
                    and e.time_range.end <= span.end):
                calls[e.name] = calls.get(e.name, 0) + 1
        out.update(device_launches=ran, window_calls=calls)
    else:
        run()
    out["wall"] = time.perf_counter() - t0
    out["streams"] = [list(q.output_token_ids) for q in seqs]
    out["counted"] = {}
    for name, n in COUNTERS.launches.items():
        family = next(k for k in KERNELS if name.startswith(k))
        out["counted"][family] = out["counted"].get(family, 0) + n
    out["plain_calls"] = dict(COUNTERS.plain_cuda_calls)
    graphs = engine.runner.graphs
    if graphs is not None:
        out.update(captures=dict(graphs.captures),
                   capture_seconds=dict(graphs.capture_seconds),
                   replays=dict(graphs.replays), keys=graphs.keys(),
                   eager_steps=dict(graphs.eager_steps),
                   pool_bytes=graphs.pool_bytes())
    out["steps"] = engine.metrics.pipeline_steps_total
    out["ragged_steps"] = engine.metrics.ragged_steps_total
    out["drafted"] = engine.metrics.spec_draft_tokens_total
    out["engine"] = engine
    return out


def _seeded_run(engine, vocab):
    """One seeded stochastic request alone: every step has the seeded
    row, so every step runs eagerly on either path."""
    from production_stack_tpu_torch.engine.sequence import SamplingParams

    rng = np.random.RandomState(9)
    seq = engine.generate(rng.randint(258, vocab, size=200).tolist(),
                          SamplingParams(temperature=0.8, top_p=0.95,
                                         seed=17, max_tokens=8,
                                         ignore_eos=True))
    return list(seq.output_token_ids)


def graph_phase(vocab: int) -> None:
    """Each case graphed against eager: greedy streams byte-identical;
    see the module docstring (phase 6)."""
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig, bench_1b_model_config)

    rng = np.random.RandomState(4)
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(64, 700, 16).round().astype(int)]
    spec_prompts = []
    for i in range(16):
        block = rng.randint(258, vocab, size=16 + 3 * i).tolist()
        spec_prompts.append((block * (500 // len(block) + 1))[:500 - 7 * i])
    for c, (label, cache, sched) in enumerate(GRAPH_CASES):
        cfg_of = lambda: EngineConfig(  # noqa: E731
            model=bench_1b_model_config(),
            cache=CacheConfig(page_size=128, num_pages=512, **cache),
            scheduler=SchedulerConfig(
                max_num_seqs=32, max_model_len=1024, prefill_chunk_size=512,
                prefill_batch_size=8, **sched))
        case_prompts = spec_prompts if "speculative_k" in sched else prompts
        runs = {}
        for cuda_graphs in (True, False):
            run = _engine_run(cfg_of(), case_prompts, cuda_graphs,
                              profiled=c == 0)
            if c == 0:
                # A seeded request alone, in the same engine.
                run["seeded"] = _seeded_run(run["engine"], vocab)
                if cuda_graphs:
                    run["eager_after_seeded"] = dict(
                        run["engine"].runner.graphs.eager_steps)
            del run["engine"]
            torch.cuda.empty_cache()
            runs["graphs" if cuda_graphs else "eager"] = run
        g, e = runs["graphs"], runs["eager"]
        log(f"graphs bench-1b {label}: {len(case_prompts)} prompts x 32 "
            f"tokens over {g['steps']} steps ({g['ragged_steps']} unified or "
            f"verify-ragged, {g['drafted']} drafted); graphed "
            f"{g['wall']:.3f} s, eager {e['wall']:.3f} s; captures "
            f"{g['captures']} in "
            f"{ {k: round(v, 3) for k, v in g['capture_seconds'].items()} } s"
            f", replays {g['replays']}, {len(g['keys'])} keys "
            f"{sorted(g['keys'])}, graph pool "
            f"{g['pool_bytes'] / 2**20:.1f} MiB, eager steps "
            f"{g['eager_steps']}; launches graphed {g['counted']}, eager "
            f"{e['counted']}")
        if g["streams"] != e["streams"]:
            rows = [i for i, (a, b) in enumerate(zip(g["streams"],
                                                     e["streams"]))
                    if a != b]
            raise AssertionError(f"graphs {label}: greedy streams differ "
                                 f"from the eager run's in rows {rows}")
        if (sum(g["captures"].values()) != len(g["keys"])
                or g["eager_steps"] != {"seeded": 0}
                or sum(g["replays"].values()) < len(g["keys"])):
            raise AssertionError(
                f"graphs {label}: expected one capture a key, a replay "
                f"every step and no eager step: captures {g['captures']}, "
                f"keys {len(g['keys'])}, replays {g['replays']}, steps "
                f"{g['steps']}, eager {g['eager_steps']}")
        if g["plain_calls"] or e["plain_calls"]:
            raise AssertionError(f"graphs {label}: plain versions ran on "
                                 f"CUDA tensors")
        if set(g["counted"]) != set(KERNELS) and c < 2:
            raise AssertionError(f"graphs {label}: launched {g['counted']}, "
                                 "expected all three kernels")
        if "speculative_k" in sched and g["drafted"] <= 0:
            raise AssertionError(f"graphs {label}: nothing was drafted")
        if c == 0:
            for path, run in runs.items():
                if run["device_launches"] != run["counted"]:
                    raise AssertionError(
                        f"graphs {label} ({path}): the card ran "
                        f"{run['device_launches']} kernels, the counters "
                        f"say {run['counted']}")
                calls = {k: v / HOST_WINDOW_STEPS
                         for k, v in sorted(run["window_calls"].items())}
                log(f"graphs bench-1b {label} ({path}): host calls per "
                    f"steady decode step {sum(calls.values()):.2f} "
                    f"({calls}); "
                    f"the card ran {run['device_launches']} attention "
                    "kernels, as counted")
            if g["seeded"] != e["seeded"]:
                raise AssertionError("graphs: a seeded request's tokens "
                                     "differ between the two engines")
            eager = g["eager_after_seeded"]["seeded"]
            if eager < 8:
                raise AssertionError(f"graphs: the seeded request's steps "
                                     f"ran eagerly {eager} times, expected "
                                     "one a step (8)")
            log(f"graphs: a seeded request alone ran {eager} steps "
                f"eagerly in the graphed engine, tokens equal to the eager "
                "engine's")
        log(f"graphs bench-1b {label}: greedy streams byte-identical, "
            f"graphed against eager ({len(case_prompts)} rows x 32 tokens)")


# ---- sampling options phase -------------------------------------------------


# Greedy bias of a guided row: its structural bytes in the order that
# closes a document ({"":""}) and EOS after it.
GUIDED_CLOSING_BIAS = {ord("{"): 60.0, ord('"'): 100.0, ord(":"): 80.0,
                       ord("}"): 50.0, 257: 100.0}
FORCED_TOKEN = 1234
OPTIONS_MIN_TOKENS = 8
LOGPROB_TOL = 1e-3


def _option_rows():
    """(label, sampling kwargs) of the phase's 16 rows: every option of
    the chain, mixed with plain greedy rows, 32 tokens each."""
    base = dict(temperature=0.0, max_tokens=32)
    lp = dict(logprobs=True, top_logprobs=20)
    kinds = [
        ("plain", dict(base, ignore_eos=True)),
        ("penalties+logprobs", dict(base, ignore_eos=True,
                                    presence_penalty=0.8,
                                    frequency_penalty=0.4, **lp)),
        ("repetition", dict(base, ignore_eos=True, repetition_penalty=1.3)),
        ("forced", dict(base, ignore_eos=True,
                        logit_bias={FORCED_TOKEN: 100.0})),
        ("min_tokens", dict(base, min_tokens=OPTIONS_MIN_TOKENS,
                            logit_bias={257: 100.0})),
        ("guided", dict(base, guided="json",
                        logit_bias=GUIDED_CLOSING_BIAS)),
        ("logprobs", dict(base, ignore_eos=True, **lp)),
        ("plain", dict(base, ignore_eos=True)),
    ]
    return kinds * 2


def _options_run(prompts, decode_steps, cuda_graphs):
    from production_stack_tpu_torch.engine.config import (
        CacheConfig, EngineConfig, SchedulerConfig, bench_1b_model_config)
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sequence import SamplingParams
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

    cfg = EngineConfig(
        model=bench_1b_model_config(),
        cache=CacheConfig(page_size=128, num_pages=512),
        scheduler=SchedulerConfig(
            max_num_seqs=32, max_model_len=1024, prefill_chunk_size=512,
            prefill_batch_size=8, decode_steps=decode_steps,
            async_scheduling=decode_steps == 1, unified_step=True))
    engine = LLMEngine(cfg, device="cuda", cuda_graphs=cuda_graphs)
    torch.cuda.synchronize()
    COUNTERS.reset()
    ids = [engine.add_request(p, SamplingParams(**kw))
           for p, (_, kw) in zip(prompts, _option_rows())]
    rows = {sid: [] for sid in ids}
    seqs = [engine.sequences[sid] for sid in ids]
    t0 = time.perf_counter()
    while engine.has_work():
        for out in engine.step():
            if out.new_token is not None:
                rows[out.seq_id].append((out.new_token, out.logprobs))
    torch.cuda.synchronize()
    out = {"wall": time.perf_counter() - t0,
           "rows": [rows[sid] for sid in ids],
           "finish": [s.finish_reason.value for s in seqs],
           "steps": engine.metrics.pipeline_steps_total,
           "launches": dict(COUNTERS.launches),
           "plain_calls": dict(COUNTERS.plain_cuda_calls),
           "guided_fsm": engine.guided_fsm}
    graphs = engine.runner.graphs
    if graphs is not None:
        out.update(captures=dict(graphs.captures), keys=graphs.keys(),
                   replays=dict(graphs.replays),
                   eager_steps=dict(graphs.eager_steps))
    del engine, seqs
    torch.cuda.empty_cache()
    return out


def _tokens(run):
    return [[t for t, _ in r] for r in run["rows"]]


def _logprob_gap(a, b) -> float:
    """The largest difference between two runs' logprob entries of the
    same tokens; raises where a top id differs other than at a tie."""
    worst = 0.0
    for (slp, tops), (e_slp, e_tops) in zip(a, b):
        worst = max(worst, abs(slp - e_slp))
        vals = [v for _, v in e_tops]
        for j, ((tid, v), (e_tid, e_v)) in enumerate(zip(tops, e_tops)):
            worst = max(worst, abs(v - e_v))
            if tid != e_tid and not (j == len(vals) - 1 or any(
                    k != j and abs(vals[k] - e_v) <= LOGPROB_TOL
                    for k in range(len(vals)))):
                raise AssertionError(f"sampling options: top id {tid} "
                                     f"against {e_tid} at rank {j}, no tie")
    return worst


def sampling_options_phase(vocab: int) -> None:
    """The per-row option chain at full width, graphed against eager at
    decode_steps 1 and 4; see the module docstring (phase 7)."""
    rng = np.random.RandomState(6)
    prompts = [rng.randint(258, vocab, size=n).tolist()
               for n in np.linspace(64, 700, 16).round().astype(int)]
    labels = [label for label, _ in _option_rows()]
    runs = {}
    for k in (1, 4):
        for cuda_graphs in (True, False):
            runs[k, cuda_graphs] = _options_run(prompts, k, cuda_graphs)
    for k in (1, 4):
        g, e = runs[k, True], runs[k, False]
        if _tokens(g) != _tokens(e):
            bad = [labels[i] for i, (a, b) in enumerate(zip(_tokens(g),
                                                           _tokens(e)))
                   if a != b]
            raise AssertionError(f"sampling options K={k}: graphed streams "
                                 f"differ from eager in rows {bad}")
        gap = 0.0
        for i, (rg, re_) in enumerate(zip(g["rows"], e["rows"])):
            want = _option_rows()[i][1].get("logprobs", False)
            entries = [lp for _, lp in rg], [lp for _, lp in re_]
            if want != all(x is not None for x in entries[0] + entries[1]):
                raise AssertionError(f"sampling options K={k}: row "
                                     f"{labels[i]} logprobs {want} not kept")
            if want:
                gap = max(gap, _logprob_gap(*entries))
        if gap > LOGPROB_TOL:
            raise AssertionError(f"sampling options K={k}: logprobs differ "
                                 f"by {gap} graphed against eager")
        if (sum(g["captures"].values()) != len(g["keys"])
                or any(g["eager_steps"].values())):
            raise AssertionError(f"sampling options K={k}: captures "
                                 f"{g['captures']} for {len(g['keys'])} keys, "
                                 f"eager steps {g['eager_steps']}")
        if g["plain_calls"] or e["plain_calls"]:
            raise AssertionError("sampling options: plain versions ran on "
                                 "CUDA tensors")
        fsm = g["guided_fsm"]
        for i, label in enumerate(labels):
            toks = _tokens(g)[i]
            if label == "forced" and set(toks) != {FORCED_TOKEN}:
                raise AssertionError(f"sampling options K={k}: the +100 "
                                     f"token was not emitted: {toks}")
            if label == "min_tokens" and (
                    len(toks) != OPTIONS_MIN_TOKENS + 1 or toks[-1] != 257
                    or 257 in toks[:-1]):
                raise AssertionError(f"sampling options K={k}: min_tokens "
                                     f"row {toks}")
            if label == "guided":
                state = 0
                for t in toks:
                    state = fsm.advance(state, t)
                json.loads(bytes(t for t in toks if t < 256))
                if state < 0 or toks[-1] != 257:
                    raise AssertionError(f"sampling options K={k}: guided "
                                         f"row {toks}")
        by_options = {}
        for key in g["keys"]:
            name = "+".join(key[3]) or "none"
            by_options[name] = by_options.get(name, 0) + 1
        log(f"sampling options bench-1b K={k}: 16 rows "
            f"({', '.join(labels[:8])} x 2) in {g['steps']} steps; "
            f"graphed {g['wall']:.3f} s, eager {e['wall']:.3f} s; "
            f"captures {g['captures']} for {len(g['keys'])} keys, by "
            f"option set {by_options}; replays {g['replays']}, eager "
            f"steps {g['eager_steps']}; launches {g['launches']}; "
            f"logprobs graphed vs eager within {gap:.2e}")
    if _tokens(runs[1, True]) != _tokens(runs[4, True]):
        raise AssertionError("sampling options: decode_steps 4 streams "
                             "differ from decode_steps 1")
    log("sampling options bench-1b: greedy streams byte-identical graphed "
        "against eager and at decode_steps 1 and 4; guided rows parse as "
        "JSON, min_tokens rows held EOS back, the +100 token emitted")


# ---- serving phase ----------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type":
                                          "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def serving_run(label, extra_args, requests, repeat, after=(), form="",
                probe=None):
    """Start the port's server with SERVER_ARGS + ``extra_args``, send
    ``requests`` concurrently with the launch counters set to 0 just
    before and read just after, then ``repeat`` twice; then (outside
    the counted window) the ``after`` requests, and ``probe`` (a body
    whose answer is returned unchecked, as ``probe``). Checks every
    completion, that every kernel launched in its ``form`` (the
    counter suffix: "", "_int8", "_stacked" or "_int8_stacked") and in
    no other, and returns what the run measured, with the decode
    dispatches' rows and committed tokens in the counted window."""
    from production_stack_tpu_torch.engine.server import make_server
    from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS

    port = _free_port()
    server = make_server(SERVER_ARGS + extra_args
                         + ["--host", "127.0.0.1", "--port", str(port)])
    # The synchronous decode dispatches (bursts, or single steps with
    # async off): rows and tokens each committed.
    runner = server.app.engine.runner
    decode = {"dispatches": 0, "row_steps": 0, "tokens": 0}
    run_decode = runner.run_decode

    def counted_run_decode(plan):
        out = run_decode(plan)
        if plan.drafts is None:
            decode["dispatches"] += 1
            decode["row_steps"] += len(out[0])
            decode["tokens"] += sum(len(t) for t in out[0])
        return out

    runner.run_decode = counted_run_decode
    thread = threading.Thread(target=server.serve, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{port}"

    def post_all(bodies):
        with ThreadPoolExecutor(len(bodies)) as pool:
            return list(pool.map(
                lambda b: _post(base + "/v1/completions", b), bodies))

    try:
        torch.cuda.synchronize()
        COUNTERS.reset()
        decode.update(dispatches=0, row_steps=0, tokens=0)
        t0 = time.perf_counter()
        answers = post_all(requests)
        wall = time.perf_counter() - t0
        again = [_post(base + "/v1/completions", repeat) for _ in range(2)]
        torch.cuda.synchronize()
        launches = dict(COUNTERS.launches)
        plain_calls = dict(COUNTERS.plain_cuda_calls)
        decode_counts = dict(decode)
        graphs = runner.graphs
        ledger = (dict(graphs.captures), dict(graphs.replays),
                  dict(graphs.eager_steps), len(graphs.keys()))
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            metrics = r.read().decode()
        after_answers = post_all(list(after)) if after else []
        probe_answer = (_post(base + "/v1/completions", probe)
                        if probe is not None else None)
    finally:
        server.shutdown()
        thread.join(timeout=60)

    bodies = list(requests) + [repeat] * 2 + list(after)
    for body, ans in zip(bodies, answers + again + after_answers):
        usage = ans["usage"]
        n = body["max_tokens"]
        if (usage["completion_tokens"] != n
                or usage["prompt_tokens"] != len(body["prompt"])
                or usage["total_tokens"] != len(body["prompt"]) + n
                or ans["choices"][0]["finish_reason"] != "length"):
            raise AssertionError(f"{label}: bad completion: {ans}")
    if again[0]["choices"][0]["text"] != again[1]["choices"][0]["text"]:
        raise AssertionError(f"{label}: a repeated greedy request gave "
                             "other tokens")

    def metric(name):
        return float(next(line.split()[-1] for line in metrics.splitlines()
                          if line.startswith(name + " ")))

    ragged = metric("vllm:engine_ragged_steps_total")
    if ragged <= 0:
        raise AssertionError(f"{label}: no unified mixed step ran")
    for kernel in KERNELS:
        if launches.get(kernel + form, 0) <= 0:
            raise AssertionError(f"{label}: the run never launched "
                                 f"{kernel + form}")
        for other in ("", "_int8", "_stacked", "_int8_stacked"):
            if other != form and launches.get(kernel + other, 0):
                raise AssertionError(f"{label}: the run launched "
                                     f"{kernel + other}")
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: plain versions ran on CUDA "
                             f"tensors: {plain_calls}")
    captures, replays, eager, keys = ledger
    if (sum(captures.values()) != keys or not sum(replays.values())
            or any(eager.values())):
        raise AssertionError(f"{label}: expected every step replayed from "
                             f"a graph captured once a key: captures "
                             f"{captures}, keys {keys}, replays {replays}, "
                             f"eager steps {eager}")
    if metric("vllm:engine_compile_events_total{kind=\"step\"}") != (
            captures["step"]):
        raise AssertionError(f"{label}: /metrics does not carry the "
                             "step graphs' captures")
    log(f"{label}: captures {captures} ({keys} keys), replays {replays}, "
        f"eager steps {eager}")
    tokens = sum(b["max_tokens"] for b in requests)
    log(f"{label} bench-1b: {len(requests)} concurrent requests, "
        f"{tokens} tokens in {wall:.3f} s ({tokens / wall:.1f} tok/s); "
        f"ragged steps {ragged:.0f}; launches {launches}; plain calls "
        f"on CUDA tensors {plain_calls or 0}")
    return {"launches": launches, "answers": answers,
            "after": after_answers, "probe": probe_answer, "wall": wall,
            "tokens": tokens,
            "metrics": metrics, "metric": metric, "decode": decode_counts,
            "async": server.app.engine.config.scheduler.async_scheduling,
            "drafted": metric("vllm:spec_decode_num_draft_tokens_total"),
            "accepted": metric(
                "vllm:spec_decode_num_accepted_tokens_total")}


def serving_phase(vocab: int) -> dict:
    """Returns each serving run's kernel launch counts."""
    rng = np.random.RandomState(0)
    lengths = np.linspace(64, 700, 16).round().astype(int)
    requests = []
    for i, n in enumerate(lengths):
        body = {"model": "bench-1b", "max_tokens": 32, "ignore_eos": True,
                "prompt": rng.randint(258, vocab, size=n).tolist()}
        body.update({"temperature": 0.0} if i % 2 == 0 else
                    {"temperature": 0.8, "top_p": 0.95})
        requests.append(body)
    repeat = {"model": "bench-1b", "max_tokens": 32, "ignore_eos": True,
              "temperature": 0.0,
              "prompt": rng.randint(258, vocab, size=300).tolist()}
    # Greedy prompts that repeat a block of 16..64 tokens up to about
    # 500 tokens: the trailing n-gram of each has occurred before, so
    # the proposer drafts even when random weights do not repeat.
    spec_requests = []
    for i in range(16):
        block = rng.randint(258, vocab, size=16 + 3 * i).tolist()
        spec_requests.append({
            "model": "bench-1b", "max_tokens": 32, "ignore_eos": True,
            "temperature": 0.0,
            "prompt": (block * (500 // len(block) + 1))[:500 - 7 * i]})

    # After the timed window: n 3 of best_of 4 candidates, with the
    # sampled logprob and 5 alternatives a position.
    probe = {"model": "bench-1b", "max_tokens": 16, "ignore_eos": True,
             "temperature": 0.9, "seed": 5, "n": 3, "best_of": 4,
             "logprobs": 5, "prompt": requests[3]["prompt"]}
    base = serving_run("serving", [], requests, repeat,
                       after=spec_requests, probe=probe)
    _check_best_of(base["probe"], probe)
    spec = serving_run("serving spec k=4", ["--speculative-k", "4"],
                       spec_requests, spec_requests[0])
    if spec["drafted"] <= 0:
        raise AssertionError("the speculative run drafted no token")
    same = total = whole = 0
    for a, b in zip(spec["answers"], base["after"]):
        ta, tb = a["choices"][0]["text"], b["choices"][0]["text"]
        same += sum(x == y for x, y in zip(ta, tb))
        total += max(len(ta), len(tb))
        whole += ta == tb
    log(f"serving spec k=4: drafted {spec['drafted']:.0f}, accepted "
        f"{spec['accepted']:.0f} tokens; {spec['tokens'] / spec['wall']:.1f} "
        f"tok/s; greedy characters agreeing with the spec-off server "
        f"{same}/{total} ({same / total:.4f}), whole completions "
        f"{whole}/{len(spec['answers'])}")

    int8 = serving_run("serving int8 KV", ["--kv-cache-dtype", "int8"],
                       requests, repeat, form="_int8")
    if 'vllm:engine_kv_cache_dtype{kv_dtype="int8"} 1.0' not in (
            int8["metrics"]):
        raise AssertionError("int8 serving: /metrics does not show "
                             'kv_dtype="int8"')
    capacity = int8["metric"]("vllm:engine_kv_cache_page_capacity")
    if capacity != INT8_PAGE_CAPACITY:
        raise AssertionError(f"int8 serving: page capacity {capacity}, "
                             f"expected {INT8_PAGE_CAPACITY}")
    same, total, whole, greedy = _greedy_agreement(requests, int8, base)
    log(f"serving int8 KV: page capacity {capacity:.0f}, "
        f"{int8['tokens'] / int8['wall']:.1f} tok/s against "
        f"{base['tokens'] / base['wall']:.1f} for bf16 KV; greedy "
        f"characters agreeing with the bf16 KV server {same}/{total} "
        f"({same / total:.4f}), whole completions {whole}/{greedy}")

    stacked = serving_run("serving stacked", ["--cache-layout", "stacked"],
                          requests, repeat, form="_stacked")
    same, total, whole, greedy = _greedy_agreement(requests, stacked, base)
    log(f"serving stacked: {stacked['tokens'] / stacked['wall']:.1f} tok/s "
        f"against {base['tokens'] / base['wall']:.1f} per_layer; greedy "
        f"characters agreeing with the per_layer server {same}/{total} "
        f"({same / total:.4f}), whole completions {whole}/{greedy}")

    burst = serving_run("serving stacked int8 K=4",
                        ["--cache-layout", "stacked", "--kv-cache-dtype",
                         "int8", "--decode-steps", "4"], requests, repeat,
                        form="_int8_stacked")
    d = burst["decode"]
    per_row = d["tokens"] / max(d["row_steps"], 1)
    log(f"serving stacked int8 K=4: async {burst['async']}, "
        f"{burst['tokens'] / burst['wall']:.1f} tok/s; {d['dispatches']} "
        f"decode dispatches, {d['row_steps']} row-dispatches committing "
        f"{d['tokens']} tokens ({per_row:.2f} a row a dispatch)")
    if burst["async"]:
        raise AssertionError("burst serving: --async-scheduling auto did "
                             "not resolve off with --decode-steps 4")
    if per_row < 3.0:
        raise AssertionError(f"burst serving: {per_row:.2f} tokens a row "
                             "a decode dispatch, expected about 4")
    return {"serve": base["launches"], "serve_spec": spec["launches"],
            INT8_RUN: int8["launches"], STACKED_RUN: stacked["launches"],
            BURST_RUN: burst["launches"]}


def _check_best_of(ans, body) -> None:
    """An n / best_of / logprobs answer's shape: n choices in order of
    their mean token logprob, each with its tokens' legacy logprobs,
    and every candidate's tokens in the usage."""
    n, m = body["n"], body["max_tokens"]
    choices = ans["choices"]
    means = []
    for i, c in enumerate(choices):
        lp = c["logprobs"]
        if (c["index"] != i or c["finish_reason"] != "length"
                or len(lp["tokens"]) != m or len(lp["token_logprobs"]) != m
                or len(lp["top_logprobs"]) != m
                or not all(1 <= len(t) <= body["logprobs"]
                           for t in lp["top_logprobs"])):
            raise AssertionError(f"serving n/best_of: bad choice {c}")
        means.append(sum(lp["token_logprobs"]) / m)
    if (len(choices) != n or means != sorted(means, reverse=True)
            or ans["usage"]["completion_tokens"] != body["best_of"] * m):
        raise AssertionError(f"serving n/best_of: {len(choices)} choices, "
                             f"means {means}, usage {ans['usage']}")
    log(f"serving n={n} best_of={body['best_of']} logprobs="
        f"{body['logprobs']}: {n} choices of mean token logprob "
        f"{[round(x, 4) for x in means]}, usage {ans['usage']}")


def _greedy_agreement(requests, run, base):
    """(characters equal, characters, whole completions equal, greedy
    completions) of ``run``'s greedy answers against ``base``'s."""
    same = total = whole = greedy = 0
    for body, a, b in zip(requests, run["answers"], base["answers"]):
        if body.get("temperature", 1.0) != 0.0:
            continue
        ta, tb = a["choices"][0]["text"], b["choices"][0]["text"]
        same += sum(x == y for x, y in zip(ta, tb))
        total += max(len(ta), len(tb))
        whole += ta == tb
        greedy += 1
    return same, total, whole, greedy


# ---- main -------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from production_stack_tpu_torch.ops import paged_kv_common

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t_start = t0 = time.perf_counter()
    ptxas = []
    lib = paged_kv_common.build_kernels(log=ptxas.append)
    paged_kv_common.kernel_lib()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s -> "
        f"{os.path.relpath(lib, here)}")
    for text in ptxas:
        for line in text.splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                log(line.strip())

    headline = kernel_phase(dev)
    torch.cuda.empty_cache()
    model_phase(dev)
    from production_stack_tpu_torch.engine.config import (
        bench_1b_model_config)
    vocab = bench_1b_model_config().vocab_size
    engine_phase(vocab)
    graph_phase(vocab)
    sampling_options_phase(vocab)
    launches = serving_phase(vocab)

    def numbers(h):
        out = {"max_abs_err": h["max_abs_err"], "ms": h["ms"],
               "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
               "bound_by": h["bound_by"], "library_ms": h["library_ms"],
               "case": h["case"]}
        for key in ("per_layer_ms", "splits", "ms_by_splits"):
            if key in h:
                out[key] = h[key]
        return out

    summary = []
    for name, meta in KERNELS.items():
        h = headline[name]
        summary.append({
            "name": name, **meta,
            "launches": launches[MAIN_RUN].get(name, 0),
            "launches_by_run": {run: counts.get(name, 0)
                                for run, counts in launches.items()},
            **numbers(h["bf16"]),
            "int8": {"launches": launches[INT8_RUN].get(name + "_int8", 0),
                     **numbers(h["int8"])},
            "stacked": {"launches": launches[STACKED_RUN].get(
                name + "_stacked", 0), **numbers(h["stacked"])},
            "int8_stacked": {"launches": launches[BURST_RUN].get(
                name + "_int8_stacked", 0), **numbers(h["int8_stacked"])}})
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s, the kernel build included")
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
