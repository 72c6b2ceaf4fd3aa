"""Device time of the three attention kernels and the int8-weight GEMM at
their headline shapes.

    python production_stack_tpu_torch/tools/kernel_times.py [--repo DIR] \
        [--geometry bench-1b|g4_d128|g1_d64|g7_d128|g8_d128|g1_d80|
                    g7_d64|g1_d128|g3_d256|g1_d100|g3_d512|g1_d320]
        [--page-size P] [--kernels decode,prefill,ragged,int8_weight]

Times ``paged_decode_attention`` (B = 32, kv lens spread over 1..1024
with two pad rows, page size 128), ``paged_prefill_attention`` (B = 8,
T = 512, live lengths 64..512 with one pad row, page size 128: the
first chunk, and the second chunk from position 512 as
``paged_prefill_second``; beside each, ``library_paged_prefill*``:
one ``scaled_dot_product_attention`` over the same K/V gathered dense,
with the same mask, a yardstick the port never calls; and, where the
wrapper has it, the walk's plan as ``prefill_plan``: the walk, tile
rows, consumer warpgroups, ring stages, copy path, the walk also
printed on a line of its own) and
``paged_ragged_attention`` (the widest unified mixed step of
the serving configuration, R = 40 rows at W = 512: 28 decode rows, 8
chunk rows of first and second chunks, 4 pad rows; the speculative
verify block, B = 32 at W = 5, draft lens 0..4, two pad rows; and the
unified block's 28 decode rows and 12 pad rows alone, whose tiles past
a row's live slots only write zeros; page size 128; and, where the
wrapper's module has it, the walk's plan as ``ragged_plan`` at W = 512
and ``ragged_plan_verify`` at W = 5, the walk also printed on a line of
its own) at the bench-1b
geometry (32 q / 8 kv heads, head_dim 64, bf16) or the one
``--geometry`` names (``g4_d128``: Mixtral-8x7B's, Mistral-7B's and
Llama-3-8B's 32 q over 8 kv heads at head_dim 128; ``g1_d64``:
OPT-1.3b's 32 heads of 64, one q head a kv head; ``g7_d128``:
Qwen2-7B's 28 q over 4 kv heads at 128; ``g8_d128``: Llama-3-70B's 64
q over 8 kv heads at 128; ``g1_d80``: OPT-2.7b's 32 heads of 80 in f16;
``g7_d64``: Qwen2-0.5B's 14 q over 2 kv heads at 64 in f32;
``g1_d128``: Llama-2-7B's 32 heads of 128; ``g3_d256``: Falcon3-7B's
12 q over 4 kv heads at 256; ``g1_d100``: OpenLLaMA-3B's 32 heads of
100 in f16, padded in the kernel to 128; ``g3_d512``: 6 q over 2 kv
heads at 512, ``g3_d256``'s K/V bytes; ``g1_d320``: 16 heads of 320 in
f16, the wide prefill walk's width 384 padded; both four and three
slabs of 128 in decode and ragged), in the
geometry's dtype
(bf16 where none is named) over a cache of that type and an int8 one,
through the public wrappers of the checkout at ``--repo``
(default: the checkout this file lies in); ``--kernels`` names the
kernels to time (default all four). ``--page-size P`` (default
128) times the same rows over pages of P tokens (the same 1024-token
table width; a checkout whose kernels refuse P raises). The unified
block also runs
in the stacked form, its K/V at layer 15 of a [16, ...] cache whose
other layers are random, timed beside the per-layer launch in the order
per-layer, stacked, stacked, per-layer (``_stacked`` and
``_per_layer`` keys, a list of two readings each). Where
the decode wrapper takes ``num_splits`` it also times the launch's fixed
cost: a batch of pad rows (every block returns at once) and a batch of
one-token rows, each at one split and at three (the second adds the
merge kernel's launch). ``int8_weight`` times the int8-weight GEMM
(``ops/int8_matmul_cuda.int8_weight_matmul``, where the checkout has
it) at M = 1, 8, 16, 32, 64 and 160 rows for each bench-1b projection
(qkv, o, gate_up, down, bf16) and OPT-2.7b's fc1 (f16), each beside one
``torch.matmul`` in the same type on the dequantized weight
(``bf16_matmul_*``, ``f16_matmul_*``), its bound
(``int8_weight_bound_*``), the device kernels one call ran and their
device us a call (``int8_weight_kernels_*``, from torch.profiler) and,
where the checkout has ``int8_weight_plan``, its plan
(``int8_weight_plan_*``). To compare the GEMM of two commits:

    python production_stack_tpu_torch/tools/kernel_times.py \
        --repo build/parent --kernels int8_weight

and the same with ``--repo build/change``, run parent, change, change,
parent, comparing the ``_median`` keys.
The wrappers' signatures are stable, so the same script times two
commits in one call on the card: unpack the other commit somewhere and
pass its root.

Each timed launch is queued behind a device-side wait with the L2
flushed, so the CUDA events bracket the kernels alone (the wrapper's
Python runs ahead of the card). Prints the card's name and power limit,
then one JSON object of milliseconds per launch: each key the mean of
its 50 launches (every launch counted), ``<key>_median`` their median,
and ``spread_flags`` the keys whose mean parts from its median by more
than SPREAD_FLAG (a stall or a clock change inside the window). Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

L2_FLUSH_BYTES = 128 << 20
HEAD_START_CYCLES = 4_000_000  # about 2 ms: host stalls shorter are hidden
# A mean more than this share away from its median is flagged.
SPREAD_FLAG = 0.10


def _ms(fn, flush, iters=50, warmup=5):
    """(mean, median) device ms a launch over ``iters`` launches."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        torch.cuda._sleep(HEAD_START_CYCLES)
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
        torch.cuda.synchronize()
    times = [s.elapsed_time(e) for s, e in pairs]
    return sum(times) / iters, statistics.median(times)


def _time(out, key, fn, flush, append=False) -> None:
    """Time ``fn`` into ``out[key]`` (the mean; appended to a list with
    ``append``) and ``out[key + "_median"]``, flagging a wide spread."""
    mean, median = _ms(fn, flush)
    for k, x in ((key, mean), (key + "_median", median)):
        if append:
            out.setdefault(k, []).append(x)
        else:
            out[k] = x
    if abs(mean - median) > SPREAD_FLAG * median:
        out.setdefault("spread_flags", []).append(key)


# The stacked form: bench-1b's layer count and its last layer.
STACK = (16, 15)
# The int8-weight GEMM's cases as (K, N, dtype): bench-1b's four
# projections in bf16 and OPT-2.7b's fc1 in f16, at the rows of a
# decode step (1 to 64) and of a verify block (160).
W8_CASES = {"qkv": (2048, 3072, torch.bfloat16),
            "o": (2048, 2048, torch.bfloat16),
            "gate_up": (2048, 11264, torch.bfloat16),
            "down": (5632, 2048, torch.bfloat16),
            "fc1": (2560, 10240, torch.float16)}
W8_ROWS = (1, 8, 16, 32, 64, 160)
# (q heads, kv heads, head_dim, dtype) by --geometry.
GEOMETRIES = {"bench-1b": (32, 8, 64, torch.bfloat16),
              "g4_d128": (32, 8, 128, torch.bfloat16),
              "g1_d64": (32, 32, 64, torch.bfloat16),
              "g7_d128": (28, 4, 128, torch.bfloat16),
              "g8_d128": (64, 8, 128, torch.bfloat16),
              "g1_d80": (32, 32, 80, torch.float16),
              "g7_d64": (14, 2, 64, torch.float32),
              "g1_d128": (32, 32, 128, torch.bfloat16),
              "g3_d256": (12, 4, 256, torch.bfloat16),
              "g1_d100": (32, 32, 100, torch.float16),
              "g3_d512": (6, 2, 512, torch.bfloat16),
              "g1_d320": (16, 16, 320, torch.float16)}


def _stack_at(cache, gen):
    """A stacked [16, ...] cache (a QuantKV's data and scales alike)
    holding ``cache`` at layer 15 and random values in the others."""
    def stack(t):
        out = torch.empty((STACK[0],) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        if t.is_floating_point():
            out.normal_(generator=torch.Generator(t.device).manual_seed(1))
        else:
            out.random_(-127, 128,
                        generator=torch.Generator(t.device).manual_seed(1))
        out[STACK[1]] = t
        return out
    if hasattr(cache, "scale"):
        return type(cache)(stack(cache.data), stack(cache.scale).abs_())
    return stack(cache)


def _table(kv_lens, ps, max_pages, num_pages, gen, dev):
    perm = torch.randperm(num_pages - 1, generator=gen).to("cpu") + 1
    table = torch.zeros((len(kv_lens), max_pages), dtype=torch.int32)
    used = 0
    for i, n in enumerate(kv_lens):
        need = -(-int(n) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return table.to(dev)


def _sdpa_call(q, k, v, table, pos, kv_lens, group):
    """One ``scaled_dot_product_attention`` computing the prefill
    kernel's function on the same inputs: each row's K/V gathered from
    its pages into dense [B, heads, L, d] (an int8 cache dequantized),
    the causal and length mask as a boolean [B, 1, T, L]."""
    def dense(cache):
        data = getattr(cache, "data", cache)
        if hasattr(cache, "scale"):
            data = (data.float() * cache.scale[:, :, None, :]).to(q.dtype)
        g = data[:, table.long()]  # [kv, B, P, d, ps]
        kvh, b, p, d, ps = g.shape
        kmax = int(kv_lens.max())
        flat = g.permute(1, 0, 2, 4, 3).reshape(b, kvh, p * ps, d)
        return flat[:, :, :kmax].repeat_interleave(group, dim=1)
    kd, vd = dense(k), dense(v)
    tok = torch.arange(kd.shape[2], device=q.device)
    mask = ((tok[None, None, :] <= pos.long()[:, :, None])
            & (tok[None, None, :] < kv_lens.long()[:, None, None]))[:, None]
    qd = q.transpose(1, 2)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kernel_times")
    p.add_argument("--repo", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    p.add_argument("--geometry", default="bench-1b",
                   choices=sorted(GEOMETRIES))
    p.add_argument("--page-size", type=int, default=128,
                   help="tokens a page holds (default 128)")
    p.add_argument("--kernels", default="decode,prefill,ragged,int8_weight",
                   help="the kernels to time, comma-separated (default: "
                   "all four)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.repo))
    from production_stack_tpu_torch.ops.paged_attention_cuda import (
        paged_decode_attention)
    from production_stack_tpu_torch.ops.prefill_attention_cuda import (
        paged_prefill_attention)
    from production_stack_tpu_torch.ops.quant_kv import QuantKV, quantize_kv
    from production_stack_tpu_torch.ops.ragged_attention_cuda import (
        paged_ragged_attention)
    from production_stack_tpu_torch.ops import (prefill_attention_cuda,
                                                ragged_attention_cuda)
    plan = getattr(prefill_attention_cuda, "prefill_walk_plan", None)
    ragged_plan = getattr(ragged_attention_cuda, "ragged_walk_plan", None)

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    # Half a second of dense work first: the first timed case of a
    # process otherwise reads high (the card's clocks).
    x = torch.randn((4096, 4096), device=dev).to(torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        for _ in range(20):
            x @ x
        torch.cuda.synchronize()
    (nh, kv, d, dtype), ps = GEOMETRIES[args.geometry], args.page_size
    max_pages = -(-1024 // ps)
    # The decode rows' page budget: 65,536 tokens (512 pages at 128).
    decode_pages = max(512 * 128 // ps, 32 * max_pages + 1)

    def caches(num_pages, int8):
        k, v = (torch.randn((kv, num_pages, d, ps), generator=gen)
                .to(dev, dtype) for _ in range(2))
        if not int8:
            return k, v

        def quant(c):
            q8, scale = quantize_kv(c.permute(0, 1, 3, 2))
            return QuantKV(q8.permute(0, 1, 3, 2).contiguous(),
                           scale.contiguous())
        return quant(k), quant(v)

    out = {"repo": os.path.abspath(args.repo), "geometry": args.geometry,
           "page_size": ps}
    kernels = set(args.kernels.split(","))
    for int8 in (False, True):
        tag = "_int8" if int8 else ""
        lens = np.linspace(1, 1024, 32).round().astype(int).tolist()
        lens[7] = lens[21] = 0
        if "decode" in kernels:
            k, v = caches(decode_pages, int8)
            q = torch.randn((32, nh, d), generator=gen).to(dev, dtype)
            table = _table(lens, ps, max_pages, decode_pages, gen, dev)
            kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
            _time(out, "paged_decode" + tag, lambda: paged_decode_attention(
                q, k, v, table, kv_lens), flush)
        if ("decode" in kernels and not int8 and "num_splits" in
                inspect.signature(paged_decode_attention).parameters):
            for label, n in (("pad_rows", 0), ("one_token_rows", 1)):
                short = torch.full((32,), n, dtype=torch.int32, device=dev)
                for splits in (1, 3):
                    _time(out, f"paged_decode_{label}_splits{splits}",
                          lambda: paged_decode_attention(
                              q, k, v, table, short, num_splits=splits),
                          flush)

        live = [512, 448, 384, 320, 256, 0, 128, 64]
        chunks = (("", 0), ("_second", 512)) if "prefill" in kernels else ()
        for chunk, start in chunks:
            lens = [start + n if n else 0 for n in live]
            k, v = caches(8 * max_pages + 1, int8)
            q = torch.randn((8, 512, nh, d), generator=gen).to(dev, dtype)
            table = _table(lens, ps, max_pages, 8 * max_pages + 1, gen,
                           dev)
            kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
            pos = (torch.tensor([start if n else 0 for n in live],
                                dtype=torch.int32, device=dev)[:, None]
                   + torch.arange(512, dtype=torch.int32, device=dev)
                   ).contiguous()
            key = "paged_prefill" + chunk + tag
            _time(out, key, lambda: paged_prefill_attention(
                q, k, v, table, pos, kv_lens), flush)
            sdpa = _sdpa_call(q, k, v, table, pos, kv_lens, nh // kv)
            _time(out, "library_" + key, sdpa, flush)
            del sdpa
        if plan is not None:
            out["prefill_plan" + tag] = plan(
                dtype, torch.int8 if int8 else dtype, nh // kv, 512, d, ps)
            print(f"prefill walk {args.geometry}{tag}: "
                  f"{out['prefill_plan' + tag]['walk']}", flush=True)

        # Ragged blocks as (kv_len, last_index) per row.
        decode_lens = np.linspace(70, 1024, 28).round().astype(int).tolist()
        chunks = [(0, 512), (0, 448), (0, 300), (0, 64), (512, 188),
                  (512, 100), (512, 500), (0, 200)]
        verify = [(max(int(n), i % 5 + 1), i % 5) for i, n in enumerate(
            np.linspace(1, 1024, 32).round().astype(int))]
        verify[9] = verify[26] = (0, -1)
        blocks = {
            "unified": (512, [(n, 0) for n in decode_lens]
                        + [(s + n, n - 1) for s, n in chunks]
                        + [(0, -1)] * 4, False),
            "verify": (5, verify, True),
            "dead_tiles": (512, [(n, 0) for n in decode_lens]
                           + [(0, -1)] * 12, False),
        }
        if ragged_plan is not None and "ragged" in kernels:
            cache = torch.int8 if int8 else dtype
            for key, w in (("ragged_plan", 512), ("ragged_plan_verify", 5)):
                out[key + tag] = ragged_plan(dtype, cache, nh // kv, w, d, ps)
            print(f"ragged walk {args.geometry}{tag}: "
                  f"{out['ragged_plan' + tag]['walk']}", flush=True)
        for label, (w, rows, is_verify) in (
                blocks.items() if "ragged" in kernels else ()):
            pages = len(rows) * max_pages + 1
            k, v = caches(pages, int8)
            q = torch.randn((len(rows), w, nh, d), generator=gen).to(dev,
                                                                     dtype)
            table = _table([n for n, _ in rows], ps, max_pages, pages, gen,
                           dev)
            kv_lens = torch.tensor([n for n, _ in rows], dtype=torch.int32,
                                   device=dev)
            last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                                device=dev)
            drafts = torch.clamp(last, min=0) if is_verify else None
            _time(out, f"paged_ragged_{label}{tag}",
                  lambda: paged_ragged_attention(q, k, v, table, kv_lens,
                                                 last, drafts), flush)
            if label != "unified":
                continue
            k5, v5 = _stack_at(k, gen), _stack_at(v, gen)
            calls = {
                "per_layer": lambda: paged_ragged_attention(
                    q, k, v, table, kv_lens, last, drafts),
                "stacked": lambda: paged_ragged_attention(
                    q, k5, v5, table, kv_lens, last, drafts,
                    layer=STACK[1]),
            }
            for form in ("per_layer", "stacked", "stacked", "per_layer"):
                _time(out, f"paged_ragged_unified{tag}_{form}", calls[form],
                      flush, append=True)
            del k5, v5
    if "int8_weight" in kernels:
        _int8_weight_times(out, dev, gen, flush)
    print(json.dumps(out), flush=True)
    return 0


def _w8_bound_ms(m, k, n) -> float:
    """The least time of one product on an H100: the int8 weight and
    its f32 scales, x and the output moved once (3.35 TB/s), against
    2 m n k 16-bit tensor-core operations (989 TFLOP/s)."""
    moved = n * k + 4 * n + 2 * m * k + 2 * m * n
    return max(moved / 3.35e12, 2 * m * n * k / 989e12) * 1e3


def _device_kernels(fn, flush, calls=10) -> dict:
    """{device kernel: [launches a call, device us a call]} of ``calls``
    calls of ``fn``, each after the L2 flush, read from torch.profiler
    (the flush's fill kernel left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return {e.key: [e.count / calls, e.device_time_total / calls]
            for e in prof.key_averages()
            if e.count and e.device_time_total and "Fill" not in e.key}


def _int8_weight_times(out, dev, gen, flush) -> None:
    """The int8-weight GEMM at every shape of W8_CASES, each beside the
    16-bit ``torch.matmul`` on the dequantized weight, its bound, its
    device kernels and (where the checkout has ``int8_weight_plan``)
    its plan."""
    try:
        from production_stack_tpu_torch.ops import int8_matmul_cuda
    except ImportError:  # a checkout from before the kernel
        return
    plan = getattr(int8_matmul_cuda, "int8_weight_plan", None)
    for name, (k, n, dtype) in W8_CASES.items():
        q = torch.randint(-127, 128, (n, k), generator=gen,
                          dtype=torch.int8).to(dev)
        scale = torch.full((n,), 0.02 / 127, device=dev)
        dense = (q.float() * scale[:, None]).to(dtype)
        tname = "bf16" if dtype == torch.bfloat16 else "f16"
        for m in W8_ROWS:
            x = torch.randn((m, k), generator=gen).to(dev, dtype)
            case = f"{name}_m{m}"
            call = lambda: int8_matmul_cuda.int8_weight_matmul(x, q, scale)
            _time(out, "int8_weight_matmul_" + case, call, flush)
            _time(out, f"{tname}_matmul_{case}",
                  lambda: torch.matmul(x, dense.t()), flush)
            out["int8_weight_bound_" + case] = _w8_bound_ms(m, k, n)
            out["int8_weight_kernels_" + case] = _device_kernels(call, flush)
            if plan is not None:
                out["int8_weight_plan_" + case] = plan(m, n, k, dtype)
            print(f"int8_weight {case}: {out['int8_weight_matmul_' + case]:.5f}"
                  f" ms, {tname} matmul {out[f'{tname}_matmul_{case}']:.5f}, "
                  f"bound {out['int8_weight_bound_' + case]:.5f}; "
                  f"plan {out.get('int8_weight_plan_' + case)}", flush=True)
        del q, dense


if __name__ == "__main__":
    raise SystemExit(main())
