"""Device time of the three attention kernels at their headline shapes.

    python production_stack_tpu_torch/tools/kernel_times.py [--repo DIR]

Times ``paged_decode_attention`` (B = 32, kv lens spread over 1..1024
with two pad rows, page size 128), ``paged_prefill_attention`` (B = 8,
T = 512, first chunk, live lengths 64..512 with one pad row, page size
128) and ``paged_ragged_attention`` (the widest unified mixed step of
the serving configuration, R = 40 rows at W = 512: 28 decode rows, 8
chunk rows of first and second chunks, 4 pad rows; the speculative
verify block, B = 32 at W = 5, draft lens 0..4, two pad rows; and the
unified block's 28 decode rows and 12 pad rows alone, whose tiles past
a row's live slots only write zeros; page size 128) at the bench-1b
geometry (32 q / 8 kv heads, head_dim 64, bf16), over a bf16 and an
int8 cache, through the public wrappers of the checkout at ``--repo``
(default: the checkout this file lies in). Where
the decode wrapper takes ``num_splits`` it also times the launch's fixed
cost: a batch of pad rows (every block returns at once) and a batch of
one-token rows, each at one split and at three (the second adds the
merge kernel's launch). The wrappers' signatures are stable, so the same
script times two commits in one call on the card: unpack the other
commit somewhere and pass its root.

Each timed launch is queued behind a device-side wait with the L2
flushed, so the CUDA events bracket the kernels alone (the wrapper's
Python runs ahead of the card). Prints the card's name and power limit,
then one JSON object of milliseconds per launch. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

L2_FLUSH_BYTES = 128 << 20
HEAD_START_CYCLES = 4_000_000  # about 2 ms: host stalls shorter are hidden


def _ms(fn, flush, iters=50, warmup=5) -> float:
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
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def _table(kv_lens, ps, max_pages, num_pages, gen, dev):
    perm = torch.randperm(num_pages - 1, generator=gen).to("cpu") + 1
    table = torch.zeros((len(kv_lens), max_pages), dtype=torch.int32)
    used = 0
    for i, n in enumerate(kv_lens):
        need = -(-int(n) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return table.to(dev)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="kernel_times")
    p.add_argument("--repo", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
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
    nh, kv, d, ps, max_pages, bf16 = 32, 8, 64, 128, 8, torch.bfloat16

    def caches(num_pages, int8):
        k, v = (torch.randn((kv, num_pages, d, ps), generator=gen)
                .to(dev, bf16) for _ in range(2))
        if not int8:
            return k, v

        def quant(c):
            q8, scale = quantize_kv(c.permute(0, 1, 3, 2))
            return QuantKV(q8.permute(0, 1, 3, 2).contiguous(),
                           scale.contiguous())
        return quant(k), quant(v)

    out = {"repo": os.path.abspath(args.repo)}
    for int8 in (False, True):
        tag = "_int8" if int8 else ""
        lens = np.linspace(1, 1024, 32).round().astype(int).tolist()
        lens[7] = lens[21] = 0
        k, v = caches(512, int8)
        q = torch.randn((32, nh, d), generator=gen).to(dev, bf16)
        table = _table(lens, ps, max_pages, 512, gen, dev)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        out["paged_decode" + tag] = _ms(
            lambda: paged_decode_attention(q, k, v, table, kv_lens), flush)
        if not int8 and "num_splits" in inspect.signature(
                paged_decode_attention).parameters:
            for label, n in (("pad_rows", 0), ("one_token_rows", 1)):
                short = torch.full((32,), n, dtype=torch.int32, device=dev)
                for splits in (1, 3):
                    out[f"paged_decode_{label}_splits{splits}"] = _ms(
                        lambda: paged_decode_attention(
                            q, k, v, table, short, num_splits=splits),
                        flush)

        live = [512, 448, 384, 320, 256, 0, 128, 64]
        k, v = caches(8 * max_pages + 1, int8)
        q = torch.randn((8, 512, nh, d), generator=gen).to(dev, bf16)
        table = _table(live, ps, max_pages, 8 * max_pages + 1, gen, dev)
        kv_lens = torch.tensor(live, dtype=torch.int32, device=dev)
        pos = torch.arange(512, dtype=torch.int32, device=dev).repeat(8, 1)
        out["paged_prefill" + tag] = _ms(
            lambda: paged_prefill_attention(q, k, v, table, pos, kv_lens),
            flush)

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
        for label, (w, rows, is_verify) in blocks.items():
            pages = len(rows) * max_pages + 1
            k, v = caches(pages, int8)
            q = torch.randn((len(rows), w, nh, d), generator=gen).to(dev,
                                                                     bf16)
            table = _table([n for n, _ in rows], ps, max_pages, pages, gen,
                           dev)
            kv_lens = torch.tensor([n for n, _ in rows], dtype=torch.int32,
                                   device=dev)
            last = torch.tensor([li for _, li in rows], dtype=torch.int32,
                                device=dev)
            drafts = torch.clamp(last, min=0) if is_verify else None
            out[f"paged_ragged_{label}{tag}"] = _ms(
                lambda: paged_ragged_attention(q, k, v, table, kv_lens, last,
                                               drafts), flush)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
