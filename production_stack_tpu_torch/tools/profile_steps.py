"""Where an engine step's time goes on the card.

    python -m production_stack_tpu_torch.tools.profile_steps \
        [--kv-cache-dtype auto|bf16|int8] \
        [--cache-layout auto|stacked|per_layer] [--decode-steps K]

Builds an ``LLMEngine`` at the serving configuration of
``chip_smoke.py`` (bench-1b at full width, random weights, page_size
128, 512 pages, 32 sequences, chunk 512, prefill batch 8, unified steps
on, async on unless K > 1, as the server's ``auto`` resolves it;
``--kv-cache-dtype int8`` serves the int8 KV cache, its page budget
expanded as the server expands it; ``--cache-layout stacked`` one
stacked buffer per k/v; ``--decode-steps K`` decode bursts of K
tokens), admits 32 prompts of 512 tokens (64 · K tokens each to
generate) and runs ``torch.profiler`` over:

- each of the first 4 steps on its own (the prefill step and the
  unified mixed steps that admit the rest of the prompts), labelled
  with the step's decode, prefill and pad rows;
- 16 steady decode steps together.

For each window it prints the host wall time per step, the device's
busy time per step (the sum of the kernels' device time), the idle
share of the wall time, the attention kernels' device time and share of
the busy time, and the kernels that take the most device time;
for the decode window also the tokens each row gained per step and the
wall time per token-step. Wall times are taken under the profiler,
which adds host cost. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    SchedulerConfig,
    bench_1b_model_config,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import SamplingParams

PROMPTS, PROMPT_LEN = 32, 512
FILL_STEPS, DECODE_STEPS = 4, 16
TOP_KERNELS = 8


def _breakdown(prof, steps: int, wall_s: float, label: str) -> None:
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    wall_ms = wall_s * 1e3 / steps
    print(f"{label}: {steps} step(s), wall {wall_ms:.3f} ms/step, device "
          f"busy {busy_ms:.3f} ms/step (idle "
          f"{100 - 100 * busy_ms / wall_ms:.1f}% of wall), "
          f"{sum(e.count for e in kernels) / steps:.0f} kernels/step",
          flush=True)
    # The hand-written attention kernels (csrc/: paged_decode with its
    # merge, paged_prefill, paged_ragged) and their share of busy time.
    attn = [e for e in kernels if "pstt" in e.key and "paged_" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3 / steps
    print(f"{label}: attention kernels {attn_ms:.3f} ms/step "
          f"({100 * attn_ms / max(busy_ms, 1e-9):.1f}% of busy), "
          f"{sum(e.count for e in attn) / steps:.0f} launches/step",
          flush=True)
    by_time = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in by_time[:TOP_KERNELS]:
        ms = e.self_device_time_total / 1e3 / steps
        print(f"{label}:   {ms:8.3f} ms/step {e.count / steps:6.1f}x  "
              f"{e.key[:90]}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_steps")
    p.add_argument("--kv-cache-dtype", default="auto",
                   choices=["auto", "bf16", "int8"])
    p.add_argument("--cache-layout", default="auto",
                   choices=["auto", "stacked", "per_layer"])
    p.add_argument("--decode-steps", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_steps: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    cfg = EngineConfig(
        model=bench_1b_model_config(),
        cache=CacheConfig(page_size=128, num_pages=512,
                          cache_layout=args.cache_layout,
                          kv_cache_dtype=args.kv_cache_dtype),
        scheduler=SchedulerConfig(
            max_num_seqs=32, max_model_len=1024, prefill_chunk_size=512,
            prefill_batch_size=8, decode_steps=args.decode_steps,
            async_scheduling=args.decode_steps <= 1, unified_step=True))
    engine = LLMEngine(cfg, device="cuda")
    print(f"KV cache {cfg.cache.resolved_kv_dtype()} "
          f"{cfg.cache.cache_layout}, {cfg.cache.num_pages} pages of "
          f"{cfg.cache.page_size} tokens; decode steps "
          f"{cfg.scheduler.decode_steps}, async "
          f"{cfg.scheduler.async_scheduling}", flush=True)
    rng = np.random.RandomState(1)
    vocab = cfg.model.vocab_size
    seqs = []
    for _ in range(PROMPTS):
        sid = engine.add_request(
            rng.randint(258, vocab, size=PROMPT_LEN).tolist(),
            SamplingParams(temperature=0.0,
                           max_tokens=64 * max(1, args.decode_steps),
                           ignore_eos=True))
        seqs.append(engine.sequences[sid])
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    for i in range(FILL_STEPS):
        ragged_before = engine.stats()["engine_ragged_steps_total"]
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        s = engine.stats()
        # The row gauges describe the last unified step only.
        label = (f"step {i + 1} unified, {s['engine_step_decode_rows']:.0f}"
                 f" decode + {s['engine_step_prefill_rows']:.0f} prefill "
                 f"+ {s['engine_step_pad_rows']:.0f} pad rows"
                 if s["engine_ragged_steps_total"] > ragged_before
                 else f"step {i + 1} bimodal")
        _breakdown(prof, 1, wall, label)

    for _ in range(3):  # into steady decode
        engine.step()
    torch.cuda.synchronize()
    generated = sum(len(s.output_token_ids) for s in seqs)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # A pipelined step commits the previous step's tokens, so the count
    # is of tokens committed in the window, one step behind the work.
    per_row = ((sum(len(s.output_token_ids) for s in seqs) - generated)
               / PROMPTS / DECODE_STEPS)
    label = f"decode B={PROMPTS} K={cfg.scheduler.decode_steps}"
    _breakdown(prof, DECODE_STEPS, wall, label)
    print(f"{label}: {per_row:.2f} tokens a row per step, wall "
          f"{wall * 1e3 / DECODE_STEPS / per_row:.3f} ms per token-step",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
