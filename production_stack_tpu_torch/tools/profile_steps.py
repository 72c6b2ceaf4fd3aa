"""Where an engine step's time goes on the card.

    python -m production_stack_tpu_torch.tools.profile_steps \
        [--kv-cache-dtype auto|bf16|int8] \
        [--cache-layout auto|stacked|per_layer] [--decode-steps K] \
        [--eager]

Builds an ``LLMEngine`` at the serving configuration of
``chip_smoke.py`` (bench-1b at full width, random weights, page_size
128, 512 pages, 32 sequences, chunk 512, prefill batch 8, unified steps
on, async on unless K > 1, as the server's ``auto`` resolves it;
``--kv-cache-dtype int8`` serves the int8 KV cache, its page budget
expanded as the server expands it; ``--cache-layout stacked`` one
stacked buffer per k/v; ``--decode-steps K`` decode bursts of K
tokens). The engine replays its steps as CUDA graphs, as it serves;
``--eager`` profiles the eager path (``cuda_graphs=False``) too, in the
order graphs, eager, eager, graphs, so that neither path owns the
call's warmer end.

Each profile runs the workload twice in one engine: 32 prompts of 512
tokens (64 · K tokens each to generate), unprofiled, so that every
step's graph is captured (and the eager path's first-use costs are
paid); then 32 other prompts of the same lengths, whose steps have the
same shapes and replay those graphs, under ``torch.profiler``:

- each of the first 4 steps on its own (the prefill step and the
  unified mixed steps that admit the rest of the prompts), labelled
  with the step's decode, prefill and pad rows;
- 16 steady decode steps together.

For each window it prints the host wall time per step, the device's
busy time per step (the sum of the kernels' device time), the idle
share of the wall time, the kernels the device ran per step, the host
calls that launch work or copy per step (``cudaLaunchKernel``,
``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...: what the host pays per
step), the attention kernels' device time and share of the busy time,
and the kernels that take the most device time; for the decode window
also the tokens each row gained per step and the wall time per
token-step. After the first pass it prints the captures and capture
seconds by kind and the graphs' memory pool. Wall times are taken under
the profiler, which adds host cost. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
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
ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def is_host_launch(name: str) -> bool:
    """Whether a profiled host call (a ``cuda*`` or ``cu*`` API) queues work
    on the card: a kernel or graph launch, a copy or a fill."""
    return (name.startswith(("cuda", "cu")) and "Launch" in name
            or name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy",
                                "cuMemset")))


def _breakdown(prof, steps: int, wall_s: float, label: str) -> dict:
    events = prof.key_averages()
    kernels = [e for e in events if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    wall_ms = wall_s * 1e3 / steps
    calls = {e.key: e.count for e in events if is_host_launch(e.key)}
    row = {"window": label, "steps": steps, "wall_ms": wall_ms,
           "busy_ms": busy_ms, "idle_pct": 100 - 100 * busy_ms / wall_ms,
           "kernels_per_step": sum(e.count for e in kernels) / steps,
           "host_launches_per_step": sum(calls.values()) / steps}
    by_name = ", ".join(f"{k} {v / steps:.1f}"
                        for k, v in sorted(calls.items()))
    print(f"{label}: {steps} step(s), wall {wall_ms:.3f} ms/step, device "
          f"busy {busy_ms:.3f} ms/step (idle {row['idle_pct']:.1f}% of "
          f"wall), {row['kernels_per_step']:.0f} kernels/step, "
          f"{row['host_launches_per_step']:.1f} host launches/step "
          f"({by_name})", flush=True)
    # The hand-written attention kernels (csrc/: paged_decode with its
    # merge, paged_prefill, paged_ragged) and their share of busy time.
    attn = [e for e in kernels if "pstt" in e.key and "paged_" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3 / steps
    row["attention_ms"] = attn_ms
    print(f"{label}: attention kernels {attn_ms:.3f} ms/step "
          f"({100 * attn_ms / max(busy_ms, 1e-9):.1f}% of busy), "
          f"{sum(e.count for e in attn) / steps:.0f} launches/step",
          flush=True)
    by_time = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in by_time[:TOP_KERNELS]:
        ms = e.self_device_time_total / 1e3 / steps
        print(f"{label}:   {ms:8.3f} ms/step {e.count / steps:6.1f}x  "
              f"{e.key[:90]}", flush=True)
    return row


def _add_prompts(engine, rng, vocab, max_tokens):
    seqs = []
    for _ in range(PROMPTS):
        sid = engine.add_request(
            rng.randint(258, vocab, size=PROMPT_LEN).tolist(),
            SamplingParams(temperature=0.0, max_tokens=max_tokens,
                           ignore_eos=True))
        seqs.append(engine.sequences[sid])
    return seqs


def profile_path(args, cuda_graphs: bool) -> dict:
    """One engine, one path: the unprofiled pass, then the profiled
    one. Returns the windows' rows and the graphs' ledger."""
    path = "graphs" if cuda_graphs else "eager"
    cfg = EngineConfig(
        model=bench_1b_model_config(),
        cache=CacheConfig(page_size=128, num_pages=512,
                          cache_layout=args.cache_layout,
                          kv_cache_dtype=args.kv_cache_dtype),
        scheduler=SchedulerConfig(
            max_num_seqs=32, max_model_len=1024, prefill_chunk_size=512,
            prefill_batch_size=8, decode_steps=args.decode_steps,
            async_scheduling=args.decode_steps <= 1, unified_step=True))
    engine = LLMEngine(cfg, device="cuda", cuda_graphs=cuda_graphs)
    print(f"[{path}] KV cache {cfg.cache.resolved_kv_dtype()} "
          f"{cfg.cache.cache_layout}, {cfg.cache.num_pages} pages of "
          f"{cfg.cache.page_size} tokens; decode steps "
          f"{cfg.scheduler.decode_steps}, async "
          f"{cfg.scheduler.async_scheduling}", flush=True)
    rng = np.random.RandomState(1)
    vocab = cfg.model.vocab_size
    max_tokens = 64 * max(1, args.decode_steps)
    # The first pass: every step shape once (captures, first uses).
    t0 = time.perf_counter()
    _add_prompts(engine, rng, vocab, max_tokens)
    while engine.has_work():
        engine.step()
    torch.cuda.synchronize()
    out = {"path": path, "first_pass_s": time.perf_counter() - t0,
           "windows": []}
    graphs = engine.runner.graphs
    if graphs is not None:
        out.update(captures=dict(graphs.captures),
                   capture_seconds=dict(graphs.capture_seconds),
                   keys=len(graphs.keys()), pool_bytes=graphs.pool_bytes(),
                   eager_steps=dict(graphs.eager_steps))
        seconds = {k: round(v, 3) for k, v in out["capture_seconds"].items()}
        print(f"[{path}] first pass {out['first_pass_s']:.2f} s; captures "
              f"{out['captures']}, capture seconds {seconds}, "
              f"{out['keys']} keys, graph pool "
              f"{out['pool_bytes'] / 2**20:.1f} MiB, eager steps "
              f"{out['eager_steps']}", flush=True)
    else:
        print(f"[{path}] first pass {out['first_pass_s']:.2f} s",
              flush=True)

    seqs = _add_prompts(engine, rng, vocab, max_tokens)
    for i in range(FILL_STEPS):
        ragged_before = engine.stats()["engine_ragged_steps_total"]
        torch.cuda.synchronize()
        with profile(activities=ACTIVITIES) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        s = engine.stats()
        # The row gauges describe the last unified step only.
        label = (f"[{path}] step {i + 1} unified, "
                 f"{s['engine_step_decode_rows']:.0f} decode + "
                 f"{s['engine_step_prefill_rows']:.0f} prefill + "
                 f"{s['engine_step_pad_rows']:.0f} pad rows"
                 if s["engine_ragged_steps_total"] > ragged_before
                 else f"[{path}] step {i + 1} bimodal")
        out["windows"].append(_breakdown(prof, 1, wall, label))

    for _ in range(3):  # into steady decode
        engine.step()
    torch.cuda.synchronize()
    generated = sum(len(s.output_token_ids) for s in seqs)
    with profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            engine.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # A pipelined step commits the previous step's tokens, so the count
    # is of tokens committed in the window, one step behind the work.
    per_row = ((sum(len(s.output_token_ids) for s in seqs) - generated)
               / PROMPTS / DECODE_STEPS)
    label = f"[{path}] decode B={PROMPTS} K={cfg.scheduler.decode_steps}"
    row = _breakdown(prof, DECODE_STEPS, wall, label)
    row["tokens_per_row_step"] = per_row
    out["windows"].append(row)
    print(f"{label}: {per_row:.2f} tokens a row per step, wall "
          f"{wall * 1e3 / DECODE_STEPS / per_row:.3f} ms per token-step",
          flush=True)
    if graphs is not None and sum(graphs.captures.values()) != out["keys"]:
        raise AssertionError(f"[{path}] the profiled pass captured new "
                             f"graphs: {graphs.captures}")
    while engine.has_work():
        engine.step()
    del engine
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="profile_steps")
    p.add_argument("--kv-cache-dtype", default="auto",
                   choices=["auto", "bf16", "int8"])
    p.add_argument("--cache-layout", default="auto",
                   choices=["auto", "stacked", "per_layer"])
    p.add_argument("--decode-steps", type=int, default=1)
    p.add_argument("--eager", action="store_true",
                   help="profile the eager path too: graphs, eager, "
                        "eager, graphs")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_steps: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    order = [True, False, False, True] if args.eager else [True]
    for cuda_graphs in order:
        print(json.dumps(profile_path(args, cuda_graphs)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
