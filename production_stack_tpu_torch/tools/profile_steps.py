"""Where an engine step's time goes on the card.

    python -m production_stack_tpu_torch.tools.profile_steps \
        [--kv-cache-dtype auto|bf16|int8] \
        [--cache-layout auto|stacked|per_layer] [--decode-steps K] \
        [--eager] [--sampling-options]

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
call's warmer end. ``--sampling-options`` gives every request all three
penalties, a ``logit_bias`` of 16 ids and top-20 logprobs (the per-row
option chain; such rows keep the steps out of the async pipeline and
the unified step, as the scheduler rules), and also prints the host's
time and bytes building the options' inputs per build
(``ModelRunner._options_payload``) and the sampling step's device time
at the decode shape with and without the chain (``chain_times``).

Each profile runs the workload twice in one engine: 32 prompts of 512
tokens (64 · K tokens each to generate), unprofiled, so that every
step's graph is captured (and the eager path's first-use costs are
paid); then 32 other prompts of the same lengths, whose steps have the
same shapes and replay those graphs, under ``torch.profiler``:

- each of the first 4 steps on its own (the prefill step and the
  unified mixed steps that admit the rest of the prompts), labelled
  with the step's decode, prefill and pad rows;
- 16 steady decode steps together, once every prompt is admitted.

Then the same 16 decode steps unprofiled, for the wall per token-step.

For each window it prints the host wall time per step, the device's
busy time per step (the sum of the kernels' device time), the idle
share of the wall time, the kernels the device ran per step, the host
calls that launch work or copy per step (``cudaLaunchKernel``,
``cudaGraphLaunch``, ``cudaMemcpyAsync``, ...: what the host pays per
step), the attention kernels' device time and share of the busy time,
and the kernels that take the most device time; for the decode window
also the tokens each row gained per step (a row whose options break
the async pipeline gains one every other step) and the wall and device
time per token-step. After the first pass it prints the captures and capture
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


# --sampling-options: every row's options.
SAMPLING_OPTIONS = dict(presence_penalty=0.5, frequency_penalty=0.5,
                        repetition_penalty=1.1, logprobs=True,
                        top_logprobs=20)
BIASED_IDS = 16


def _add_prompts(engine, rng, vocab, max_tokens, options):
    seqs = []
    for _ in range(PROMPTS):
        extra = {}
        if options:
            extra = dict(SAMPLING_OPTIONS, logit_bias={
                int(t): 2.0 for t in rng.randint(258, vocab, BIASED_IDS)})
        sid = engine.add_request(
            rng.randint(258, vocab, size=PROMPT_LEN).tolist(),
            SamplingParams(temperature=0.0, max_tokens=max_tokens,
                           ignore_eos=True, **extra))
        seqs.append(engine.sequences[sid])
    return seqs


class PayloadClock:
    """Host time and bytes of the runner's option inputs: wraps
    ``ModelRunner._options_payload`` of one engine."""

    def __init__(self, runner):
        self.seconds = 0.0
        self.bytes = 0
        self.calls = 0
        build = runner._options_payload

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            payload, options = build(*args, **kwargs)
            self.seconds += time.perf_counter() - t0
            self.bytes += sum(a.nbytes for a in payload.values())
            self.calls += 1
            return payload, options

        runner._options_payload = timed

    def take(self):
        out = (self.seconds, self.bytes, self.calls)
        self.seconds, self.bytes, self.calls = 0.0, 0, 0
        return out


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
    clock = PayloadClock(engine.runner)
    options = args.sampling_options
    print(f"[{path}] KV cache {cfg.cache.resolved_kv_dtype()} "
          f"{cfg.cache.cache_layout}, {cfg.cache.num_pages} pages of "
          f"{cfg.cache.page_size} tokens; decode steps "
          f"{cfg.scheduler.decode_steps}, async "
          f"{cfg.scheduler.async_scheduling}; sampling options "
          f"{'on' if options else 'off'}", flush=True)
    rng = np.random.RandomState(1)
    vocab = cfg.model.vocab_size
    max_tokens = 64 * max(1, args.decode_steps)
    # The first pass: every step shape once (captures, first uses).
    t0 = time.perf_counter()
    _add_prompts(engine, rng, vocab, max_tokens, options)
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

    seqs = _add_prompts(engine, rng, vocab, max_tokens, options)
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

    # Into steady decode: every prompt admitted (rows with options keep
    # the steps bimodal, so admission takes more steps), then 3 more.
    while engine.scheduler.num_waiting:
        engine.step()
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    generated = sum(len(s.output_token_ids) for s in seqs)
    clock.take()
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
    clock.take()
    out["windows"].append(row)
    print(f"{label}: {per_row:.2f} tokens a row per step, wall "
          f"{wall * 1e3 / DECODE_STEPS / per_row:.3f} ms and device busy "
          f"{row['busy_ms'] / per_row:.3f} ms per token-step", flush=True)
    # The same window unprofiled: wall per token-step, and the host's
    # option inputs per build (one build a dispatched decode step).
    generated = sum(len(s.output_token_ids) for s in seqs)
    t0 = time.perf_counter()
    for _ in range(DECODE_STEPS):
        engine.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = (sum(len(s.output_token_ids) for s in seqs) - generated) / PROMPTS
    payload_s, payload_bytes, calls = clock.take()
    calls = max(calls, 1)
    row.update(unprofiled_ms_per_token_step=wall * 1e3 / tokens,
               options_payload_ms_per_build=payload_s * 1e3 / calls,
               options_payload_mb_per_build=payload_bytes / 1e6 / calls)
    print(f"{label} unprofiled: wall "
          f"{row['unprofiled_ms_per_token_step']:.3f} ms per token-step; "
          f"option inputs built on the host "
          f"{row['options_payload_ms_per_build']:.3f} ms and "
          f"{row['options_payload_mb_per_build']:.3f} MB a build ({calls} "
          f"builds)", flush=True)
    if graphs is not None and sum(graphs.captures.values()) != out["keys"]:
        raise AssertionError(f"[{path}] the profiled pass captured new "
                             f"graphs: {graphs.captures}")
    while engine.has_work():
        engine.step()
    del engine
    torch.cuda.empty_cache()
    return out


def chain_times(batch: int = PROMPTS, iters: int = 50) -> dict:
    """Device time of the sampling step at the decode shape ([batch,
    vocab] f32 logits), each variant captured in a CUDA graph as the
    engine runs it and timed over ``iters`` replays with CUDA events:
    the plain greedy sample, and the whole chain (penalties, bias,
    ``min_tokens`` suppression, the guided mask) with the greedy sample
    and top-20 logprobs."""
    from production_stack_tpu_torch.engine.guided import build_json_fsm
    from production_stack_tpu_torch.engine.model_runner import (
        STOP_SET_WIDTH, TOP_LOGPROBS_WIDTH)
    from production_stack_tpu_torch.engine.tokenizer import BenchTokenizer
    from production_stack_tpu_torch.ops.sampling import (
        apply_sampling_options, sample_tokens, token_logprobs)

    vocab = bench_1b_model_config().vocab_size
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fsm = build_json_fsm(BenchTokenizer(vocab))
    mask = torch.from_numpy(fsm.mask).to(dev)
    logits = torch.randn((batch, vocab), device=dev, generator=gen) * 3
    inputs = {
        "pen_counts": torch.randint(0, 3, (batch, vocab), device=dev,
                                    generator=gen, dtype=torch.int32),
        "pen_prompt_mask": torch.rand((batch, vocab), device=dev,
                                      generator=gen) < 0.02,
        "pen_presence": torch.full((batch,), 0.5, device=dev),
        "pen_frequency": torch.full((batch,), 0.5, device=dev),
        "pen_repetition": torch.full((batch,), 1.1, device=dev),
        "logit_bias": torch.zeros((batch, vocab), device=dev),
        "sup_ids": torch.full((batch, STOP_SET_WIDTH), 257, device=dev,
                              dtype=torch.int32),
        "sup_rem": torch.ones((batch,), device=dev, dtype=torch.int32),
        "fsm_state": torch.arange(batch, device=dev, dtype=torch.int32)}
    knobs = (torch.zeros(batch, device=dev), torch.ones(batch, device=dev),
             torch.zeros(batch, device=dev, dtype=torch.int32))

    def plain():
        return sample_tokens(logits, *knobs, mode="greedy")

    def chain():
        sampled = sample_tokens(apply_sampling_options(
            logits, inputs, guided_mask=mask), *knobs, mode="greedy")
        return (sampled,) + token_logprobs(logits, sampled,
                                           TOP_LOGPROBS_WIDTH)

    out = {}
    for name, fn in (("plain_ms", plain), ("chain_ms", chain)):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        for _ in range(5):
            graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        out[name] = start.elapsed_time(end) / iters
    print(f"sampling step at [{batch}, {vocab}], one graph replay: plain "
          f"greedy {out['plain_ms']:.4f} ms, the option chain with top-20 "
          f"logprobs {out['chain_ms']:.4f} ms", flush=True)
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
    p.add_argument("--sampling-options", action="store_true",
                   help="every request penalized, biased and asking for "
                        "top-20 logprobs")
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
    if args.sampling_options:
        print(json.dumps(chain_times()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
