"""Tensor, pipeline and context parallelism across cards: streams
against one rank, and tok/s.

    python -m production_stack_tpu_torch.tools.tp_serving [--sizes 1 2 4]
        [--pp 1 2] [--cp 1 2]

Builds each engine the way the server builds it (``--model bench-1b
--random-weights`` at ``chip_smoke.py``'s serving flags, plus
``--tensor-parallel-size T --pipeline-parallel-size P
--context-parallel-size C`` for every combination of ``--sizes`` (tp),
``--pp`` and ``--cp`` but pp with cp, which the engine refuses): ranks
1..N-1 spawned on cards 1..N-1 and joined over NCCL, every step a CUDA
graph with its collectives inside (pp's hops and sum, tp's reduces and
gathers; the cp whole-prompt prefill eager, counted). Under cp a prompt
of at least 512 tokens (5 of the 16) prefills in one ring dispatch.
Runs go in the order given and then in reverse (1 2 4 4 2 1), so a
warm-up drift does not favour one. Each engine serves
``chip_smoke.py``'s 16 prompts (64..700 random tokens, greedy,
32 out) twice: an untimed round that captures the graphs, then a timed
round. Prints, one JSON line a run, the size, tok/s of the timed round
(host clock around the round, which ends in a read of every token) and
its greedy streams against the first tp-1 engine's: equal, or equal up
to a first flip at a near tie of that engine (its top-1 margin under
``NEAR_TIE_LOGITS``, as ``chip_smoke.py`` holds resumed streams: the
row-parallel sums, a stage's microbatch GEMMs and the ring run in
another order in bf16). A flip at a wider margin fails the run. The
card's name and power limit come first.

``--device cpu`` (with ``--model DIR --tokenizer bench``, a checkpoint
whose heads and layers divide by the sizes) rehearses the same ranks
over gloo on the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import time
from typing import List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.server import (
    build_engine_from_args,
    parse_args,
)

# chip_smoke.py's serving flags, prefix caching off: the timed round
# prefills every prompt anew (and a cp engine's long prompts take their
# ring dispatch).
SERVER_ARGS = ["--model", "bench-1b", "--random-weights",
               "--page-size", "128", "--num-pages", "512",
               "--max-num-seqs", "32", "--max-model-len", "1024",
               "--prefill-chunk-size", "512", "--prefill-batch-size", "8",
               "--async-scheduling", "auto", "--unified-step", "auto",
               "--disable-prefix-caching",
               # Below the longest prompts (700): a cp engine's ring runs.
               "--long-prefill-threshold", "512"]
# The largest top-1 margin, in logits, at which two greedy streams of
# the same weights may part (chip_smoke.py's rule).
NEAR_TIE_LOGITS = 0.125
OUT = 32


def prompts(vocab: int) -> List[List[int]]:
    rng = np.random.RandomState(0)
    return [rng.randint(258, vocab, size=int(n)).tolist()
            for n in np.linspace(64, 700, 16).round()]


def streams(engine, batch) -> List[List[int]]:
    seqs = [engine.sequences[engine.add_request(
        list(p), SamplingParams(temperature=0.0, max_tokens=OUT,
                                ignore_eos=True))] for p in batch]
    while engine.has_work() or engine._in_flight is not None:
        engine.step()
    return [list(s.output_token_ids) for s in seqs]


def margin(engine, context, token) -> float:
    """The engine's top-1 logprob minus its logprob of ``token`` after
    ``context``; inf when ``token`` is not among its top 20."""
    sid = engine.add_request(list(context), SamplingParams(
        temperature=0.0, max_tokens=1, logprobs=True, top_logprobs=20,
        ignore_eos=True))
    entry = None
    while entry is None:
        for out in engine.step():
            if out.seq_id == sid and out.logprobs is not None:
                entry = out.logprobs
    while engine.has_work():
        engine.step()
    top = dict(entry[1])
    return (max(top.values()) - top[token]) if token in top else float("inf")


def flip(ref_engine, prompt, want, got) -> Optional[tuple]:
    """(first differing token, the reference's margin there) or None."""
    at = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b), None)
    if at is None and len(want) == len(got):
        return None
    at = min(len(want), len(got)) if at is None else at
    return at, margin(ref_engine, list(prompt) + want[:at], got[at])


def run(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sizes", type=int, nargs="+", default=[1, 2],
                   help="tensor-parallel sizes")
    p.add_argument("--pp", type=int, nargs="+", default=[1],
                   help="pipeline-parallel sizes")
    p.add_argument("--cp", type=int, nargs="+", default=[1],
                   help="context-parallel sizes")
    p.add_argument("--device", default=None)
    p.add_argument("--model", default=None)
    p.add_argument("--tokenizer", default=None)
    args = p.parse_args(argv)
    extra = []
    if args.device:
        extra += ["--device", args.device]
    if args.model:
        extra += ["--model", args.model]
    if args.tokenizer:
        extra += ["--tokenizer", args.tokenizer]
    card = "cpu"
    if args.device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card,
                      "cards": torch.cuda.device_count()}), flush=True)
    ref = batch = want = None
    failed = False
    runs = [r for r in itertools.product(args.sizes, args.pp, args.cp)
            if r[1] == 1 or r[2] == 1]
    for tp, pp, cp in runs + runs[::-1]:
        engine, _ = build_engine_from_args(parse_args(
            SERVER_ARGS + extra + [
                "--tensor-parallel-size", str(tp),
                "--pipeline-parallel-size", str(pp),
                "--context-parallel-size", str(cp)]))
        size = tp * pp * cp
        try:
            if batch is None:
                batch = prompts(engine.config.model.vocab_size)
            streams(engine, batch)  # warm: the graphs captured
            if engine.runner.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = streams(engine, batch)
            wall = time.perf_counter() - t0
        finally:
            if size != 1 or ref is not None:
                engine.close()
        if ref is None and size == 1:
            ref, want = engine, got
        flips = []
        if want is not None and ref is not engine:
            flips = [(i,) + f for i, (pr, w, g) in enumerate(
                zip(batch, want, got)) if (f := flip(ref, pr, w, g))]
        wide = [f for f in flips if not f[2] < NEAR_TIE_LOGITS]
        failed |= bool(wide)
        print(json.dumps({
            "tp": tp, "pp": pp, "cp": cp, "card": card,
            "tokens": OUT * len(batch),
            "seconds": wall, "tok_s": OUT * len(batch) / wall,
            "streams_equal_to_one_rank": len(batch) - len(flips),
            "flips": flips, "wide_flips": wide,
            "sp_prefills": engine.runner.sp_prefill_steps,
            "graphs": engine.runner.graphs is not None}), flush=True)
        if ref is not engine:
            del engine
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(run())
