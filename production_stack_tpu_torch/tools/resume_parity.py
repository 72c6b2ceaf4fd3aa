"""Where a resumed greedy stream parts from the uninterrupted one.

    python -m production_stack_tpu_torch.tools.resume_parity [--kv-cache-dtype int8 --cache-layout stacked]

bench-1b with random weights at the serving configuration (page size
128, 512 pages, async and unified steps, step graphs) on one card, with
the port's cache server in a thread. Engine A generates 64 greedy
tokens from ``chip_smoke.py``'s fleet-phase prompt (680 random letters
from seed 9 under the chat rendering, 705 ids), checkpointing every 16
over the remote tier (host pool 0). From each of A's checkpoints a
fresh engine resumes twice: restoring the shipped pages from the tier,
and recomputing the whole journal (no tier). For each it prints the
first output token at which the resumed stream parts from A's, or that
it does not, and then whether the restore's and the recompute's
streams are byte-identical. Then A's request on a fresh engine, and on
one with async and unified off, to show that the engine repeats itself
when a stream's steps do not change.

A resumed stream computes the journal's tail (past the last full page)
in one prefill chunk where A computed it in its own chunks and decode
steps, so with bf16 arithmetic the two may part at a near tie; a
restore and a recompute giving the same stream puts that on the tail's
arithmetic, not on the tier's pages. Prints the card's name and power
limit first. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import threading

import numpy as np
import torch

from production_stack_tpu_torch.engine.cache_server import (
    build_cache_server,
)
from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    OffloadConfig,
    SchedulerConfig,
    bench_1b_model_config,
)
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.sequence import (
    SamplingParams,
    SequenceState,
)
from production_stack_tpu_torch.engine.tokenizer import (
    BenchTokenizer,
    render_chat_prompt,
)

OUT, INTERVAL = 64, 16


def _engine(args, remote=None, checkpoint=0, pipelined=True) -> LLMEngine:
    cfg = EngineConfig(
        model=bench_1b_model_config(),
        cache=CacheConfig(page_size=128, num_pages=512,
                          kv_cache_dtype=args.kv_cache_dtype,
                          cache_layout=args.cache_layout),
        scheduler=SchedulerConfig(
            max_num_seqs=32, max_model_len=1024, prefill_chunk_size=512,
            prefill_batch_size=8, async_scheduling=pipelined,
            unified_step=pipelined),
        offload=OffloadConfig(enable=remote is not None, remote_url=remote,
                              host_pool_bytes=0),
        checkpoint_interval_tokens=checkpoint)
    return LLMEngine(cfg, tokenizer=BenchTokenizer(cfg.model.vocab_size))


def _run(engine: LLMEngine, sid: str):
    """Step ``sid`` to its end: (output ids, checkpoint descriptors)."""
    seq, frames = engine.sequences[sid], []
    while seq.state != SequenceState.FINISHED:
        engine.step()
        ckpt = engine.take_checkpoint(sid)
        if ckpt is not None:
            frames.append(ckpt)
    while engine.has_work():
        engine.step()
    return list(seq.output_token_ids), frames


def _parting(got, ref):
    return next((i for i, (x, y) in enumerate(zip(got, ref)) if x != y),
                None)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--kv-cache-dtype", default="auto")
    p.add_argument("--cache-layout", default="auto")
    args = p.parse_args(argv)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    server = build_cache_server(8 << 30)
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def sp():
        return SamplingParams(temperature=0.0, max_tokens=OUT,
                              ignore_eos=True)

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz ,."))
    content = "".join(np.random.RandomState(9).choice(letters, size=680))
    prompt = render_chat_prompt(
        BenchTokenizer(bench_1b_model_config().vocab_size),
        [{"role": "user", "content": content}])
    a = _engine(args, server.url, INTERVAL)
    ref, frames = _run(a, a.add_request(list(prompt), sp()))
    del a
    form = (f"{args.kv_cache_dtype} KV, {args.cache_layout} layout, "
            f"prompt of {len(prompt)}")
    for desc in frames:
        n = desc["output_tokens"]
        streams = []
        for how, remote in (("restore", server.url), ("recompute", None)):
            b = _engine(args, remote)
            out, _ = _run(b, b.add_resume(desc["tokens"], n, sp()))
            got = desc["tokens"][len(prompt):] + out
            streams.append(got)
            restored = b.offload.restored_pages if b.offload else 0
            print(f"{form}: checkpoint at output {n} ({len(desc['tokens'])} "
                  f"tokens), {how} ({restored} pages restored): parts at "
                  f"output token {_parting(got, ref)}", flush=True)
            del b
            torch.cuda.empty_cache()
        print(f"{form}: checkpoint at output {n}: restore and recompute "
              f"byte-identical {streams[0] == streams[1]} (first difference "
              f"at output token {_parting(*streams)})", flush=True)
    for label, pipelined in (("fresh engine", True),
                             ("async and unified off", False)):
        e = _engine(args, pipelined=pipelined)
        out, _ = _run(e, e.add_request(list(prompt), sp()))
        print(f"{form}: A's request again, {label}: parts at output token "
              f"{_parting(out, ref)}", flush=True)
        del e
        torch.cuda.empty_cache()
    server.shutdown()


if __name__ == "__main__":
    main()
