"""OpenAI-compatible HTTP server for the engine, on the standard library.

    python -m production_stack_tpu_torch.engine.server \\
        --model bench-1b --random-weights --page-size 128 --num-pages 512
    python -m production_stack_tpu_torch.engine.server --model DIR \\
        [--random-weights] [--tokenizer T] [--chat-template J]

``--model`` is a local HF checkpoint directory (``config.json`` and
safetensors or ``pytorch_model*.bin`` weights of a llama, mistral,
qwen2, opt, gpt2 or mixtral model, engine/weights.py; its own tokenizer
unless ``--tokenizer`` names another, or ``bench``), or one of the
random-weights presets ``tiny-llama``, ``tiny-opt`` and ``bench-1b``.

Routes served, with the JSON shapes, status codes and SSE frames of the
JAX engine's server: GET ``/health`` (role, draining, build id, active
requests; 503 ``{"status": "watchdog"}`` while a step has run past
``--step-watchdog-s``), ``/v1/models``, ``/metrics`` (the ``vllm:*``
names the router scrapes, the observatory's included), ``/version``
and ``/kv/summary`` (the hot prefix chains of kvecon/summary.py, free
pages and the KV dtype), POST ``/v1/completions`` and
``/v1/chat/completions`` (with and without ``stream``), ``/v1/resume``
and ``/drain``; disaggregated serving, POST ``/v1/disagg/prefill`` and
``/v1/disagg/handoff``; and the debug routes, POST
``/debug/profiler/start`` and ``/debug/profiler/stop`` (a
``torch.profiler`` Chrome trace), GET ``/debug/trace/{request_id}`` and
``/debug/steps`` (the tracer's flight recorder), ``/debug/compiles``
and ``/debug/memory`` (the observatory's ledgers); the pooled routes,
POST ``/v1/embeddings``, ``/v1/score``, ``/score``, ``/v1/rerank`` and
``/rerank`` (engine/embeddings.py: ``--pooling`` last or mean, unit
vectors; score and rerank are their cosines); and the self-tuning
controllers' GET ``/autotune/status`` and POST ``/autotune/reset``.
That is all 24 routes the JAX server registers; ``UNPORTED_ROUTES`` is
empty, and a JAX route not ported yet would answer 501 naming its
feature. A path neither server has answers 404.

Self-tuning (``--autotune off|shadow|on``, autotune/): the engine loop
ticks the controllers between steps every ``--autotune-interval-s``;
they turn the unified step's prefill budget, per-row draft caps, the
KV summary's admission floor and pool watermarks, the checkpoint
interval and the shed threshold. ``shadow`` logs decisions without
applying them; ``/metrics`` carries the ``vllm:autotune_*`` lines.

Disaggregated serving (``--engine-role``): a prefill-role engine
answers ``/v1/disagg/prefill`` with a handoff descriptor (the prompt,
the first token, the shipped pages' tier keys and bytes) after shipping
the prompt's committed pages to the offload tier; a decode-role engine
takes the descriptor at ``/v1/disagg/handoff``, restores the pages
(or recomputes) and streams from the first token on. The descriptor is
the JAX server's, so either server takes the other's. Every role
serves both routes, as the JAX server does: the role gates the
router's choice of engine, not what an engine answers.

Tracing: by default the server installs a tracer (engine/tracing.py)
with a flight recorder of ``--trace-ring-size`` requests (256); with
``--request-span-log`` it also writes one JSON span line per finished
request. ``--trace-ring-size 0`` and no span log install none.

Fleet contract, as the JAX server keeps it:
- QoS headers: ``x-priority`` (interactive | batch | background; any
  other value is a 400; absent, ``--default-priority``) orders
  admission and picks preemption victims; ``x-qos-spec-off: 1`` keeps
  the request's rows from drafting. While the waiting queue holds
  ``--shed-threshold`` of ``--max-queue-len`` or more, a
  non-interactive request is shed with 429 and ``Retry-After``.
- ``POST /drain`` turns new generation requests away with 503 and
  ``Retry-After`` while admitted ones finish; ``{"migrate": true}``
  cuts each checkpointed stream right after its next checkpoint frame
  (a ``: migrating`` comment, then the connection closes without the
  stream's end) so the router resumes it elsewhere; ``{"exit": true}``
  stops the server once idle (``--drain-exit-timeout-s`` bounds the
  wait). The stop shuts the in-process server down; ``main`` then
  returns, ending the process.
- Stream checkpoints (``--checkpoint-interval-tokens``): a stream with
  one candidate, no logprobs and no echo carries ``: checkpoint {...}``
  comment frames, the resume descriptor the router keeps; ``POST
  /v1/resume`` continues such a stream (400 for a bad descriptor, 409
  for one of another KV dtype), replaying the journal through the same
  detokenizer and stop scanner and skipping ``delivered_text_chars``.
  Streams are sent with chunked transfer encoding, so a cut reads as
  one to the client.

Flags: all 75 of the JAX server's, with the same names, defaults and
meanings (``parse_args``). ``--distributed`` (with
``--coordinator-address``, ``--num-processes``, ``--process-id``) makes
this process one of a multi-host world: process 0 serves HTTP and
renders the bridge's slice liveness on ``/metrics``; every other
process replays its steps (``run_worker_from_args``) and never serves.
``--chat-template`` (inline Jinja source or a file) is rendered once at
start-up, so a broken template stops the server there. ``--device`` is the port's own (the
card unless ``cpu`` is asked for).

Weight-only int8 (``--quantization int8``): the projections are int8
with per-channel scales; decode-sized products run the int8-weight
kernel. Multi-LoRA (``--enable-lora``, ``--lora-modules NAME=PATH ...``
registered at start, ``--max-loras``, ``--max-lora-rank``): a request
whose ``model`` is a registered adapter runs with it and its response
echoes the adapter's name; any other ``model`` runs the base model, as
in the JAX server (the router filters by served name).
``/v1/models`` lists each adapter with its ``parent``, and
``/v1/disagg/prefill`` refuses adapter names only.
``--attention-impl``'s JAX values map onto the port's impls
(``resolve_attention_impl``); ``--dtype`` applies to the presets and,
on the card, only to a geometry the kernels are built for;
``--compilation-cache-dir`` moves the kernels' nvcc build.

The HTTP layer is ``http.server.ThreadingHTTPServer`` (one thread per
connection); the engine steps on one loop thread of its own and hands
each request's tokens to that request's queue.

Request options served, parsed and validated as the JAX server does
(``sampling_from_body``): ``temperature``, ``top_p``, ``top_k``,
``seed``, ``stop``, ``ignore_eos``, the three penalties, ``logit_bias``
(at most 300 ids of the vocabulary, values in [-100, 100]),
``min_tokens`` (at most ``max_tokens``), ``response_format``
``json_object`` (guided JSON), ``logprobs`` / ``top_logprobs`` (up to
20; the chat ``logprobs.content`` form and the legacy ``tokens`` /
``token_logprobs`` / ``top_logprobs`` form, streamed and not), ``n``
(1..16) and, on ``/v1/completions``, ``best_of`` (n..16: the n
candidates of highest mean token logprob), each choice one engine
request over the shared prompt. The 400s the JAX server also gives
remain: ``suffix``, ``echo`` with ``logprobs``, a streamed ``best_of``
> n and out-of-range values.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import queue
import signal
import tempfile
import threading
import time
import urllib.parse
import uuid
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

import torch

from production_stack_tpu_torch.autotune import (
    Autotuner,
    build_engine_controllers,
    observatory_drift_flags,
)
from production_stack_tpu_torch.engine.config import (
    AutotuneConfig,
    CacheConfig,
    EngineConfig,
    KVEconConfig,
    LoRAConfig,
    OffloadConfig,
    ParallelConfig,
    QoSConfig,
    SchedulerConfig,
    bench_1b_model_config,
    tiny_model_config,
)
from production_stack_tpu_torch.engine.embeddings import (
    Embedder,
    parse_embedding_input,
)
from production_stack_tpu_torch.engine.engine import LLMEngine, StepOutput
from production_stack_tpu_torch.engine.model_runner import (
    async_scheduling_eligible,
    check_engine_geometry,
    check_parallel,
    deferred_kv_eligible,
    resolve_device,
    unified_step_eligible,
)
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.step_graphs import EAGER_REASONS
from production_stack_tpu_torch.engine.tokenizer import (
    BenchTokenizer,
    get_tokenizer,
    render_chat_prompt,
)
from production_stack_tpu_torch.engine.weights import (
    load_model_config,
    load_weights,
)
from production_stack_tpu_torch.engine.tracing import EngineTracer
from production_stack_tpu_torch.kvecon.summary import (
    PrefixSummaryTracker,
    routable_text,
)
from production_stack_tpu_torch.ops import paged_kv_common
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.parallel import mesh
from production_stack_tpu_torch.parallel.distributed import (
    DistributedProcess,
    init_distributed,
    is_coordinator,
    run_distributed_worker,
    start_distributed,
    start_parallel,
)
from production_stack_tpu_torch.parallel.topology import (
    MeshPlan,
    discover_topology,
    parse_placement,
    process_slices,
    process_topology,
    slice_of_process,
)
from production_stack_tpu_torch.qos import (
    PRIORITY_HEADER,
    PRIORITY_NAMES,
    SPEC_OFF_HEADER,
    Priority,
    parse_priority,
    priority_name,
    shed_counter_dict,
    shed_retry_after_s,
)
from production_stack_tpu_torch.utils.log import init_logger
from production_stack_tpu_torch.version import __version__

logger = init_logger(__name__)


class EngineLoop:
    """Steps the engine on a background thread. Requests are admitted
    on that thread (between steps); the outputs of each HTTP request's
    engine requests (its choices) go, tagged with the choice's index,
    to one ``queue.Queue`` its handler thread reads."""

    def __init__(self, engine: LLMEngine):
        self.engine = engine
        self._submit_q: "queue.Queue" = queue.Queue()
        self._streams: dict = {}
        self._wakeup = threading.Event()
        self._stop = threading.Event()
        self.uptime_start = time.time()
        # Step watchdog: wall-clock start of the step on the clock, None
        # between steps. A step of the async pipeline stays on the clock
        # from its dispatch until the call that reads it back returns,
        # so a wedged graph replay shows here while /health (on a
        # handler thread) keeps answering.
        self._step_started: Optional[float] = None
        # Self-tuning: the EngineServer installs an Autotuner here; the
        # loop ticks it between steps, so controllers touch scheduler
        # and config state from the thread that reads it. None = no
        # tuning.
        self.autotuner = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="engine-loop")

    def current_step_s(self) -> float:
        """Seconds the step on the clock has run (0.0 when idle)."""
        started = self._step_started
        if started is None:
            return 0.0
        return time.time() - started

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wakeup.set()
        self._thread.join(timeout=30)

    def _admit(self, item: dict) -> None:
        seq_id = item["seq_id"]
        try:
            if item.get("kind") == "resume":
                self.engine.add_resume(
                    item["tokens"], item["prior"], item["sampling"],
                    seq_id=seq_id, request_id=item.get("request_id"))
            elif item.get("kind") == "handoff":
                self.engine.add_handoff(
                    item["prompt"], item["first_token"], item["sampling"],
                    seq_id=seq_id, request_id=item.get("request_id"))
            else:
                self.engine.add_request(
                    item["prompt"], item["sampling"], seq_id=seq_id,
                    lora_name=item.get("lora_name"),
                    handoff_prefill=item.get("handoff_prefill", False),
                    request_id=item.get("request_id"),
                    priority=item.get("priority"),
                    spec_off=item.get("spec_off", False))
        except Exception as e:
            # Queue full / invalid request: fail THIS request, never
            # the loop.
            logger.warning("Rejecting %s: %s", seq_id, e)
            self._emit(StepOutput(seq_id, None, True, "abort"))

    def _run(self) -> None:
        while not self._stop.is_set():
            block = not self.engine.has_work()
            try:
                item = self._submit_q.get(block=block,
                                          timeout=0.2 if block else None)
            except queue.Empty:
                item = None
            if item is not None:
                if item.get("kind") == "call":
                    self._call(item)
                else:
                    self._admit(item)
                continue  # admit as many as possible before stepping
            if self.autotuner is not None:
                try:
                    self.autotuner.maybe_tick()
                except Exception:
                    logger.exception("autotune tick failed")
            if not self.engine.has_work():
                continue
            if self._step_started is None:
                self._step_started = time.time()
            try:
                outputs = self.engine.step()
            except Exception:
                logger.exception("Engine step failed")
                self._wakeup.wait(0.05)
                self._wakeup.clear()
                continue
            finally:
                self._step_started = (time.time()
                                      if self.engine._in_flight is not None
                                      else None)
            if not outputs:
                self._wakeup.wait(0.002)
                self._wakeup.clear()
            for out in outputs:
                self._emit(out)

    @staticmethod
    def _call(item: dict) -> None:
        try:
            item["result"] = item["fn"]()
        except Exception as e:  # handed to the caller's thread
            item["error"] = e
        item["done"].set()

    def call(self, fn):
        """Run ``fn()`` on the loop thread between two steps and return
        its result (or raise its exception) here: state that belongs to
        the step thread (the profiler's, which records that thread's
        operations) is set from there. With the loop not running, here."""
        if not self._thread.is_alive():
            return fn()
        item = {"kind": "call", "fn": fn, "done": threading.Event()}
        self._submit_q.put(item)
        self._wakeup.set()
        item["done"].wait()
        if "error" in item:
            raise item["error"]
        return item["result"]

    def _emit(self, out: StepOutput) -> None:
        stream = self._streams.get(out.seq_id)
        if stream is not None:
            stream[0].put((stream[1], out))

    def submit(self, prompt: List[int], samplings: List[SamplingParams],
               priority: Optional[int] = None, spec_off: bool = False,
               request_id: Optional[str] = None,
               handoff_prefill: bool = False,
               lora_name: Optional[str] = None
               ) -> Tuple[List[str], "queue.Queue"]:
        """One engine request a sampling, over the shared prompt (with
        the adapter ``lora_name``, if any); returns their sequence ids
        and the queue of their (index, StepOutput) pairs."""
        stream: "queue.Queue" = queue.Queue()
        seq_ids = []
        for i, sampling in enumerate(samplings):
            seq_id = f"seq-{uuid.uuid4().hex[:16]}"
            self._streams[seq_id] = (stream, i)
            self._submit_q.put({
                "seq_id": seq_id, "prompt": prompt, "sampling": sampling,
                "priority": priority, "spec_off": spec_off,
                "request_id": request_id,
                "handoff_prefill": handoff_prefill,
                "lora_name": lora_name})
            seq_ids.append(seq_id)
        self._wakeup.set()
        return seq_ids, stream

    def _submit_one(self, item: dict) -> Tuple[str, "queue.Queue"]:
        seq_id = item["seq_id"] = f"seq-{uuid.uuid4().hex[:16]}"
        stream: "queue.Queue" = queue.Queue()
        self._streams[seq_id] = (stream, 0)
        self._submit_q.put(item)
        self._wakeup.set()
        return seq_id, stream

    def submit_resume(self, tokens: List[int], prior: int,
                      sampling: SamplingParams,
                      request_id: Optional[str] = None
                      ) -> Tuple[str, "queue.Queue"]:
        """Submit a stream's resume journal; its queue carries only the
        new tokens (the handler replays the journal)."""
        return self._submit_one({"kind": "resume", "tokens": tokens,
                                 "prior": prior, "sampling": sampling,
                                 "request_id": request_id})

    def submit_handoff(self, prompt: List[int], first_token: int,
                       sampling: SamplingParams,
                       request_id: Optional[str] = None
                       ) -> Tuple[str, "queue.Queue"]:
        """Submit a handoff descriptor's sequence; its queue carries
        the tokens from the second on (the handler has the first)."""
        return self._submit_one({"kind": "handoff", "prompt": prompt,
                                 "first_token": first_token,
                                 "sampling": sampling,
                                 "request_id": request_id})

    def finish_stream(self, seq_id: str) -> None:
        self._streams.pop(seq_id, None)

    def abort(self, seq_id: str) -> None:
        self.engine.abort_request(seq_id)
        self.finish_stream(seq_id)
        self._wakeup.set()


# ---- request parsing -------------------------------------------------------


class BadRequest(ValueError):
    """A request the server answers with a 400."""


def sampling_from_body(body: dict, max_model_len: int,
                       vocab_size: Optional[int] = None) -> SamplingParams:
    """A request's sampling parameters, parsed and validated as the JAX
    server's ``_sampling_from_body`` does; raises ValueError (a 400)."""
    max_tokens = body.get("max_tokens")
    if max_tokens is None:
        max_tokens = body.get("max_completion_tokens")
    if max_tokens is None:
        max_tokens = 256  # OpenAI default; 0 is invalid, not "unset"
    temperature = body.get("temperature")
    top_p = body.get("top_p")
    top_k = body.get("top_k")
    stop = body.get("stop")
    if stop is None:
        stop_strings = []
    elif isinstance(stop, str):
        stop_strings = [stop]
    else:
        stop_strings = [str(s) for s in stop][:4]  # OpenAI caps at 4
    presence = body.get("presence_penalty")
    frequency = body.get("frequency_penalty")
    repetition = body.get("repetition_penalty")  # vLLM extension
    # Chat: ``logprobs`` a bool and ``top_logprobs`` an int; legacy
    # completions: ``logprobs`` is the top-k int itself.
    lp_req = body.get("logprobs")
    lp_top = int(body.get("top_logprobs") or 0)
    if isinstance(lp_req, bool):
        if not lp_req and lp_top > 0:
            raise BadRequest("'top_logprobs' is only allowed when "
                             "'logprobs' is enabled")
        lp_flag = lp_req
    elif lp_req is None:
        lp_flag = lp_top > 0
    else:
        lp_flag, lp_top = True, int(lp_req)
    p = SamplingParams(
        max_tokens=min(int(max_tokens), max_model_len),
        temperature=1.0 if temperature is None else float(temperature),
        top_p=1.0 if top_p is None else float(top_p),
        top_k=0 if top_k is None else int(top_k),
        stop_strings=stop_strings,
        presence_penalty=0.0 if presence is None else float(presence),
        frequency_penalty=0.0 if frequency is None else float(frequency),
        repetition_penalty=1.0 if repetition is None else float(repetition),
        ignore_eos=bool(body.get("ignore_eos", False)),
        seed=None if body.get("seed") is None else int(body["seed"]),
        logprobs=lp_flag,
        top_logprobs=lp_top,
        logit_bias=_logit_bias_from_body(body, vocab_size),
        min_tokens=int(body.get("min_tokens") or 0),
        guided=_guided_from_body(body),
    )
    _validate_sampling(p)
    return p


def _logit_bias_from_body(body: dict,
                          vocab_size: Optional[int]) -> Optional[dict]:
    """OpenAI ``logit_bias``: {"<token id>": bias} with bias in [-100,
    100], at most 300 entries, ids inside the vocabulary when it is
    known."""
    raw = body.get("logit_bias")
    if not raw:
        return None
    if not isinstance(raw, dict):
        raise BadRequest("logit_bias must be an object mapping token ids "
                         "to bias values")
    if len(raw) > 300:
        raise BadRequest("logit_bias supports at most 300 entries")
    bias = {}
    for k, v in raw.items():
        try:
            tid, value = int(k), float(v)
        except (TypeError, ValueError):
            raise BadRequest(f"logit_bias entries must map integer token "
                             f"ids to numbers (got {k!r}: {v!r})")
        if not -100.0 <= value <= 100.0:
            raise BadRequest(f"logit_bias values must be in [-100, 100], "
                             f"got {value} for token {tid}")
        if vocab_size is not None and not 0 <= tid < vocab_size:
            raise BadRequest(f"logit_bias token id {tid} is outside the "
                             f"model vocabulary (size {vocab_size})")
        bias[tid] = value
    return bias


def _guided_from_body(body: dict) -> Optional[str]:
    """OpenAI ``response_format`` -> guided mode ("json" or None)."""
    rf = body.get("response_format")
    if rf is None:
        return None
    if not isinstance(rf, dict) or "type" not in rf:
        raise BadRequest("response_format must be an object with a "
                         "'type' field")
    if rf["type"] == "text":
        return None
    if rf["type"] == "json_object":
        return "json"
    raise BadRequest(f"unsupported response_format type {rf['type']!r} "
                     "(supported: 'text', 'json_object')")


def _validate_sampling(p: SamplingParams) -> None:
    """Out-of-range parameters are a 400, never device input (a
    repetition penalty of 0 would divide logits into NaN)."""
    if p.max_tokens < 1:
        raise BadRequest("max_tokens must be at least 1")
    if not 0.0 <= p.temperature <= 2.0:
        raise BadRequest(f"temperature must be in [0, 2], got "
                         f"{p.temperature}")
    if not 0.0 < p.top_p <= 1.0:
        raise BadRequest(f"top_p must be in (0, 1], got {p.top_p}")
    if p.top_k < 0:
        raise BadRequest(f"top_k must be a non-negative integer, got "
                         f"{p.top_k}")
    for name in ("presence_penalty", "frequency_penalty"):
        if not -2.0 <= getattr(p, name) <= 2.0:
            raise BadRequest(f"{name} must be in [-2, 2], got "
                             f"{getattr(p, name)}")
    if p.repetition_penalty <= 0.0:
        raise BadRequest(f"repetition_penalty must be a positive number, "
                         f"got {p.repetition_penalty}")
    if not 0 <= p.top_logprobs <= 20:
        raise BadRequest(f"top_logprobs must be in [0, 20], got "
                         f"{p.top_logprobs}")
    if not 0 <= p.min_tokens <= p.max_tokens:
        raise BadRequest(f"min_tokens must be in [0, max_tokens], got "
                         f"{p.min_tokens} with max_tokens {p.max_tokens}")


def _count(body: dict, name: str, default: int) -> int:
    """An integer option (``n``, ``best_of``); -1 when it is not one."""
    value = body.get(name)
    try:
        return default if value is None else int(value)
    except (TypeError, ValueError):
        return -1


class StopStringScanner:
    """Incremental OpenAI ``stop``-sequence detection on decoded text:
    holds back the last ``max(len(stop)) - 1`` characters; on a hit it
    emits only the text before the stop and sets ``stopped``."""

    def __init__(self, stops):
        self.stops = [s for s in stops if s]
        self.hold = max((len(s) for s in self.stops), default=1) - 1
        self.buf = ""
        self.stopped = False

    def feed(self, delta: str) -> str:
        if self.stopped or not delta:
            return ""
        if not self.stops:
            return delta
        self.buf += delta
        hits = [j for j in (self.buf.find(s) for s in self.stops)
                if j != -1]
        if hits:
            self.stopped = True
            out, self.buf = self.buf[:min(hits)], ""
            return out
        cut = len(self.buf) - self.hold
        if cut > 0:
            out, self.buf = self.buf[:cut], self.buf[cut:]
            return out
        return ""

    def flush(self) -> str:
        if self.stopped:
            return ""
        out, self.buf = self.buf, ""
        return out


class Choice:
    """One choice's text and logprobs as its engine outputs arrive:
    incremental detokenizing (a run that ends inside a UTF-8 sequence
    is held back), the stop-string scan, and logprob entries released by
    character accounting, as the JAX server releases them: an entry
    joins ``lp_content`` only once its token's text has left the
    scanner's hold-back, so a stop hit drops the entries of every
    truncated token and the entries spell the returned text."""

    def __init__(self, tokenizer, sampling: SamplingParams, lp_json):
        self.tokenizer = tokenizer
        self.scanner = StopStringScanner(sampling.stop_strings)
        self.lp_json = lp_json
        self.tokens: List[int] = []
        self.base = 0  # tokens[:base] are decoded
        self.pieces: List[str] = []
        self.lp_content: List[dict] = []
        self._lp_queue: List[list] = []  # [entry, fed-chars watermark]
        self._fed = self._emitted = 0
        self.n_tokens = 0
        self.finish_reason = "stop"
        self.done = False
        self.stopped = False  # by a stop string: the engine must abort

    @property
    def text(self) -> str:
        return "".join(self.pieces)

    def _decode(self, token: Optional[int], flush: bool = False) -> str:
        if token is not None:
            self.tokens.append(token)
        tail = self.tokenizer.decode(self.tokens[self.base:])
        if not flush and tail.endswith("\ufffd"):
            return ""
        self.base = len(self.tokens)
        return tail

    def _settle(self) -> None:
        # A token the detokenizer held back has no characters of its
        # own: it takes the watermark of the feed its bytes surface in.
        for item in self._lp_queue:
            if item[1] is None:
                item[1] = self._fed

    def _emit(self, text: str, emits: list) -> None:
        self._emitted += len(text)
        ready = []
        while (self._lp_queue and self._lp_queue[0][1] is not None
               and self._lp_queue[0][1] <= self._emitted):
            ready.append(self._lp_queue.pop(0)[0])
        self.lp_content.extend(ready)
        if text:
            self.pieces.append(text)
        if text or ready:
            emits.append((text, ready))

    def feed(self, out: StepOutput) -> List[Tuple[str, list]]:
        """Take one engine output; returns the (text, logprob entries)
        deltas it releases, and sets ``done`` at the choice's end."""
        emits: List[Tuple[str, list]] = []
        if out.new_token is not None:
            self.n_tokens += 1
            text = self._decode(out.new_token)
            self._fed += len(text)
            if text:
                self._settle()
            if out.logprobs is not None:
                self._lp_queue.append([
                    self.lp_json(out.new_token, out.logprobs),
                    self._fed if text else None])
            self._emit(self.scanner.feed(text), emits)
            if self.scanner.stopped:
                # A text-level stop: the engine cannot see it.
                self.finish_reason, self.done, self.stopped = (
                    "stop", True, True)
                return emits
        if out.finished:
            self.finish_reason = out.finish_reason or "stop"
            tail = self._decode(None, flush=True)
            self._fed += len(tail)
            self._settle()
            self._emit(self.scanner.feed(tail), emits)
            self._emit(self.scanner.flush(), emits)
            if self.scanner.stopped:
                self.finish_reason = "stop"
            self.done = True
        return emits


def _usage(prompt_len: int, completion_len: int) -> dict:
    return {"prompt_tokens": prompt_len,
            "completion_tokens": completion_len,
            "total_tokens": prompt_len + completion_len}


def _legacy_logprobs(entries: list) -> Optional[dict]:
    """Chat-form logprob entries in the legacy completions form."""
    if not entries:
        return None
    return {"tokens": [e["token"] for e in entries],
            "token_logprobs": [e["logprob"] for e in entries],
            "top_logprobs": [{t["token"]: t["logprob"]
                              for t in e["top_logprobs"]}
                             for e in entries]}


def _mean_logprob(choice: "Choice") -> float:
    entries = choice.lp_content
    if not entries:
        return float("-inf")
    return sum(e["logprob"] for e in entries) / len(entries)


def _sampling_to_wire(p: SamplingParams) -> dict:
    """SamplingParams -> the JSON-safe dict of a resume descriptor."""
    d = dict(vars(p))
    if d.get("logit_bias"):
        # JSON object keys are strings; _sampling_from_wire restores
        # the int token ids.
        d["logit_bias"] = {str(k): v for k, v in d["logit_bias"].items()}
    return d


def _sampling_from_wire(d: dict) -> SamplingParams:
    """Inverse of ``_sampling_to_wire``; unknown keys are dropped, so a
    descriptor from a newer engine (or the JAX engine) still resumes."""
    d = dict(d)
    lb = d.get("logit_bias")
    if lb:
        d["logit_bias"] = {int(k): float(v) for k, v in lb.items()}
    allowed = {f.name for f in dataclasses.fields(SamplingParams)}
    return SamplingParams(**{k: v for k, v in d.items() if k in allowed})


def _error(status: int, message: str, kind: Optional[str] = None,
           headers: Optional[dict] = None) -> tuple:
    err = {"message": message}
    if kind is not None:
        err["type"] = kind
    return status, {"error": err}, headers or {}


# Yielded by a stream in place of a frame: end the stream here without
# its terminating chunk, so the client reads a cut, not an end.
STREAM_CUT = object()
MIGRATING_FRAME = b": migrating\n\n"


def _frame(payload: dict) -> bytes:
    return f"data: {json.dumps(payload)}\n\n".encode()


# ---- the server ------------------------------------------------------------


class EngineServer:
    """The request handlers, independent of the HTTP transport. A
    handler's answer is ``(status, body, headers)``: ``body`` a dict
    (JSON), a str (text) or an iterator of SSE byte frames."""

    def __init__(self, engine: LLMEngine, served_model_name: str,
                 build_id: str = "", drain_exit_timeout_s: float = 0.0,
                 profile_dir: Optional[str] = None, pooling: str = "last",
                 chat_template: Optional[str] = None):
        self.engine = engine
        self.loop = EngineLoop(engine)
        self.model_name = served_model_name
        self.tokenizer = engine.tokenizer
        # --chat-template's Jinja source, rendered for every chat
        # request in place of the model's own template (None: the
        # model's, or the role-tagged rendering).
        self.chat_template = chat_template
        # Rolling upgrades: --build-id labels the running revision in
        # /health and /version.
        self.build_id = build_id
        # Zero-loss drain: once POST /drain sets ``draining``, new
        # generation requests get 503 + Retry-After while admitted ones
        # finish; ``migrate_drain`` cuts checkpointed streams at their
        # next checkpoint frame.
        self.draining = False
        self.migrate_drain = False
        self.drain_exit_timeout_s = drain_exit_timeout_s
        self._drain_exit: Optional[threading.Thread] = None
        # Called once a drain with "exit" finds the server idle; the
        # HTTP server installs its shutdown here.
        self.on_drain_exit = None
        # Generation requests being answered (their streams included):
        # what /health reports and the drain exit waits for. The lock
        # also guards the shed counts (handler threads update both).
        self._active = 0
        self._active_lock = threading.Lock()
        # Per-class count of requests shed with 429
        # (vllm:qos_shed_total{class}).
        self.qos_shed_counts = shed_counter_dict()
        # Latched once per hung step, so the trip is logged once.
        self._watchdog_tripped = False
        # Hot prefix chains behind GET /kv/summary, observed from each
        # completion request's text (the router hashes the same text).
        kve = engine.config.kvecon
        self.kv_summary = PrefixSummaryTracker(
            top_k=kve.summary_top_k, admit_hits=kve.admit_hits,
            ttl_s=kve.ttl_s)
        # POST /debug/profiler/start|stop: the default trace directory
        # (--profile-dir; else a temporary directory made at the first
        # start), the running profiler and its span id.
        self.profile_dir = profile_dir
        self._profiler = None
        self._profiler_dir: Optional[str] = None
        self._profiler_span_id: Optional[str] = None
        self._profiler_lock = threading.Lock()
        # The pooled routes' embedder (--pooling), built at their first
        # request; one embed batch at a time.
        self.pooling = pooling
        self._embedder: Optional[Embedder] = None
        self._embed_lock = threading.Lock()
        # Self-tuning controllers, built whatever the mode (maybe_tick
        # is a no-op in 'off'), so /autotune/status always answers.
        at = engine.config.autotune
        try:
            controllers = build_engine_controllers(self, at)
            drift_flags = observatory_drift_flags(engine.runner)
        except AttributeError:
            # Stub engines lack the scheduler and metrics the catalog
            # reads; they get a live, empty autotuner.
            controllers, drift_flags = [], None
        self.autotuner = Autotuner(
            at, controllers, tracer=getattr(engine, "tracer", None),
            drift_flags=drift_flags)
        self.loop.autotuner = self.autotuner

    # ---- health, drain, version, KV summary --------------------------------

    def health(self) -> Tuple[int, dict]:
        state = {"role": self.engine.config.engine_role,
                 "draining": self.draining,
                 "active_requests": self._active,
                 "build_id": self.build_id}
        limit = self.engine.config.step_watchdog_s
        if limit > 0:
            stuck = self.loop.current_step_s()
            if stuck > limit:
                # A wedged step stalls every queued request; a 503
                # makes the router's prober rotate the replica out.
                if not self._watchdog_tripped:
                    self._watchdog_tripped = True
                    logger.error(
                        "Step watchdog tripped: step running for %.3fs "
                        "(limit %.3fs); /health now 503", stuck, limit)
                    tracer = self.engine.tracer
                    if tracer is not None:
                        # A span of its own, so that traceview shows the
                        # trip beside the requests it stalled.
                        sid = f"watchdog-{uuid.uuid4().hex[:12]}"
                        tracer.start(sid, prompt_tokens=0)
                        tracer.event(sid, "watchdog_trip",
                                     step_s=round(stuck, 3))
                        tracer.finish(sid, reason="watchdog")
                return 503, {"status": "watchdog",
                             "stuck_step_s": round(stuck, 3), **state}
            self._watchdog_tripped = False
        return 200, {"status": "ok", **state}

    def begin_generation(self) -> Optional[tuple]:
        """A generation request arrives: its 503 answer while draining,
        else None, counting it in flight until ``end_generation``."""
        if self.draining:
            return _error(503, "engine is draining; retry on another "
                          "replica", headers={"Retry-After": "1"})
        with self._active_lock:
            self._active += 1
        return None

    def end_generation(self) -> None:
        with self._active_lock:
            self._active -= 1

    def drain(self, body: dict) -> dict:
        """Turn new generation requests away; with ``migrate`` cut
        checkpointed streams at their next frame; with ``exit`` stop
        the server once idle."""
        already = self.draining
        self.draining = True
        if body.get("migrate"):
            self.migrate_drain = True
        if not already:
            logger.info("Drain requested: rejecting new admissions, "
                        "%d generation request(s) in flight",
                        self._active)
        if body.get("exit") and self._drain_exit is None:
            self._drain_exit = threading.Thread(
                target=self._exit_when_idle, daemon=True,
                name="drain-exit")
            self._drain_exit.start()
        stats = self.engine.stats()
        return {"status": "draining", "active_requests": self._active,
                "running": stats["num_requests_running"],
                "waiting": stats["num_requests_waiting"]}

    def _exit_when_idle(self) -> None:
        """Wait for every generation request in flight to end, then
        stop the server (``--drain-exit-timeout-s`` bounds the wait; 0
        waits for ever)."""
        deadline = (time.time() + self.drain_exit_timeout_s
                    if self.drain_exit_timeout_s > 0 else None)
        while self._active > 0 or self.engine.has_work():
            if deadline is not None and time.time() >= deadline:
                logger.warning(
                    "Drain exit timeout (%.1fs) with %d request(s) still "
                    "in flight; exiting anyway",
                    self.drain_exit_timeout_s, self._active)
                break
            time.sleep(0.05)
        logger.info("Drain complete; exiting")
        if self.on_drain_exit is not None:
            self.on_drain_exit()

    def version(self) -> dict:
        return {"version": __version__, "build_id": self.build_id,
                "role": self.engine.config.engine_role}

    def kv_summary_snapshot(self) -> dict:
        """The engine's KV state for the router's KV-aware routing, from
        host-side state only: hot prefix chains (text-domain blake2b,
        decayed hit counts), free-page headroom and the KV dtype."""
        cm = self.engine.cache_manager
        return {"hot_chains": [[h, v] for h, v in self.kv_summary.snapshot()],
                "free_pages": cm.num_free_pages,
                "total_pages": cm.config.num_pages - 1,
                "kv_dtype": self.engine.config.cache.resolved_kv_dtype(),
                "top_k": self.kv_summary.top_k}

    def models(self) -> dict:
        created = int(self.loop.uptime_start)
        data = [{"id": self.model_name, "object": "model",
                 "created": created, "owned_by": "production-stack-tpu"}]
        # LoRA adapters are addressable models, with their parent.
        for name in self.engine.lora_names():
            data.append({"id": name, "object": "model", "created": created,
                         "owned_by": "production-stack-tpu",
                         "parent": self.model_name})
        return {"object": "list", "data": data}

    def metrics(self) -> str:
        stats = self.engine.stats()
        lines = []
        for name in ("num_requests_running", "num_requests_waiting",
                     "gpu_cache_usage_perc", "gpu_prefix_cache_hit_rate"):
            lines += [f"# TYPE vllm:{name} gauge",
                      f"vllm:{name} {float(stats[name])}"]
        lines += ["# TYPE vllm:num_preemptions_total counter",
                  "vllm:num_preemptions_total "
                  f"{float(stats['num_preemptions_total'])}"]
        for name in ("engine_kv_cache_page_capacity",
                     "engine_kv_bytes_per_decode_step"):
            lines += [f"# TYPE vllm:{name} gauge",
                      f"vllm:{name} {float(stats[name])}"]
        kv_dtype = self.engine.config.cache.resolved_kv_dtype()
        cm = self.engine.cache_manager
        lines += [
            "# TYPE vllm:engine_kv_cache_dtype gauge",
            f'vllm:engine_kv_cache_dtype{{kv_dtype="{kv_dtype}"}} 1.0',
            "# TYPE vllm:kv_free_page_headroom gauge",
            f"vllm:kv_free_page_headroom {float(cm.num_free_pages)}",
            "# TYPE vllm:kv_total_pages gauge",
            f"vllm:kv_total_pages {float(cm.config.num_pages - 1)}",
            # Launches of each hand-written kernel since start: a card
            # whose counts stay 0 is serving through no kernel.
            "# TYPE vllm:engine_kernel_launches_total counter",
        ]
        for name, count in sorted(COUNTERS.launches.items()):
            lines.append("vllm:engine_kernel_launches_total"
                         f'{{kernel="{name}"}} {float(count)}')
        lines += self._observatory_metrics()
        lines += self._fleet_metrics(stats)
        lines += self._autotune_metrics()
        lines += self.engine.metrics.render()
        lines.append("")
        return "\n".join(lines)

    def _fleet_metrics(self, stats: dict) -> List[str]:
        """The fleet side's lines, under the JAX server's names: the
        disaggregation counters and the AWAITING_KV depth, the KV
        summary's breadth, the shared tier's counters (0 without a
        remote tier), the drain gauge, sheds by class and preemptions
        by outcome; then the engine's checkpoint, resume and
        offload-tier counters under their ``stats()`` names."""
        ostats = (self.engine.offload.stats()
                  if self.engine.offload is not None else {})
        lines = []
        for name in ("disagg_prefill_requests_total",
                     "disagg_decode_requests_total",
                     "disagg_kv_bytes_shipped_total"):
            lines += [f"# TYPE vllm:{name} counter",
                      f"vllm:{name} {float(stats[name])}"]
        lines += ["# TYPE vllm:disagg_awaiting_kv_requests gauge",
                  "vllm:disagg_awaiting_kv_requests "
                  f"{float(stats['disagg_awaiting_kv_requests'])}",
                  "# TYPE vllm:kv_summary_hot_chains gauge",
                  "vllm:kv_summary_hot_chains "
                  f"{float(self.kv_summary.hot_count())}"]
        for name in ("hits", "misses", "admissions", "rejections"):
            lines += [f"# TYPE vllm:kv_cluster_{name}_total counter",
                      f"vllm:kv_cluster_{name}_total "
                      f"{float(ostats.get('cluster_' + name, 0.0))}"]
        lines += ["# TYPE vllm:engine_draining gauge",
                  f"vllm:engine_draining {float(self.draining)}",
                  "# TYPE vllm:qos_shed_total counter"]
        lines += [f'vllm:qos_shed_total{{class="{cls}"}} {float(n)}'
                  for cls, n in sorted(self.qos_shed_counts.items())]
        lines.append("# TYPE vllm:preempt_offload_total counter")
        lines += [f'vllm:preempt_offload_total{{outcome="{o}"}} {float(n)}'
                  for o, n in sorted(self.engine.scheduler
                                     .preempt_offload_outcomes.items())]
        for name in ("checkpoint_ships_total", "checkpoint_kv_bytes_total",
                     "stream_resumes_total"):
            lines += [f"# TYPE vllm:{name} counter",
                      f"vllm:{name} {float(stats[name])}"]
        for name in ("host_pages", "host_bytes", "host_hit_rate",
                     "offloaded_pages", "restored_pages"):
            kind = "counter" if name.endswith("ed_pages") else "gauge"
            lines += [f"# TYPE vllm:kv_offload_{name} {kind}",
                      f"vllm:kv_offload_{name} "
                      f"{float(ostats.get(name, 0.0))}"]
        return lines

    def _autotune_metrics(self) -> List[str]:
        """The JAX server's self-tuning lines: controllers allowed to
        act, latched guardrail freezes, live knob values and cumulative
        decisions (applied and shadow)."""
        at = self.autotuner
        lines = ["# TYPE vllm:autotune_active_controllers gauge",
                 "vllm:autotune_active_controllers "
                 f"{float(at.active_count())}",
                 "# TYPE vllm:autotune_frozen gauge"]
        lines += [f'vllm:autotune_frozen{{controller="{name}"}} '
                  f"{float(frozen)}"
                  for name, frozen in sorted(at.frozen_flags().items())]
        lines.append("# TYPE vllm:autotune_knob_value gauge")
        lines += [f'vllm:autotune_knob_value{{controller="{name}"}} '
                  f"{float(value)}"
                  for name, value in sorted(at.knob_values().items())]
        lines.append("# TYPE vllm:autotune_decisions_total counter")
        lines += [f'vllm:autotune_decisions_total{{controller="{name}"}} '
                  f"{float(count)}"
                  for name, count in sorted(at.decisions_total.items())]
        return lines

    def _observatory_metrics(self) -> List[str]:
        """The JAX server's observatory block under its names, types and
        labels, read from the runner's observatory (nothing without
        one): the capture ledger (the step graphs' captures by kind and
        their seconds, warm-up included; every kind at 0 where nothing
        was captured, as on the CPU), graphs held, analytic device bytes
        by category, seconds waited on steps and their median by kind,
        MFU, and the attention path of each phase. Then the steps the
        card ran without a graph, by reason."""
        obs = self.engine.runner.observatory
        lines = []
        if obs is not None:
            for name, kind, values in (
                    ("engine_compile_events_total", "counter",
                     obs.compile_events_by_kind()),
                    ("engine_compile_seconds_total", "counter",
                     obs.compile_seconds_by_kind()),
                    ("engine_executable_cache_size", "gauge",
                     obs.executable_cache_sizes())):
                lines.append(f"# TYPE vllm:{name} {kind}")
                lines += [f'vllm:{name}{{kind="{k}"}} {float(v)}'
                          for k, v in sorted(values.items())]
            lines.append("# TYPE vllm:engine_hbm_bytes gauge")
            lines += [f'vllm:engine_hbm_bytes{{category="{c}"}} {float(n)}'
                      for c, n in sorted(obs.hbm_bytes().items())]
            lines.append(
                "# TYPE vllm:engine_step_device_seconds_total counter")
            lines += ["vllm:engine_step_device_seconds_total"
                      f'{{kind="{k}"}} {float(v)}' for k, v in
                      sorted(obs.device_seconds_by_kind().items())]
            lines.append("# TYPE vllm:engine_step_time_median_seconds gauge")
            lines += ["vllm:engine_step_time_median_seconds"
                      f'{{kind="{k}"}} {float(v)}' for k, v in
                      sorted(obs.step_time_medians().items())]
            lines += ["# TYPE vllm:engine_mfu gauge",
                      f"vllm:engine_mfu {float(obs.mfu())}",
                      "# TYPE vllm:engine_attention_impl gauge"]
            lines += ["vllm:engine_attention_impl"
                      f'{{phase="{phase}",impl="{impl}"}} 1.0'
                      for phase, impl in
                      sorted(obs.attention_impls().items())]
        graphs = self.engine.runner.graphs
        eager = (graphs.eager_steps if graphs
                 else dict.fromkeys(EAGER_REASONS, 0))
        lines.append("# TYPE vllm:engine_eager_steps_total counter")
        lines += [f'vllm:engine_eager_steps_total{{reason="{reason}"}} '
                  f"{float(n)}" for reason, n in sorted(eager.items())]
        # The mesh the engine runs on, as the JAX server reports it (the
        # port serves one replica: dp is 1).
        par = self.engine.config.parallel
        axis_sizes = {"dp": 1, "pp": par.pipeline_parallel_size,
                      "sp": par.context_parallel_size,
                      "tp": par.tensor_parallel_size}
        lines.append("# TYPE vllm:engine_mesh_shape gauge")
        lines += [f'vllm:engine_mesh_shape{{axis="{axis}"}} '
                  f"{float(axis_sizes[axis])}"
                  for axis in ("dp", "pp", "sp", "tp")]
        # The slice this process serves and each slice's liveness, as
        # the JAX server reports them: on one host slice 0, live; in a
        # multi-host world the bridge's ledger.
        slice_id, live = 0, {0: True}
        runtime = self.engine.tp_runtime
        if runtime is not None and runtime.process is not None:
            process, bridge = runtime.process, runtime.bridge
            slice_id = slice_of_process(process.process_id,
                                        process.num_processes,
                                        bridge.num_slices)
            live = bridge.check_liveness()
        lines += ["# TYPE vllm:engine_slice_id gauge",
                  f"vllm:engine_slice_id {float(slice_id)}",
                  "# TYPE vllm:engine_slice_live gauge"]
        lines += [f'vllm:engine_slice_live{{slice="{i}"}} {float(on)}'
                  for i, on in sorted(live.items())]
        return lines

    def parse_completion(self, body: dict, chat: bool):
        """-> (prompt ids, prompt text or None, sampling); raises
        BadRequest."""
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list):
                raise BadRequest("'messages' must be a list")
            prompt, prompt_text = render_chat_prompt(
                self.tokenizer, messages,
                chat_template=self.chat_template), None
        else:
            if body.get("suffix"):
                raise BadRequest("'suffix' (insertion) is not supported")
            prompt_in = body.get("prompt", "")
            if (isinstance(prompt_in, list) and prompt_in
                    and isinstance(prompt_in[0], int)):
                prompt, prompt_text = list(prompt_in), None
            else:
                prompt_text = ("".join(prompt_in)
                               if isinstance(prompt_in, list)
                               else str(prompt_in))
                prompt = self.tokenizer.encode(prompt_text)
        sched = self.engine.config.scheduler
        sampling = sampling_from_body(
            body, sched.max_model_len,
            vocab_size=self.engine.config.model.vocab_size)
        if len(prompt) > sched.max_model_len - 1:
            raise BadRequest(
                f"Prompt is {len(prompt)} tokens; maximum is "
                f"{sched.max_model_len - 1} (max_model_len "
                f"{sched.max_model_len})")
        return prompt, prompt_text, sampling

    def _lp_json(self, token_id: int, entry: tuple) -> dict:
        """One position in the chat ``logprobs.content`` form."""
        slp, tops = entry
        text = self.tokenizer.decode([token_id])
        return {"token": text, "logprob": slp,
                "bytes": list(text.encode("utf-8", "replace")),
                "top_logprobs": [{"token": self.tokenizer.decode([tid]),
                                  "logprob": tlp} for tid, tlp in tops]}

    def run_choices(self, seq_ids: List[str], stream: "queue.Queue",
                    choices: List[Choice]):
        """Yield ``(index, text, logprob entries)`` as each submitted
        choice releases them, then ``(index, None, None)`` when that
        choice is done. Closing the generator early (a client that went
        away, a migrate cut) aborts every choice still running."""
        left = len(seq_ids)
        try:
            while left:
                i, out = stream.get()
                choice = choices[i]
                if choice.done:
                    continue
                for text, entries in choice.feed(out):
                    yield i, text, entries
                if choice.done:
                    left -= 1
                    if choice.stopped:
                        self.loop.abort(seq_ids[i])
                    self.loop.finish_stream(seq_ids[i])
                    yield i, None, None
        finally:
            for seq_id, choice in zip(seq_ids, choices):
                if not choice.done:
                    self.loop.abort(seq_id)
                self.loop.finish_stream(seq_id)

    def qos_admit(self, headers) -> tuple:
        """The request's QoS class and the shed gate: ``(priority,
        spec_off, rejection or None)``. A bad ``x-priority`` is a 400.
        While the waiting queue holds ``shed_threshold`` of
        ``max_queue_len`` or more, a non-interactive request is turned
        away with 429 and a Retry-After of queue depth over running
        rows (one request per row-second, on purpose pessimistic);
        interactive requests always pass (the scheduler's queue-full
        refusal stays the hard stop)."""
        raw = headers.get(PRIORITY_HEADER)
        if raw is None:
            priority = Priority(self.engine.default_priority)
        else:
            try:
                priority = parse_priority(raw)
            except ValueError as e:
                return None, False, _error(400, str(e),
                                           "invalid_request_error")
        spec_off = headers.get(SPEC_OFF_HEADER) == "1"
        qos = self.engine.config.qos
        max_queue = self.engine.config.scheduler.max_queue_len
        depth = self.engine.scheduler.num_waiting
        if (priority != Priority.INTERACTIVE
                and depth >= qos.shed_threshold * max_queue):
            retry_after = shed_retry_after_s(
                depth, max(1.0, float(self.engine.scheduler.num_running)))
            with self._active_lock:
                self.qos_shed_counts[priority_name(priority)] += 1
            return priority, spec_off, _error(
                429, f"engine overloaded ({depth} requests waiting); "
                f"{priority_name(priority)} requests are being shed — "
                f"retry after {retry_after}s", "overloaded_error",
                {"Retry-After": str(retry_after)})
        return priority, spec_off, None

    def complete(self, body: dict, chat: bool, headers=None) -> tuple:
        """A completion request's answer: a dict for a whole answer, or
        an iterator of SSE frames for ``stream``."""
        headers = headers or {}
        if chat and not isinstance(body.get("messages"), list):
            return _error(400, "'messages' must be a list")
        if not chat and body.get("suffix"):
            return _error(400, "'suffix' (insertion) is not supported",
                          "invalid_request_error")
        self.kv_summary.observe_text(routable_text(body))
        priority, spec_off, rejection = self.qos_admit(headers)
        if rejection is not None:
            return rejection
        try:
            prompt, prompt_text, sampling = self.parse_completion(body,
                                                                  chat)
            n, best_of, stream = self._choice_counts(body, chat)
            echo = bool(body.get("echo")) and not chat
            if echo and sampling.logprobs:
                raise BadRequest("'echo' with 'logprobs' (prompt "
                                 "logprobs) is not supported")
        except (BadRequest, TypeError, ValueError) as e:
            return _error(400, str(e), "invalid_request_error")
        echo_text = ""
        if echo:
            echo_text = (prompt_text if prompt_text is not None
                         else self.tokenizer.decode(prompt))
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:16]
        created = int(time.time())
        requested_lp = sampling.logprobs
        if best_of > n and not sampling.logprobs:
            # Ranking needs each candidate's logprobs; the response
            # carries them only when the client asked.
            sampling = dataclasses.replace(sampling, logprobs=True)
        # A seeded request's choices draw at seed + i: a seeded draw
        # depends only on (seed, position), so one seed would make
        # every choice the same.
        samplings = [sampling if best_of == 1 or sampling.seed is None
                     else dataclasses.replace(sampling,
                                              seed=sampling.seed + i)
                     for i in range(best_of)]
        choices = [Choice(self.tokenizer, sp, self._lp_json)
                   for sp in samplings]
        request_id = headers.get("x-request-id")
        # A request addressed to a registered adapter runs with it and
        # echoes its name; any other name runs the base model (the
        # router already filtered by served model name).
        requested = body.get("model")
        lora_name = (requested if requested in self.engine.lora_names()
                     else None)
        response_model = lora_name or self.model_name
        seq_ids, queue_ = self.loop.submit(prompt, samplings, priority,
                                           spec_off, request_id,
                                           lora_name=lora_name)

        def envelope(obj: str, out: list, **extra) -> dict:
            return {"id": rid, "object": obj, "created": created,
                    "model": response_model, "choices": out, **extra}

        if stream:
            # Stream checkpoints ride single-candidate plain streams:
            # one descriptor cannot rebuild several choices, logprobs
            # or echo.
            relay = (self.engine.config.checkpoint_interval_tokens > 0
                     and best_of == 1 and not sampling.logprobs
                     and not echo)
            identity = {"version": 1, "request_id": request_id,
                        "response_id": rid, "created": created,
                        "chat": chat, "model": response_model}
            return 200, self._stream(
                envelope, chat, echo_text, prompt, samplings, choices,
                requested_lp, body.get("stream_options"), seq_ids,
                queue_, identity if relay else None), {}
        for _ in self.run_choices(seq_ids, queue_, choices):
            pass
        completion_tokens = sum(c.n_tokens for c in choices)
        if best_of > n:
            # The n of highest mean token logprob; ties keep the
            # earlier candidate.
            choices = sorted(choices, key=lambda c: -_mean_logprob(c))[:n]
        out = []
        for i, c in enumerate(choices):
            if chat:
                out.append({"index": i, "message": {"role": "assistant",
                                                    "content": c.text},
                            "finish_reason": c.finish_reason,
                            "logprobs": ({"content": c.lp_content}
                                         if requested_lp else None)})
            else:
                out.append({"index": i, "text": echo_text + c.text,
                            "finish_reason": c.finish_reason,
                            "logprobs": (_legacy_logprobs(c.lp_content)
                                         if requested_lp else None)})
        return 200, envelope("chat.completion" if chat
                             else "text_completion", out,
                             usage=_usage(len(prompt), completion_tokens)), {}

    @staticmethod
    def _choice_counts(body: dict, chat: bool) -> Tuple[int, int, bool]:
        """(n, best_of, stream), validated as the JAX server does."""
        n = _count(body, "n", 1)
        if not 1 <= n <= 16:
            raise BadRequest("'n' must be an integer in [1, 16]")
        stream = bool(body.get("stream", False))
        best_of = n
        if not chat and body.get("best_of") is not None:
            best_of = _count(body, "best_of", n)
            if not n <= best_of <= 16:
                raise BadRequest("'best_of' must be an integer in [n, 16]")
            if stream and best_of > n:
                raise BadRequest("'best_of' > n cannot be streamed")
        return n, best_of, stream

    def _checkpoint_frames(self, seq_id: str, identity: Optional[dict],
                           sampling: SamplingParams):
        """After a delta: the stream's new checkpoint frame, if one
        landed, and under a migrate drain the cut that follows it."""
        if identity is None:
            return
        ckpt = self.engine.take_checkpoint(seq_id)
        if ckpt is None:
            return
        desc = dict(identity, kv_dtype=self.engine.config.cache
                    .resolved_kv_dtype(),
                    sampling=_sampling_to_wire(sampling))
        desc.update(ckpt)
        yield f": checkpoint {json.dumps(desc)}\n\n".encode()
        if self.migrate_drain:
            # The frame just sent is the whole resume state: cut the
            # stream so the router resumes it on another replica (the
            # marker tells it the cut is a migration, not a crash).
            tracer = self.engine.tracer
            if tracer is not None:
                tracer.event(seq_id, "migrate_ship")
            yield MIGRATING_FRAME
            yield STREAM_CUT

    def _stream(self, envelope, chat, echo_text, prompt, samplings,
                choices, with_logprobs, stream_opts, seq_ids, queue_,
                identity):
        obj = "chat.completion.chunk" if chat else "text_completion"

        def chunk(index: int, delta: Optional[str], finish: Optional[str],
                  first: bool = False, entries=None) -> bytes:
            if chat:
                d: Dict[str, str] = {"role": "assistant"} if first else {}
                if delta:
                    d["content"] = delta
                choice = {"index": index, "delta": d,
                          "finish_reason": finish}
                if with_logprobs:
                    choice["logprobs"] = ({"content": entries}
                                          if entries else None)
            else:
                choice = {"index": index, "text": delta or "",
                          "finish_reason": finish}
                if with_logprobs:
                    choice["logprobs"] = _legacy_logprobs(entries)
            return _frame(envelope(obj, [choice]))

        for i in range(len(choices)):
            if chat:
                yield chunk(i, None, None, first=True)
            elif echo_text:
                yield chunk(i, echo_text, None)
        events = self.run_choices(seq_ids, queue_, choices)
        try:
            for i, text, entries in events:
                if text is None:
                    yield chunk(i, None, choices[i].finish_reason)
                    continue
                yield chunk(i, text, None, entries=entries)
                for frame in self._checkpoint_frames(seq_ids[0], identity,
                                                     samplings[0]):
                    yield frame
                    if frame is STREAM_CUT:
                        return
        finally:
            events.close()
        if isinstance(stream_opts, dict) and stream_opts.get(
                "include_usage"):
            yield _frame(envelope(obj, [], usage=_usage(
                len(prompt), sum(c.n_tokens for c in choices))))
        yield b"data: [DONE]\n\n"

    def resume(self, body: dict, headers=None) -> tuple:
        """POST /v1/resume: continue a stream whose engine died or was
        drained mid-generation. The body carries the checkpoint
        descriptor the engine attached to its SSE stream and
        ``delivered_text_chars``, the content text the router already
        forwarded. The journaled context parks in AWAITING_KV (the
        checkpointed pages restore from the offload tier, or a miss
        recomputes from the journal); the journal is replayed through
        the same detokenizer and stop scanner, the delivered characters
        are skipped, and the rest streams under the original response
        id: for greedy sampling the client's text is byte-identical to
        an uninterrupted run."""
        headers = headers or {}
        desc = body.get("descriptor")
        if not isinstance(desc, dict):
            return _error(400, "'descriptor' object is required")
        token_ids = desc.get("tokens")
        output_tokens = desc.get("output_tokens")
        if (not isinstance(token_ids, list) or not token_ids
                or not all(isinstance(t, int) for t in token_ids)
                or not isinstance(output_tokens, int)
                or not 0 < output_tokens < len(token_ids)):
            return _error(400, "descriptor missing tokens/output_tokens")
        vocab = self.engine.config.model.vocab_size
        if not all(0 <= t < vocab for t in token_ids):
            return _error(400, "descriptor tokens outside the model "
                          f"vocabulary (size {vocab})")
        my_dtype = self.engine.config.cache.resolved_kv_dtype()
        desc_dtype = desc.get("kv_dtype") or my_dtype
        if desc_dtype != my_dtype:
            # 409: this pod can never restore those pages (tier keys are
            # dtype-namespaced); the router picks another replica.
            return _error(409, "checkpoint KV not restorable here "
                          f"(descriptor kv_dtype {desc_dtype!r}, engine "
                          f"{my_dtype!r})")
        try:
            sampling = _sampling_from_wire(desc.get("sampling") or {})
        except Exception as e:
            return _error(400, f"bad descriptor sampling: {e}")
        if sampling.guided is not None:
            return _error(400, "guided streams cannot be resumed")
        try:
            delivered = int(body.get("delivered_text_chars") or 0)
        except (TypeError, ValueError):
            delivered = -1
        if delivered < 0:
            return _error(400, "delivered_text_chars must be a "
                          "non-negative integer")
        chat = bool(desc.get("chat", True))
        # The original stream's identity: the resumed chunks carry the
        # same id, created and model.
        rid = (desc.get("response_id")
               or ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:16])
        created = int(desc.get("created") or time.time())
        model = desc.get("model") or self.model_name
        prompt_len = len(token_ids) - output_tokens
        seq_id, queue_ = self.loop.submit_resume(
            token_ids, output_tokens, sampling,
            request_id=headers.get("x-request-id"))
        # Peek the first engine output, so a refused submission is a
        # retryable 503 and not a stream that aborts after its headers.
        _, first = queue_.get()
        if (first.finished and first.new_token is None
                and first.finish_reason == "abort"):
            self.loop.finish_stream(seq_id)
            return _error(503, "engine rejected the resume",
                          headers={"Retry-After": "1"})
        texts = self._resume_texts(seq_id, queue_, first, sampling,
                                   token_ids[prompt_len:], delivered)
        obj = "chat.completion" if chat else "text_completion"
        if not bool(body.get("stream", True)):
            pieces = list(texts)
            n_tokens, finish = pieces.pop()
            text = "".join(pieces)
            choice = ({"index": 0, "message": {"role": "assistant",
                                               "content": text},
                       "finish_reason": finish} if chat else
                      {"index": 0, "text": text, "finish_reason": finish})
            return 200, {"id": rid, "object": obj, "created": created,
                         "model": model, "choices": [choice],
                         "usage": _usage(prompt_len, n_tokens)}, {}
        # The resumed leg checkpoints too, so a second failure resumes
        # again; the descriptor's identity is carried forward.
        identity = {"version": 1, "request_id": desc.get("request_id"),
                    "response_id": rid, "created": created, "chat": chat,
                    "model": model}
        return 200, self._resume_stream(seq_id, texts, chat, rid, created,
                                        model, identity, sampling), {}

    def _resume_texts(self, seq_id, queue_, first, sampling, output_ids,
                      delivered):
        """The resumed stream's new text pieces, then ``(completion
        tokens, finish reason)`` last: the journal's outputs are
        replayed through a fresh ``Choice`` (detokenizer and stop
        scanner), the first ``delivered`` characters skipped. A handoff
        takes the same path, its journal the first token (``seq_id``
        None and ``first`` a finished output when no engine sequence
        continues it)."""
        choice = Choice(self.tokenizer, sampling, self._lp_json)
        skip = delivered

        def unsent(emits):
            nonlocal skip
            for text, _ in emits:
                if skip and text:
                    cut = min(skip, len(text))
                    text, skip = text[cut:], skip - cut
                if text:
                    yield text

        try:
            for tok in output_ids:
                yield from unsent(choice.feed(StepOutput(seq_id, tok, False,
                                                         None)))
                if choice.stopped:
                    break
            out = first
            while not choice.done:
                yield from unsent(choice.feed(out))
                if not choice.done:
                    out = queue_.get()[1]
        finally:
            if not choice.done or choice.stopped:
                self.loop.abort(seq_id)
            self.loop.finish_stream(seq_id)
        yield choice.n_tokens, choice.finish_reason

    def _resume_stream(self, seq_id, texts, chat, rid, created, model,
                       identity, sampling, role_chunk: bool = False):
        """A resumed (or, with ``role_chunk``, a handed-off) stream's
        SSE frames. A resume has no role chunk: the first leg sent it."""
        obj = "chat.completion.chunk" if chat else "text_completion"

        def chunk(delta: Optional[str], finish: Optional[str]) -> bytes:
            if chat:
                choice = {"index": 0,
                          "delta": {"content": delta} if delta else {},
                          "finish_reason": finish}
            else:
                choice = {"index": 0, "text": delta or "",
                          "finish_reason": finish}
            return _frame({"id": rid, "object": obj, "created": created,
                           "model": model, "choices": [choice]})

        if role_chunk and chat:
            yield _frame({"id": rid, "object": obj, "created": created,
                          "model": model, "choices": [{
                              "index": 0, "delta": {"role": "assistant"},
                              "finish_reason": None}]})
        try:
            for item in texts:
                if not isinstance(item, str):
                    yield chunk(None, item[1])
                    break
                yield chunk(item, None)
                for frame in self._checkpoint_frames(seq_id, identity,
                                                     sampling):
                    yield frame
                    if frame is STREAM_CUT:
                        return
        finally:
            texts.close()
        yield b"data: [DONE]\n\n"

    # ---- disaggregated serving ---------------------------------------------

    def disagg_prefill(self, body: dict, headers=None) -> tuple:
        """POST /v1/disagg/prefill: run the prompt through chunked
        prefill, ship its committed pages to the offload tier and answer
        the handoff descriptor a decode-role engine continues from. The
        first sampled token rides the descriptor. Without a tier the
        descriptor names no page and the decode side recomputes. Any
        role serves it, as the JAX server does: the role gates routing,
        not capability."""
        headers = headers or {}
        messages = body.get("messages")
        chat = isinstance(messages, list)
        try:
            if chat:
                prompt = render_chat_prompt(
                    self.tokenizer, messages,
                    chat_template=self.chat_template)
            else:
                prompt_in = body.get("prompt", "")
                if (isinstance(prompt_in, list) and prompt_in
                        and isinstance(prompt_in[0], int)):
                    prompt = list(prompt_in)
                elif isinstance(prompt_in, list):
                    prompt = self.tokenizer.encode("".join(prompt_in))
                else:
                    prompt = self.tokenizer.encode(str(prompt_in))
            sampling = sampling_from_body(
                body, self.engine.config.scheduler.max_model_len,
                vocab_size=self.engine.config.model.vocab_size)
        except (BadRequest, TypeError, ValueError) as e:
            return _error(400, str(e), "invalid_request_error")
        if (sampling.guided is not None or sampling.logprobs
                or body.get("model") in self.engine.lora_names()):
            # Guided automaton state and first-token logprobs do not
            # cross a handoff, and an adapter's cache salt is this
            # process's; any other model name runs the base model.
            return _error(400, "request cannot be disaggregated (guided "
                          "decoding, logprobs and LoRA adapters are "
                          "monolithic-only)", "invalid_request_error")
        max_prompt = self.engine.config.scheduler.max_model_len - 1
        if len(prompt) > max_prompt:
            return _error(400, f"Prompt is {len(prompt)} tokens; maximum "
                          f"is {max_prompt}", "invalid_request_error")
        (seq_id,), queue_ = self.loop.submit(
            prompt, [sampling], request_id=headers.get("x-request-id"),
            handoff_prefill=True)
        try:
            _, out = queue_.get()
        finally:
            self.loop.finish_stream(seq_id)
        if out.new_token is None and out.finish_reason == "abort":
            return _error(503, "prefill engine rejected the request",
                          headers={"Retry-After": "1"})
        info = (self.engine.take_handoff_info(seq_id)
                or {"num_pages": 0, "kv_bytes": 0, "page_keys": []})
        return 200, {"descriptor": {
            "version": 1,
            "request_id": seq_id,
            "chat": chat,
            "model": self.model_name,
            "token_ids": list(prompt),
            "first_token": out.new_token,
            # Set when the first token already finished the request
            # (stop or length): the decode side then sends that token
            # alone and never touches its engine.
            "finish_reason": (out.finish_reason
                              if out.finish_reason != "handoff" else None),
            "kv_dtype": self.engine.config.cache.resolved_kv_dtype(),
            "page_keys": info["page_keys"],
            "num_pages": info["num_pages"],
            "kv_bytes": info["kv_bytes"],
            "sampling": _sampling_to_wire(sampling),
        }}, {}

    def disagg_handoff(self, body: dict, headers=None) -> tuple:
        """POST /v1/disagg/handoff: continue from a prefill engine's
        descriptor. The answer (SSE chunks, or one JSON completion with
        ``"stream": false``, the default) starts with the descriptor's
        first token; the engine restores the shipped pages (AWAITING_KV)
        or recomputes, so the request always completes. Any role serves
        it."""
        headers = headers or {}
        desc = body.get("descriptor")
        if not isinstance(desc, dict):
            return _error(400, "'descriptor' object is required")
        token_ids = desc.get("token_ids")
        first_token = desc.get("first_token")
        if (not isinstance(token_ids, list)
                or not all(isinstance(t, int) for t in token_ids)
                or not isinstance(first_token, int)):
            return _error(400, "descriptor missing token_ids/first_token")
        my_dtype = self.engine.config.cache.resolved_kv_dtype()
        desc_dtype = desc.get("kv_dtype") or my_dtype
        if desc_dtype != my_dtype:
            # 409: this engine can never restore those pages (tier keys
            # are dtype-namespaced); the router falls back to a
            # monolithic recompute.
            return _error(409, "handoff KV not restorable here (descriptor "
                          f"kv_dtype {desc_dtype!r}, engine {my_dtype!r})")
        try:
            sampling = _sampling_from_wire(desc.get("sampling") or {})
        except Exception as e:
            return _error(400, f"bad descriptor sampling: {e}")
        chat = bool(desc.get("chat", True))
        rid = ("chatcmpl-" if chat else "cmpl-") + uuid.uuid4().hex[:16]
        created = int(time.time())
        finish_hint = desc.get("finish_reason")
        seq_id, queue_ = None, None
        first = StepOutput(None, None, True, finish_hint or "length")
        if not finish_hint and sampling.max_tokens > 1:
            seq_id, queue_ = self.loop.submit_handoff(
                token_ids, first_token, sampling,
                request_id=headers.get("x-request-id"))
            # Peek the first engine output, so a refused submission is a
            # retryable 503 and not a stream that aborts after its
            # headers.
            _, first = queue_.get()
            if (first.finished and first.new_token is None
                    and first.finish_reason == "abort"):
                self.loop.finish_stream(seq_id)
                return _error(503, "decode engine rejected the handoff",
                              headers={"Retry-After": "1"})
        texts = self._resume_texts(seq_id, queue_, first, sampling,
                                   [first_token], 0)
        if bool(body.get("stream", False)):
            return 200, self._resume_stream(
                seq_id, texts, chat, rid, created, self.model_name, None,
                sampling, role_chunk=True), {}
        pieces = list(texts)
        n_tokens, finish = pieces.pop()
        text = "".join(pieces)
        choice = ({"index": 0, "message": {"role": "assistant",
                                           "content": text},
                   "finish_reason": finish} if chat else
                  {"index": 0, "text": text, "finish_reason": finish})
        return 200, {"id": rid, "object": ("chat.completion" if chat
                                           else "text_completion"),
                     "created": created, "model": self.model_name,
                     "choices": [choice],
                     "usage": _usage(len(token_ids), n_tokens)}, {}

    # ---- debug routes ------------------------------------------------------

    def profiler_start(self, query: dict, headers=None) -> tuple:
        """POST /debug/profiler/start[?dir=]: start ``torch.profiler``
        (host operations of the step thread, and the card's kernels and
        copies); the stop writes a Chrome trace into ``dir``, else
        ``--profile-dir``, else a temporary directory. 409 while one
        runs. With a tracer the capture window is a span of its own."""
        import torch.profiler as tprof
        headers = headers or {}
        with self._profiler_lock:
            if self._profiler is not None:
                return _error(409, "profiler already running")
            trace_dir = (query.get("dir") or self.profile_dir
                         or tempfile.mkdtemp(prefix="torch-trace-"))
            activities = [tprof.ProfilerActivity.CPU]
            if self.engine.runner.device.type == "cuda":
                activities.append(tprof.ProfilerActivity.CUDA)
            prof = tprof.profile(activities=activities)
            # Started on the step thread: the profiler records the
            # operations of the thread that starts it.
            self.loop.call(prof.start)
            self._profiler, self._profiler_dir = prof, trace_dir
        tracer = self.engine.tracer
        if tracer is not None:
            sid = f"prof-{uuid.uuid4().hex[:12]}"
            self._profiler_span_id = sid
            tracer.start(sid, request_id=headers.get("x-request-id"),
                         prompt_tokens=0)
            tracer.event(sid, "profiler_start", dir=trace_dir)
        return 200, {"status": "started", "dir": trace_dir}, {}

    def profiler_stop(self) -> tuple:
        """POST /debug/profiler/stop: stop the profiler and write its
        Chrome trace (named in the answer); 409 when none runs."""
        with self._profiler_lock:
            prof, self._profiler = self._profiler, None
            if prof is None:
                return _error(409, "profiler not running")
            self.loop.call(prof.stop)
            os.makedirs(self._profiler_dir, exist_ok=True)
            path = os.path.join(
                self._profiler_dir,
                f"trace-{time.strftime('%Y%m%d-%H%M%S')}-"
                f"{uuid.uuid4().hex[:6]}.json")
            prof.export_chrome_trace(path)
        tracer = self.engine.tracer
        sid, self._profiler_span_id = self._profiler_span_id, None
        if tracer is not None and sid is not None:
            tracer.event(sid, "profiler_stop")
            tracer.finish(sid, reason="profiler", arrival_ts=time.time())
        return 200, {"status": "stopped", "trace": path}, {}

    @staticmethod
    def _limit(query: dict, default: int) -> Optional[int]:
        try:
            return int(query.get("limit", default))
        except (TypeError, ValueError):
            return None

    def debug_trace(self, request_id: str) -> tuple:
        """GET /debug/trace/{request_id}: the flight recorder's event
        timelines of one request, by the router's x-request-id or the
        engine's sequence id."""
        tracer = self.engine.tracer
        if tracer is None:
            return _error(404, "tracing disabled")
        found = tracer.lookup(request_id)
        if found is None:
            return _error(404, "no trace for that id (expired from the "
                          "ring or never seen)")
        return 200, found, {}

    def debug_steps(self, query: dict) -> tuple:
        """GET /debug/steps[?limit=N]: the most recent step records,
        oldest first."""
        tracer = self.engine.tracer
        if tracer is None:
            return _error(404, "tracing disabled")
        limit = self._limit(query, 100)
        if limit is None:
            return _error(400, "limit must be an integer")
        return 200, {"steps": tracer.recent_steps(limit=limit)}, {}

    def debug_compiles(self, query: dict) -> tuple:
        """GET /debug/compiles[?limit=N]: the observatory's capture
        ledger: events and seconds by kind, graphs held, the ring of
        recent captures with their bucket shapes, and under
        ``timings`` the PSTPU_TIMING dispatch walls by kind ({} with the
        variable unset)."""
        obs = self.engine.runner.observatory
        if obs is None:
            return _error(404, "observatory disabled")
        limit = self._limit(query, 32)
        if limit is None:
            return _error(400, "limit must be an integer")
        return 200, obs.compile_report(limit=limit), {}

    def debug_memory(self) -> tuple:
        """GET /debug/memory: the observatory's memory ledger: the
        analytic bytes by category and, on the card,
        ``torch.cuda.memory_stats``."""
        obs = self.engine.runner.observatory
        if obs is None:
            return _error(404, "observatory disabled")
        return 200, obs.memory_report(), {}


    # ---- self-tuning -------------------------------------------------------

    def autotune_status(self) -> tuple:
        """GET /autotune/status: mode, cadence, and each controller's
        knob, clamp band, freeze and decision counts."""
        return 200, self.autotuner.status(), {}

    def autotune_reset(self, body: dict) -> tuple:
        """POST /autotune/reset: unlatch one controller's guardrail
        freeze (``{"controller": name}``) or all (empty body)."""
        return 200, {"reset": self.autotuner.reset(body.get("controller"))}, {}

    # ---- pooled routes: embeddings, score, rerank ---------------------------

    def _ensure_embedder(self) -> Embedder:
        if self._embedder is None:
            self._embedder = Embedder(
                self.engine.config.model, self.engine.runner.params,
                max_len=self.engine.config.scheduler.max_model_len,
                pooling=self.pooling, encode_fn=self.engine.runner.encode)
        return self._embedder

    def _embed(self, token_lists: List[List[int]]):
        """[N, hidden] unit vectors. Each chunk runs on the engine loop's
        thread between two steps, never beside a step graph's capture,
        and counts as an eager step of reason ``embed``."""
        embedder = self._ensure_embedder()
        graphs = self.engine.runner.graphs

        def on_loop(fn):
            def counted():
                if graphs is not None:
                    graphs.count_eager("embed")
                return fn()
            return self.loop.call(counted)

        with self._embed_lock:
            return embedder.embed_batch(token_lists, run=on_loop)

    def embeddings(self, body: dict) -> tuple:
        """POST /v1/embeddings over the served model's hidden states."""
        try:
            token_lists = parse_embedding_input(
                body.get("input"), self.tokenizer,
                max_len=self.engine.config.scheduler.max_model_len)
        except ValueError as e:
            return _error(400, str(e), "invalid_request_error")
        try:
            vectors = self._embed(token_lists)
        except NotImplementedError as e:
            return _error(501, str(e))
        n_tokens = sum(len(t) for t in token_lists)
        return 200, {
            "object": "list",
            "model": self.model_name,
            "data": [{"object": "embedding", "index": i,
                      "embedding": vec.tolist()}
                     for i, vec in enumerate(vectors)],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }, {}

    def _pair_scores(self, query: str, documents: List[str]):
        """Bi-encoder relevance: the cosine of pooled vectors (a dot
        product: they are L2-normalized); (scores, tokens)."""
        self._ensure_embedder()
        max_len = self.engine.config.scheduler.max_model_len
        token_lists = [self.tokenizer.encode(query)[:max_len]] + [
            self.tokenizer.encode(d)[:max_len] for d in documents]
        if not all(token_lists):
            raise ValueError("texts must not be empty")
        vectors = self._embed(token_lists)
        scores = vectors[1:] @ vectors[0]
        return [float(x) for x in scores], sum(len(t) for t in token_lists)

    def score(self, body: dict) -> tuple:
        """POST /v1/score (and /score): relevance of the text_2
        document(s) to text_1."""
        text_1 = body.get("text_1") or body.get("query")
        text_2 = body.get("text_2") or body.get("documents")
        if not isinstance(text_1, str) or text_2 is None:
            return _error(400, "'text_1' (string) and 'text_2' (string or "
                          "list) are required")
        docs = [text_2] if isinstance(text_2, str) else list(text_2)
        try:
            scores, n_tokens = self._pair_scores(text_1, docs)
        except ValueError as e:
            return _error(400, str(e))
        except NotImplementedError as e:
            return _error(501, str(e))
        return 200, {
            "id": "score-" + uuid.uuid4().hex[:16],
            "object": "list",
            "model": self.model_name,
            "data": [{"object": "score", "index": i, "score": x}
                     for i, x in enumerate(scores)],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        }, {}

    def rerank(self, body: dict) -> tuple:
        """POST /v1/rerank (and /rerank): the documents by relevance to
        the query, best first (``top_n`` of them when given)."""
        query = body.get("query")
        documents = body.get("documents")
        if not isinstance(query, str) or not isinstance(documents, list):
            return _error(400, "'query' (string) and 'documents' (list of "
                          "strings) are required")
        try:
            scores, n_tokens = self._pair_scores(
                query, [str(d) for d in documents])
        except ValueError as e:
            return _error(400, str(e))
        except NotImplementedError as e:
            return _error(501, str(e))
        order = sorted(range(len(scores)), key=lambda i: -scores[i])
        top_n = body.get("top_n")
        if isinstance(top_n, int) and top_n > 0:
            order = order[:top_n]
        return 200, {
            "id": "rerank-" + uuid.uuid4().hex[:16],
            "model": self.model_name,
            "usage": {"total_tokens": n_tokens},
            "results": [{"index": i, "document": {"text": documents[i]},
                         "relevance_score": scores[i]} for i in order],
        }, {}


# The JAX server's routes this server does not serve: (method, path,
# feature). Empty: the port serves all 24; a route a later JAX change
# adds goes here until it is ported.
UNPORTED_ROUTES: Tuple[Tuple[str, str, str], ...] = ()


def unported_feature(method: str, path: str) -> Optional[str]:
    """The feature of a JAX-server route this server does not serve,
    or None."""
    for m, route, feature in UNPORTED_ROUTES:
        if (m, route) == (method, path):
            return feature
    return None


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "EngineHTTPServer"

    def log_message(self, fmt, *args):  # quiet access log
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _no_route(self, method: str, path: str) -> None:
        """501 naming the feature of an unported JAX-server route, else
        404. The body is not read, so the connection closes after."""
        self.close_connection = True
        feature = unported_feature(method, path)
        if feature is None:
            self._send(404, {"error": {"message": f"no route {path}"}})
        else:
            self._send(501, {"error": {
                "message": f"{path}: {feature}, not ported",
                "type": "not_implemented_error"}})

    def _send(self, status: int, body, content_type="application/json",
              headers: Optional[dict] = None):
        data = (json.dumps(body) if isinstance(body, dict)
                else body).encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(data)

    def _query(self) -> dict:
        return {k: v[-1] for k, v in urllib.parse.parse_qs(
            urllib.parse.urlsplit(self.path).query).items()}

    def do_GET(self):
        app = self.server.app
        path = self.path.split("?", 1)[0]
        debug = {
            "/debug/steps": lambda: app.debug_steps(self._query()),
            "/debug/compiles": lambda: app.debug_compiles(self._query()),
            "/debug/memory": app.debug_memory,
        }
        trace_prefix = "/debug/trace/"
        if path in debug:
            status, body, headers = debug[path]()
            self._send(status, body, headers=headers)
        elif path.startswith(trace_prefix) and len(path) > len(trace_prefix):
            status, body, headers = app.debug_trace(urllib.parse.unquote(
                path[len(trace_prefix):]))
            self._send(status, body, headers=headers)
        elif path == "/health":
            self._send(*app.health())
        elif path == "/v1/models":
            self._send(200, app.models())
        elif path == "/metrics":
            self._send(200, app.metrics(), "text/plain; version=0.0.4")
        elif path == "/version":
            self._send(200, app.version())
        elif path == "/kv/summary":
            self._send(200, app.kv_summary_snapshot())
        elif path == "/autotune/status":
            self._send(*app.autotune_status())
        else:
            self._no_route("GET", path)

    def _json_body(self) -> Optional[dict]:
        """The request's JSON object, or None (after a 400) when it is
        not one."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"null")
        except (ValueError, json.JSONDecodeError):
            body = None
        if not isinstance(body, dict):
            self._send(400, {"error": {
                "message": "Request body must be a JSON object",
                "type": "invalid_request_error"}})
            return None
        return body

    def do_POST(self):
        app = self.server.app
        path = self.path.split("?", 1)[0]
        lenient = {"/drain": lambda b: (200, app.drain(b), {}),
                   "/autotune/reset": app.autotune_reset}
        if path in lenient:
            # A missing or malformed body reads as {}, as in the JAX
            # server.
            length = int(self.headers.get("Content-Length") or 0)
            try:
                body = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError):
                body = {}
            status, result, headers = lenient[path](
                body if isinstance(body, dict) else {})
            self._send(status, result, headers=headers)
            return
        profiler = {
            "/debug/profiler/start": lambda: app.profiler_start(
                self._query(), self.headers),
            "/debug/profiler/stop": app.profiler_stop,
        }
        if path in profiler:
            self.rfile.read(int(self.headers.get("Content-Length") or 0))
            status, body, headers = profiler[path]()
            self._send(status, body, headers=headers)
            return
        # The pooled routes: not generation requests (no drain gate),
        # as in the JAX server.
        pooled = {"/v1/embeddings": app.embeddings, "/v1/score": app.score,
                  "/score": app.score, "/v1/rerank": app.rerank,
                  "/rerank": app.rerank}
        if path in pooled:
            body = self._json_body()
            if body is not None:
                status, result, headers = pooled[path](body)
                self._send(status, result, headers=headers)
            return
        handlers = {
            "/v1/completions": lambda b: app.complete(b, False,
                                                      self.headers),
            "/v1/chat/completions": lambda b: app.complete(b, True,
                                                           self.headers),
            "/v1/resume": lambda b: app.resume(b, self.headers),
            "/v1/disagg/prefill": lambda b: app.disagg_prefill(
                b, self.headers),
            "/v1/disagg/handoff": lambda b: app.disagg_handoff(
                b, self.headers),
        }
        if path not in handlers:
            self._no_route("POST", path)
            return
        body = self._json_body()
        if body is None:
            return
        # A generation request: refused while draining, else counted in
        # flight until its answer (its stream included) is written.
        rejection = app.begin_generation()
        if rejection is not None:
            self._send(*rejection[:2], headers=rejection[2])
            return
        try:
            status, result, headers = handlers[path](body)
            if isinstance(result, dict):
                self._send(status, result, headers=headers)
            else:
                self._stream(result)
        finally:
            app.end_generation()

    def _stream(self, frames) -> None:
        """Server-sent events, one chunk a frame (chunked transfer
        encoding). ``STREAM_CUT`` ends the stream without its last
        chunk and closes the connection: the client reads a cut."""
        self.send_response(HTTPStatus.OK)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            for frame in frames:
                if frame is STREAM_CUT:
                    self.close_connection = True
                    return
                self.wfile.write(b"%x\r\n%s\r\n" % (len(frame), frame))
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True  # client gone
        finally:
            frames.close()  # aborts the sequence if it did not finish


class EngineHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, app: EngineServer):
        super().__init__(address, _Handler)
        self.app = app
        # A drain with "exit" stops this server once idle; serve()
        # then returns (and main() with it).
        app.on_drain_exit = self.shutdown

    def serve(self) -> None:
        """Start the engine loop and serve until ``shutdown()``."""
        self.app.loop.start()
        try:
            self.serve_forever(poll_interval=0.2)
        finally:
            self.app.loop.stop()
            self.server_close()
            self.app.engine.close()


# ---- construction -----------------------------------------------------------


def _resolve(flag: str, eligible: bool = True) -> bool:
    """--async-scheduling / --unified-step auto|on|off: 'auto' is on
    where the JAX engine's 'auto' turns the feature on, else off; an
    explicit 'on' is honoured. 'auto' turns the unified step on for a
    monolithic engine on one host (``unified_step_eligible``: a role
    engine never holds prefill and decode work at once) and the async
    pipeline on for single-step decode without --speculative-k on one
    host and any role but prefill (``async_scheduling_eligible``: a
    burst already amortizes the host round trip, a verify step's commit
    count is data-dependent, and a prefill-role engine has no decode
    step to overlap); both resolve off under --distributed, as in
    JAX."""
    return flag == "on" or (flag == "auto" and eligible)


def resolve_attention_impl(flag: str, device: torch.device) -> str:
    """--attention-impl, the JAX server's values, onto the port's
    ``ATTENTION_IMPLS`` (models/llama.py): ``auto`` and ``pallas`` (the
    hand-written kernels) select ``cuda`` on the card and ``plain`` on
    the CPU; ``xla`` and ``pallas-interpret`` (reference paths) select
    ``plain``, which serves only with ``--device cpu``: on the card the
    plain versions are on no path, so those values are refused."""
    if device.type != "cuda":
        return "plain"
    if flag in ("xla", "pallas-interpret"):
        raise ValueError(
            f"--attention-impl {flag} selects the plain attention, which "
            "the card never serves; use auto or pallas (the CUDA "
            "kernels), or --device cpu")
    return "cuda"


def _resolve_deferred_kv(args, model_config) -> bool:
    """--deferred-kv-writes auto|on|off -> bool: 'auto' is on where the
    JAX server's is (the same predicate over the same arguments,
    ``deferred_kv_eligible``, pp and cp sizes included); an explicit
    'on' the runner cannot serve is refused by the runner, as in
    JAX."""
    if args.deferred_kv_writes == "on":
        return True
    if args.deferred_kv_writes == "off":
        return False
    return deferred_kv_eligible(
        model_config.architecture, args.decode_steps, args.attention_impl,
        args.pipeline_parallel_size, args.context_parallel_size,
        args.speculative_k)


def world_size(args) -> int:
    """Ranks of the flags' tp x sp x pp world."""
    return (args.tensor_parallel_size * args.pipeline_parallel_size
            * args.context_parallel_size)


def tp_devices(args, device: torch.device) -> list:
    """The devices of the world's ranks, one a rank in global rank
    order, from the mesh plan over this host's topology
    (``--num-slices``, ``--mesh-placement``): the CUDA devices, or on
    the CPU that many CPU ranks. A plan wider than the host is refused,
    as in JAX."""
    devices = None
    if device.type == "cpu":
        devices = [device] * world_size(args)
    topology = discover_topology(devices, num_slices=args.num_slices)
    plan = MeshPlan(tp=args.tensor_parallel_size,
                    pp=args.pipeline_parallel_size,
                    sp=args.context_parallel_size,
                    placement=parse_placement(args.mesh_placement))
    return plan.build(topology).world_devices()


def distributed_process(args) -> Optional[DistributedProcess]:
    """This process's place in a ``--distributed`` world (None without
    the flag), after the JAX server's refusals: the offload tiers are
    host-0-local state, and a context-parallel prefill is refused at
    start-up rather than on the first long prompt."""
    if not args.distributed:
        return None
    if args.enable_kv_offload or args.kv_remote_url:
        raise ValueError(
            "KV offload tiers are host-0-local state and are not "
            "yet supported in multi-host mode")
    if args.context_parallel_size > 1:
        raise ValueError(
            "--context-parallel-size > 1 is not yet supported "
            "with --distributed (single-host sp only)")
    return init_distributed(args.coordinator_address, args.num_processes,
                            args.process_id)


def process_devices(args, device: torch.device,
                    process: DistributedProcess) -> list:
    """The devices of this process's ranks of a ``--distributed``
    world (its L = world / processes ranks: that many CPU ranks, or
    cards 0..L-1), after the mesh plan is checked against the processes
    (``process_topology``: an "ici" axis may not cross a slice)."""
    per = len(process.local_ranks(world_size(args)))
    MeshPlan(tp=args.tensor_parallel_size, pp=args.pipeline_parallel_size,
             sp=args.context_parallel_size,
             placement=parse_placement(args.mesh_placement)).validate(
        process_topology(process.num_processes, per, args.num_slices))
    if device.type == "cpu":
        return [device] * per
    if torch.cuda.device_count() < per:
        raise ValueError(f"process {process.process_id} holds {per} ranks "
                         f"but sees {torch.cuda.device_count()} cards")
    return [torch.device("cuda", i) for i in range(per)]


def engine_config_from_args(args, device: torch.device) -> tuple:
    """(EngineConfig, the checkpoint directory every rank reads or None)
    of the parsed flags, after the JAX runner's refusals."""
    if args.compilation_cache_dir:
        paged_kv_common.set_build_root(
            os.path.join(args.compilation_cache_dir, "kernels"))
    if args.model in ("tiny-llama", "tiny-opt"):
        model_config = tiny_model_config(args.model.split("-")[1])
    elif args.model == "bench-1b":
        model_config = bench_1b_model_config()
    else:
        # A local HF checkpoint directory: its config and its weights
        # (unless --random-weights).
        model_config = load_model_config(args.model)
    if args.dtype:
        # On the card the runner refuses a geometry the kernels do not
        # serve, naming the rule it breaks.
        model_config.dtype = args.dtype
    model_config.quantization = args.quantization
    model_config.attention_impl = args.attention_impl
    config = EngineConfig(
        model=model_config,
        cache=CacheConfig(page_size=args.page_size,
                          num_pages=args.num_pages,
                          enable_prefix_caching=(
                              not args.disable_prefix_caching),
                          cache_layout=args.cache_layout,
                          kv_cache_dtype=args.kv_cache_dtype),
        scheduler=SchedulerConfig(
            max_num_seqs=args.max_num_seqs,
            max_model_len=args.max_model_len,
            prefill_chunk_size=args.prefill_chunk_size,
            prefill_batch_size=args.prefill_batch_size,
            decode_steps=args.decode_steps,
            async_scheduling=_resolve(
                args.async_scheduling,
                eligible=(async_scheduling_eligible(
                    args.decode_steps, args.speculative_k,
                    distributed=args.distributed)
                    and args.engine_role != "prefill")),
            unified_step=_resolve(
                args.unified_step,
                eligible=unified_step_eligible(
                    engine_role=args.engine_role,
                    distributed=args.distributed)),
            speculative_k=args.speculative_k,
            speculative_min_match=args.speculative_min_match,
            deferred_kv_writes=_resolve_deferred_kv(args, model_config),
            max_queue_len=args.max_queue_len),
        parallel=ParallelConfig(
            tensor_parallel_size=args.tensor_parallel_size,
            pipeline_parallel_size=args.pipeline_parallel_size,
            context_parallel_size=args.context_parallel_size,
            long_prefill_threshold=args.long_prefill_threshold,
            num_slices=args.num_slices,
            mesh_placement=args.mesh_placement),
        offload=OffloadConfig(
            enable=args.enable_kv_offload or bool(args.kv_remote_url),
            host_pool_bytes=args.kv_host_pool_bytes,
            remote_url=args.kv_remote_url),
        qos=QoSConfig(
            default_priority=args.default_priority,
            preempt_to_offload=args.preempt_to_offload == "on",
            shed_threshold=args.shed_threshold),
        kvecon=KVEconConfig(
            summary_top_k=args.kv_summary_top_k,
            admit_hits=args.kv_admit_hits,
            ttl_s=args.kv_ttl_s,
            watermark_high=args.kv_watermark_high,
            watermark_low=args.kv_watermark_low),
        autotune=AutotuneConfig(
            mode=args.autotune,
            interval_s=args.autotune_interval_s,
            dead_band=args.autotune_dead_band,
            controllers=args.autotune_controllers,
            freeze_window_s=args.autotune_freeze_window_s,
            burn_threshold=args.autotune_burn_threshold,
            target_itl_ms=args.autotune_target_itl_ms,
            min_spec_k=args.autotune_min_spec_k,
            min_checkpoint_interval_tokens=(
                args.autotune_min_checkpoint_interval_tokens),
            max_checkpoint_interval_tokens=(
                args.autotune_max_checkpoint_interval_tokens),
            min_shed_threshold=args.autotune_min_shed_threshold),
        lora=LoRAConfig(
            enable=args.enable_lora or bool(args.lora_modules),
            max_loras=args.max_loras,
            max_lora_rank=args.max_lora_rank),
        seed=args.seed,
        engine_role=args.engine_role,
        handoff_timeout_s=args.handoff_timeout_s,
        device_peak_flops=args.device_peak_flops,
        checkpoint_interval_tokens=args.checkpoint_interval_tokens,
        step_watchdog_s=args.step_watchdog_s,
    )
    weights_dir = None
    # The JAX runner's refusals, before any rank is started.
    check_parallel(config)
    mesh.check_tp(model_config, args.tensor_parallel_size)
    if args.model not in ("tiny-llama", "tiny-opt", "bench-1b"):
        if device.type == "cuda":
            # Refuse a geometry the kernels lack before reading weights.
            check_engine_geometry(config)
        if not args.random_weights:
            weights_dir = args.model
    return config, weights_dir


def build_engine_from_args(args, devices=None, tp_backend=None) -> tuple:
    """(engine, served name) of the parsed flags. ``devices`` and
    ``tp_backend`` override the ranks' devices (global rank order) and
    backend (ranks that share one card need gloo, named explicitly); by
    default the mesh plan picks the devices and NCCL joins them. Under
    ``--distributed`` this is process 0's engine, the coordinator's,
    and the cards decide the backend (``start_distributed``)."""
    process = distributed_process(args)
    device = resolve_device(args.device)
    resolve_attention_impl(args.attention_impl, device)
    if devices is None and process is not None:
        devices = process_devices(args, device, process)
    elif devices is None:
        devices = ([device] if world_size(args) <= 1
                   and args.num_slices <= 1 else tp_devices(args, device))
    devices = [torch.device(d) for d in devices]
    device = devices[0]
    config, weights_dir = engine_config_from_args(args, device)
    model_config = config.model
    params, tokenizer = None, None
    if args.model not in ("tiny-llama", "tiny-opt", "bench-1b"):
        # A checkpoint directory's tokenizer (or --tokenizer).
        tokenizer = get_tokenizer(args.tokenizer or args.model)
    if weights_dir is not None:
        # Rank 0's part (tp shard 0 of stage 0); the other ranks read
        # their own.
        params = load_weights(
            weights_dir, model_config, device=device,
            tp=args.tensor_parallel_size,
            layers=(None if args.pipeline_parallel_size == 1 else
                    mesh.stage_layers(model_config.num_hidden_layers,
                                      0, args.pipeline_parallel_size)))
    runtime = None
    if process is not None:
        # Rank 0 of a multi-host world: the other processes join at the
        # coordinator's address and replay this process's steps.
        runtime = start_distributed(
            config, devices, process, weights=weights_dir,
            num_slices=process_slices(process.num_processes,
                                      args.num_slices))
    elif len(devices) > 1:
        # Ranks 1..N-1, one card each (NCCL; gloo on the CPU), replay
        # this process's steps through the bridge.
        runtime = start_parallel(config, devices, backend=tp_backend,
                                 weights=weights_dir)
    # The presets serve with the bench tokenizer at the model's vocab:
    # random-weights greedy ids decode to one character each.
    try:
        engine = LLMEngine(config, params=params,
                           tokenizer=tokenizer or BenchTokenizer(
                               model_config.vocab_size),
                           device=device,
                           **(runtime.engine_args() if runtime else {}))
    except BaseException:
        if runtime is not None:
            runtime.close()
        raise
    for module in args.lora_modules or []:
        name, _, path = module.partition("=")
        if not path:
            raise ValueError(
                f"--lora-modules entries must be name=path, got {module!r}")
        engine.register_lora(path, name=name)
    if args.request_span_log or args.trace_ring_size > 0:
        # The server's default: the flight recorder on, the span log
        # off. An engine built as a library keeps tracer None.
        engine.tracer = EngineTracer(
            span_log_path=args.request_span_log,
            ring_size=max(1, args.trace_ring_size),
            role=args.engine_role)
    return engine, args.served_model_name or args.model


def run_worker_from_args(args) -> dict:
    """A ``--distributed`` process other than 0: build its ranks'
    runners and replay the coordinator's records until its shutdown
    record (``run_distributed_worker``); it never serves HTTP. Returns
    its ranks' kernel launch counts."""
    process = distributed_process(args)
    device = resolve_device(args.device)
    resolve_attention_impl(args.attention_impl, device)
    devices = process_devices(args, device, process)
    config, weights_dir = engine_config_from_args(args, devices[0])
    return run_distributed_worker(config, devices, process, weights_dir)


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="tpu-engine-torch")
    p.add_argument("--model", default="tiny-llama",
                   help="HF model dir, or tiny-llama/tiny-opt/bench-1b "
                        "(random weights)")
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer of a --model directory: a local HF "
                        "tokenizer path (needs transformers) or bench; "
                        "default the directory's own")
    p.add_argument("--random-weights", action="store_true",
                   help="a --model directory's config with random "
                        "weights (seeded by --seed); the presets are "
                        "random always")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; with no card and no "
                        "--device cpu the server refuses to start")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--dtype", default=None,
                   choices=[None, "bfloat16", "float32", "float16"],
                   help="model dtype (default: the preset's), for any "
                        "model; on the card the attention kernels take "
                        "bf16, f16 or f32 at any query group and any "
                        "head_dim of 1 or more (above 256 as slabs of "
                        "128), and refuse a head_dim under 1 at start, "
                        "naming the rule")
    p.add_argument("--attention-impl", default="auto",
                   choices=["auto", "xla", "pallas", "pallas-interpret"],
                   help="the JAX server's values: auto and pallas run the "
                        "CUDA kernels on the card (the plain versions on "
                        "the CPU); xla and pallas-interpret select the "
                        "plain versions, served only with --device cpu "
                        "and refused on the card")
    p.add_argument("--quantization", default="none",
                   choices=["none", "int8"],
                   help="weight-only quantization: int8 projections with "
                        "per-channel scales (half the weight bytes a "
                        "decode step reads)")
    p.add_argument("--page-size", type=int, default=16,
                   help="tokens a KV page holds: any size of 1 or more, "
                        "with every --kv-cache-dtype (the kernels walk "
                        "128-token chunks whatever the page)")
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--kv-cache-dtype", default="auto",
                   choices=["auto", "bf16", "int8"],
                   help="KV page storage: auto/bf16 keep the model's "
                        "dtype; int8 quantizes on write (one f32 scale "
                        "per slot) and spends the same device bytes on "
                        "about 1.9x the pages, at any --page-size")
    p.add_argument("--cache-layout", default="auto",
                   choices=["auto", "stacked", "per_layer"],
                   help="KV cache device layout: one stacked [L, ...] "
                        "buffer per k/v, a list of per-layer buffers, or "
                        "auto (the JAX engine's rule: stacked under "
                        "pipeline or context parallelism, which refuse "
                        "per_layer; per_layer otherwise)")
    p.add_argument("--disable-prefix-caching", action="store_true")
    p.add_argument("--enable-lora", action="store_true",
                   help="multi-LoRA adapter serving")
    p.add_argument("--lora-modules", nargs="*", default=None,
                   metavar="NAME=PATH",
                   help="PEFT adapter directories to serve by name")
    p.add_argument("--max-loras", type=int, default=8)
    p.add_argument("--max-lora-rank", type=int, default=16)
    p.add_argument("--max-num-seqs", type=int, default=8)
    p.add_argument("--max-model-len", type=int, default=2048)
    p.add_argument("--prefill-chunk-size", type=int, default=512)
    p.add_argument("--prefill-batch-size", type=int, default=4)
    p.add_argument("--decode-steps", type=int, default=1,
                   help="decode iterations chained in one dispatch (K "
                        "tokens per host round trip); async 'auto' then "
                        "resolves off")
    p.add_argument("--max-queue-len", type=int, default=1024)
    p.add_argument("--async-scheduling", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--unified-step", default="auto",
                   choices=["auto", "on", "off"])
    p.add_argument("--speculative-k", type=int, default=0,
                   help="prompt-lookup speculative decoding: draft up "
                        "to K tokens per row from its own n-gram "
                        "history and verify them in one step (0 = off)")
    p.add_argument("--speculative-min-match", type=int, default=2,
                   help="minimum n-gram length the proposer must match "
                        "before drafting")
    p.add_argument("--deferred-kv-writes", default="auto",
                   choices=["auto", "on", "off"],
                   help="defer a decode burst's KV writes to one flush a "
                        "burst; the decode kernel reads the burst's tail. "
                        "'auto' enables it when eligible (llama family, "
                        "--decode-steps > 1, auto or xla attention, no "
                        "--speculative-k)")
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="ranks that split the heads and the MLP, one "
                        "card each over NCCL (on the CPU: gloo ranks); "
                        "the server starts ranks 1..N-1 itself")
    p.add_argument("--pipeline-parallel-size", type=int, default=1,
                   help="layer stages, one rank (times the tp size) "
                        "each: microbatches hop stage to stage "
                        "(parallel/pipeline_serving.py)")
    p.add_argument("--context-parallel-size", type=int, default=1,
                   help="sequence shards: a long cold prompt prefills in "
                        "one ring-attention dispatch over the ranks "
                        "(parallel/context_serving.py)")
    p.add_argument("--long-prefill-threshold", type=int, default=None,
                   help="prompt length (tokens) that takes the "
                        "context-parallel prefill path (default 2 x "
                        "--prefill-chunk-size)")
    p.add_argument("--num-slices", type=int, default=0,
                   help="force the device topology into N equal "
                        "contiguous slices; 0 discovers it (one host is "
                        "one slice)")
    p.add_argument("--mesh-placement", default="auto",
                   help="per-axis mesh placement as 'axis=ici' / "
                        "'axis=any' pairs (comma separated); 'auto' "
                        "keeps tp and sp inside one slice")
    p.add_argument("--seed", type=int, default=0)
    # Offload tiers, QoS, fleet contract and KV economy: the JAX
    # server's flags, names, defaults and choices.
    p.add_argument("--enable-kv-offload", action="store_true",
                   help="device -> host-RAM KV offload tier")
    p.add_argument("--kv-host-pool-bytes", type=int,
                   default=2 * 1024 ** 3)
    p.add_argument("--kv-remote-url", default=None,
                   help="Remote shared KV cache server URL")
    p.add_argument("--default-priority", default="batch",
                   choices=list(PRIORITY_NAMES),
                   help="QoS class assumed for requests without an "
                        "x-priority header; priority orders admission "
                        "and picks preemption victims (lowest class, "
                        "newest arrival first)")
    p.add_argument("--preempt-to-offload", default="on",
                   choices=["on", "off"],
                   help="Under KV page pressure, ship a preempted "
                        "victim's committed pages to the offload tier "
                        "and restore them on re-admission instead of "
                        "recomputing; inert without --enable-kv-offload "
                        "or --kv-remote-url")
    p.add_argument("--shed-threshold", type=float, default=0.95,
                   help="Fraction of --max-queue-len at which "
                        "non-interactive requests are shed with 429 + "
                        "Retry-After; interactive requests are never "
                        "shed by this gate")
    p.add_argument("--handoff-timeout-s", type=float, default=30.0,
                   help="How long a sequence parked in AWAITING_KV "
                        "waits for an unreachable offload tier before "
                        "degrading to a full recompute")
    p.add_argument("--drain-exit-timeout-s", type=float, default=0.0,
                   help="After POST /drain {\"exit\": true}, the "
                        "longest the server waits for in-flight "
                        "requests before stopping anyway (0 = wait for "
                        "ever)")
    p.add_argument("--build-id", type=str, default="",
                   help="Opaque build/revision label reported in "
                        "/health and /version")
    p.add_argument("--checkpoint-interval-tokens", type=int, default=0,
                   help="Every N generated tokens, ship a streaming "
                        "sequence's committed KV pages to the offload "
                        "tier and attach a resume descriptor to the SSE "
                        "stream (0 disables)")
    p.add_argument("--step-watchdog-s", type=float, default=0.0,
                   help="Seconds a single engine step may run before "
                        "/health answers 503 (0 disables)")
    p.add_argument("--kv-summary-top-k", type=int, default=64,
                   help="Hot prefix chains advertised at GET "
                        "/kv/summary for KV-state-aware routing")
    p.add_argument("--kv-admit-hits", type=int, default=2,
                   help="Decayed hit count a prefix chain needs before "
                        "the summary advertises it")
    p.add_argument("--kv-ttl-s", type=float, default=900.0,
                   help="Seconds an idle prefix chain stays in the "
                        "summary tracker (0 disables TTL)")
    p.add_argument("--kv-watermark-high", type=float, default=1.0,
                   help="Host KV pool fill fraction that triggers LRU "
                        "eviction (1.0 = evict exactly at capacity)")
    p.add_argument("--kv-watermark-low", type=float, default=1.0,
                   help="Fill fraction the host KV pool drains down to "
                        "once the high watermark trips")
    # Disaggregation, the profiler and the observatory, request tracing.
    p.add_argument("--engine-role", default="both",
                   choices=["prefill", "decode", "both"],
                   help="Disaggregated serving role: 'prefill' computes "
                        "prompt KV and hands off over the offload tier, "
                        "'decode' continues handoffs, 'both' (default) "
                        "serves monolithically; reported in /health")
    p.add_argument("--profile-dir", "--profiler-dir", dest="profile_dir",
                   default=None,
                   help="Default output directory of the Chrome traces "
                        "of /debug/profiler/start (--profiler-dir is an "
                        "alias); unset, a temporary directory")
    p.add_argument("--device-peak-flops", type=float, default=0.0,
                   help="Per-card peak FLOP/s for the observatory's "
                        "vllm:engine_mfu gauge; 0 resolves from the "
                        "device-name table (unknown devices report MFU "
                        "0)")
    p.add_argument("--request-span-log", default=None,
                   help="Write one JSON engine-span line per finished "
                        "request to this path ('-' = the engine log); "
                        "stitch with the router's spans by python -m "
                        "production_stack_tpu.traceview")
    p.add_argument("--trace-ring-size", type=int, default=256,
                   help="Flight-recorder depth: recent request timelines "
                        "kept for /debug/trace/{id} and step records for "
                        "/debug/steps; 0 turns the recorder (and, with no "
                        "--request-span-log, all tracing) off")
    p.add_argument("--pooling", default="last", choices=["last", "mean"],
                   help="/v1/embeddings pooling mode")
    p.add_argument("--chat-template", default=None,
                   help="Jinja chat template source or file path, "
                        "overriding the model's own template")
    p.add_argument("--compilation-cache-dir", default=None,
                   help="build (and find) the CUDA kernel library under "
                        "DIR/kernels/<source hash>/ instead of "
                        "build/kernels/, so a restarted pod skips the "
                        "nvcc build")
    # Multi-host serving (parallel/distributed.py): one server process a
    # host; process 0 serves HTTP, the others replay its steps.
    p.add_argument("--distributed", action="store_true",
                   help="Join a multi-host world of --num-processes "
                        "server processes at --coordinator-address")
    p.add_argument("--coordinator-address", default=None,
                   help="host:port of the rendezvous store, hosted by "
                        "process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    # Self-tuning controllers: the JAX server's flags.
    p.add_argument("--autotune", default="off",
                   choices=["off", "shadow", "on"],
                   help="Self-tuning controllers: off, shadow (compute + "
                        "span-log decisions without applying), or on "
                        "(close the loop)")
    p.add_argument("--autotune-interval-s", type=float, default=2.0,
                   help="Seconds between controller ticks")
    p.add_argument("--autotune-dead-band", type=float, default=0.05,
                   help="Relative dead-band: drop proposals within this "
                        "fraction of the current knob value")
    p.add_argument("--autotune-controllers", default="all",
                   help="Comma-separated controller allowlist (spec_k,"
                        "prefill_budget,kvecon,checkpoint_interval,"
                        "qos_shed) or 'all'")
    p.add_argument("--autotune-freeze-window-s", type=float, default=30.0,
                   help="Guardrail blame window: freeze controllers that "
                        "applied a decision this recently when perf drift "
                        "flips or 5m burn rises")
    p.add_argument("--autotune-burn-threshold", type=float, default=1.0,
                   help="5m SLO burn rate at/above which a rise trips the "
                        "guardrail")
    p.add_argument("--autotune-target-itl-ms", type=float, default=50.0,
                   help="Decode ITL p99 target the prefill-budget "
                        "controller steers toward")
    p.add_argument("--autotune-min-spec-k", type=int, default=1,
                   help="Floor for the per-sequence speculative draft cap "
                        "(ceiling is --speculative-k)")
    p.add_argument("--autotune-min-checkpoint-interval-tokens", type=int,
                   default=64,
                   help="Floor for the tuned checkpoint interval")
    p.add_argument("--autotune-max-checkpoint-interval-tokens", type=int,
                   default=4096,
                   help="Ceiling for the tuned checkpoint interval")
    p.add_argument("--autotune-min-shed-threshold", type=float, default=0.5,
                   help="Floor for the tuned QoS shed gate (ceiling is "
                        "--shed-threshold)")
    return p.parse_args(argv)


def load_chat_template(args) -> Optional[str]:
    """--chat-template accepts inline Jinja source or a file path. The
    template is rendered once here, so a broken one fails at start-up
    rather than falling back at request time."""
    if not args.chat_template:
        return None
    if os.path.exists(args.chat_template):
        with open(args.chat_template) as f:
            source = f.read()
    else:
        source = args.chat_template
    import jinja2
    jinja2.Template(source).render(
        messages=[{"role": "user", "content": "probe"}],
        add_generation_prompt=True)
    return source


def make_server(argv=None, devices=None,
                tp_backend=None) -> EngineHTTPServer:
    """Build the engine and bind the HTTP server (not yet serving);
    ``devices`` and ``tp_backend`` as ``build_engine_from_args``."""
    args = parse_args(argv)
    chat_template = load_chat_template(args)
    engine, served_name = build_engine_from_args(args, devices, tp_backend)
    return EngineHTTPServer((args.host, args.port),
                            EngineServer(
                                engine, served_name,
                                build_id=args.build_id,
                                drain_exit_timeout_s=args.drain_exit_timeout_s,
                                profile_dir=args.profile_dir,
                                pooling=args.pooling,
                                chat_template=chat_template))


def main(argv=None) -> None:
    args = parse_args(argv)
    if not is_coordinator(distributed_process(args)):
        # Workers never serve HTTP: they mirror process 0's steps and
        # exit when its shutdown record arrives.
        run_worker_from_args(args)
        return
    server = make_server(argv)
    # SIGTERM stops serving as a drain-exit does, so the tp workers
    # are released and joined on the way out.
    signal.signal(signal.SIGTERM, lambda *_: threading.Thread(
        target=server.shutdown, daemon=True).start())
    host, port = server.server_address[:2]
    cache = server.app.engine.config.cache
    logger.info("Serving %s on http://%s:%d (role %s, device %s, KV cache "
                "%s %s, %d pages of %d tokens)", server.app.model_name,
                host, port, server.app.engine.config.engine_role,
                server.app.engine.runner.device,
                cache.resolved_kv_dtype(), cache.cache_layout,
                cache.num_pages, cache.page_size)
    try:
        server.serve()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
