"""OpenAI-compatible HTTP server for the engine, on the standard library.

    python -m production_stack_tpu_torch.engine.server \\
        --model bench-1b --random-weights --page-size 128 --num-pages 512

Routes served, with the JSON shapes of the JAX engine's server: GET
``/health``, ``/v1/models`` and ``/metrics`` (the ``vllm:*`` names the
router scrapes; the compile ledger's
``vllm:engine_compile_{events,seconds}_total{kind}`` count the step
graphs' captures), POST ``/v1/completions`` and ``/v1/chat/completions``
(with and without ``stream``). That is 5 of the 24 routes the JAX
server registers. Each of the other 19 (``UNPORTED_ROUTES``: drain,
resume, disaggregation, embeddings, score, rerank, autotune, version,
KV summary, profiler and the debug ledgers) answers 501 with a message
naming its feature; a path neither server has answers 404.

Flags: 20 of the JAX server's 75, with the same names and meanings
(``parse_args``); the others are absent and argparse refuses them.
``--device`` is the port's own (the card unless ``cpu`` is asked for).

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
> n, out-of-range values, and a ``model`` other than the served one
(LoRA adapters are not served).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import queue
import threading
import time
import uuid
from http import HTTPStatus
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from production_stack_tpu_torch.engine.config import (
    CacheConfig,
    EngineConfig,
    SchedulerConfig,
    bench_1b_model_config,
    tiny_model_config,
)
from production_stack_tpu_torch.engine.engine import LLMEngine, StepOutput
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.engine.step_graphs import (
    EAGER_REASONS,
    STEP_KINDS,
)
from production_stack_tpu_torch.engine.tokenizer import (
    BenchTokenizer,
    render_chat_prompt,
)
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.utils.log import init_logger

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
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="engine-loop")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wakeup.set()
        self._thread.join(timeout=30)

    def _run(self) -> None:
        while not self._stop.is_set():
            block = not self.engine.has_work()
            try:
                item = self._submit_q.get(block=block,
                                          timeout=0.2 if block else None)
            except queue.Empty:
                item = None
            if item is not None:
                seq_id, prompt, sampling = item
                try:
                    self.engine.add_request(prompt, sampling,
                                            seq_id=seq_id)
                except Exception as e:
                    # Queue full / invalid request: fail THIS request,
                    # never the loop.
                    logger.warning("Rejecting %s: %s", seq_id, e)
                    self._emit(StepOutput(seq_id, None, True, "abort"))
                continue  # admit as many as possible before stepping
            if not self.engine.has_work():
                continue
            try:
                outputs = self.engine.step()
            except Exception:
                logger.exception("Engine step failed")
                self._wakeup.wait(0.05)
                self._wakeup.clear()
                continue
            if not outputs:
                self._wakeup.wait(0.002)
                self._wakeup.clear()
            for out in outputs:
                self._emit(out)

    def _emit(self, out: StepOutput) -> None:
        stream = self._streams.get(out.seq_id)
        if stream is not None:
            stream[0].put((stream[1], out))

    def submit(self, prompt: List[int], samplings: List[SamplingParams]
               ) -> Tuple[List[str], "queue.Queue"]:
        """One engine request a sampling, over the shared prompt;
        returns their sequence ids and the queue of their (index,
        StepOutput) pairs."""
        stream: "queue.Queue" = queue.Queue()
        seq_ids = []
        for i, sampling in enumerate(samplings):
            seq_id = f"seq-{uuid.uuid4().hex[:16]}"
            self._streams[seq_id] = (stream, i)
            self._submit_q.put((seq_id, prompt, sampling))
            seq_ids.append(seq_id)
        self._wakeup.set()
        return seq_ids, stream

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


# ---- the server ------------------------------------------------------------


class EngineServer:
    """The request handlers, independent of the HTTP transport."""

    def __init__(self, engine: LLMEngine, served_model_name: str):
        self.engine = engine
        self.loop = EngineLoop(engine)
        self.model_name = served_model_name
        self.tokenizer = engine.tokenizer
        self._active = 0
        self._active_lock = threading.Lock()

    def health(self) -> dict:
        return {"status": "ok", "role": "both", "draining": False,
                "active_requests": self._active, "build_id": ""}

    def models(self) -> dict:
        return {"object": "list", "data": [{
            "id": self.model_name, "object": "model",
            "created": int(self.loop.uptime_start),
            "owned_by": "production-stack-tpu"}]}

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
        lines += self._graph_metrics()
        lines += self.engine.metrics.render()
        lines.append("")
        return "\n".join(lines)

    def _graph_metrics(self) -> List[str]:
        """The JAX server's compile ledger under its names, types and
        ``kind`` labels, counting the step graphs' captures and their
        seconds (warm-up included); every kind at 0 where nothing was
        captured (the CPU has no graphs). Then the steps the card ran
        without a graph, by reason."""
        graphs = self.engine.runner.graphs
        events = graphs.captures if graphs else dict.fromkeys(STEP_KINDS, 0)
        seconds = (graphs.capture_seconds if graphs
                   else dict.fromkeys(STEP_KINDS, 0.0))
        eager = (graphs.eager_steps if graphs
                 else dict.fromkeys(EAGER_REASONS, 0))
        lines = ["# TYPE vllm:engine_compile_events_total counter"]
        lines += [f'vllm:engine_compile_events_total{{kind="{kind}"}} '
                  f"{float(n)}" for kind, n in sorted(events.items())]
        lines.append("# TYPE vllm:engine_compile_seconds_total counter")
        lines += [f'vllm:engine_compile_seconds_total{{kind="{kind}"}} '
                  f"{float(s)}" for kind, s in sorted(seconds.items())]
        lines.append("# TYPE vllm:engine_eager_steps_total counter")
        lines += [f'vllm:engine_eager_steps_total{{reason="{reason}"}} '
                  f"{float(n)}" for reason, n in sorted(eager.items())]
        return lines

    def parse_completion(self, body: dict, chat: bool):
        """-> (prompt ids, prompt text or None, sampling); raises
        BadRequest."""
        if chat:
            messages = body.get("messages")
            if not isinstance(messages, list):
                raise BadRequest("'messages' must be a list")
            prompt, prompt_text = render_chat_prompt(
                self.tokenizer, messages), None
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
        requested = body.get("model")
        if requested is not None and requested != self.model_name:
            raise BadRequest(
                f"model {requested!r} is not served here (serving "
                f"{self.model_name!r}; LoRA adapters are not supported "
                "by this engine yet)")
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

    def run_choices(self, prompt: List[int],
                    samplings: List[SamplingParams], choices: List[Choice]):
        """Submit one engine request a choice and yield ``(index, text,
        logprob entries)`` as each choice releases them, then ``(index,
        None, None)`` when that choice is done. Closing the generator
        early (a client that went away) aborts every choice still
        running."""
        seq_ids, stream = self.loop.submit(prompt, samplings)
        left = len(seq_ids)
        with self._active_lock:
            self._active += 1
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
            with self._active_lock:
                self._active -= 1

    def complete(self, body: dict, chat: bool):
        """A request's response: ``(status, dict)`` for a whole answer,
        or ``(200, iterator of SSE byte frames)`` for ``stream``."""
        try:
            prompt, prompt_text, sampling = self.parse_completion(body,
                                                                  chat)
            n, best_of, stream = self._choice_counts(body, chat)
            echo = bool(body.get("echo")) and not chat
            if echo and sampling.logprobs:
                raise BadRequest("'echo' with 'logprobs' (prompt "
                                 "logprobs) is not supported")
        except (BadRequest, TypeError, ValueError) as e:
            return 400, {"error": {"message": str(e),
                                   "type": "invalid_request_error"}}
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

        def envelope(obj: str, out: list, **extra) -> dict:
            return {"id": rid, "object": obj, "created": created,
                    "model": self.model_name, "choices": out, **extra}

        if stream:
            return 200, self._stream(envelope, chat, echo_text, prompt,
                                     samplings, choices, requested_lp,
                                     body.get("stream_options"))
        for _ in self.run_choices(prompt, samplings, choices):
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
                             usage=_usage(len(prompt), completion_tokens))

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

    def _stream(self, envelope, chat, echo_text, prompt, samplings,
                choices, with_logprobs, stream_opts):
        obj = "chat.completion.chunk" if chat else "text_completion"

        def frame(payload) -> bytes:
            return f"data: {json.dumps(payload)}\n\n".encode()

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
            return frame(envelope(obj, [choice]))

        for i in range(len(choices)):
            if chat:
                yield chunk(i, None, None, first=True)
            elif echo_text:
                yield chunk(i, echo_text, None)
        events = self.run_choices(prompt, samplings, choices)
        try:
            for i, text, entries in events:
                if text is None:
                    yield chunk(i, None, choices[i].finish_reason)
                else:
                    yield chunk(i, text, None, entries=entries)
        finally:
            events.close()
        if isinstance(stream_opts, dict) and stream_opts.get(
                "include_usage"):
            yield frame(envelope(obj, [], usage=_usage(
                len(prompt), sum(c.n_tokens for c in choices))))
        yield b"data: [DONE]\n\n"


# The JAX server's routes this server does not serve: (method, path,
# feature). A path ending in "/" is a prefix (the JAX server's
# /debug/trace/{request_id}).
UNPORTED_ROUTES = (
    ("POST", "/v1/disagg/prefill", "disaggregated prefill"),
    ("POST", "/v1/disagg/handoff", "disaggregated KV handoff"),
    ("POST", "/v1/resume", "crash-recovery resume"),
    ("POST", "/drain", "rollout drain"),
    ("POST", "/v1/embeddings", "embeddings"),
    ("POST", "/v1/score", "scoring"),
    ("POST", "/score", "scoring"),
    ("POST", "/v1/rerank", "reranking"),
    ("POST", "/rerank", "reranking"),
    ("GET", "/version", "build version"),
    ("GET", "/kv/summary", "KV cache summary"),
    ("GET", "/autotune/status", "autotuning"),
    ("POST", "/autotune/reset", "autotuning"),
    ("POST", "/debug/profiler/start", "device profiler"),
    ("POST", "/debug/profiler/stop", "device profiler"),
    ("GET", "/debug/trace/", "request traces"),
    ("GET", "/debug/steps", "step ledger"),
    ("GET", "/debug/compiles", "compile ledger"),
    ("GET", "/debug/memory", "memory ledger"),
)


def unported_feature(method: str, path: str) -> Optional[str]:
    """The feature of a JAX-server route this server does not serve,
    or None."""
    for m, route, feature in UNPORTED_ROUTES:
        prefix = route.endswith("/")
        if m == method and (path.startswith(route) and len(path) > len(route)
                            if prefix else path == route):
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

    def _send(self, status: int, body, content_type="application/json"):
        data = (json.dumps(body) if isinstance(body, dict)
                else body).encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        app = self.server.app
        path = self.path.split("?", 1)[0]
        if path == "/health":
            self._send(200, app.health())
        elif path == "/v1/models":
            self._send(200, app.models())
        elif path == "/metrics":
            self._send(200, app.metrics(), "text/plain; version=0.0.4")
        else:
            self._no_route("GET", path)

    def do_POST(self):
        app = self.server.app
        path = self.path.split("?", 1)[0]
        if path not in ("/v1/completions", "/v1/chat/completions"):
            self._no_route("POST", path)
            return
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(length) or b"null")
        except (ValueError, json.JSONDecodeError):
            body = None
        if not isinstance(body, dict):
            self._send(400, {"error": {
                "message": "Request body must be a JSON object",
                "type": "invalid_request_error"}})
            return
        status, result = app.complete(body,
                                      chat=path == "/v1/chat/completions")
        if isinstance(result, dict):
            self._send(status, result)
            return
        # Server-sent events; the connection closes at the end.
        self.send_response(HTTPStatus.OK)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        self.close_connection = True
        try:
            for frame in result:
                self.wfile.write(frame)
                self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass  # client gone
        finally:
            result.close()  # aborts the sequence if it did not finish


class EngineHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address, app: EngineServer):
        super().__init__(address, _Handler)
        self.app = app

    def serve(self) -> None:
        """Start the engine loop and serve until ``shutdown()``."""
        self.app.loop.start()
        try:
            self.serve_forever(poll_interval=0.2)
        finally:
            self.app.loop.stop()
            self.server_close()


# ---- construction -----------------------------------------------------------


def _resolve(flag: str, eligible: bool = True) -> bool:
    """--async-scheduling / --unified-step auto|on|off: 'auto' is on
    where the JAX engine's 'auto' turns the feature on, else off; an
    explicit 'on' is honoured. The port serves one model on one device,
    so 'auto' turns the unified step on always and the async pipeline
    on for single-step decode without --speculative-k (the JAX
    engine's async_scheduling_eligible: a burst already amortizes the
    host round trip, and a verify step's commit count is
    data-dependent)."""
    return flag == "on" or (flag == "auto" and eligible)


def build_engine_from_args(args) -> tuple:
    if args.model == "tiny-llama":
        model_config = tiny_model_config("llama")
    elif args.model == "bench-1b":
        model_config = bench_1b_model_config()
    else:
        raise NotImplementedError(
            f"--model {args.model!r}: the port serves tiny-llama and "
            "bench-1b with random weights; checkpoint loading is not "
            "ported yet")
    config = EngineConfig(
        model=model_config,
        cache=CacheConfig(page_size=args.page_size,
                          num_pages=args.num_pages,
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
                eligible=args.decode_steps <= 1 and args.speculative_k == 0),
            unified_step=_resolve(args.unified_step),
            speculative_k=args.speculative_k,
            speculative_min_match=args.speculative_min_match,
            max_queue_len=args.max_queue_len),
        seed=args.seed,
    )
    engine = LLMEngine(config,
                       tokenizer=BenchTokenizer(model_config.vocab_size),
                       device=args.device)
    return engine, args.served_model_name or args.model


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="tpu-engine-torch")
    p.add_argument("--model", default="tiny-llama",
                   choices=["tiny-llama", "bench-1b"])
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--random-weights", action="store_true",
                   help="accepted for parity: both models are built "
                        "from random weights (seeded by --seed)")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; with no card and no "
                        "--device cpu the server refuses to start")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=512)
    p.add_argument("--kv-cache-dtype", default="auto",
                   choices=["auto", "bf16", "int8"],
                   help="KV page storage: auto/bf16 keep the model's "
                        "dtype; int8 quantizes on write (one f32 scale "
                        "per slot) and spends the same device bytes on "
                        "about 1.9x the pages; on the card it needs a "
                        "page size that is a multiple of 16")
    p.add_argument("--cache-layout", default="auto",
                   choices=["auto", "stacked", "per_layer"],
                   help="KV cache device layout: one stacked [L, ...] "
                        "buffer per k/v, a list of per-layer buffers, or "
                        "auto (per_layer: the JAX engine's rule, which "
                        "picks stacked only under pipeline or context "
                        "parallelism)")
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
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def make_server(argv=None) -> EngineHTTPServer:
    """Build the engine and bind the HTTP server (not yet serving)."""
    args = parse_args(argv)
    engine, served_name = build_engine_from_args(args)
    return EngineHTTPServer((args.host, args.port),
                            EngineServer(engine, served_name))


def main(argv=None) -> None:
    server = make_server(argv)
    host, port = server.server_address[:2]
    cache = server.app.engine.config.cache
    logger.info("Serving %s on http://%s:%d (device %s, KV cache %s %s, "
                "%d pages of %d tokens)", server.app.model_name, host,
                port, server.app.engine.runner.device,
                cache.resolved_kv_dtype(), cache.cache_layout,
                cache.num_pages, cache.page_size)
    try:
        server.serve()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
