"""Engine-side request tracing: per-request event timelines, a step
flight recorder, and JSON span lines in the format of the router's
spans (``production_stack_tpu/router/tracing.py``).

The port's copy of the JAX engine's ``engine/tracing.py``, standard
library only, with the same event vocabulary (``SPAN_EVENTS``) and the
same span-line format, so ``python -m production_stack_tpu.traceview``
stitches the port's lines with the router's as it stitches the JAX
engine's.

The router's span stops at the proxy boundary; this module picks the
request up inside the engine, keyed by the router's ``x-request-id``
header, and records what aggregate histograms cannot show for one
request: enqueue, the AWAITING_KV park and restore, each prefill chunk,
the first token, preemption, an offload restore, the handoff ship, the
finish reason. Two sinks:

- an optional JSON-line span log (``--request-span-log``; ``-`` logs
  through the process logger): one ``{"span": "engine_request"}`` line
  per finished request;
- a flight recorder, on whenever a tracer is installed: bounded rings
  of recent request timelines and per-step records, served at
  ``/debug/trace/{request_id}`` and ``/debug/steps``.

Concurrency: the engine's step thread, the HTTP handler threads and the
drain path all touch the tracer. Every mutation is a dict or
``deque(maxlen=...)`` operation, atomic under the interpreter lock: no
lock is taken on the step or token path.

Disabled cost: the engine holds ``tracer = None`` unless one is
installed; every emission site is behind an ``is None`` check, so an
untraced engine allocates no span object on its step path.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

# The closed vocabulary of engine span event names, the JAX engine's
# tuple as it is (the port emits a subset: it has no crash respawn;
# the autotuner's decisions are autotune_decision events on spans of
# their own).
SPAN_EVENTS = (
    "enqueue",
    "awaiting_kv_park",
    "awaiting_kv_restore",
    "offload_restore",
    "prefill_chunk",
    "first_token",
    "preempt",
    "preempt_offload",
    "qos_shed",
    "handoff_ship",
    "profiler_start",
    "profiler_stop",
    "checkpoint_ship",
    "resume_restore",
    "migrate_ship",
    "watchdog_trip",
    "crash_respawn",
    "autotune_decision",
    "finish",
)


def _ms(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None or b is None:
        return None
    return round((b - a) * 1e3, 2)


class EngineSpan:
    """One request's event timeline inside a single engine process."""

    __slots__ = ("seq_id", "request_id", "role", "start_ts", "events",
                 "summary")

    def __init__(self, seq_id: str, request_id: Optional[str],
                 role: str = "both"):
        self.seq_id = seq_id
        self.request_id = request_id
        self.role = role
        self.start_ts = time.time()
        self.events: List[Dict[str, Any]] = []
        self.summary: Dict[str, Any] = {}

    def event(self, name: str, **fields: Any) -> None:
        record: Dict[str, Any] = {"event": name,
                                  "ts": round(time.time(), 6)}
        if fields:
            record.update(fields)
        self.events.append(record)

    def to_dict(self) -> Dict[str, Any]:
        data: Dict[str, Any] = {
            "span": "engine_request",
            "request_id": self.request_id,
            "seq_id": self.seq_id,
            "role": self.role,
            "arrival_ts": round(self.start_ts, 6),
        }
        data.update(self.summary)
        data["events"] = self.events
        return data

    def to_json(self) -> str:
        return json.dumps(self.to_dict())


class _SpanSink:
    """Line-buffered JSON-line sink, same contract as the router's
    SpanLogger: path ``-`` routes through the process logger."""

    def __init__(self, path: str):
        self._lock = threading.Lock()
        self._fh = None
        if path != "-":
            self._fh = open(path, "a", buffering=1)

    def emit(self, line: str) -> None:
        if self._fh is None:
            logger.info("engine-span %s", line)
            return
        with self._lock:
            self._fh.write(line + "\n")


class EngineTracer:
    """Per-request timelines + step flight recorder for one engine.

    Installed on ``LLMEngine.tracer`` (and mirrored onto
    ``Scheduler.tracer``); every caller guards with ``is None`` so an
    engine without a tracer pays nothing.
    """

    def __init__(self, span_log_path: Optional[str] = None,
                 ring_size: int = 256, step_ring_size: int = 512,
                 role: str = "both"):
        self.role = role
        self._live: Dict[str, EngineSpan] = {}
        self._ring: deque = deque(maxlen=max(1, int(ring_size)))
        self._steps: deque = deque(maxlen=max(1, int(step_ring_size)))
        self._step_ids = itertools.count()
        self._sink = (_SpanSink(span_log_path)
                      if span_log_path else None)

    # -- request timeline ---------------------------------------------------

    def start(self, seq_id: str, request_id: Optional[str] = None,
              **fields: Any) -> None:
        span = EngineSpan(seq_id, request_id, role=self.role)
        span.event("enqueue", **fields)
        self._live[seq_id] = span

    def event(self, seq_id: str, name: str, **fields: Any) -> None:
        span = self._live.get(seq_id)
        if span is not None:
            span.event(name, **fields)

    def finish(self, seq_id: str, reason: Optional[str] = None, *,
               arrival_ts: Optional[float] = None,
               first_scheduled_ts: Optional[float] = None,
               first_token_ts: Optional[float] = None,
               finish_ts: Optional[float] = None,
               prompt_tokens: Optional[int] = None,
               output_tokens: Optional[int] = None) -> None:
        """Finalizes a live span: appends the terminal event, derives
        the phase durations, emits the JSON line, and moves the span
        into the flight-recorder ring. Idempotent per seq_id (abort
        and the finished-output drain can race to it)."""
        span = self._live.pop(seq_id, None)
        if span is None:
            return
        span.event("finish", reason=reason)
        arrival = arrival_ts if arrival_ts is not None else span.start_ts
        end = finish_ts if finish_ts is not None else time.time()
        span.summary = {
            "finish_reason": reason,
            "prompt_tokens": prompt_tokens,
            "output_tokens": output_tokens,
            "queue_ms": _ms(arrival, first_scheduled_ts),
            "ttft_ms": _ms(arrival, first_token_ts),
            "decode_ms": _ms(first_token_ts, end),
            "latency_ms": _ms(arrival, end),
        }
        self._ring.append(span)
        if self._sink is not None:
            self._sink.emit(span.to_json())

    # -- step flight recorder -----------------------------------------------

    def on_step(self, **fields: Any) -> None:
        record: Dict[str, Any] = {"step": next(self._step_ids),
                                  "ts": round(time.time(), 6)}
        record.update(fields)
        self._steps.append(record)

    def recent_steps(self, limit: int = 100) -> List[Dict[str, Any]]:
        steps = list(self._steps)
        if limit > 0:
            steps = steps[-limit:]
        return steps

    # -- lookup -------------------------------------------------------------

    def lookup(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """All recorded timelines for one ``x-request-id`` (or engine
        seq id) — live spans first, then the ring, oldest first."""
        spans = [span for span in
                 list(self._live.values()) + list(self._ring)
                 if trace_id in (span.seq_id, span.request_id)]
        if not spans:
            return None
        return {"request_id": trace_id,
                "spans": [s.to_dict() for s in spans]}
