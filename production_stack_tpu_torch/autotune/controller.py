"""Self-tuning controller framework, the JAX package's
``autotune/controller.py`` in the port.

Host-side closed-loop tuning: every knob a controller touches rides a
non-shape input or the existing bucket lattices of the step graphs
(engine/step_graphs.py), so a decision never captures a graph key
outside them — ``tests/test_torch_autotune.py`` and ``chip_smoke.py``'s
autotune phase hold the capture ledger to that.

One ``Autotuner`` owns a set of ``Controller`` objects and ticks them
on a bounded cadence from the engine loop (or any host loop). Each
tick runs the controller's observe -> propose -> apply pipeline:

- ``observe()`` reads the controller's telemetry signal (windowed —
  controllers keep their own last-snapshot state); None = no signal
  yet, skip this tick;
- ``propose(signal)`` turns the signal into a target knob value
  (None = hold); the framework clamps it to the controller's
  [lo, hi] band and drops it inside the relative dead-band;
- ``apply(target)`` writes the knob — only in ``on`` mode and only
  while the drift guardrail has not frozen the controller.

Every surviving decision — applied or shadow — is emitted as an
``autotune_decision`` span event on a synthetic span of the engine's
tracer (engine/tracing.py; the watchdog-trip pattern), which is the
whole A/B story: run ``shadow`` next to ``on`` and diff the span
logs.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Callable, Dict, List, Optional

from production_stack_tpu_torch.autotune.guardrail import DriftGuardrail
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

MODES = ("off", "shadow", "on")


class Controller:
    """One closed-loop knob: a name, a clamp band, and the
    observe/propose/apply triplet. Subclasses hold references to the
    live objects whose attributes they tune (scheduler, configs, the
    KV summary tracker) — all host-side dataclass fields read fresh
    each step, never graph shapes."""

    name = "controller"

    def __init__(self, lo: float, hi: float):
        if lo > hi:
            raise ValueError(
                f"controller {self.name}: lo {lo} > hi {hi}")
        self.lo = float(lo)
        self.hi = float(hi)

    def enabled(self) -> bool:
        """False when the tuned feature is off (no spec decoding, no
        checkpointing, ...) — the autotuner then drops the
        controller entirely."""
        return True

    def observe(self) -> Optional[float]:
        raise NotImplementedError

    def current(self) -> float:
        raise NotImplementedError

    def propose(self, signal: float) -> Optional[float]:
        raise NotImplementedError

    def apply(self, target: float) -> None:
        raise NotImplementedError

    def clamp(self, value: float) -> float:
        return min(self.hi, max(self.lo, value))


class Autotuner:
    """Ticks controllers on a bounded cadence and enforces the shared
    policy: mode gating, dead-band, clamps, guardrail freezes, span
    emission, and the decision/knob counters behind the
    ``vllm:autotune_*`` metrics."""

    def __init__(self, config, controllers: List[Controller],
                 tracer=None,
                 clock: Callable[[], float] = time.monotonic,
                 drift_flags: Optional[
                     Callable[[], Dict[str, float]]] = None,
                 burn_rate: Optional[Callable[[], float]] = None):
        self.config = config
        self.mode = config.mode
        selected = _parse_selection(config.controllers)
        self.controllers = [
            c for c in controllers
            if c.enabled() and (selected is None or c.name in selected)
        ]
        self.tracer = tracer
        self.clock = clock
        self.guardrail = DriftGuardrail(
            freeze_window_s=config.freeze_window_s,
            burn_threshold=config.burn_threshold,
            drift_flags=drift_flags, burn_rate=burn_rate, clock=clock)
        self._next_tick: Optional[float] = None
        self._lock = threading.Lock()
        self.decisions_total: Dict[str, int] = {
            c.name: 0 for c in self.controllers}
        self.applied_total: Dict[str, int] = {
            c.name: 0 for c in self.controllers}

    # -- cadence ------------------------------------------------------------

    def maybe_tick(self) -> bool:
        """Called from the host loop every iteration; runs one tick
        when the cadence interval has elapsed. Cheap no-op in
        ``off`` mode and between ticks."""
        if self.mode == "off" or not self.controllers:
            return False
        now = self.clock()
        if self._next_tick is not None and now < self._next_tick:
            return False
        self._next_tick = now + self.config.interval_s
        self.tick(now)
        return True

    def tick(self, now: Optional[float] = None) -> None:
        """One observe -> propose -> apply pass over every
        controller. Exceptions in a controller are contained — a
        broken tuner must never take down the engine loop."""
        now = self.clock() if now is None else now
        with self._lock:
            newly = self.guardrail.scan(now)
            for name in newly:
                logger.warning(
                    "autotune: controller %s FROZEN (perf drift / "
                    "burn rise within %.0fs of its decisions); "
                    "latched until POST /autotune/reset",
                    name, self.guardrail.freeze_window_s)
            for c in self.controllers:
                try:
                    self._tick_one(c, now)
                except Exception:
                    logger.exception(
                        "autotune: controller %s tick failed", c.name)

    def _tick_one(self, c: Controller, now: float) -> None:
        signal = c.observe()
        if signal is None:
            return
        target = c.propose(signal)
        if target is None:
            return
        target = c.clamp(target)
        current = c.current()
        if self._within_dead_band(current, target):
            return
        frozen = self.guardrail.is_frozen(c.name)
        applied = False
        if self.mode == "on" and not frozen:
            c.apply(target)
            applied = True
            self.applied_total[c.name] += 1
            self.guardrail.note_applied(c.name, now)
        self.decisions_total[c.name] += 1
        self._emit_span(c, signal, current, target, applied, frozen)

    def _within_dead_band(self, current: float,
                          target: float) -> bool:
        band = self.config.dead_band * max(abs(current), 1e-9)
        return abs(target - current) <= band

    def _emit_span(self, c: Controller, signal: float,
                   current: float, target: float, applied: bool,
                   frozen: bool) -> None:
        if self.tracer is None:
            return
        # Synthetic span (the watchdog-trip pattern): decisions show
        # up in traceview next to the requests they affected.
        sid = f"autotune-{uuid.uuid4().hex[:12]}"
        self.tracer.start(sid, prompt_tokens=0)
        self.tracer.event(
            sid, "autotune_decision", controller=c.name,
            mode=self.mode, signal=round(float(signal), 6),
            current=round(float(current), 6),
            target=round(float(target), 6),
            applied=applied, frozen=frozen)
        self.tracer.finish(sid, reason="autotune")

    # -- observability surface ----------------------------------------------

    def active_count(self) -> int:
        """Controllers currently allowed to act: 0 in off/shadow
        mode (nothing is being applied), unfrozen count in on."""
        if self.mode != "on":
            return 0
        return sum(1 for c in self.controllers
                   if not self.guardrail.is_frozen(c.name))

    def frozen_flags(self) -> Dict[str, bool]:
        return {c.name: self.guardrail.is_frozen(c.name)
                for c in self.controllers}

    def knob_values(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for c in self.controllers:
            try:
                out[c.name] = float(c.current())
            except Exception:
                out[c.name] = 0.0
        return out

    def status(self) -> dict:
        """The GET /autotune/status payload."""
        knobs = self.knob_values()
        return {
            "mode": self.mode,
            "interval_s": self.config.interval_s,
            "active_controllers": self.active_count(),
            "controllers": [
                {
                    "name": c.name,
                    "knob": knobs.get(c.name, 0.0),
                    "lo": c.lo,
                    "hi": c.hi,
                    "frozen": self.guardrail.is_frozen(c.name),
                    "decisions": self.decisions_total[c.name],
                    "applied": self.applied_total[c.name],
                }
                for c in self.controllers
            ],
        }

    def reset(self, controller: Optional[str] = None) -> List[str]:
        with self._lock:
            return self.guardrail.reset(controller)


def _parse_selection(spec: str) -> Optional[set]:
    """``--autotune-controllers`` value -> name set (None = all)."""
    spec = (spec or "all").strip()
    if spec in ("", "all"):
        return None
    return {name.strip() for name in spec.split(",") if name.strip()}
