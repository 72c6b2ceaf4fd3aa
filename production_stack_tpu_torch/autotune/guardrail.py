"""Drift-sentinel guardrail for self-tuning controllers.

A controller that keeps "optimizing" while the engine is actually
regressing is worse than a static knob: it chases noise and amplifies
the regression. The guardrail watches the same signals an operator
would page on — the perf-drift sentinel's per-phase flags
(``vllm:perf_drift``-family, obs/drift.py) and the 5-minute SLO burn
rate — and when either degrades, it FREEZES every controller whose
applied decisions fall inside the recent blame window. Frozen state
is latched (``vllm:autotune_frozen{controller}`` stays 1) until an
operator resets it via ``POST /autotune/reset``; a frozen controller
keeps observing and span-logging in shadow, but never applies again.

Signals are injected as callables so the same guardrail serves the
engine loop (observatory step-time medians), the fleet controller
(autoscaler one-scrape burn rate) and the tests (fake everything,
fake clock). The JAX package's ``autotune/guardrail.py`` in the
port.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional


class DriftGuardrail:
    """Freeze controllers whose recent decisions correlate with a
    perf-drift flip or a rising SLO burn.

    ``drift_flags`` returns ``{phase: 0.0|1.0}`` (a flag going
    0 -> 1 between scans is a trip); ``burn_rate`` returns the
    current 5m burn (a rise to/above ``burn_threshold`` between
    scans is a trip). Either may be None/empty — absent signals
    never trip."""

    def __init__(self, freeze_window_s: float = 30.0,
                 burn_threshold: float = 1.0,
                 drift_flags: Optional[
                     Callable[[], Dict[str, float]]] = None,
                 burn_rate: Optional[Callable[[], float]] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.freeze_window_s = float(freeze_window_s)
        self.burn_threshold = float(burn_threshold)
        self.drift_flags = drift_flags
        self.burn_rate = burn_rate
        self.clock = clock
        self._last_flags: Dict[str, float] = {}
        self._last_burn: Optional[float] = None
        # controller -> wall time of its most recent APPLIED decision
        # (shadow decisions carry no blame: they changed nothing).
        self._recent: Dict[str, float] = {}
        # controller -> freeze time; membership IS the latch.
        self._frozen: Dict[str, float] = {}

    def note_applied(self, controller: str,
                     now: Optional[float] = None) -> None:
        self._recent[controller] = (self.clock() if now is None
                                    else now)

    def scan(self, now: Optional[float] = None) -> List[str]:
        """Evaluate the signals once; returns newly frozen names."""
        now = self.clock() if now is None else now
        tripped = self._tripped()
        if not tripped:
            return []
        newly: List[str] = []
        for name, ts in self._recent.items():
            if (now - ts <= self.freeze_window_s
                    and name not in self._frozen):
                self._frozen[name] = now
                newly.append(name)
        return newly

    def _tripped(self) -> bool:
        tripped = False
        flags: Dict[str, float] = {}
        if self.drift_flags is not None:
            try:
                flags = dict(self.drift_flags() or {})
            except Exception:
                flags = {}
            for phase, val in flags.items():
                if val and not self._last_flags.get(phase, 0.0):
                    tripped = True
            self._last_flags = flags
        if self.burn_rate is not None:
            try:
                burn = float(self.burn_rate())
            except Exception:
                burn = None
            if burn is not None:
                if (self._last_burn is not None
                        and burn > self._last_burn
                        and burn >= self.burn_threshold):
                    tripped = True
                self._last_burn = burn
        return tripped

    def is_frozen(self, controller: str) -> bool:
        return controller in self._frozen

    def frozen(self) -> Dict[str, float]:
        """{controller: freeze wall time} for every latched freeze."""
        return dict(self._frozen)

    def reset(self, controller: Optional[str] = None) -> List[str]:
        """Operator reset: unlatch one controller (or all). The blame
        window restarts too, so the next scan cannot re-freeze on the
        decisions that caused the trip."""
        if controller is None:
            cleared = sorted(self._frozen)
            self._frozen.clear()
            self._recent.clear()
            return cleared
        if controller in self._frozen:
            del self._frozen[controller]
            self._recent.pop(controller, None)
            return [controller]
        return []
