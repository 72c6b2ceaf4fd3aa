"""The engine-side controller catalog, the JAX package's
``autotune/controllers.py`` in the port.

Five closed loops over knobs the stack already reads live each step —
per-sequence speculative k, the unified-step prefill token budget,
kvecon admission/watermarks, the checkpoint interval, and the QoS
shed gate. Every knob is host-side state (dataclass fields, scheduler
attributes, per-sequence caps): a budget only truncates a chunk into
the unified [R, W] lattice, a draft cap only shortens drafts inside
the fixed [B, K + 1] verify block, so no decision captures a step
graph outside the existing keys.

``build_engine_controllers(server)`` wires the catalog to a live
EngineServer; tests construct controllers directly against fakes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from production_stack_tpu_torch.autotune.controller import Controller


class HistogramWindow:
    """Windowed quantiles over an engine/metrics.py Histogram: diffs
    the cumulative bucket counts between calls and returns the bucket
    upper edge at the requested rank — cheap, host-side, and exactly
    the resolution the dead-band needs."""

    def __init__(self, hist):
        self.hist = hist
        self._counts = list(hist.counts)
        self._n = hist.n

    def quantile(self, q: float) -> Tuple[Optional[float], int]:
        """(approximate q-quantile over the window, window count)."""
        counts = list(self.hist.counts)
        n = self.hist.n
        delta = [c - p for c, p in zip(counts, self._counts)]
        dn = n - self._n
        self._counts, self._n = counts, n
        if dn <= 0:
            return None, 0
        rank = q * dn
        cum = 0
        for i, c in enumerate(delta):
            cum += c
            if cum >= rank and c > 0:
                if i < len(self.hist.buckets):
                    return self.hist.buckets[i], dn
                break
        # +inf tail: report past the last finite edge.
        return self.hist.buckets[-1] * 2.0, dn


class SpecKController(Controller):
    """(1) Per-sequence speculative k from observed per-seq
    acceptance. Shrinks a row's draft cap when its windowed
    acceptance is low (wasted verify slots), grows it back toward the
    ``--speculative-k`` ceiling when acceptance is high. The cap
    rides ``seq.spec_k_cap`` — a bound the proposer applies to the
    existing non-shape draft inputs, so the verify block keeps its
    [B, K + 1] graph. Knob scalar = mean cap over running rows."""

    name = "spec_k"
    LOW_ACCEPT = 0.4
    HIGH_ACCEPT = 0.7
    MIN_WINDOW_DRAFTED = 4

    def __init__(self, engine, cfg):
        super().__init__(lo=cfg.min_spec_k,
                         hi=max(cfg.min_spec_k,
                                engine.config.scheduler.speculative_k))
        self.engine = engine
        self._seen: Dict[str, Tuple[int, int]] = {}
        self._window: Dict[str, Tuple[int, int]] = {}

    def enabled(self) -> bool:
        return self.engine.config.scheduler.speculative_k > 0

    def observe(self) -> Optional[float]:
        running = list(self.engine.scheduler.running)
        total_d = total_a = 0
        self._window = {}
        seen_now: Dict[str, Tuple[int, int]] = {}
        for seq in running:
            d = seq.spec_drafted_total
            a = seq.spec_accepted_total
            pd, pa = self._seen.get(seq.seq_id, (0, 0))
            seen_now[seq.seq_id] = (d, a)
            wd, wa = d - pd, a - pa
            if wd > 0:
                self._window[seq.seq_id] = (wd, wa)
                total_d += wd
                total_a += wa
        self._seen = seen_now  # finished rows fall out of the window
        if total_d < self.MIN_WINDOW_DRAFTED:
            return None
        return total_a / total_d

    def current(self) -> float:
        caps = [seq.spec_k_cap
                for seq in self.engine.scheduler.running
                if seq.spec_k_cap is not None]
        if not caps:
            return self.hi
        return sum(caps) / len(caps)

    def propose(self, signal: float) -> Optional[float]:
        cur = self.current()
        if signal < self.LOW_ACCEPT:
            return cur - 1.0
        if signal > self.HIGH_ACCEPT:
            return cur + 1.0
        return None

    def apply(self, target: float) -> None:
        # Per-sequence: each row moves by ITS OWN windowed acceptance;
        # rows without enough window data drift toward the mean
        # target so new arrivals converge too.
        for seq in self.engine.scheduler.running:
            cap = (seq.spec_k_cap if seq.spec_k_cap is not None
                   else int(self.hi))
            wd, wa = self._window.get(seq.seq_id, (0, 0))
            if wd >= 2:
                acc = wa / wd
                if acc < self.LOW_ACCEPT:
                    cap -= 1
                elif acc > self.HIGH_ACCEPT:
                    cap += 1
            elif target > cap:
                cap += 1
            elif target < cap:
                cap -= 1
            seq.spec_k_cap = int(self.clamp(cap))


class PrefillBudgetController(Controller):
    """(2) Unified-step prefill token budget from decode ITL
    headroom. While the windowed ITL p99 has slack against the target
    (``--autotune-target-itl-ms``), grow mixed-step prefill admission
    one chunk at a time toward the static full-bandwidth budget;
    shrink when p99 exceeds the target. The budget is a host-side
    scheduler attribute that only narrows chunk selection inside the
    unified [R, W] lattice the step graphs already key."""

    name = "prefill_budget"
    MIN_WINDOW_TOKENS = 8

    def __init__(self, engine, cfg):
        sched = engine.config.scheduler
        self.chunk = sched.prefill_chunk_size
        super().__init__(
            lo=self.chunk,
            hi=self.chunk * sched.prefill_batch_size)
        self.engine = engine
        self.target_itl_s = cfg.target_itl_ms / 1000.0
        self._win = HistogramWindow(engine.metrics.itl)

    def enabled(self) -> bool:
        return (self.engine.config.scheduler.unified_step
                and self.target_itl_s > 0)

    def observe(self) -> Optional[float]:
        p99, n = self._win.quantile(0.99)
        if p99 is None or n < self.MIN_WINDOW_TOKENS:
            return None
        return p99

    def current(self) -> float:
        return float(self.engine.scheduler.mixed_prefill_budget)

    def propose(self, p99: float) -> Optional[float]:
        cur = self.current()
        if p99 > self.target_itl_s:
            return cur - self.chunk
        if p99 < 0.5 * self.target_itl_s:
            return cur + self.chunk
        return None

    def apply(self, target: float) -> None:
        self.engine.scheduler.mixed_prefill_budget = int(
            self.clamp(target))


class KVEconController(Controller):
    """(3) kvecon admission floor and offload-pool watermarks from
    measured hit rate vs free-page headroom. Under page pressure with
    a weak windowed hit rate, tighten the summary's admission floor
    (fewer speculative hot-chain advertisements) and pull the host
    pool watermarks down so eviction runs earlier; with ample
    headroom and a paying hit rate, relax both back toward the
    configured statics. Knob scalar = ``admit_hits``."""

    name = "kvecon"
    LOW_HEADROOM = 0.15
    HIGH_HEADROOM = 0.5
    PAYING_HIT_RATE = 0.2
    WATERMARK_STEP = 0.05
    WATERMARK_FLOOR = 0.5

    def __init__(self, engine, kv_summary, cfg):
        super().__init__(lo=1.0, hi=8.0)
        self.engine = engine
        self.kv_summary = kv_summary
        self._prev_hits = 0
        self._prev_queries = 0
        self._hit_rate = 0.0

    def observe(self) -> Optional[float]:
        cm = self.engine.cache_manager
        total = max(1, cm.config.num_pages - 1)
        headroom = cm.num_free_pages / total
        hits = cm.prefix_hit_tokens
        queries = cm.prefix_query_tokens
        dq = queries - self._prev_queries
        dh = hits - self._prev_hits
        self._prev_hits, self._prev_queries = hits, queries
        if dq > 0:
            self._hit_rate = dh / dq
        return headroom

    def current(self) -> float:
        return float(self.kv_summary.admit_hits)

    def propose(self, headroom: float) -> Optional[float]:
        cur = self.current()
        if headroom < self.LOW_HEADROOM:
            return cur + 1.0
        if (headroom > self.HIGH_HEADROOM
                and self._hit_rate >= self.PAYING_HIT_RATE):
            return cur - 1.0
        return None

    def apply(self, target: float) -> None:
        tightening = target > self.current()
        self.kv_summary.admit_hits = int(self.clamp(target))
        offload = self.engine.offload
        pool = getattr(offload, "host", None) if offload else None
        if pool is None:
            return
        kve = self.engine.config.kvecon
        step = (-self.WATERMARK_STEP if tightening
                else self.WATERMARK_STEP)
        high = min(kve.watermark_high,
                   max(self.WATERMARK_FLOOR,
                       pool.watermark_high + step))
        low = min(kve.watermark_low,
                  max(self.WATERMARK_FLOOR - self.WATERMARK_STEP,
                      pool.watermark_low + step))
        pool.watermark_high = max(high, low)
        pool.watermark_low = min(high, low)


class CheckpointIntervalController(Controller):
    """(4) Checkpoint interval from observed crash/resume rates. A
    resume arriving means a stream actually crashed somewhere and had
    to replay from its last checkpoint — halve the interval so the
    next crash loses less. Quiet windows let the interval relax back
    up (doubling) toward the configured ceiling, shedding the
    ship-per-N-tokens overhead."""

    name = "checkpoint_interval"
    QUIET_TICKS_TO_RELAX = 5

    def __init__(self, engine, cfg):
        super().__init__(lo=cfg.min_checkpoint_interval_tokens,
                         hi=cfg.max_checkpoint_interval_tokens)
        self.engine = engine
        self._prev_resumes: Optional[int] = None
        self._quiet_ticks = 0

    def enabled(self) -> bool:
        return self.engine.config.checkpoint_interval_tokens > 0

    def observe(self) -> Optional[float]:
        resumes = self.engine.stream_resumes
        prev, self._prev_resumes = self._prev_resumes, resumes
        if prev is None:
            return None
        return float(resumes - prev)

    def current(self) -> float:
        return float(self.engine.config.checkpoint_interval_tokens)

    def propose(self, resume_delta: float) -> Optional[float]:
        cur = self.current()
        if resume_delta > 0:
            self._quiet_ticks = 0
            return cur / 2.0
        self._quiet_ticks += 1
        if self._quiet_ticks >= self.QUIET_TICKS_TO_RELAX:
            self._quiet_ticks = 0
            return cur * 2.0
        return None

    def apply(self, target: float) -> None:
        self.engine.config.checkpoint_interval_tokens = int(
            self.clamp(target))


class QoSShedController(Controller):
    """(5) QoS shed threshold and degrade-ladder clamp from measured
    queue drain rate. A queue that keeps growing while already deep
    means admission outruns drain: pull the shed gate earlier (shed
    sooner, keep interactive latency) and clamp the degrade ladder —
    non-interactive rows lose their speculative slots engine-wide
    (the same ``spec_off`` semantics the router's per-request header
    uses). A draining queue relaxes both back to the configured
    statics."""

    name = "qos_shed"
    DEEP_FRACTION = 0.25
    SHALLOW_FRACTION = 0.1
    STEP = 0.05

    def __init__(self, engine, cfg):
        super().__init__(lo=cfg.min_shed_threshold,
                         hi=engine.config.qos.shed_threshold)
        self.engine = engine
        self._prev_waiting: Optional[int] = None
        self._waiting = 0

    def observe(self) -> Optional[float]:
        waiting = self.engine.scheduler.num_waiting
        prev, self._prev_waiting = self._prev_waiting, waiting
        self._waiting = waiting
        if prev is None:
            return None
        return float(waiting - prev)

    def current(self) -> float:
        return float(self.engine.config.qos.shed_threshold)

    def propose(self, growth: float) -> Optional[float]:
        cur = self.current()
        max_queue = max(1, self.engine.config.scheduler.max_queue_len)
        depth = self._waiting / max_queue
        if growth > 0 and depth > self.DEEP_FRACTION:
            return cur - self.STEP
        if growth <= 0 and depth < self.SHALLOW_FRACTION:
            return cur + self.STEP
        return None

    def apply(self, target: float) -> None:
        value = self.clamp(target)
        self.engine.config.qos.shed_threshold = value
        # Degrade ladder clamp: while the gate sits below the
        # configured static, the engine is in degrade — spend no
        # speculative slack on non-interactive rows.
        self.engine.scheduler.spec_degrade_clamp = (
            value < self.hi - 1e-9)


def build_engine_controllers(server, cfg) -> list:
    """The full catalog wired to a live EngineServer; the Autotuner
    drops entries whose ``enabled()`` says the feature is off."""
    engine = server.engine
    return [
        SpecKController(engine, cfg),
        PrefillBudgetController(engine, cfg),
        KVEconController(engine, server.kv_summary, cfg),
        CheckpointIntervalController(engine, cfg),
        QoSShedController(engine, cfg),
    ]


def observatory_drift_flags(runner, band: float = 0.25):
    """Engine-local drift signal for the guardrail: the first
    non-zero step-time median per kind becomes the baseline; a median
    later exceeding baseline * (1 + band) flags that kind — the same
    median-vs-band shape as the router's perf-drift sentinel
    (obs/drift.py), minus the baseline file."""
    baseline: Dict[str, float] = {}

    def flags() -> Dict[str, float]:
        obs = getattr(runner, "observatory", None)
        if obs is None:
            return {}
        out: Dict[str, float] = {}
        for kind, median in obs.step_time_medians().items():
            if median <= 0:
                continue
            base = baseline.setdefault(kind, median)
            out[kind] = 1.0 if median > base * (1.0 + band) else 0.0
        return out

    return flags
