"""QoS types of the engine side: priority classes, their header, and
the shed gate's Retry-After.

The port's copy of the engine-facing part of
``production_stack_tpu/qos/__init__.py`` (docs/qos.md): the router
stamps a priority class on every request (``x-priority``), the
engine's scheduler admits waiting sequences in priority-then-arrival
order and picks the lowest-priority, newest victim under page
pressure, and the server sheds non-interactive requests under queue
pressure. The router's token buckets and fairness index stay with the
router. Standard library only.
"""

from __future__ import annotations

import enum
from typing import Dict

# Carried end to end: client -> router -> engine. The engine server
# maps it to Sequence.priority.
PRIORITY_HEADER = "x-priority"

# Degradation-ladder hint: the router sets this on requests it admits
# in degraded mode; the engine skips speculative drafting for them.
SPEC_OFF_HEADER = "x-qos-spec-off"


class Priority(enum.IntEnum):
    """Request priority class. Lower value = more important, so
    ``(seq.priority, seq.arrival_time)`` sorts admission order and
    ``max()`` over the same tuple picks the preemption victim."""

    INTERACTIVE = 0
    BATCH = 1
    BACKGROUND = 2


PRIORITY_NAMES = tuple(p.name.lower() for p in Priority)

# Unlabeled traffic lands in the middle class: sheddable under
# overload, but ahead of explicit background work.
DEFAULT_PRIORITY = Priority.BATCH


def parse_priority(name: str) -> Priority:
    """'interactive' | 'batch' | 'background' -> Priority.

    Raises ValueError on anything else (the server answers 400; the
    engine config re-raises it for --default-priority typos)."""
    try:
        return Priority[str(name).strip().upper()]
    except KeyError:
        raise ValueError(
            f"invalid priority {name!r} (expected one of: "
            f"{', '.join(PRIORITY_NAMES)})")


def shed_retry_after_s(queue_depth: int, service_rate: float) -> int:
    """Retry-After for a shed request: the time the current queue needs
    to drain at the given service rate, floored at 1 s."""
    if service_rate <= 0:
        return 1
    return max(1, int(round(queue_depth / service_rate)))


def priority_name(priority: "Priority | int") -> str:
    return Priority(int(priority)).name.lower()


def shed_counter_dict() -> Dict[str, int]:
    """Zeroed per-class shed counter (a stable label set for metrics)."""
    return {name: 0 for name in PRIORITY_NAMES}
