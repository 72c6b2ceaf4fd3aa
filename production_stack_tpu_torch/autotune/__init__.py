"""Self-tuning serving: host-side controllers that close the
telemetry -> knob loop, the JAX package's ``autotune/`` in the port.

The engine-side controllers tick from the server's engine loop and
read the metrics registry and the observatory directly. Everything is
off by default (``--autotune off|shadow|on``). ``PoolSplitController``
(the JAX package's ``autotune/fleet.py``) is not here: it rides the
fleet autoscaler, which talks to engines over HTTP and so drives the
port's servers as they are."""

from production_stack_tpu_torch.autotune.controller import (
    MODES, Autotuner, Controller)
from production_stack_tpu_torch.autotune.controllers import (
    CheckpointIntervalController, KVEconController,
    PrefillBudgetController, QoSShedController, SpecKController,
    build_engine_controllers, observatory_drift_flags)
from production_stack_tpu_torch.autotune.guardrail import DriftGuardrail

__all__ = [
    "MODES",
    "Autotuner",
    "Controller",
    "DriftGuardrail",
    "SpecKController",
    "PrefillBudgetController",
    "KVEconController",
    "CheckpointIntervalController",
    "QoSShedController",
    "build_engine_controllers",
    "observatory_drift_flags",
]
