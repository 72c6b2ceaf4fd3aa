"""Topology discovery and declarative mesh planning, the JAX package's
``parallel/topology.py`` in the port.

The devices of a deployment group into **slices**: ICI domains on a TPU,
here the cards of one host, joined by NVLink. ``discover_topology``
groups the CUDA devices of this host (one slice), or the devices a
caller lists (the CPU ranks of the tests, or one card named twice for
two ranks that share it), and ``num_slices`` (or the
``PSTPU_NUM_SLICES`` variable) forces an even split, so a one-host rig
rehearses multi-slice layouts as in JAX. ``MeshPlan`` is the
declarative mesh: axis sizes plus per-axis placement ("ici" = must not
straddle a slice, "any" = may cross slices). It validates against the
topology, so a tp axis wider than a slice, or a plan that needs more
devices than exist, is a ``ValueError`` at start-up. ``build`` lays the
devices out slice-major in (dp, pp, sp, tp) order; the port serves the
tp axis (``tp_devices``: one device a rank). A multi-host world
(``--distributed``) has a slice a server process, or ``--num-slices``
of them (``process_slices``, ``slice_of_process``).

Pure Python beside ``torch.device``: no JAX, no collective.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

# Mesh axis order, outermost first: tp innermost so tensor-parallel
# collectives ride adjacent links; dp (pure replication) outermost.
AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "sp", "tp")

# Default per-axis placement: tensor-parallel and the sp ring want every
# hop inside one slice; pipeline hops and replica fan-out may cross.
DEFAULT_PLACEMENT: Dict[str, str] = {
    "dp": "any",
    "pp": "any",
    "sp": "ici",
    "tp": "ici",
}

# Forced slice count for rigs where discovery has nothing to go on
# (--num-slices on the server; the variable serves bare pytest).
_FAKE_SLICES_ENV = "PSTPU_NUM_SLICES"


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Devices grouped into slices, slice-major. ``source``: "forced"
    (a num_slices override), "flat" (one slice: one host's cards) or
    "process" (a multi-host world's server processes)."""

    slices: Tuple[Tuple[object, ...], ...]
    source: str = "flat"

    @property
    def num_slices(self) -> int:
        return len(self.slices)

    @property
    def slice_size(self) -> int:
        return len(self.slices[0]) if self.slices else 0

    @property
    def devices(self) -> Tuple[object, ...]:
        return tuple(d for s in self.slices for d in s)

    @property
    def num_devices(self) -> int:
        return sum(len(s) for s in self.slices)

    def slice_of(self, device) -> int:
        for i, group in enumerate(self.slices):
            if any(d is device or d == device for d in group):
                return i
        raise ValueError(f"device {device!r} not in this topology")

    def describe(self) -> str:
        return (f"{self.num_devices} devices in {self.num_slices} "
                f"slice(s) of {self.slice_size} ({self.source})")


def local_devices() -> list:
    """The CUDA devices of this host, in index order."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def discover_topology(devices: Optional[Sequence] = None,
                      num_slices: int = 0) -> DeviceTopology:
    """Group ``devices`` (default: this host's CUDA devices) into
    slices. An explicit ``num_slices`` (or PSTPU_NUM_SLICES) forces an
    even contiguous split; otherwise the host is one slice."""
    devices = local_devices() if devices is None else list(devices)
    if not devices:
        raise ValueError("discover_topology needs at least one device")
    if num_slices <= 0:
        num_slices = int(os.environ.get(_FAKE_SLICES_ENV, "0") or 0)
    if num_slices > 0:
        n = len(devices)
        if num_slices > n or n % num_slices:
            raise ValueError(
                f"num_slices={num_slices} must evenly divide the "
                f"{n} visible devices")
        size = n // num_slices
        return DeviceTopology(
            tuple(tuple(devices[i * size:(i + 1) * size])
                  for i in range(num_slices)),
            source="forced")
    return DeviceTopology((tuple(devices),), source="flat")


def process_slices(num_processes: int, num_slices: int = 0) -> int:
    """The slice count of a multi-host world of ``num_processes``
    server processes: ``num_slices`` (which must divide them), or with
    0 one slice a process, as JAX's discovery groups devices by
    process."""
    if num_slices <= 0:
        return num_processes
    if num_slices > num_processes or num_processes % num_slices:
        raise ValueError(f"num_slices={num_slices} must evenly divide the "
                         f"{num_processes} processes")
    return num_slices


def process_topology(num_processes: int, per_process: int,
                     num_slices: int = 0) -> DeviceTopology:
    """The topology of a multi-host world: ``per_process`` ranks on
    each of ``num_processes`` server processes, named (process, local
    index), grouped into ``process_slices`` slices, so that a
    ``MeshPlan`` is checked against the processes as JAX checks it
    against its process-grouped devices (an "ici" axis may not cross
    one)."""
    n = process_slices(num_processes, num_slices)
    devices = [(p, i) for p in range(num_processes)
               for i in range(per_process)]
    size = len(devices) // n
    return DeviceTopology(tuple(tuple(devices[i * size:(i + 1) * size])
                                for i in range(n)), source="process")


def slice_of_process(process_index: int, num_processes: int,
                     num_slices: int) -> int:
    """The slice of a process: processes map to slices contiguously,
    slice-major (JAX's ``MultihostStepBridge.slice_of_process``)."""
    n = max(1, num_processes)
    return min(num_slices - 1, process_index * num_slices // n)


def parse_placement(text: str) -> Dict[str, str]:
    """Parse a ``--mesh-placement`` override: "tp=ici,pp=any,...".
    "auto" (or empty) keeps DEFAULT_PLACEMENT; unknown axes and values
    are refused."""
    placement = dict(DEFAULT_PLACEMENT)
    if not text or text == "auto":
        return placement
    for entry in text.split(","):
        axis, _, where = entry.strip().partition("=")
        if axis not in AXIS_ORDER:
            raise ValueError(
                f"mesh_placement axis {axis!r} unknown "
                f"(axes: {'/'.join(AXIS_ORDER)})")
        if where not in ("ici", "any"):
            raise ValueError(
                f"mesh_placement for {axis!r} must be 'ici' or 'any' "
                f"(got {where!r})")
        placement[axis] = where
    return placement


@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """A built plan: ``devices`` [dp, pp, sp, tp] (an object array)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...] = AXIS_ORDER

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def tp_devices(self, dp: int = 0, pp: int = 0, sp: int = 0) -> list:
        """The devices of one tp group, rank order."""
        return list(self.devices[dp, pp, sp])

    def world_devices(self, dp: int = 0) -> list:
        """The devices of one replica's tp x sp x pp ranks, in global
        rank order ((pp, sp, tp), tp fastest:
        parallel/collectives.axis_ranks)."""
        return list(self.devices[dp].reshape(-1))


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """Declarative mesh: axis sizes + per-axis placement ("ici": the
    axis's contiguous device block must fit inside one slice; "any":
    may span slices)."""

    tp: int = 1
    dp: int = 1
    pp: int = 1
    sp: int = 1
    placement: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_PLACEMENT))

    def __post_init__(self):
        for axis in AXIS_ORDER:
            if getattr(self, axis) < 1:
                raise ValueError(f"MeshPlan.{axis} must be >= 1")
        for axis, where in self.placement.items():
            if axis not in AXIS_ORDER:
                raise ValueError(
                    f"MeshPlan placement axis {axis!r} unknown "
                    f"(axes: {'/'.join(AXIS_ORDER)})")
            if where not in ("ici", "any"):
                raise ValueError(
                    f"MeshPlan placement for {axis!r} must be 'ici' "
                    f"or 'any' (got {where!r})")

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {axis: getattr(self, axis) for axis in AXIS_ORDER}

    @property
    def num_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp

    def _inner_block(self, axis: str) -> int:
        """Contiguous device-block length ``axis`` spans: its own size
        times every axis inner to it (inner axes vary fastest)."""
        sizes = self.axis_sizes
        block = 1
        for a in reversed(AXIS_ORDER):
            block *= sizes[a]
            if a == axis:
                return block
        raise ValueError(f"unknown axis {axis!r}")

    def validate(self, topology: DeviceTopology) -> None:
        """Reject plans the topology cannot carry."""
        if self.num_devices > topology.num_devices:
            raise ValueError(
                f"MeshPlan needs {self.num_devices} devices, "
                f"topology has {topology.num_devices} "
                f"({topology.describe()})")
        sizes = {len(s) for s in topology.slices}
        if len(sizes) > 1:
            raise ValueError(
                "MeshPlan needs equal-size slices "
                f"(got sizes {sorted(sizes)})")
        slice_size = topology.slice_size
        for axis in AXIS_ORDER:
            where = self.placement.get(axis, DEFAULT_PLACEMENT[axis])
            if where != "ici" or getattr(self, axis) == 1:
                continue
            block = self._inner_block(axis)
            if block > slice_size or slice_size % block:
                raise ValueError(
                    f"MeshPlan axis '{axis}' (size "
                    f"{getattr(self, axis)}, contiguous block "
                    f"{block}) would straddle a slice boundary: "
                    f"slices are {slice_size} devices wide "
                    f"({topology.describe()}). Shrink the axis or "
                    f"place it 'any' to allow cross-slice hops.")

    def build(self, topology: Optional[DeviceTopology] = None
              ) -> DeviceGrid:
        """Validate against ``topology`` (default: discovered) and lay
        the devices out slice-major as [dp, pp, sp, tp]."""
        if topology is None:
            topology = discover_topology()
        self.validate(topology)
        grid = np.empty((self.num_devices,), dtype=object)
        grid[:] = list(topology.devices[: self.num_devices])
        return DeviceGrid(grid.reshape(self.dp, self.pp, self.sp, self.tp))
