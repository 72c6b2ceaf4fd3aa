"""The port's topology discovery and mesh plan against the JAX
package's (``tests/test_topology.py``'s cases), and the port's server
tp flags resolving through them.

JAX runs on the 8 fake CPU devices of tests/conftest.py; the port is
given 8 CPU ranks (its ``discover_topology`` groups the devices it is
given, or this host's CUDA devices). Each case runs both and compares
what they return or the error they raise.
"""

import numpy as np
import pytest
import torch

import jax

from production_stack_tpu.engine.config import (
    ParallelConfig as JaxParallelConfig,
)
from production_stack_tpu.parallel import topology as jax_topology
from production_stack_tpu_torch.engine.config import ParallelConfig
from production_stack_tpu_torch.engine.server import parse_args, tp_devices
from production_stack_tpu_torch.parallel import topology

CPU_RANKS = [torch.device("cpu", i) for i in range(8)]


def _both(fn_jax, fn_port):
    """(JAX result or error, port result or error)."""
    out = []
    for fn in (fn_jax, fn_port):
        try:
            out.append(fn())
        except ValueError as exc:
            out.append(exc)
    return out


def _shape(topo):
    return (topo.source, topo.num_slices, topo.slice_size,
            tuple(len(s) for s in topo.slices))


def test_axis_order_and_default_placement_are_jaxs():
    assert topology.AXIS_ORDER == jax_topology.AXIS_ORDER
    assert topology.DEFAULT_PLACEMENT == jax_topology.DEFAULT_PLACEMENT


@pytest.mark.parametrize("num_slices", [0, 1, 2, 4, 8, 3, 16])
def test_discovery_partitions_as_jax(num_slices):
    theirs, ours = _both(
        lambda: jax_topology.discover_topology(num_slices=num_slices),
        lambda: topology.discover_topology(CPU_RANKS,
                                           num_slices=num_slices))
    if isinstance(theirs, Exception):
        assert isinstance(ours, ValueError)
        assert "evenly divide" in str(theirs) and "evenly divide" in str(ours)
        return
    assert _shape(ours) == _shape(theirs)
    # Slice-major: the first slice holds the first devices.
    assert ours.slice_of(CPU_RANKS[0]) == theirs.slice_of(jax.devices()[0])
    assert ours.slice_of(CPU_RANKS[7]) == theirs.slice_of(jax.devices()[7])


def test_forced_slices_env_var(monkeypatch):
    monkeypatch.setenv("PSTPU_NUM_SLICES", "4")
    assert (_shape(topology.discover_topology(CPU_RANKS))
            == _shape(jax_topology.discover_topology()))


def test_discovery_needs_a_device():
    with pytest.raises(ValueError, match="at least one device"):
        topology.discover_topology([])


@pytest.mark.parametrize("text", ["auto", "", "pp=ici, dp=any", "tp=any",
                                  "ep=ici", "tp=dcn", "sp=any,tp=ici"])
def test_parse_placement_is_jaxs(text):
    theirs, ours = _both(lambda: jax_topology.parse_placement(text),
                         lambda: topology.parse_placement(text))
    if isinstance(theirs, Exception):
        assert type(ours) is type(theirs) and str(ours) == str(theirs)
    else:
        assert ours == theirs


PLANS = [
    ({"tp": 8}, 2, {}), ({"tp": 8}, 2, {"tp": "any"}),
    ({"dp": 2, "tp": 4}, 2, {}), ({"dp": 2, "tp": 8}, 2, {"tp": "any"}),
    ({"tp": 2}, 2, {}), ({"tp": 4}, 0, {}), ({"pp": 2, "tp": 4}, 2, {}),
    ({"pp": 2, "tp": 2}, 4, {"pp": "ici"}), ({"sp": 2, "tp": 2}, 4, {}),
]


@pytest.mark.parametrize("sizes,num_slices,placement", PLANS)
def test_plan_validates_and_builds_as_jax(sizes, num_slices, placement):
    place = {**topology.DEFAULT_PLACEMENT, **placement}
    theirs, ours = _both(
        lambda: jax_topology.MeshPlan(**sizes, placement=place).build(
            jax_topology.discover_topology(num_slices=num_slices)),
        lambda: topology.MeshPlan(**sizes, placement=place).build(
            topology.discover_topology(CPU_RANKS, num_slices=num_slices)))
    if isinstance(theirs, Exception):
        assert isinstance(ours, ValueError)
        # The same rule refuses it (the message names the port's cross-
        # slice hops where JAX's names DCN).
        assert str(ours).split(":")[0] == str(theirs).split(":")[0]
        return
    assert ours.axis_names == theirs.axis_names
    assert ours.devices.shape == theirs.devices.shape
    index = {d: i for i, d in enumerate(CPU_RANKS)}
    jax_index = {d: i for i, d in enumerate(jax.devices())}
    assert (np.vectorize(index.get)(ours.devices).tolist()
            == np.vectorize(jax_index.get)(theirs.devices).tolist())


def test_plan_field_refusals_are_jaxs():
    for kwargs in ({"tp": 0}, {"placement": {"ep": "ici"}},
                   {"placement": {"tp": "dcn"}}):
        with pytest.raises(ValueError) as jax_exc:
            jax_topology.MeshPlan(**kwargs)
        with pytest.raises(ValueError) as port_exc:
            topology.MeshPlan(**kwargs)
        assert str(port_exc.value) == str(jax_exc.value)


def test_parallel_config_validates_topology_fields():
    for kwargs, field in (({"num_slices": -1}, "num_slices"),
                          ({"mesh_placement": "bogus=ici"},
                           "mesh_placement")):
        with pytest.raises(ValueError, match=field):
            JaxParallelConfig(**kwargs)
        with pytest.raises(ValueError, match=field):
            ParallelConfig(**kwargs)
    ParallelConfig(num_slices=2, mesh_placement="tp=ici")
    with pytest.raises(ValueError, match="tensor_parallel_size"):
        ParallelConfig(tensor_parallel_size=0)


@pytest.mark.parametrize("argv,want", [
    (["--tensor-parallel-size", "2"], 2),
    (["--tensor-parallel-size", "4", "--num-slices", "2"], "straddle"),
    (["--tensor-parallel-size", "4", "--num-slices", "2",
      "--mesh-placement", "tp=any"], 4),
    (["--tensor-parallel-size", "2", "--num-slices", "3"], "evenly divide"),
    (["--tensor-parallel-size", "2", "--mesh-placement", "tp=dcn"],
     "must be 'ici' or 'any'"),
])
def test_server_flags_resolve_through_the_plan(argv, want):
    """--tensor-parallel-size, --num-slices and --mesh-placement on the
    CPU: one rank a CPU device, refused where the JAX mesh is."""
    args = parse_args(["--device", "cpu"] + argv)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            tp_devices(args, torch.device("cpu"))
    else:
        assert len(tp_devices(args, torch.device("cpu"))) == want


def test_a_plan_wider_than_the_cards_is_refused():
    """On the card the devices are this host's CUDA devices: a plan
    that needs more is a ValueError, as JAX's is."""
    plan = topology.MeshPlan(tp=2)
    with pytest.raises(ValueError, match="needs 2 devices"):
        plan.build(topology.discover_topology([torch.device("cuda", 0)]))
