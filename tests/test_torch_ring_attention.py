"""Ring attention and the dense context-parallel forward in the port
against the JAX package's, on the CPU.

JAX runs ``ring_attention_sharded`` and ``context_parallel_forward``
on an sp mesh of the fake CPU devices (tests/conftest.py); the port
runs the same inputs (numpy, from a seed) over fake sp ranks, one
thread each (``parallel/collectives.FakeTPGroup``), every rank giving
its shard. Tolerance: f32 within 1e-5 (atol = rtol), the same block
math in the same order.

Also here: the ring's dense reference, the hops a call takes, the
groups' collectives (``shift``, ``masked_sum``, ``all_gather``) and the
rank layout of a dp x pp x sp x tp world against the JAX mesh's. The card's
checks are in tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from production_stack_tpu.engine.config import (
    tiny_model_config as jax_tiny_model_config,
)
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu.ops.ring_attention import ring_attention_sharded
from production_stack_tpu.parallel import topology as jax_topology
from production_stack_tpu.parallel.context import (
    context_parallel_forward as jax_context_parallel_forward,
)
from production_stack_tpu_torch.engine.config import tiny_model_config
from production_stack_tpu_torch.models.convert import params_from_numpy
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_dense,
)
from production_stack_tpu_torch.parallel.collectives import (
    FakeTPGroup,
    axis_ranks,
    fake_mesh,
    rank_coords,
    run_ranks,
)
from production_stack_tpu_torch.parallel.context import (
    context_parallel_forward,
)

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _sp_mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("sp",))


def _qkv(seed, b, t, hq, hkv, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, t, h, d).astype(np.float32)
                 for h in (hq, hkv, hkv))


def _ring(q, k, v, n, causal=True):
    """The port's ring over n fake sp ranks: the ranks' shards joined
    along the sequence."""
    tl = q.shape[1] // n
    groups = FakeTPGroup.world(n, axis="sp")
    outs = run_ranks(groups, lambda g: ring_attention(
        *(torch.from_numpy(x[:, g.rank * tl:(g.rank + 1) * tl])
          for x in (q, k, v)), g, causal=causal))
    return torch.cat(outs, dim=1).numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("gqa", [1, 2])
@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax(sp, gqa, causal):
    """The ring over fake sp ranks against JAX's sharded ring on its sp
    mesh, GQA and not, causal and not: f32 within 1e-5."""
    q, k, v = _qkv(sp * 10 + gqa, 2, 32, 4, 4 // gqa, 16)
    want = ring_attention_sharded(*(jnp.asarray(x) for x in (q, k, v)),
                                  _sp_mesh(sp), causal=causal)
    np.testing.assert_allclose(_ring(q, k, v, sp, causal),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_the_dense_reference_is_the_ring(causal):
    """``ring_attention_dense`` on one process against the ring at sp 4
    and against JAX's ring: f32 within 1e-5."""
    q, k, v = _qkv(7, 1, 48, 8, 2, 16)
    dense = ring_attention_dense(*(torch.from_numpy(x) for x in (q, k, v)),
                                 causal=causal).numpy()
    np.testing.assert_allclose(_ring(q, k, v, 4, causal), dense, **TOL)
    want = ring_attention_sharded(*(jnp.asarray(x) for x in (q, k, v)),
                                  _sp_mesh(4), causal=causal)
    np.testing.assert_allclose(dense, np.asarray(want), **TOL)


def test_a_ring_takes_n_minus_one_hops_with_k_and_v_together():
    """n blocks, n - 1 hops a rank (K and V in one collective; JAX's
    last hop, whose result it drops, is not taken); one sp rank none."""
    q, k, v = _qkv(3, 1, 16, 4, 2, 8)
    COUNTERS.reset()
    _ring(q, k, v, 4)
    assert COUNTERS.launches == {"sp_hop": 4 * 3}
    COUNTERS.reset()
    _ring(q, k, v, 1)
    assert COUNTERS.launches == {}


@pytest.mark.parametrize("sp", [2, 4])
def test_context_parallel_forward_matches_jax(sp):
    """The dense cp forward over fake sp ranks against JAX's on its sp
    mesh, the same tiny-llama weights (JAX's init carried across):
    every rank's logits [B, T, vocab] f32 within 1e-5 of JAX's, and the
    ranks' bitwise alike."""
    jcfg = jax_tiny_model_config("llama")
    np_params = {k: np.asarray(v) for k, v in jax_llama.init_params(
        jcfg, jax.random.PRNGKey(0)).items()}
    tokens = np.random.RandomState(2).randint(
        0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    want = jax_context_parallel_forward(
        {k: jnp.asarray(v) for k, v in np_params.items()}, jcfg,
        jnp.asarray(tokens), _sp_mesh(sp))
    cfg = tiny_model_config("llama")
    params = params_from_numpy(np_params, cfg, "cpu")
    outs = run_ranks(FakeTPGroup.world(sp, axis="sp"),
                     lambda g: context_parallel_forward(
                         params, cfg, torch.from_numpy(tokens), g))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), **TOL)
    assert all(torch.equal(outs[0], o) for o in outs[1:])


def test_context_parallel_forward_refuses_an_uneven_sequence():
    cfg = tiny_model_config("llama")
    params = params_from_numpy({k: np.asarray(v) for k, v in
                                jax_llama.init_params(
                                    jax_tiny_model_config("llama"),
                                    jax.random.PRNGKey(0)).items()},
                               cfg, "cpu")
    with pytest.raises(ValueError, match="must divide by the sp size"):
        run_ranks(FakeTPGroup.world(2, axis="sp"),
                  lambda g: context_parallel_forward(
                      params, cfg, torch.zeros((1, 15), dtype=torch.long),
                      g))


# ---- the groups -------------------------------------------------------------


def test_shift_masked_sum_and_gather_of_a_group():
    """``shift`` gives each rank its predecessor's tensor (JAX's
    ppermute i -> i + 1), ``masked_sum`` the keeping rank's on every
    rank, ``all_gather`` the rank-order join; each counted once under
    its axis."""
    groups = FakeTPGroup.world(3, axis="pp")
    COUNTERS.reset()
    outs = run_ranks(groups, lambda g: (
        g.shift(torch.full((2,), float(g.rank))),
        g.masked_sum(torch.full((2,), 10.0 + g.rank), g.rank == 2),
        g.all_gather(torch.full((1,), float(g.rank)), dim=0)))
    assert [o[0].tolist() for o in outs] == [[2.0] * 2, [0.0] * 2,
                                             [1.0] * 2]
    assert all(o[1].tolist() == [12.0, 12.0] for o in outs)
    assert all(o[2].tolist() == [0.0, 1.0, 2.0] for o in outs)
    assert COUNTERS.launches == {"pp_hop": 3, "pp_sum": 3,
                                 "pp_all_gather": 3}


@pytest.mark.parametrize("sizes", [dict(tp=2, pp=2), dict(tp=2, sp=2),
                                   dict(pp=4), dict(sp=2, tp=4),
                                   dict(dp=2, sp=2), dict(dp=2, sp=4),
                                   dict(dp=2, pp=2, tp=2),
                                   dict(dp=4, pp=2)])
def test_the_world_is_laid_out_as_the_jax_mesh(sizes):
    """Global rank r's (dp, pp, sp, tp) coordinates are those of device
    r of JAX's ``MeshPlan`` mesh (``build_mesh``'s, AXIS_ORDER (dp, pp,
    sp, tp)), tp fastest; each axis group is the JAX mesh's line along
    that axis; ``fake_mesh`` gives every rank its groups at those
    coordinates. dp defaults to 1: a serving world is laid out as
    before."""
    tp, pp, sp, dp = (sizes.get(a, 1) for a in ("tp", "pp", "sp", "dp"))
    jmesh = jax_topology.MeshPlan(tp=tp, dp=dp, pp=pp, sp=sp).build(
        jax_topology.discover_topology())
    assert jmesh.axis_names == ("dp", "pp", "sp", "tp")
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)  # [dp, pp, sp, tp]
    order = {int(i): r for r, i in enumerate(ids.reshape(-1))}
    for r in range(tp * pp * sp * dp):
        at = rank_coords(r, tp=tp, pp=pp, sp=sp, dp=dp)
        assert int(ids[at["dp"], at["pp"], at["sp"], at["tp"]]) == (
            ids.reshape(-1)[r])
        if dp == 1:
            assert rank_coords(r, tp=tp, pp=pp, sp=sp) == at
    axes = ("dp", "pp", "sp", "tp")
    mesh = fake_mesh(tp=tp, pp=pp, sp=sp, dp=dp)
    for j, axis in enumerate(axes):
        line = np.moveaxis(ids, j, -1).reshape(-1, ids.shape[j])
        want = sorted(sorted(order[int(i)] for i in row) for row in line)
        assert axis_ranks(axis, tp=tp, pp=pp, sp=sp, dp=dp) == want
        for ranks in want:
            views = [getattr(mesh[r], axis) for r in ranks]
            if len(ranks) == 1:
                assert views == [None]
            else:
                assert [v.rank for v in views] == list(range(len(ranks)))
                assert len({id(v._world) for v in views}) == 1
