"""The port's dense training forwards and their gradients against the
JAX package's, on the CPU.

JAX runs ``llama.forward_train``, ``context_parallel_forward`` on a
(dp, sp) mesh of the fake CPU devices (tests/conftest.py) and
``jax.grad`` of the loss ``mean(logits ** 2)``; the port runs
``models/llama.forward_train``, ``parallel/context.
context_parallel_forward`` and ``parallel/pipeline.pipeline_forward``
over fake ranks, one thread each (``parallel/collectives.fake_mesh``),
on the same weights (JAX's init carried across by
``models/convert.params_from_numpy``) and the same tokens (numpy, from
a seed), then ``backward`` of the same loss. The gradients go back to
JAX's layout through ``params_to_numpy`` and are held to ``jax.grad``'s
leaf by leaf at relative L2 1e-3 (ring attention's online softmax and
the dense softmax sum in different orders), on every rank after
``collectives.sync_grads``; logits at rtol = atol = 5e-4, JAX's own
tolerance for its cp forward.

Also here: ``params_to_numpy``'s round trip (bitwise), the reverse hops
a ring's backward takes (n - 1 a rank, none for one rank), and a
backward on the fake groups finishing well inside their barrier's
timeout (a rank that skipped a reverse hop would hold the others until
it broke).
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu.parallel.context import (
    context_parallel_forward as jax_context_parallel_forward,
)
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.convert import (
    params_from_numpy,
    params_to_numpy,
    stage_params_from_numpy,
)
from production_stack_tpu_torch.ops.paged_kv_common import COUNTERS
from production_stack_tpu_torch.ops.ring_attention import (
    ring_attention,
    ring_attention_dense,
)
from production_stack_tpu_torch.parallel import mesh
from production_stack_tpu_torch.parallel.collectives import (
    FakeTPGroup,
    fake_mesh,
    run_ranks,
    sync_grads,
)
from production_stack_tpu_torch.parallel.context import (
    context_parallel_forward,
)
from production_stack_tpu_torch.parallel.pipeline import pipeline_forward
from tests import test_torch_model_families as fam
from tests import test_torch_pipeline as pipe

torch.set_num_threads(2)

LOGITS_TOL = dict(rtol=5e-4, atol=5e-4)
REL_L2 = 1e-3


def _rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / np.linalg.norm(want))


def _hold(got: dict, want: dict, names=None, cut=slice(None)) -> None:
    """``got``'s leaves (``params_to_numpy`` of the gradients) within
    REL_L2 of ``want``'s (``jax.grad``'s; per-layer leaves at ``cut``),
    each also finite and non-zero."""
    names = sorted(want) if names is None else names
    assert names
    for k in names:
        w = np.asarray(want[k])
        if w.ndim and k not in ("embed", "lm_head", "final_norm"):
            w = w[cut]
        assert np.isfinite(got[k]).all() and np.abs(got[k]).sum() > 0, k
        assert _rel_l2(got[k], w) <= REL_L2, (k, _rel_l2(got[k], w))


def _loss(logits):
    return (logits ** 2).mean()


def _jax_grad(forward, np_params):
    """(logits, grads) of ``forward``, JAX's, on ``np_params``."""
    def loss(p):
        logits = forward(p)
        return jnp.mean(logits ** 2), logits

    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in np_params.items()})
    return np.asarray(logits), {k: np.asarray(v) for k, v in grads.items()}


def _tiny(arch):
    """(jax config, port config, JAX-layout weights) of tiny-llama, or
    of a qwen2 of its size (q/k/v biases, given values)."""
    jcfg, cfg = pipe._fam_configs(arch)
    return jcfg, cfg, fam._params("llama", jcfg)


def _tokens(seed, b, t, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(
        np.int32)


# ---- params_to_numpy ---------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama", "qwen2", "opt", "gpt2",
                                  "mixtral"])
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """JAX dict -> port params -> JAX dict, every leaf bitwise, for
    each family's fused projections, biases and expert layouts."""
    if arch == "qwen2":
        _, cfg, np_params = _tiny(arch)
    else:
        jcfg, cfg = fam._configs(arch)
        np_params = fam._params(arch, jcfg)
    back = params_to_numpy(params_from_numpy(np_params, cfg, "cpu"), cfg)
    assert sorted(back) == sorted(np_params)
    for k, v in np_params.items():
        assert back[k].dtype == v.dtype and np.array_equal(back[k], v), k


# ---- forward_train -----------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama", "qwen2"])
def test_forward_train_and_its_gradient_match_jax(arch):
    """``forward_train``'s f32 logits within 5e-4 of JAX's, and the
    gradient of mean(logits ** 2) within relative L2 1e-3 of
    ``jax.grad``'s on every leaf (qwen2: its q/k/v biases too)."""
    jcfg, cfg, np_params = _tiny(arch)
    tokens = _tokens(1, 2, 24, cfg.vocab_size)
    want, want_grads = _jax_grad(
        lambda p: jax_llama.forward_train(p, jcfg, jnp.asarray(tokens)),
        np_params)
    params = params_from_numpy(np_params, cfg, "cpu").requires_grad_(True)
    logits = llama.forward_train(params, cfg, torch.from_numpy(tokens))
    assert logits.dtype == torch.float32 and logits.requires_grad
    np.testing.assert_allclose(logits.detach().numpy(), want, **LOGITS_TOL)
    _loss(logits).backward()
    got = params_to_numpy(params, cfg, grad=True)
    _hold(got, want_grads)
    if arch == "qwen2":
        assert {"bq", "bk", "bv"} <= set(got)


def test_forward_train_without_grads_records_nothing():
    """Weights made as the engine makes them (no ``requires_grad``):
    the same logits, no graph."""
    _, cfg, np_params = _tiny("llama")
    tokens = torch.from_numpy(_tokens(1, 2, 24, cfg.vocab_size))
    params = params_from_numpy(np_params, cfg, "cpu")
    plain = llama.forward_train(params, cfg, tokens)
    assert not plain.requires_grad
    params.requires_grad_(True)
    assert torch.equal(plain, llama.forward_train(params, cfg,
                                                  tokens).detach())


# ---- context parallelism: sp and dp x sp --------------------------------------


def _cp_ranks(np_params, cfg, tokens, sp, dp):
    """Every rank's (logits, gradient dict after ``sync_grads``) of the
    port's cp forward over a fake dp x sp world."""
    def rank(g):
        params = params_from_numpy(np_params, cfg, "cpu").requires_grad_(
            True)
        logits = context_parallel_forward(params, cfg,
                                          torch.from_numpy(tokens), g.sp,
                                          g.dp)
        _loss(logits).backward()
        sync_grads(params, g.sp, g.dp)
        return logits.detach().numpy(), params_to_numpy(params, cfg,
                                                        grad=True)
    return run_ranks(fake_mesh(sp=sp, dp=dp), rank)


@pytest.mark.parametrize("dp,sp", [(1, 2), (1, 4), (2, 2)])
def test_context_parallel_gradients_match_jax(dp, sp):
    """cp forward and backward over fake dp x sp ranks against
    ``jax.grad`` through JAX's ``context_parallel_forward`` on the
    matching (dp, sp) mesh, tiny-llama (JAX's cp body has no q/k/v
    biases): every rank's logits within 5e-4 of JAX's, and every rank's
    gradient, after ``sync_grads`` over sp and dp, within relative L2
    1e-3 on every leaf; plus JAX's own check, finite and non-zero."""
    jcfg, cfg, np_params = _tiny("llama")
    tokens = _tokens(3, 2, 32, cfg.vocab_size)
    jmesh = Mesh(np.asarray(jax.devices()[:dp * sp]).reshape(dp, sp),
                 ("dp", "sp"))
    want, want_grads = _jax_grad(
        lambda p: jax_context_parallel_forward(p, jcfg, jnp.asarray(tokens),
                                               jmesh), np_params)
    gnorm = sum(float(np.abs(g).sum()) for g in want_grads.values())
    assert np.isfinite(gnorm) and gnorm > 0
    outs = _cp_ranks(np_params, cfg, tokens, sp, dp)
    assert len(outs) == dp * sp
    for logits, grads in outs:
        np.testing.assert_allclose(logits, want, **LOGITS_TOL)
        _hold(grads, want_grads)


def test_context_parallel_gradient_is_the_one_process_gradient():
    """qwen2 (its biases kept by the port's cp body) at dp 2 x sp 2:
    every rank's synced gradient is JAX ``forward_train``'s."""
    jcfg, cfg, np_params = _tiny("qwen2")
    tokens = _tokens(4, 2, 32, cfg.vocab_size)
    _, want_grads = _jax_grad(
        lambda p: jax_llama.forward_train(p, jcfg, jnp.asarray(tokens)),
        np_params)
    for _, grads in _cp_ranks(np_params, cfg, tokens, 2, 2):
        _hold(grads, want_grads)


@pytest.mark.parametrize("batch,seq,match", [
    (3, 32, "batch 3 must divide by the dp size 2"),
    (2, 30, "sequence 30 must divide by the sp size 4")])
def test_context_parallel_forward_refuses_uneven_shards(batch, seq, match):
    _, cfg, np_params = _tiny("llama")
    params = params_from_numpy(np_params, cfg, "cpu")
    dp = 2 if batch == 3 else 1
    with pytest.raises(ValueError, match=match):
        run_ranks(fake_mesh(sp=2 if dp == 2 else 4, dp=dp),
                  lambda g: context_parallel_forward(
                      params, cfg, torch.zeros((batch, seq),
                                               dtype=torch.long),
                      g.sp, g.dp))


# ---- pipeline parallelism ------------------------------------------------------


def _pp_ranks(np_params, cfg, tokens, pp, microbatches, timeout_s=60.0):
    """Every stage's ((lo, hi), logits, gradient dict) of the port's
    GPipe forward, each stage holding its layers only."""
    def rank(g):
        lo, hi = mesh.stage_layers(cfg.num_hidden_layers, g.pp.rank, pp)
        params = stage_params_from_numpy(np_params, cfg, (lo, hi),
                                         "cpu").requires_grad_(True)
        logits = pipeline_forward(params, cfg, torch.from_numpy(tokens),
                                  g.pp, num_microbatches=microbatches)
        _loss(logits).backward()
        return ((lo, hi), logits.detach().numpy(), params_to_numpy(
            params, dataclasses.replace(cfg, num_hidden_layers=hi - lo),
            grad=True))
    return run_ranks(fake_mesh(pp=pp, timeout_s=timeout_s), rank)


@pytest.mark.parametrize("microbatches", [2, 4])
def test_pipeline_gradients_match_jax(microbatches):
    """GPipe at pp 2 over fake stages against ``jax.grad`` of JAX
    ``forward_train``: each stage's gradient of its own layers (JAX's
    sliced), the final norm and head whole on every stage, the
    embedding on stage 0 (where it is gathered), within relative L2
    1e-3; every stage's logits within 5e-4."""
    jcfg, cfg = pipe._dense_configs(4)
    np_params = pipe._dense_params(jcfg, 0)
    tokens = _tokens(5, microbatches * 2, 16, cfg.vocab_size)
    want, want_grads = _jax_grad(
        lambda p: jax_llama.forward_train(p, jcfg, jnp.asarray(tokens)),
        np_params)
    layer_leaves = sorted(set(want_grads) - {"embed", "lm_head",
                                             "final_norm"})
    for stage, ((lo, hi), logits, grads) in enumerate(
            _pp_ranks(np_params, cfg, tokens, 2, microbatches)):
        np.testing.assert_allclose(logits, want, **LOGITS_TOL)
        _hold(grads, want_grads, layer_leaves, cut=slice(lo, hi))
        _hold(grads, want_grads, ["final_norm", "lm_head"]
              + (["embed"] if stage == 0 else []))


# ---- the backward collectives ---------------------------------------------------


@pytest.mark.parametrize("n", [4, 1])
def test_a_rings_backward_takes_n_minus_one_reverse_hops(n):
    """A ring under autograd: n - 1 hops a rank forward and as many
    reverse hops in its backward (none at one rank), and the gradient
    of q, k and v that of the dense reference."""
    rng = np.random.RandomState(6)
    q, k, v = (torch.from_numpy(rng.randn(1, 16, h, 8).astype(np.float32))
               for h in (4, 2, 2))
    tl = 16 // n

    def rank(g):
        parts = [x[:, g.rank * tl:(g.rank + 1) * tl].clone().requires_grad_(
            True) for x in (q, k, v)]
        (ring_attention(*parts, g) ** 2).sum().backward()
        return [p.grad for p in parts]

    COUNTERS.reset()
    grads = run_ranks(FakeTPGroup.world(n, axis="sp"), rank)
    counts = dict(COUNTERS.launches)
    COUNTERS.reset()
    want = {"sp_hop": n * (n - 1), "sp_hop_back": n * (n - 1)}
    assert counts == {k: c for k, c in want.items() if c}
    dense = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (ring_attention_dense(*dense) ** 2).sum().backward()
    for i, x in enumerate(dense):
        got = torch.cat([g[i] for g in grads], dim=1)
        assert _rel_l2(got.numpy(), x.grad.numpy()) <= REL_L2


@pytest.mark.parametrize("case", ["cp", "dp_cp", "pp"])
def test_a_backward_on_fake_groups_ends_well_inside_the_timeout(case):
    """Every rank takes every reverse hop, in one order (bubble ticks
    included under pp), so the backward ends in a small part of the
    barrier's 30 s timeout; the reverse hops equal the forward hops."""
    jcfg, cfg, np_params = _tiny("llama")
    COUNTERS.reset()
    t0 = time.perf_counter()
    if case == "pp":
        jcfg, cfg = pipe._dense_configs(4)
        np_params = pipe._dense_params(jcfg, 0)
        _pp_ranks(np_params, cfg, _tokens(7, 4, 16, cfg.vocab_size), 2, 2,
                  timeout_s=30.0)
    else:
        dp = 2 if case == "dp_cp" else 1

        def rank(g):
            params = params_from_numpy(np_params, cfg,
                                       "cpu").requires_grad_(True)
            _loss(context_parallel_forward(
                params, cfg, torch.from_numpy(_tokens(7, 2, 32, 512)), g.sp,
                g.dp)).backward()
        run_ranks(fake_mesh(sp=2, dp=dp, timeout_s=30.0), rank)
    wall = time.perf_counter() - t0
    counts = dict(COUNTERS.launches)
    COUNTERS.reset()
    axis = "pp" if case == "pp" else "sp"
    assert wall < 10.0, wall
    assert counts[f"{axis}_hop"] == counts[f"{axis}_hop_back"] > 0, counts
