"""Context parallelism's dense forward: the whole model with the
sequence sharded over an sp group and the batch over a dp group, the
JAX package's ``parallel/context.py`` in the port.

Each rank takes its [B/dp, T/sp] slice of the tokens, with global
positions ``sp_idx * T/sp + arange(T/sp)``; norms, projections and the
MLP are local, and attention is ring attention (ops/ring_attention.py)
over the sp group. The logits are gathered along the sequence, then
along the batch, so every rank returns the [B, T, vocab] of JAX's
sharded output.

It is differentiable, as JAX's is under ``jax.grad``: while autograd
records, the ring's hops and the two gathers are the autograd
collectives of ``parallel/collectives.py`` (a replicated loss: every
rank computes the same scalar from the same gathered logits), and
``collectives.sync_grads(params, sp, dp)`` then sums each rank's share
of the weights' gradient, leaving every rank with the one-process
gradient of ``models/llama.forward_train`` on the whole batch. Like
JAX's dense forwards it has no tp axis.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.ops.ring_attention import ring_attention
from production_stack_tpu_torch.parallel.collectives import gather


def context_parallel_forward(params, config: ModelConfig,
                             tokens: torch.Tensor, sp,
                             dp: Optional[object] = None) -> torch.Tensor:
    """Dense causal forward of a llama-family model (the numerics of
    ``models/llama.forward_train`` with ring attention's online softmax)
    over the global ``tokens`` [B, T]: T divisible by the sp size, B by
    the dp size (``dp`` None: the batch whole on every rank). Returns
    f32 logits [B, T, vocab] on every rank."""
    n, idx = sp.size, sp.rank
    dn, didx = (1, 0) if dp is None else (dp.size, dp.rank)
    b, t = tokens.shape
    if t % n:
        raise ValueError(f"sequence {t} must divide by the sp size {n}")
    if b % dn:
        raise ValueError(f"batch {b} must divide by the dp size {dn}")
    tl, bl = t // n, b // dn
    positions = (idx * tl + torch.arange(tl, device=tokens.device)
                 )[None, :].expand(bl, tl)
    x = F.embedding(tokens[didx * bl:(didx + 1) * bl,
                           idx * tl:(idx + 1) * tl].long(), params.embed)
    for lp in params.layers:
        a_in = llama.attn_norm(config, lp, x)
        q, k, v = llama.attention_inputs(config, lp, a_in, positions, None,
                                         None, None)
        attn = ring_attention(q, k, v, sp, causal=True)
        x = x + lp.o(attn.reshape(bl, tl, -1))
        x = x + llama.mlp(config, lp, llama.mlp_norm(config, lp, x), None,
                          None, None)
    logits = gather(sp, llama.head(params, config, x), dim=1)
    return logits if dp is None else gather(dp, logits, dim=0)
