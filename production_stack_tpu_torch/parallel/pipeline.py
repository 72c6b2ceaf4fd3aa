"""Pipeline parallelism's dense forward: layer stages over a pp group,
the JAX package's ``parallel/pipeline.py`` in the port.

A GPipe schedule of ``M + S - 1`` ticks over M microbatches and S
stages: at tick i stage s runs microbatch i - s (stage 0 embeds it
first), the stages hand their activations on with one hop a tick (the
group's ``shift``), and the last stage banks each finished microbatch.
The banked hidden states reach every stage by one masked sum, and every
stage returns the full logits (JAX returns them sharded over pp, one
block of microbatches a stage: the same [B, T, vocab]). The layer body
is the dense causal forward of ``models/llama.encode`` (f32 scores,
with the llama family's q/k/v biases where the config has them), the
numerics of JAX's ``_layer_block``.

It is differentiable, as JAX's is through ``ppermute`` and ``psum``:
while autograd records, the hops and the masked sum are the autograd
collectives of ``parallel/collectives.py`` (a replicated loss: every
stage computes the same scalar from the same logits), and one ``link``
threads every hop of the stage into the hidden states, so every stage's
backward takes every reverse hop, in reverse tick order, bubbles
included. Each stage's gradient then covers its own layers; the head's
(every stage computes it whole) is whole on every stage, and the
embedding's, gathered on stage 0 only, is whole there.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.parallel.collectives import (
    hop,
    masked_sum,
    recording,
)
from production_stack_tpu_torch.parallel.mesh import stage_layers


def gpipe_ticks(pp, microbatches: int, first: Callable[[int], torch.Tensor],
                layers: Callable[[torch.Tensor, int], torch.Tensor],
                bubble: Callable[[], torch.Tensor],
                link: Optional[torch.Tensor] = None):
    """The GPipe schedule on this rank's stage: M + S - 1 ticks, at tick
    i microbatch m = i - s through ``layers(x, m)``, ``x`` being
    ``first(m)`` on stage 0 and what the previous stage handed on
    otherwise; a bubble tick computes nothing and hands on ``bubble()``
    (every rank takes every hop, in one order; the hop after the last
    tick, whose result JAX discards, is not taken). Returns the last
    stage's outputs in microbatch order ([] on the other stages).

    ``link`` (training: a 0-dim tensor that requires grad) is threaded
    through every hop (``collectives.hop``) and returned beside the
    outputs, ``(banked, link)``; the caller adds it to what the stage's
    loss reads, so the stage's backward reaches every hop."""
    stages, stage = pp.size, pp.rank
    x_recv, banked = None, []
    ticks = microbatches + stages - 1
    for tick in range(ticks):
        m = tick - stage
        if 0 <= m < microbatches:
            x_out = layers(first(m) if stage == 0 else x_recv, m)
            if stage == stages - 1:
                banked.append(x_out)
        else:
            x_out = bubble()
        if tick < ticks - 1:
            if link is None:
                x_recv = hop(pp, x_out)
            else:
                x_recv, link = hop(pp, x_out, link)
    return banked if link is None else (banked, link)


def pipeline_forward(params, config: ModelConfig, tokens: torch.Tensor, pp,
                     num_microbatches: Optional[int] = None
                     ) -> torch.Tensor:
    """Dense causal forward of a llama-family model with its layers
    pipelined over ``pp``'s ranks.

    Args:
      params: the stage's ``LlamaParams`` (its L/S layers), or the whole
        model's, whose stage slice is then used.
      config: the whole model's config (L layers).
      tokens: [B, T]; B must divide by the microbatches.
      num_microbatches: M, default the pp size; must divide by it.

    Returns f32 logits [B, T, vocab] on every stage. Differentiable
    while autograd records on the stage's weights (the same on every
    stage: see the module docstring).
    """
    stages, stage = pp.size, pp.rank
    m_count = num_microbatches or stages
    b, t = tokens.shape
    if b % m_count:
        raise ValueError(f"batch {b} must divide by microbatches "
                         f"{m_count}")
    layers_total = config.num_hidden_layers
    if layers_total % stages:
        raise ValueError(f"layers {layers_total} must divide by pp size "
                         f"{stages}")
    if m_count % stages:
        raise ValueError(
            f"microbatches {m_count} must divide by pp size {stages} "
            "(outputs shard M over the stages)")
    layers = params.layers
    if len(layers) == layers_total and stages > 1:
        lo, hi = stage_layers(layers_total, stage, stages)
        layers = list(layers)[lo:hi]
    mb = b // m_count
    link = (torch.zeros((), dtype=params.embed.dtype, device=tokens.device,
                        requires_grad=True)
            if recording(*params.parameters()) else None)
    banked = gpipe_ticks(
        pp, m_count,
        lambda m: F.embedding(tokens[m * mb:(m + 1) * mb].long(),
                              params.embed),
        lambda x, m: llama.encode_layers(layers, config, x),
        lambda: torch.zeros((mb, t, config.hidden_size),
                            dtype=params.embed.dtype, device=tokens.device),
        link)
    if link is not None:
        banked, link = banked
    hidden = (torch.cat(banked) if banked else torch.zeros(
        (b, t, config.hidden_size), dtype=params.embed.dtype,
        device=tokens.device))
    if link is not None:
        hidden = hidden + link  # + 0: the chain of hops into the loss
    hidden = masked_sum(pp, hidden, stage == stages - 1)
    return llama.head(params, config, hidden)
