"""Pipeline-parallel serving forward: the engine's paged forward staged
over the ranks of a pp group, the JAX package's
``parallel/pipeline_serving.py`` in the port.

Each stage holds L/S layers, those layers' slice of the stacked cache
([L/S, kv, pages, d, page]) and of the adapter stacks, plus the
embedding, the final norm and the head (parallel/mesh.py); the stage's
kernels see its local layer index (the models' ``decoder_layers``), so
every attention call is the main path's stacked-form kernel of the step
kind. ``pp_paged_forward`` has the models' forward contract
(models/llama.forward) with the rank's pp group added:

- The batch is padded to a multiple of S rows so that there are M = S
  microbatches (JAX's rule); pad rows are ``valid`` False and adapter
  slot 0, and are cut off the logits.
- M + S - 1 ticks: at tick i stage s runs microbatch i - s, embedding
  it first on stage 0 and taking the activations the previous stage
  sent otherwise; between ticks every stage hands its output to the
  next (the group's ``shift``, JAX's ``ppermute`` i -> i + 1). A bubble
  tick (no microbatch for the stage) computes and writes nothing, where
  JAX computes on don't-care data and masks the writes onto the trash
  page: the cache sees the same writes, and every rank still enters
  every hop in one order. The hop after the last tick, whose result
  JAX discards, is not taken.
- The last stage banks the finished microbatches; their hidden states
  (at the sampled slots, ``select``: JAX returns all T and selects
  after) come back to every stage by one masked sum, and every stage
  computes the logits (all-gathered over tp for a vocab-sharded head),
  so every rank samples the same tokens.

Within a stage the tp group closes the row-parallel products as on the
plain path. The unified [R, W] block and the verify span ride the same
body (kind "ragged"). Families: ``PP_FAMILIES`` (the llama body serves
llama, mistral and qwen2; GPT-2 has its own). ``pp_encode`` is the
pooled routes' dense forward staged the same way (one microbatch).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.registry import get_family
from production_stack_tpu_torch.parallel.pipeline import gpipe_ticks

PP_FAMILIES = ("llama", "mistral", "qwen2", "gpt2")


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t
    pad = torch.zeros((rows - t.shape[0],) + t.shape[1:], dtype=t.dtype,
                      device=t.device)
    return torch.cat([t, pad])


def pp_paged_forward(params, config: ModelConfig, tokens: torch.Tensor,
                     positions: torch.Tensor, page_table: torch.Tensor,
                     kv_lens: torch.Tensor, valid: torch.Tensor, k_cache,
                     v_cache, *, kind: str, pp,
                     impl: Optional[str] = None,
                     select: Optional[torch.Tensor] = None, lora=None,
                     lora_ids: Optional[torch.Tensor] = None, tp=None,
                     kv_tail=None) -> torch.Tensor:
    """``models/llama.forward``'s contract over the stage this rank
    holds (``params`` the stage's, ``config`` its ``stage_model_config``,
    ``k_cache``/``v_cache`` its stacked layers), with ``pp`` the rank's
    pp group. Returns the full logits [B, T or S, vocab] on every
    stage."""
    if kv_tail is not None:
        raise NotImplementedError(
            "deferred_kv_writes with pipeline/context parallelism (the "
            "pp/sp runners use their own burst bodies)")
    fam = get_family(config)
    stages, stage = pp.size, pp.rank
    b, t = tokens.shape
    padded = b + (-b) % stages
    microbatches = stages
    mb = padded // microbatches
    tokens, positions, page_table, kv_lens, valid = (
        _pad_rows(x, padded) for x in (tokens, positions, page_table,
                                       kv_lens, valid))
    if lora_ids is not None:
        lora_ids = _pad_rows(lora_ids, padded)

    def rows(x, m):
        return x[m * mb:(m + 1) * mb]

    banked = gpipe_ticks(
        pp, microbatches,
        lambda m: fam.embed(params, config, rows(tokens, m),
                            rows(positions, m)),
        lambda x, m: fam.decoder_layers(
            params, config, x, rows(positions, m), rows(page_table, m),
            rows(kv_lens, m), rows(valid, m), k_cache, v_cache, kind=kind,
            impl=impl, lora=lora,
            lora_ids=None if lora_ids is None else rows(lora_ids, m),
            tp=tp),
        lambda: torch.zeros((mb, t, config.hidden_size),
                            dtype=params.embed.dtype, device=tokens.device))
    if banked:
        hidden = llama.select_slots(torch.cat(banked)[:b], select)
    else:
        width = t if select is None else select.shape[1]
        hidden = torch.zeros((b, width, config.hidden_size),
                             dtype=params.embed.dtype, device=tokens.device)
    hidden = pp.masked_sum(hidden, stage == stages - 1)
    return fam.head(params, config, hidden, None, tp)


def pp_encode(params, config: ModelConfig, tokens: torch.Tensor, pp,
              tp=None) -> torch.Tensor:
    """``models/llama.encode`` over the stages: stage 0 embeds, each
    stage runs its layers in turn and hands on, and the last stage's
    hidden states reach every stage by one masked sum before the final
    norm."""
    def zeros():
        return torch.zeros(tokens.shape + (config.hidden_size,),
                           dtype=params.embed.dtype, device=tokens.device)

    banked = gpipe_ticks(
        pp, 1, lambda m: F.embedding(tokens.long(), params.embed),
        lambda x, m: llama.encode_layers(params.layers, config, x, tp),
        zeros)
    x = pp.masked_sum(banked[0] if banked else zeros(),
                      pp.rank == pp.size - 1)
    return llama.rms_norm(x, params.final_norm, config.rms_norm_eps)
