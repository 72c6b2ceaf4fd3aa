"""Context-parallel serving prefill: a long prompt in one dispatch with
its sequence over an sp group, the JAX package's
``parallel/context_serving.py`` in the port.

- Every rank embeds its [B, T/n] slice of the tokens at their global
  positions (GPT-2's position table is read at the global index), and
  each layer's norms, projections and MLP are local.
- Attention is ring attention over the sp ranks' query shards
  (ops/ring_attention.py: K/V blocks hop the ring, online softmax).
- The cache is replicated over sp: each layer's fresh K/V shards are
  all-gathered along the sequence and every rank writes the whole
  prompt into its own stacked cache at the layer, so that any rank can
  run the decode, chunked, unified and verify steps that follow on the
  standard path, through the main path's kernels.
- Under tp each rank runs its heads through the ring and closes the
  row-parallel products over its tp group, as the plain path does.
- Pad slots (T padded to an sp multiple) are ``valid`` False: their
  writes land on the trash page and their outputs are dropped.
- The head runs on the last prompt token's row only: the rank holding
  it is found from ``last_index``, its row gathered over sp.

The unified and verify dispatches (``shard_rows_forward``, JAX's
``shard_w_forward``): each sp rank runs 1/sp of the [R, W] block's
token work. JAX pins the W axis to sp and lets GSPMD split the query
columns; here the split is by rows, which needs no change to the ragged
kernel: rank r runs rows ``[r R/sp, (r + 1) R/sp)`` (R a multiple of
the sp size: the runner pads the block) through the model on their own
page tables and descriptors, then every rank's freshly written K/V
slots are all-gathered and written into every replica
(``share_slot_writes``, one gather a step over every layer: the live
slots only, ``share_slots`` from the host), and the sampled span's
logits are gathered over sp, so every rank samples the whole block as
before. The math per row is unchanged; single-token decode dispatches
do not pass through it.
"""

from __future__ import annotations

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.lora import layer_stacks
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.registry import get_family
from production_stack_tpu_torch.ops.attention import page_slots, write_slots
from production_stack_tpu_torch.ops.quant_kv import QuantKV
from production_stack_tpu_torch.ops.ring_attention import ring_attention

SP_FAMILIES = ("llama", "mistral", "qwen2", "gpt2")


def sp_prefill_forward(params, config: ModelConfig, tokens: torch.Tensor,
                       page_table: torch.Tensor, valid: torch.Tensor,
                       last_index: torch.Tensor, k_cache, v_cache, *, sp,
                       lora=None, lora_ids=None, tp=None) -> torch.Tensor:
    """Whole-prompt prefill with the sequence sharded over ``sp``.

    Args:
      tokens:     [B, T] prompt tokens (every rank is given all of
                  them), T a multiple of the sp size
      page_table: [B, max_pages] the prompt's physical pages
      valid:      [B, T] real tokens (False: padding)
      last_index: [B] each prompt's last token
      k_cache, v_cache: the rank's stacked caches (replicated over sp,
                  tp-cut), written IN PLACE
      lora, lora_ids: adapter stacks and [B] slots, as ``forward``
      tp:         the rank's tp group, or None

    Returns f32 logits [B, vocab] at ``last_index``.
    """
    fam = get_family(config)
    n, idx = sp.size, sp.rank
    b, t = tokens.shape
    tl = t // n
    dev = tokens.device
    mine = slice(idx * tl, (idx + 1) * tl)
    full = torch.arange(t, device=dev)[None, :].expand(b, t)
    positions = full[:, mine]
    x = fam.embed(params, config, tokens[:, mine], positions)
    # The writes of the whole prompt; pad slots read page-table column 0
    # and are sent to the trash page.
    slots = page_slots(page_table, torch.where(valid, full, 0), valid,
                       k_cache[0].shape[-1])
    ids, lora_scale = llama.lora_args(lora, lora_ids)
    rope = config.architecture != "gpt2"
    stacked = not isinstance(k_cache, (list, tuple))
    for layer, lp in enumerate(params.layers):
        ll = layer_stacks(lora, layer)
        a_in = fam.attn_norm(config, lp, x)
        q, k, v = llama.attention_inputs(config, lp, a_in, positions, ll,
                                         ids, lora_scale, rope)
        attn = ring_attention(q, k, v, sp, causal=True)
        kv = sp.all_gather(torch.stack([k, v]), dim=2)
        for cache, new in ((k_cache, kv[0]), (v_cache, kv[1])):
            write_slots(cache if stacked else cache[layer], new, *slots,
                        layer=layer if stacked else None)
        x = x + llama.row_parallel(attn.reshape(b, tl, -1), lp.o, ll, "wo",
                                   ids, lora_scale, tp)
        x = x + fam.mlp(config, lp, fam.mlp_norm(config, lp, x), ll, ids,
                        lora_scale, tp)
    rows = torch.arange(b, device=dev)
    last = last_index.long()
    local = torch.clamp(last - idx * tl, 0, tl - 1)
    held = sp.all_gather(x[rows, local][:, None], dim=1)  # [B, n, H]
    return fam.head(params, config, held[rows, last // tl][:, None],
                    None, tp)[:, 0]


def share_slots(valid: np.ndarray, n: int) -> np.ndarray:
    """[n, m] int32: for each sp rank, the flat indices into the [R, W]
    block (R a multiple of ``n``) of the live slots of its rows, first
    in row-major order, then dead slots (trash page) up to ``m``: the
    largest rank's live count rounded up to a power of two and capped
    at its R/n * W slots, so that a step graph keyed on ``m`` serves
    many steps."""
    r, w = valid.shape
    seg = r // n * w
    flat = valid.reshape(n, seg)
    most = int(flat.sum(axis=1).max())
    m = min(seg, 1 << max(most - 1, 0).bit_length())
    out = np.empty((n, m), np.int32)
    for j in range(n):
        out[j] = j * seg + np.concatenate([np.flatnonzero(flat[j]),
                                           np.flatnonzero(~flat[j])])[:m]
    return out


def share_slot_writes(k_cache, v_cache, page_table: torch.Tensor,
                      positions: torch.Tensor, valid: torch.Tensor,
                      slots: torch.Tensor, sp) -> None:
    """Every sp replica's stacked caches take the K/V each rank wrote
    for its rows: this rank's ``slots[sp.rank]`` (flat indices of the
    [R, W] block) read off every layer, all-gathered over ``sp`` in one
    collective (two for int8: values and scales) and written at every
    rank's slots. Dead entries read and write the trash page."""
    pages, offsets = page_slots(page_table, positions, valid,
                                k_cache.shape[-1])
    mine, every = slots[sp.rank].long(), slots.reshape(-1).long()
    p, o = pages[mine], offsets[mine]
    pa, oa = pages[every], offsets[every]
    quant = isinstance(k_cache, QuantKV)
    data = [(c.data if quant else c) for c in (k_cache, v_cache)]
    # [L, kv, pages, d, ps] at (page, offset) pairs: [m, L, kv, d].
    got = sp.all_gather(torch.stack([c[:, :, p, :, o] for c in data]),
                        dim=1)
    for c, new in zip(data, got):
        c[:, :, pa, :, oa] = new
    if quant:
        # [L, kv, pages, ps] scales at the pairs: [L, kv, m].
        got = sp.all_gather(torch.stack([c.scale[:, :, p, o]
                                         for c in (k_cache, v_cache)]),
                            dim=-1)
        for c, new in zip((k_cache, v_cache), got):
            c.scale[:, :, pa, oa] = new


def shard_rows_forward(forward, sp):
    """The engine forward of a context-parallel runner: a ragged
    dispatch given ``share_slots`` (a unified or verify block, W > 1)
    runs this rank's rows only, shares its K/V writes with the other
    replicas and gathers the span's logits over ``sp``; any other call
    passes through (decode, prefill chunks)."""

    def wrapped(params, config, tokens, positions, page_table, kv_lens,
                valid, k_cache, v_cache, *, select=None, lora=None,
                lora_ids=None, share_slots=None, **kwargs):
        if share_slots is None or tokens.shape[1] <= 1:
            return forward(params, config, tokens, positions, page_table,
                           kv_lens, valid, k_cache, v_cache, select=select,
                           lora=lora, lora_ids=lora_ids, **kwargs)
        per = tokens.shape[0] // sp.size
        mine = slice(sp.rank * per, (sp.rank + 1) * per)
        logits = forward(
            params, config, tokens[mine], positions[mine],
            page_table[mine], kv_lens[mine], valid[mine], k_cache, v_cache,
            select=None if select is None else select[mine], lora=lora,
            lora_ids=None if lora_ids is None else lora_ids[mine],
            **kwargs)
        share_slot_writes(k_cache, v_cache, page_table, positions, valid,
                          share_slots, sp)
        return sp.all_gather(logits, dim=0)

    return wrapped
