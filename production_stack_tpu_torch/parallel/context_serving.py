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

JAX's ``shard_w_forward`` (the W axis of unified and verify dispatches
split over sp) is not ported: the sp ranks run those dispatches
replicated, the same math and the same streams.
"""

from __future__ import annotations

import torch

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.lora import layer_stacks
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.registry import get_family
from production_stack_tpu_torch.ops.attention import page_slots, write_slots
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
