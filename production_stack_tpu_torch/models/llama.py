"""Llama-family model (Llama 2/3, Mistral, Qwen2-style GQA decoders).

Weights are an ``nn.Module`` (``LlamaParams``) of per-layer
``nn.Linear``s, with q/k/v and gate/up fused into one projection each;
``forward`` is a plain function over them, the counterpart of the JAX
package's ``llama.forward``. Attention reads and writes the paged KV
cache in either layout: a list of L [kv, pages, d, page] buffers
(per_layer) or one stacked [L, kv, pages, d, page] buffer (stacked),
each, for an int8 cache, a ``QuantKV`` of int8 pages and their
per-slot scales. ``forward`` updates it IN PLACE (the JAX version
threads updated copies through).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.ops.attention import page_slots, write_slots
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention,
    paged_ragged_attention_plain,
)
from production_stack_tpu_torch.ops.rope import apply_rope

ATTENTION_IMPLS = ("cuda", "plain", "plain_bf16p")
# The step kinds the runner names (never inferred from shapes: a
# [32, 5] verify block and a small prefill block both have T > 1).
STEP_KINDS = ("decode", "prefill", "ragged")


class LlamaLayer(nn.Module):
    def __init__(self, config: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        nh, nkv, d = (config.num_attention_heads,
                      config.num_key_value_heads, config.head_dim)
        kw = {"dtype": dtype, "device": device}
        self.attn_norm = nn.Parameter(torch.ones(h, **kw))
        self.qkv = nn.Linear(h, (nh + 2 * nkv) * d,
                             bias=config.attention_bias, **kw)
        self.o = nn.Linear(nh * d, h, bias=False, **kw)
        self.mlp_norm = nn.Parameter(torch.ones(h, **kw))
        self.gate_up = nn.Linear(h, 2 * ffn, bias=False, **kw)
        self.down = nn.Linear(ffn, h, bias=False, **kw)


class LlamaParams(nn.Module):
    """The weights of one llama-family model."""

    def __init__(self, config: ModelConfig, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or config.torch_dtype
        kw = {"dtype": dtype, "device": device}
        self.embed = nn.Parameter(
            torch.empty(config.vocab_size, config.hidden_size, **kw))
        self.layers = nn.ModuleList(
            LlamaLayer(config, dtype, device)
            for _ in range(config.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(config.hidden_size,
                                                  **kw))
        self.lm_head = (None if config.tie_word_embeddings else
                        nn.Linear(config.hidden_size, config.vocab_size,
                                  bias=False, **kw))
        self.requires_grad_(False)


def dispatch_attention(config: ModelConfig, q, k_cache, v_cache,
                       page_table, positions, kv_lens, kind: str,
                       impl: Optional[str] = None,
                       layer: Optional[int] = None) -> torch.Tensor:
    """Attention over one layer's paged cache (a per-layer buffer, or
    the stacked cache at ``layer``) for the step ``kind``:
    "decode" (T == 1) through the decode kernel, "prefill" chunks
    through the chunked-prefill kernel, "ragged" blocks (unified mixed
    steps and speculative verify steps) through the ragged kernel.

    A ragged row's descriptor is rebuilt from the planner's layout
    invariant, as the JAX forward does: every row kind satisfies
    ``positions[:, 0] == kv_lens - 1 - last_index``, so ``last_index =
    kv_lens - 1 - positions[:, 0]``; a pad row has kv_len 0.

    ``impl`` is "cuda" (the kernel wrappers, which take the plain
    version for CPU tensors), "plain" (the plain versions, on any
    device) or "plain_bf16p" (the plain versions rounded as the card's
    kernels round: for bf16 queries the prefill and ragged walks feed
    their probabilities to p . v as bf16, as the tensor-core walk does;
    decode and f32 queries take the f32 walk, as their kernels do). The
    default follows the tensors: "cuda" on the card, "plain" on the
    CPU; the engine never asks for a plain impl on the card.
    """
    del config  # shapes come from the tensors
    impl = impl or ("cuda" if q.is_cuda else "plain")
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention impl must be one of "
                         f"{ATTENTION_IMPLS} (got {impl!r})")
    cuda = impl == "cuda"
    # The walks that feed bf16 probabilities to p . v on the card.
    rounded = ({"p_dtype": torch.bfloat16}
               if impl == "plain_bf16p" and q.dtype == torch.bfloat16
               else {})
    if kind == "decode":
        fn = paged_decode_attention if cuda else paged_decode_attention_plain
        return fn(q[:, 0], k_cache, v_cache, page_table, kv_lens,
                  layer=layer)[:, None]
    if kind == "prefill":
        fn = (paged_prefill_attention if cuda
              else paged_prefill_attention_plain)
        return fn(q, k_cache, v_cache, page_table, positions, kv_lens,
                  layer=layer, **rounded)
    if kind == "ragged":
        fn = paged_ragged_attention if cuda else paged_ragged_attention_plain
        last_index = (kv_lens - 1 - positions[:, 0]).to(torch.int32)
        return fn(q, k_cache, v_cache, page_table, kv_lens, last_index,
                  layer=layer, **rounded)
    raise ValueError(f"step kind must be one of {STEP_KINDS} "
                     f"(got {kind!r})")


def cached_attention(config: ModelConfig, q, k, v, k_cache, v_cache,
                     page_table, positions, kv_lens, slots, layer: int,
                     kind: str, impl: Optional[str] = None) -> torch.Tensor:
    """Write one layer's K/V into the cache (in place) and attend.

    ``k_cache``/``v_cache`` are the per_layer lists (the layer's own
    buffer is written and read) or the stacked caches (written at
    ``layer`` in place, and read there by the kernels, which take the
    layer index). ``slots`` is the step's (pages, offsets) from
    ``ops.attention.page_slots``, shared by every layer. A QuantKV
    cache is written through the quantizing path (``write_slots``
    quantizes each slot's row with its own scale), and the kernels
    dequantize on read."""
    if isinstance(k_cache, (list, tuple)):
        kc, vc, at = k_cache[layer], v_cache[layer], None
    else:
        kc, vc, at = k_cache, v_cache, layer
    write_slots(kc, k, *slots, layer=at)
    write_slots(vc, v, *slots, layer=at)
    return dispatch_attention(config, q, kc, vc, page_table, positions,
                              kv_lens, kind, impl=impl, layer=at)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def init_params(config: ModelConfig, generator: torch.Generator,
                device: torch.device) -> LlamaParams:
    """Random-init parameters (for tests, benchmarks and cold starts):
    N(0, 0.02) projections and embeddings, unit norms, zero biases —
    the JAX init's distribution, not its bits. ``generator`` must live
    on ``device``."""
    params = LlamaParams(config, device)
    for name, p in params.named_parameters():
        if name.endswith("norm") or name.endswith("bias"):
            continue
        noise = torch.randn(p.shape, generator=generator, device=device,
                            dtype=torch.float32)
        p.copy_(noise.mul_(0.02))
    return params


def forward(params: LlamaParams, config: ModelConfig,
            tokens: torch.Tensor, positions: torch.Tensor,
            page_table: torch.Tensor, kv_lens: torch.Tensor,
            valid: torch.Tensor, k_cache, v_cache, *, kind: str,
            impl: Optional[str] = None,
            select: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One model invocation over a (possibly padded) token block.

    Args:
      tokens:     [B, T] token ids
      positions:  [B, T] absolute positions (0 for padded slots)
      page_table: [B, max_pages] int32 physical page ids (page 0 = trash)
      kv_lens:    [B] int32 valid cached tokens AFTER this block is written
      valid:      [B, T] mask of real (non-padding) tokens
      k_cache/v_cache: L-lists of [kv_heads, num_pages, head_dim,
                  page_size] buffers, or stacked [L, kv_heads, ...]
                  buffers (either as QuantKVs for int8), written IN
                  PLACE
      kind:       the step kind, "decode", "prefill" or "ragged" (see
                  dispatch_attention)
      impl:       attention impl (see dispatch_attention)
      select:     optional [B, S] int64 indices into T: logits only at
                  those slots (the sampled positions), so a prefill
                  step never materializes [B, T, vocab]

    Returns f32 logits [B, T, vocab], or [B, S, vocab] with ``select``.
    """
    nh, nkv, d = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    b, t = tokens.shape
    slots = page_slots(page_table, positions, valid,
                       k_cache[0].shape[-1])
    x = F.embedding(tokens.long(), params.embed)  # [B, T, H]
    for layer, lp in enumerate(params.layers):
        a_in = rms_norm(x, lp.attn_norm, config.rms_norm_eps)
        q, k, v = lp.qkv(a_in).split([nh * d, nkv * d, nkv * d], dim=-1)
        q = apply_rope(q.reshape(b, t, nh, d), positions,
                       config.rope_theta)
        k = apply_rope(k.reshape(b, t, nkv, d), positions,
                       config.rope_theta)
        v = v.reshape(b, t, nkv, d)
        attn = cached_attention(config, q, k, v, k_cache, v_cache,
                                page_table, positions, kv_lens, slots,
                                layer, kind, impl=impl)
        x = x + lp.o(attn.reshape(b, t, nh * d))
        m_in = rms_norm(x, lp.mlp_norm, config.rms_norm_eps)
        gate, up = lp.gate_up(m_in).chunk(2, dim=-1)
        x = x + lp.down(F.silu(gate) * up)
    if select is not None:
        x = torch.take_along_dim(x, select[:, :, None], dim=1)
    x = rms_norm(x, params.final_norm, config.rms_norm_eps)
    head = (params.embed if params.lm_head is None
            else params.lm_head.weight)
    return F.linear(x, head).float()
