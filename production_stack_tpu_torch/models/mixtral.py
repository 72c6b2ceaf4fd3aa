"""Mixtral-family sparse-MoE decoders (mixtral-8x7b style), the JAX
package's ``models/mixtral.py`` in the port.

Attention is llama's GQA path over the paged cache
(``llama.self_attention``). The MoE block keeps JAX's dense
formulation: every token goes through all E experts and the combine
weights (softmax over the top-k router logits, zero elsewhere) zero
the unselected ones, so every shape is static and the block runs
inside the step graphs. Its products are plain dense matmuls, as JAX
left them to XLA outside any Pallas kernel:

    gate/up:  [N, H] x [E*F, H]^T -> [N, E, F] each
    combine:  silu(gate) * up * w[n, e]
    down:     [N, E*F] x [H, E*F]^T -> [N, H]

Scaling by the combine weight before the down projection rather than
after is the same function (the down projection is linear) and sums
the experts inside one product of depth E*F. A routed (grouped) MoE
would do E/k times fewer operations; that is later work.

Expert weights are not LoRA targets and not weight-only int8 targets
(JAX refuses ``--quantization int8`` for mixtral).

Under tensor parallelism the experts are split (parallel/mesh.py): rank
r holds experts [r E/tp, (r+1) E/tp), the router stays whole, and the
block's output, the rank's experts' share of the weighted sum, closes
with one all-reduce (JAX's expert-parallel specs, where GSPMD places
that psum).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.lora import layer_stacks
from production_stack_tpu_torch.models.llama import (
    lm_logits,
    lora_args,
    random_init,
    rms_norm,
    select_slots,
    self_attention,
)
from production_stack_tpu_torch.ops.attention import page_slots


class MixtralLayer(nn.Module):
    def __init__(self, config: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        nh, nkv, d = (config.num_attention_heads,
                      config.num_key_value_heads, config.head_dim)
        e = config.num_local_experts
        kw = {"dtype": dtype, "device": device}
        self.attn_norm = nn.Parameter(torch.ones(h, **kw))
        self.qkv = nn.Linear(h, (nh + 2 * nkv) * d, bias=False, **kw)
        self.o = nn.Linear(nh * d, h, bias=False, **kw)
        self.mlp_norm = nn.Parameter(torch.ones(h, **kw))
        self.moe_gate = nn.Linear(h, e, bias=False, **kw)  # the router
        # Per expert, [out, in]: HF's w1 (gate), w3 (up) and w2 (down),
        # w2 laid out [H, E, F] so the experts' down projections are one
        # [H, E * F] product.
        self.w_gate = nn.Parameter(torch.empty(e, ffn, h, **kw))
        self.w_up = nn.Parameter(torch.empty(e, ffn, h, **kw))
        self.w_down = nn.Parameter(torch.empty(h, e, ffn, **kw))


class MixtralParams(nn.Module):
    """The weights of one Mixtral model."""

    def __init__(self, config: ModelConfig, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or config.torch_dtype
        kw = {"dtype": dtype, "device": device}
        h = config.hidden_size
        self.embed = nn.Parameter(torch.empty(config.vocab_size, h, **kw))
        self.layers = nn.ModuleList(
            MixtralLayer(config, dtype, device)
            for _ in range(config.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(h, **kw))
        self.lm_head = (None if config.tie_word_embeddings else
                        nn.Linear(h, config.vocab_size, bias=False, **kw))
        self.requires_grad_(False)


def top_k_lower_index(logits: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties
    broken by the lower index as ``lax.top_k`` breaks them (a stable
    descending sort; E is small)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_block(x: torch.Tensor, lp: MixtralLayer, top_k: int, tp=None
              ) -> torch.Tensor:
    """Top-k routed SwiGLU experts, dense: x [B, T, H] -> [B, T, H].
    Router logits in f32 (the product in x's dtype, as JAX casts it),
    softmax over the top-k values, the combine weights in x's dtype.
    Under ``tp`` the layer holds the rank's experts only: the router
    picks among all E, the rank weighs its own, and the ranks' sums are
    reduced."""
    b, t, h = x.shape
    e, ffn = lp.w_gate.shape[:2]
    xf = x.reshape(b * t, h)
    router = F.linear(xf, lp.moe_gate.weight).float()  # [N, E]
    top_vals, top_idx = top_k_lower_index(router, top_k)
    combine = torch.zeros_like(router).scatter_(
        -1, top_idx, torch.softmax(top_vals, dim=-1))
    if tp is not None:
        combine = combine[:, tp.rank * e:(tp.rank + 1) * e]
    hidden = F.silu(F.linear(xf, lp.w_gate.reshape(e * ffn, h)))
    hidden = hidden * F.linear(xf, lp.w_up.reshape(e * ffn, h))
    hidden = hidden.view(b * t, e, ffn) * combine.to(x.dtype)[:, :, None]
    out = F.linear(hidden.reshape(b * t, e * ffn),
                   lp.w_down.reshape(h, e * ffn))
    if tp is not None:
        out = tp.all_reduce(out)
    return out.reshape(b, t, h)


def init_params(config: ModelConfig, generator: torch.Generator,
                device: torch.device) -> MixtralParams:
    return random_init(MixtralParams(config, device), generator, device)


def forward(params: MixtralParams, config: ModelConfig,
            tokens: torch.Tensor, positions: torch.Tensor,
            page_table: torch.Tensor, kv_lens: torch.Tensor,
            valid: torch.Tensor, k_cache, v_cache, *, kind: str,
            impl: Optional[str] = None,
            select: Optional[torch.Tensor] = None, lora=None,
            lora_ids: Optional[torch.Tensor] = None, tp=None
            ) -> torch.Tensor:
    """Same contract as ``llama.forward``. LoRA applies to the
    attention projections only."""
    slots = page_slots(page_table, positions, valid,
                       k_cache[0].shape[-1])
    ids, lora_scale = lora_args(lora, lora_ids)
    x = F.embedding(tokens.long(), params.embed)
    for layer, lp in enumerate(params.layers):
        ll = layer_stacks(lora, layer)
        a_in = rms_norm(x, lp.attn_norm, config.rms_norm_eps)
        x = x + self_attention(config, lp, a_in, positions, page_table,
                               kv_lens, k_cache, v_cache, slots, layer,
                               kind, impl, ll, ids, lora_scale, tp=tp)
        m_in = rms_norm(x, lp.mlp_norm, config.rms_norm_eps)
        x = x + moe_block(m_in, lp, config.num_experts_per_tok, tp)
    x = select_slots(x, select)
    x = rms_norm(x, params.final_norm, config.rms_norm_eps)
    return lm_logits(x, params, tp)
