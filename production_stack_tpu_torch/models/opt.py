"""OPT-family model (facebook/opt-*), the JAX package's ``models/opt.py``
in the port.

What differs from Llama: learned positional embeddings with HF's +2
offset, biased projections, LayerNorm (eps 1e-5) in place of RMSNorm,
a ReLU MLP and the LM head tied to the token embeddings. Attention is
one query head for each KV head (group 1) with no RoPE, through the
same paged cache and step-kind kernels as llama
(``llama.self_attention``). As in the JAX model, every layer normalizes
before its attention and MLP whatever ``do_layer_norm_before`` says,
and opt-350m's ``word_embed_proj_dim`` projections are not modelled.

``decoder_forward`` is the body GPT-2 shares (models/gpt2.py): the two
differ only in the position offset and the activation.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.lora import layer_stacks, lora_matmul
from production_stack_tpu_torch.models.llama import (
    lora_args,
    random_init,
    row_parallel,
    select_slots,
    self_attention,
)
from production_stack_tpu_torch.ops.attention import page_slots

# HF OPT reserves the first two positional-embedding rows.
POS_OFFSET = 2


class OPTLayer(nn.Module):
    def __init__(self, config: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        hd = config.num_attention_heads * config.head_dim
        kw = {"dtype": dtype, "device": device}
        self.attn_norm_w = nn.Parameter(torch.ones(h, **kw))
        self.attn_norm_b = nn.Parameter(torch.zeros(h, **kw))
        # q, k and v fused in column order (one kv head per q head).
        self.qkv = nn.Linear(h, 3 * hd, bias=True, **kw)
        self.o = nn.Linear(hd, h, bias=True, **kw)
        self.mlp_norm_w = nn.Parameter(torch.ones(h, **kw))
        self.mlp_norm_b = nn.Parameter(torch.zeros(h, **kw))
        self.fc1 = nn.Linear(h, ffn, bias=True, **kw)
        self.fc2 = nn.Linear(ffn, h, bias=True, **kw)


class OPTParams(nn.Module):
    """The weights of one OPT model (also GPT-2's layout, whose table
    has no offset rows)."""

    POS_OFFSET = POS_OFFSET

    def __init__(self, config: ModelConfig, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or config.torch_dtype
        kw = {"dtype": dtype, "device": device}
        h = config.hidden_size
        self.embed = nn.Parameter(torch.empty(config.vocab_size, h, **kw))
        self.pos_embed = nn.Parameter(torch.empty(
            config.max_position_embeddings + self.POS_OFFSET, h, **kw))
        self.layers = nn.ModuleList(
            OPTLayer(config, dtype, device)
            for _ in range(config.num_hidden_layers))
        self.final_norm_w = nn.Parameter(torch.ones(h, **kw))
        self.final_norm_b = nn.Parameter(torch.zeros(h, **kw))
        self.requires_grad_(False)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """The JAX ``layer_norm``: f32 mean and (population) variance, eps
    1e-5, scale and shift in f32, back to x's dtype."""
    x32 = x.float()
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x32 - mean), dim=-1, keepdim=True)
    normed = (x32 - mean) * torch.rsqrt(var + 1e-5)
    return (normed * weight.float() + bias.float()).to(x.dtype)


def init_params(config: ModelConfig, generator: torch.Generator,
                device: torch.device) -> OPTParams:
    return random_init(OPTParams(config, device), generator, device)


def decoder_forward(params: OPTParams, config: ModelConfig,
                    tokens: torch.Tensor, positions: torch.Tensor,
                    page_table: torch.Tensor, kv_lens: torch.Tensor,
                    valid: torch.Tensor, k_cache, v_cache, *, kind: str,
                    activation: Callable[[torch.Tensor], torch.Tensor],
                    impl: Optional[str] = None,
                    select: Optional[torch.Tensor] = None, lora=None,
                    lora_ids: Optional[torch.Tensor] = None, tp=None
                    ) -> torch.Tensor:
    """The OPT/GPT-2 body under ``llama.forward``'s contract: ``embed``,
    ``decoder_layers``, ``head``. Under ``tp`` the output projection and
    fc2 are row-parallel, their biases replicated and added once after
    the reduce; the head is the replicated embedding, so nothing is
    gathered."""
    x = embed(params, config, tokens, positions)
    x = decoder_layers(params, config, x, positions, page_table, kv_lens,
                       valid, k_cache, v_cache, kind=kind,
                       activation=activation, impl=impl, lora=lora,
                       lora_ids=lora_ids, tp=tp)
    return head(params, config, x, select)


def embed(params: OPTParams, config: ModelConfig, tokens: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    """Token plus learned position embeddings [B, T, H].

    The position index (``positions + POS_OFFSET``) is clamped into the
    table: the JAX gather clamps silently, while an out-of-range index
    on the card would end the CUDA context. Real rows never reach the
    clamp (EngineConfig caps max_model_len at the table); pad slots
    index in range."""
    del config
    pos = torch.clamp(positions.long() + params.POS_OFFSET, 0,
                      params.pos_embed.shape[0] - 1)
    return (F.embedding(tokens.long(), params.embed)
            + F.embedding(pos, params.pos_embed))


def attn_norm(config: ModelConfig, lp: nn.Module,
              x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, lp.attn_norm_w, lp.attn_norm_b)


def mlp_norm(config: ModelConfig, lp: nn.Module,
             x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, lp.mlp_norm_w, lp.mlp_norm_b)


def mlp(config: ModelConfig, lp: nn.Module, m_in: torch.Tensor, ll, ids,
        lora_scale, tp=None, activation=F.relu) -> torch.Tensor:
    """fc1, the activation, fc2 (row-parallel under ``tp``)."""
    hidden = activation(lora_matmul(m_in, lp.fc1, ll, "fc1", ids,
                                    lora_scale))
    return row_parallel(hidden, lp.fc2, ll, "fc2", ids, lora_scale, tp)


def decoder_layers(params: nn.Module, config: ModelConfig, x: torch.Tensor,
                   positions, page_table, kv_lens, valid, k_cache, v_cache,
                   *, kind: str,
                   activation: Callable[[torch.Tensor], torch.Tensor],
                   impl: Optional[str] = None, lora=None,
                   lora_ids: Optional[torch.Tensor] = None, tp=None
                   ) -> torch.Tensor:
    """Every layer of ``params.layers`` (a stage's, stage-local index)
    over ``x``, as ``llama.decoder_layers``."""
    slots = page_slots(page_table, positions, valid,
                       k_cache[0].shape[-1])
    ids, lora_scale = lora_args(lora, lora_ids)
    for layer, lp in enumerate(params.layers):
        ll = layer_stacks(lora, layer)
        a_in = attn_norm(config, lp, x)
        x = x + self_attention(config, lp, a_in, positions, page_table,
                               kv_lens, k_cache, v_cache, slots, layer,
                               kind, impl, ll, ids, lora_scale, rope=False,
                               tp=tp)
        x = x + mlp(config, lp, mlp_norm(config, lp, x), ll, ids,
                    lora_scale, tp, activation)
    return x


def head(params: OPTParams, config: ModelConfig, x: torch.Tensor,
         select: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """The final LayerNorm and the tied head's f32 logits (at
    ``select``'s slots); replicated under ``tp``."""
    del config, tp
    x = select_slots(x, select)
    x = layer_norm(x, params.final_norm_w, params.final_norm_b)
    return F.linear(x, params.embed).float()


def forward(params: OPTParams, config: ModelConfig, tokens, positions,
            page_table, kv_lens, valid, k_cache, v_cache, *, kind: str,
            impl: Optional[str] = None, select=None, lora=None,
            lora_ids=None, tp=None) -> torch.Tensor:
    """Same contract as ``llama.forward``."""
    return decoder_forward(params, config, tokens, positions, page_table,
                           kv_lens, valid, k_cache, v_cache, kind=kind,
                           activation=F.relu, impl=impl, select=select,
                           lora=lora, lora_ids=lora_ids, tp=tp)
