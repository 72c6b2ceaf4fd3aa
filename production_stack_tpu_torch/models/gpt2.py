"""GPT-2 family (gpt2, gpt2-medium/large/xl, distilgpt2), the JAX
package's ``models/gpt2.py`` in the port.

What differs from OPT (models/opt.py, whose body it runs): positional
embeddings with no offset, a tanh-approximated GELU MLP (HF's
``gelu_new``), and the LM head always tied. The checkpoint's fused
Conv1D ``c_attn`` is already the port's fused qkv projection; the
loader only transposes it (engine/weights.py).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.models import opt
from production_stack_tpu_torch.models.llama import random_init
from production_stack_tpu_torch.models.opt import (  # noqa: F401
    OPTParams,
    attn_norm,
    decoder_forward,
    embed,
    head,
    mlp_norm,
)


class GPT2Params(OPTParams):
    """OPT's layout with a position table of max_position_embeddings
    rows."""

    POS_OFFSET = 0


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def init_params(config: ModelConfig, generator: torch.Generator,
                device: torch.device) -> GPT2Params:
    return random_init(GPT2Params(config, device), generator, device)


def forward(params: GPT2Params, config: ModelConfig, tokens, positions,
            page_table, kv_lens, valid, k_cache, v_cache, *, kind: str,
            impl: Optional[str] = None, select=None, lora=None,
            lora_ids=None, tp=None) -> torch.Tensor:
    """Same contract as ``llama.forward``."""
    return decoder_forward(params, config, tokens, positions, page_table,
                           kv_lens, valid, k_cache, v_cache, kind=kind,
                           activation=gelu_tanh, impl=impl, select=select,
                           lora=lora, lora_ids=lora_ids, tp=tp)


def decoder_layers(params: GPT2Params, config: ModelConfig, x, positions,
                   page_table, kv_lens, valid, k_cache, v_cache, *,
                   kind: str, impl: Optional[str] = None, lora=None,
                   lora_ids=None, tp=None) -> torch.Tensor:
    """A stage's layers (``llama.decoder_layers``' contract)."""
    return opt.decoder_layers(params, config, x, positions, page_table,
                              kv_lens, valid, k_cache, v_cache, kind=kind,
                              activation=gelu_tanh, impl=impl, lora=lora,
                              lora_ids=lora_ids, tp=tp)


def mlp(config: ModelConfig, lp, m_in, ll, ids, lora_scale,
        tp=None) -> torch.Tensor:
    return opt.mlp(config, lp, m_in, ll, ids, lora_scale, tp, gelu_tanh)
