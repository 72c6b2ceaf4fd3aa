"""Weights from the JAX package's parameter layout.

The JAX llama ``init_params`` dict stacks every per-layer weight along
a leading [L, ...] axis and orients projections for ``x @ W``
([in, out]). ``params_from_numpy`` turns such a dict, as numpy arrays,
into the port's ``LlamaParams`` (per-layer ``nn.Linear``s, [out, in],
q/k/v and gate/up fused), so both implementations can run the same
weights. A JAX-quantized dict (the JAX ``quantize_params`` or
``init_random_quantized``: each projection a pair ``(q [L, in, out]
int8, scale [L, out] f32)``) becomes ``QuantLinear``s holding the
pairs' int8 values and scales, fused and transposed the same way.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.quantization import (
    FUSED_TARGETS,
    QuantLinear,
)
from production_stack_tpu_torch.models.llama import LlamaParams


def params_from_numpy(params: Dict[str, np.ndarray], config: ModelConfig,
                      device) -> LlamaParams:
    """Build ``LlamaParams`` on ``device`` (in the config's dtype) from
    a JAX-layout numpy dict: embed [V, H], final_norm [H], attn_norm /
    mlp_norm [L, H], wq [L, H, nh*d], wk / wv [L, H, nkv*d],
    wo [L, nh*d, H], w_gate / w_up [L, H, ffn], w_down [L, ffn, H],
    optional bq / bk / bv [L, *] and lm_head [H, V]; the projections
    dense, or each an int8 ``(q, scale)`` pair."""
    out = LlamaParams(config, torch.device(device))

    def t(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=torch.float32)

    quantized = isinstance(params["wq"], tuple)
    with torch.no_grad():
        out.embed.copy_(t(params["embed"]))
        out.final_norm.copy_(t(params["final_norm"]))
        if out.lm_head is not None:
            out.lm_head.weight.copy_(t(params["lm_head"]).T)
        for i, layer in enumerate(out.layers):
            layer.attn_norm.copy_(t(params["attn_norm"][i]))
            layer.mlp_norm.copy_(t(params["mlp_norm"][i]))
            if quantized:
                _quantized_layer(layer, params, i, device)
                continue
            layer.qkv.weight.copy_(torch.cat(
                [t(params[n][i]) for n in ("wq", "wk", "wv")], dim=1).T)
            if layer.qkv.bias is not None:
                layer.qkv.bias.copy_(torch.cat(
                    [t(params[n][i]) for n in ("bq", "bk", "bv")]))
            layer.o.weight.copy_(t(params["wo"][i]).T)
            layer.gate_up.weight.copy_(torch.cat(
                [t(params["w_gate"][i]), t(params["w_up"][i])], dim=1).T)
            layer.down.weight.copy_(t(params["w_down"][i]).T)
    return out


def _quantized_layer(layer, params: Dict, i: int, device) -> None:
    """Layer ``i``'s projections as ``QuantLinear``s from the int8
    pairs: each fused projection's int8 columns and scales concatenated
    in its targets' order, then [in, out] -> [out, in]."""
    for name, targets in FUSED_TARGETS.items():
        q = np.concatenate([np.asarray(params[n][0][i]) for n in targets],
                           axis=1)
        scale = np.concatenate([np.asarray(params[n][1][i])
                                for n in targets])
        dense = getattr(layer, name)
        bias = None
        if dense.bias is not None:
            bias = torch.cat([torch.tensor(np.asarray(params[n][i]))
                              for n in ("bq", "bk", "bv")]).to(
                                  device=device, dtype=dense.bias.dtype)
        setattr(layer, name, QuantLinear(
            torch.from_numpy(np.ascontiguousarray(q.T)).to(device),
            torch.from_numpy(scale.astype(np.float32)).to(device), bias))
