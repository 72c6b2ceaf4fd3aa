"""Weights from the JAX package's parameter layout.

The JAX llama ``init_params`` dict stacks every per-layer weight along
a leading [L, ...] axis and orients projections for ``x @ W``
([in, out]). ``params_from_numpy`` turns such a dict, as numpy arrays,
into the port's ``LlamaParams`` (per-layer ``nn.Linear``s, [out, in],
q/k/v and gate/up fused), so both implementations can run the same
weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.models.llama import LlamaParams


def params_from_numpy(params: Dict[str, np.ndarray], config: ModelConfig,
                      device) -> LlamaParams:
    """Build ``LlamaParams`` on ``device`` (in the config's dtype) from
    a JAX-layout numpy dict: embed [V, H], final_norm [H], attn_norm /
    mlp_norm [L, H], wq [L, H, nh*d], wk / wv [L, H, nkv*d],
    wo [L, nh*d, H], w_gate / w_up [L, H, ffn], w_down [L, ffn, H],
    optional bq / bk / bv [L, *] and lm_head [H, V]."""
    out = LlamaParams(config, torch.device(device))

    def t(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=torch.float32)

    with torch.no_grad():
        out.embed.copy_(t(params["embed"]))
        out.final_norm.copy_(t(params["final_norm"]))
        if out.lm_head is not None:
            out.lm_head.weight.copy_(t(params["lm_head"]).T)
        for i, layer in enumerate(out.layers):
            layer.attn_norm.copy_(t(params["attn_norm"][i]))
            layer.mlp_norm.copy_(t(params["mlp_norm"][i]))
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
