"""Weights from the JAX package's parameter layout.

A JAX ``init_params`` dict stacks every per-layer weight along a
leading [L, ...] axis and orients projections for ``x @ W`` ([in,
out]). ``params_from_numpy`` turns such a dict, as numpy arrays, into
the port's params module of the same architecture (per-layer
``nn.Linear``s, [out, in], q/k/v fused, and llama's gate/up), so both
implementations can run the same weights: ``LlamaParams``,
``OPTParams``, ``GPT2Params`` or ``MixtralParams``. A JAX-quantized
dict (the JAX ``quantize_params`` or ``init_random_quantized``: each
target projection a pair ``(q [L, in, out] int8, scale [L, out]
f32)``; llama, opt and gpt2) becomes ``QuantLinear``s holding the
pairs' int8 values and scales, fused and transposed the same way.
``stage_params_from_numpy`` builds a pipeline stage's params from such
a dict: its layers' slices of every [L, ...] leaf (an int8 pair's
weight and scale cut together); an adapter's stacks are cut the same
way by ``parallel/mesh.stage_lora_adapter``. ``params_to_numpy`` is
the inverse over dense weights, or over their gradients, so that a
gradient of the port's forward is held against ``jax.grad``'s dict
leaf by leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.quantization import (
    QuantLinear,
    fused_targets,
    has_quantized_leaves,
)
from production_stack_tpu_torch.models.registry import params_class

# The JAX biases of a projection, by the port's projection name.
_BIASES = {"qkv": ("bq", "bk", "bv"), "o": ("bo",), "fc1": ("fc1_b",),
           "fc2": ("fc2_b",)}
# Leaves copied as they are: port name (on the params module or its
# layer) -> JAX name.
_TOP = {"llama": {"embed": "embed", "final_norm": "final_norm"},
        "opt": {"embed": "embed", "pos_embed": "pos_embed",
                "final_norm_w": "final_norm_w",
                "final_norm_b": "final_norm_b"}}
_LAYER = {"llama": ("attn_norm", "mlp_norm"),
          "opt": ("attn_norm_w", "attn_norm_b", "mlp_norm_w",
                  "mlp_norm_b")}


def _family(config: ModelConfig) -> str:
    if config.architecture in ("opt", "gpt2"):
        return "opt"
    return "llama"  # the llama family and mixtral share these leaves


def params_from_numpy(params: Dict[str, np.ndarray], config: ModelConfig,
                      device):
    """Build ``config``'s params module on ``device`` (in the config's
    dtype) from a JAX-layout numpy dict, the projections dense or each
    an int8 ``(q, scale)`` pair:

    - llama: embed [V, H], final_norm [H], attn_norm / mlp_norm [L, H],
      wq [L, H, nh*d], wk / wv [L, H, nkv*d], wo [L, nh*d, H], w_gate /
      w_up [L, H, ffn], w_down [L, ffn, H], optional bq / bk / bv
      [L, *] and lm_head [H, V];
    - opt, gpt2: embed, pos_embed, final_norm_w / _b, attn_norm_w / _b,
      mlp_norm_w / _b, wq / wk / wv / wo with bq / bk / bv / bo, fc1
      [L, H, ffn] / fc1_b, fc2 [L, ffn, H] / fc2_b;
    - mixtral: llama's attention leaves, moe_gate [L, H, E], w_gate /
      w_up [L, E, H, ffn], w_down [L, E, ffn, H], optional lm_head."""
    out = params_class(config)(config, torch.device(device))
    family = _family(config)

    def t(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=torch.float32)

    quantized = isinstance(params["wq"], tuple)
    with torch.no_grad():
        for name, jax_name in _TOP[family].items():
            getattr(out, name).copy_(t(params[jax_name]))
        if getattr(out, "lm_head", None) is not None:
            out.lm_head.weight.copy_(t(params["lm_head"]).T)
        for i, layer in enumerate(out.layers):
            for name in _LAYER[family]:
                getattr(layer, name).copy_(t(params[name][i]))
            for name, targets in fused_targets(config).items():
                biases = _BIASES.get(name, ())
                if getattr(layer, name).bias is None:
                    biases = ()
                if quantized:
                    _quantized_projection(layer, name, targets, biases,
                                          params, i, device)
                    continue
                lin = getattr(layer, name)
                lin.weight.copy_(torch.cat(
                    [t(params[n][i]) for n in targets], dim=1).T)
                if biases:
                    lin.bias.copy_(torch.cat([t(params[n][i])
                                              for n in biases]))
            if config.architecture == "mixtral":
                layer.moe_gate.weight.copy_(t(params["moe_gate"][i]).T)
                layer.w_gate.copy_(t(params["w_gate"][i]).transpose(1, 2))
                layer.w_up.copy_(t(params["w_up"][i]).transpose(1, 2))
                layer.w_down.copy_(t(params["w_down"][i]).permute(2, 0, 1))
    return out


def _target_widths(config: ModelConfig, targets) -> list:
    """The output widths of a fused projection's targets, in column
    order."""
    nh, nkv, d = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    ffn = config.intermediate_size
    widths = {"wq": nh * d, "wk": nkv * d, "wv": nkv * d, "w_gate": ffn,
              "w_up": ffn}
    return [widths[n] for n in targets]


def params_to_numpy(params, config: ModelConfig,
                    grad: bool = False) -> Dict[str, np.ndarray]:
    """The JAX-layout numpy dict of a dense params module, the inverse
    of ``params_from_numpy``: every fused projection split back into its
    targets (and its bias into theirs), each [out, in] weight turned to
    [in, out], the per-layer leaves stacked along a leading [L, ...]
    axis. ``grad``: the leaves' gradients in the same layout instead
    (zeros where a leaf has none), to hold them against ``jax.grad``'s
    dict. The dtype is kept (f32 gives the JAX dict's bits)."""
    if has_quantized_leaves(params):
        raise ValueError("params_to_numpy takes dense weights only")
    family = _family(config)

    def value(p: torch.Tensor) -> np.ndarray:
        if grad:
            p = torch.zeros_like(p) if p.grad is None else p.grad
        return p.detach().cpu().numpy()

    out = {jax_name: value(getattr(params, name))
           for name, jax_name in _TOP[family].items()}
    if getattr(params, "lm_head", None) is not None:
        out["lm_head"] = value(params.lm_head.weight).T
    layers: Dict[str, list] = {}

    def put(name, arr):
        layers.setdefault(name, []).append(arr)

    for layer in params.layers:
        for name in _LAYER[family]:
            put(name, value(getattr(layer, name)))
        for name, targets in fused_targets(config).items():
            lin = getattr(layer, name)
            cuts = np.cumsum(_target_widths(config, targets)
                             if len(targets) > 1 else [])[:-1]
            for n, w in zip(targets, np.split(value(lin.weight).T, cuts,
                                              axis=1)):
                put(n, w)
            if lin.bias is not None and name in _BIASES:
                for n, b in zip(_BIASES[name],
                                np.split(value(lin.bias), cuts)):
                    put(n, b)
        if config.architecture == "mixtral":
            put("moe_gate", value(layer.moe_gate.weight).T)
            put("w_gate", value(layer.w_gate).transpose(0, 2, 1))
            put("w_up", value(layer.w_up).transpose(0, 2, 1))
            put("w_down", value(layer.w_down).transpose(1, 2, 0))
    out.update({name: np.stack(arrs) for name, arrs in layers.items()})
    return out


# The JAX leaves without a leading layer axis.
_SHARED = ("embed", "pos_embed", "final_norm", "final_norm_w",
           "final_norm_b", "lm_head")


def stage_params_from_numpy(params: Dict[str, np.ndarray],
                            config: ModelConfig, layers: Tuple[int, int],
                            device):
    """The params module of the pipeline stage holding layers
    [lo, hi) of ``config``'s model (``params_from_numpy`` over the
    stage's slice of every layer-stacked leaf), with the stage's layer
    count; the shared leaves (embeddings, final norm, head, position
    table) whole."""
    lo, hi = layers

    def stage(v):
        if isinstance(v, tuple):
            return tuple(np.asarray(x)[lo:hi] for x in v)
        return np.asarray(v)[lo:hi]

    return params_from_numpy(
        {k: v if k in _SHARED else stage(v) for k, v in params.items()},
        dataclasses.replace(config, num_hidden_layers=hi - lo), device)


def _quantized_projection(layer, name: str, targets, biases, params: Dict,
                          i: int, device) -> None:
    """Layer ``i``'s projection ``name`` as a ``QuantLinear`` from the
    int8 pairs of its ``targets``: int8 columns and scales concatenated
    in the targets' order, then [in, out] -> [out, in]; the biases stay
    dense."""
    q = np.concatenate([np.asarray(params[n][0][i]) for n in targets],
                       axis=1)
    scale = np.concatenate([np.asarray(params[n][1][i]) for n in targets])
    dense = getattr(layer, name)
    bias = None
    if biases:
        bias = torch.cat([torch.tensor(np.asarray(params[n][i]))
                          for n in biases]).to(device=device,
                                               dtype=dense.bias.dtype)
    setattr(layer, name, QuantLinear(
        torch.from_numpy(np.ascontiguousarray(q.T)).to(device),
        torch.from_numpy(scale.astype(np.float32)).to(device), bias))
