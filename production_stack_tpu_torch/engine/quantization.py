"""Weight-only int8 quantization for serving, the JAX package's
``engine/quantization.py`` in the port.

Decode streams every projection weight once a step, so storing the
projections as int8 with one f32 scale per output channel halves the
weight bytes a step reads. It is a load-time transform (symmetric,
no calibration data), selected by ``ModelConfig.quantization`` /
``--quantization int8``.

A quantized projection is a ``QuantLinear``: ``weight_int8`` [out, in]
int8 and ``scale`` [out] f32 buffers (the ``nn.Linear`` orientation of
the JAX pair ``(q [in, out], scale [out])``) and the optional bias. Its
product of at most ``INT8_KERNEL_MAX_ROWS`` rows (decode, verify and
burst steps) runs the int8-weight GEMM (ops/int8_matmul_cuda.py: the
CUDA kernel on the card, its plain version on the CPU), which reads the
int8 bytes once; a larger product (prefill chunks, unified steps) takes
JAX's form, ``dequant_matmul``. Because the scale is per output
channel, the fused ``qkv`` and ``gate_up`` projections quantize to
exactly the concatenation of JAX's separate ``wq``/``wk``/``wv`` and
``w_gate``/``w_up`` quantizations.

Serving path only: the dense encode forward of the pooled routes needs
unquantized weights (the Embedder refuses quantized params).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.ops.int8_matmul_cuda import (
    INT8_KERNEL_MAX_ROWS,
    int8_weight_matmul,
)

# Projections quantized per architecture, by the JAX names. Norms,
# embeddings, position tables, biases and the LM head stay in full
# precision; mixtral has no entry (JAX refuses it: its experts are
# not targets and its attention alone would save little).
_TARGETS = {
    "llama": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
    "mistral": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
    "qwen2": ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"),
    "opt": ("wq", "wk", "wv", "wo", "fc1", "fc2"),
    "gpt2": ("wq", "wk", "wv", "wo", "fc1", "fc2"),
}
# The port's fused projections and the JAX targets they hold, in column
# order: the llama family's, then OPT's and GPT-2's (their MLP
# projections are unfused).
FUSED_TARGETS = {
    "qkv": ("wq", "wk", "wv"),
    "o": ("wo",),
    "gate_up": ("w_gate", "w_up"),
    "down": ("w_down",),
}
_DECODER_FUSED_TARGETS = {
    "qkv": ("wq", "wk", "wv"),
    "o": ("wo",),
    "fc1": ("fc1",),
    "fc2": ("fc2",),
}


def fused_targets(config: ModelConfig):
    """{projection module name: the JAX targets it holds} of a layer of
    ``config``'s architecture (quantizable or not)."""
    if config.architecture in ("opt", "gpt2"):
        return _DECODER_FUSED_TARGETS
    if config.architecture == "mixtral":
        return {"qkv": FUSED_TARGETS["qkv"], "o": FUSED_TARGETS["o"]}
    return FUSED_TARGETS


def _targets(config: ModelConfig) -> Tuple[str, ...]:
    targets = _TARGETS.get(config.architecture)
    if targets is None:
        raise NotImplementedError(
            f"--quantization int8 is not supported for "
            f"architecture {config.architecture!r}")
    return targets


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 over the contraction dim of a
    [..., out, in] weight: (q int8 [..., out, in], scale f32 [...,
    out]), JAX's arithmetic on the transposed layout."""
    w32 = w.float()
    scale = torch.amax(torch.abs(w32), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return q, scale.squeeze(-1)


def dequant_matmul(x: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """JAX's expression and rounding order: the product in x's dtype
    against the converted weight, then times the scale in x's dtype."""
    out = F.linear(x, q.to(x.dtype))
    return out * scale.to(x.dtype)


class QuantLinear(nn.Module):
    """An int8 projection: ``weight_int8`` [out, in], ``scale`` [out] f32
    (buffers) and an optional bias."""

    def __init__(self, weight_int8: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("weight_int8", weight_int8.contiguous())
        self.register_buffer("scale", scale.float().contiguous())
        self.bias = (None if bias is None
                     else nn.Parameter(bias.detach().clone(),
                                       requires_grad=False))

    @classmethod
    def from_linear(cls, linear: nn.Linear) -> "QuantLinear":
        q, scale = quantize_weight(linear.weight.detach())
        return cls(q, scale, linear.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.numel() // max(x.shape[-1], 1)
        if rows <= INT8_KERNEL_MAX_ROWS:
            out = int8_weight_matmul(x.contiguous(), self.weight_int8,
                                     self.scale)
        else:
            out = dequant_matmul(x, self.weight_int8, self.scale)
        if self.bias is not None:
            out = out + self.bias
        return out


def is_quantized(module) -> bool:
    return isinstance(module, QuantLinear)


def has_quantized_leaves(params: nn.Module) -> bool:
    return any(is_quantized(m) for m in params.modules())


def quantize_params(params: nn.Module, config: ModelConfig) -> nn.Module:
    """Replace every target projection of ``params`` (any family's
    params module) with its ``QuantLinear``, in place; returns
    ``params``."""
    _targets(config)
    with torch.no_grad():
        for layer in params.layers:
            for name in fused_targets(config):
                mod = getattr(layer, name)
                if isinstance(mod, nn.Linear):
                    setattr(layer, name, QuantLinear.from_linear(mod))
    return params


def init_random_quantized(config: ModelConfig, seed: int,
                          device: torch.device, rank: int = 0,
                          tp: int = 1, layers=None) -> nn.Module:
    """Random int8 weights without materialising the projections in
    full precision: each target is uniform int8 in [-127, 127] with a
    flat 0.02 / 127 scale (the magnitude of the dense init), embeddings,
    position tables and the LM head N(0, 0.02), norms ones, biases
    zeros; the JAX function's leaf kinds and distribution, drawn with
    numpy's PCG64 from ``seed``, not its bits. Peak device memory is
    the serving footprint: only the int8 bytes and the non-target
    leaves land on the card. Under tensor parallelism (``tp`` > 1)
    every rank draws the same full leaves and keeps rank ``rank``'s
    shard of each module as it is made (``parallel/mesh.py``). A
    pipeline stage (``layers``, its [lo, hi) range) keeps its layers:
    the others' draws are made on the host and dropped."""
    from production_stack_tpu_torch.models.registry import params_class
    from production_stack_tpu_torch.parallel.mesh import (
        keep_layers,
        param_specs,
        shard_module,
    )

    _targets(config)
    rng = np.random.Generator(np.random.PCG64(seed & 0x7FFFFFFF))
    dtype = config.torch_dtype
    # The module tree on the meta device (no memory); every leaf is
    # replaced below by one made on ``device``.
    out = params_class(config)(config, torch.device("meta"))
    targets = fused_targets(config)

    def dense(shape, on):
        host = 0.02 * rng.standard_normal(shape, dtype=np.float32)
        return torch.from_numpy(host).to(device=on, dtype=dtype)

    def leaf(name, shape, on):
        if name.endswith("norm") or name.endswith("norm_w"):
            return torch.ones(shape, dtype=dtype, device=on)
        if name == "bias" or name.endswith("norm_b"):
            return torch.zeros(shape, dtype=dtype, device=on)
        return dense(shape, on)

    def quant(lin, on):
        q = rng.integers(-127, 128,
                         size=(lin.out_features, lin.in_features),
                         dtype=np.int8)
        bias = (None if lin.bias is None else
                torch.zeros(lin.out_features, dtype=dtype, device=on))
        return QuantLinear(
            torch.from_numpy(q).to(on),
            torch.full((lin.out_features,), 0.02 / 127.0,
                       dtype=torch.float32, device=on), bias)

    def replace_leaves(module, on=device):
        for name, p in list(module.named_parameters(recurse=False)):
            setattr(module, name, nn.Parameter(
                leaf(name, tuple(p.shape), on), requires_grad=False))

    # The draws in the order of the llama-only init this generalises:
    # the embeddings (and position table), the LM head, then each
    # layer's targets.
    specs = param_specs(config)

    def shard(module, name):
        if tp > 1:
            shard_module(module, name, specs, rank, tp)

    replace_leaves(out)
    if getattr(out, "lm_head", None) is not None:
        replace_leaves(out.lm_head)
        shard(out.lm_head, "lm_head")
    kept = range(*(layers or (0, len(out.layers))))
    for i, layer in enumerate(out.layers):
        on = device if i in kept else torch.device("cpu")
        replace_leaves(layer, on)
        shard(layer, "")
        for name in targets:
            setattr(layer, name, quant(getattr(layer, name), on))
            shard(getattr(layer, name), name)
    out.tp_shard = (rank, tp)
    return keep_layers(out, layers)
