"""Tensor-parallel layout of the weights and the KV cache, the port's
counterpart of the JAX package's ``parallel/mesh.py``.

JAX places each parameter under a ``NamedSharding`` over the ``tp``
mesh axis and lets GSPMD insert the collectives. PyTorch has no such
layer, so here a rank holds its own shard of every parameter and the
models close the row-parallel products with an explicit all-reduce
(``parallel/collectives.py``). ``param_specs`` names, per projection
of the port's params modules, how it is cut (the JAX specs, read for
the port's fused layout):

- column: the output channels split in ``tp`` (q/k/v, gate/up, OPT's
  fc1; their biases and an int8 projection's per-channel scales
  follow);
- row: the input channels split (o, down, fc2); the rank's product is
  a partial sum, and a bias stays whole and is added once, after the
  reduce (``row_bias``);
- vocab: ``lm_head``'s rows split; the logits are gathered;
- expert: Mixtral's experts split, rank r holding experts
  [r E/tp, (r+1) E/tp); the router stays whole;
- everything else is replicated (embeddings, norms, tied heads).

A fused projection is cut part by part: the rank's qkv is its slice of
q, of k and of v, each cut apart and then fused, never a contiguous cut
of the fused matrix (the same for gate/up). ``shard_params`` cuts a
full params module into one rank's shard in place;
``build_rank_params`` (random weights) and the checkpoint loader
(``engine/weights.py``) make a rank's shard one module at a time
(``finish_module``), so a rank's card never holds the whole model;
``shard_cache``
gives a rank its kv heads of every cache form; ``shard_lora_adapter``
cuts an adapter's A/B pairs as their base projections are cut (JAX
``engine/lora.py`` ``lora_stack_specs``); ``rank_model_config`` is the
model config of one rank's shard (its heads and widths).

Pipeline parallelism cuts along the layers as well (JAX places the
stacked [L, ...] leaves, the caches and the adapter stacks ``P('pp',
...)``): a stage holds its L/S layers (``stage_layers``), the
embedding, the final norm and the head (every stage computes the
logits) and GPT-2's position table. ``build_rank_params``, the int8
init and the checkpoint loader take the stage's ``layers`` range and
make only those layers' modules (the random draws of the others are
drawn and dropped, so a stage's weights are the full model's);
``keep_layers`` cuts a full params module to a stage in place,
``stage_lora_adapter`` an adapter's pairs, and ``stage_model_config``
is the config a stage's forward and cache read (its heads and its
layer count). Context parallelism replicates the tp-cut model and the
cache over its sp ranks: nothing more to cut.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.quantization import (
    QuantLinear,
    fused_targets,
)
from production_stack_tpu_torch.models.registry import params_class
from production_stack_tpu_torch.ops.quant_kv import QuantKV

# LoRA targets whose base projection is row-parallel (JAX
# ROW_PARALLEL_TARGETS): A is cut on its input rows, B stays whole.
ROW_PARALLEL_TARGETS = ("wo", "w_down", "fc2")


@dataclasses.dataclass(frozen=True)
class Split:
    """How one parameter is cut: ``kind`` ("column", "row", "vocab",
    "expert" or "replicated"), the ``axis``
    of the port's tensor it is cut on, and for a fused projection the
    widths of its ``parts`` along that axis (each cut apart)."""

    kind: str
    axis: Optional[int] = None
    parts: Optional[Tuple[int, ...]] = None


def param_specs(config: ModelConfig) -> Dict[str, Split]:
    """Per projection name of the family's layer (and ``lm_head``), its
    Split. Names absent here are replicated. Weights are [out, in]
    (``nn.Linear``); Mixtral's experts are [E, F, H] (gate, up) and
    [H, E, F] (down)."""
    nh, nkv, d = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    ffn = config.intermediate_size
    if config.architecture in ("opt", "gpt2"):
        return {"qkv": Split("column", 0, (nh * d,) * 3),
                "o": Split("row", 1),
                "fc1": Split("column", 0),
                "fc2": Split("row", 1)}
    specs = {"qkv": Split("column", 0, (nh * d, nkv * d, nkv * d)),
             "o": Split("row", 1),
             "lm_head": Split("vocab", 0)}
    if config.architecture == "mixtral":
        specs.update({"moe_gate": Split("replicated"),
                      "w_gate": Split("expert", 0),
                      "w_up": Split("expert", 0),
                      "w_down": Split("expert", 1)})
    else:
        specs.update({"gate_up": Split("column", 0, (ffn, ffn)),
                      "down": Split("row", 1)})
    return specs


def check_tp(config: ModelConfig, tp: int) -> None:
    """JAX's guard (engine/model_runner.py): the heads (and the widths
    and experts cut with them) must divide by ``tp``."""
    if tp < 1:
        raise ValueError("tensor_parallel_size must be >= 1")
    if config.num_attention_heads % tp or config.num_key_value_heads % tp:
        raise ValueError(
            f"tensor_parallel_size {tp} must divide both the query heads "
            f"({config.num_attention_heads}) and the KV heads "
            f"({config.num_key_value_heads})")
    if config.architecture == "mixtral":
        if config.num_local_experts % tp:
            raise ValueError(
                f"tensor_parallel_size {tp} must divide the experts "
                f"({config.num_local_experts})")
    elif config.intermediate_size % tp:
        raise ValueError(
            f"tensor_parallel_size {tp} must divide the MLP width "
            f"({config.intermediate_size})")
    if (config.architecture not in ("opt", "gpt2")
            and not config.tie_word_embeddings and config.vocab_size % tp):
        raise ValueError(
            f"tensor_parallel_size {tp} must divide the vocabulary "
            f"({config.vocab_size}) of the untied lm_head")


def rank_model_config(config: ModelConfig, tp: int) -> ModelConfig:
    """The config of one rank's shard: its query and kv heads and, for
    the dense MLPs, its width (head_dim and the vocabulary stay)."""
    check_tp(config, tp)
    if tp == 1:
        return config
    ffn = (config.intermediate_size if config.architecture == "mixtral"
           else config.intermediate_size // tp)
    return dataclasses.replace(
        config, num_attention_heads=config.num_attention_heads // tp,
        num_key_value_heads=config.num_key_value_heads // tp,
        intermediate_size=ffn, head_dim=config.head_dim)


def stage_layers(num_layers: int, stage: int = 0,
                 stages: int = 1) -> Tuple[int, int]:
    """The [lo, hi) layer range of pipeline stage ``stage`` of
    ``stages`` (JAX's refusal when the layers do not divide)."""
    if num_layers % stages:
        raise ValueError(f"layers {num_layers} must divide by "
                         f"pipeline_parallel_size {stages}")
    per = num_layers // stages
    return stage * per, (stage + 1) * per


def stage_model_config(config: ModelConfig, tp: int = 1, stage: int = 0,
                       stages: int = 1) -> ModelConfig:
    """The config of a pipeline stage's tp shard: ``rank_model_config``
    with the stage's layer count."""
    shard = rank_model_config(config, tp)
    if stages == 1:
        return shard
    lo, hi = stage_layers(config.num_hidden_layers, stage, stages)
    return dataclasses.replace(shard, num_hidden_layers=hi - lo)


def in_layers(path: str, layers: Optional[Tuple[int, int]]) -> bool:
    """Whether the leaf or module at ``path`` belongs to a stage of
    layer range ``layers`` (None: every layer): everything outside
    ``layers.<i>`` does."""
    if layers is None or not path.startswith("layers."):
        return True
    return layers[0] <= int(path.split(".")[1]) < layers[1]


def keep_layers(params: nn.Module, layers: Optional[Tuple[int, int]]
                ) -> nn.Module:
    """Cut a params module to the stage of layer range ``layers`` in
    place (None or all of them: as it is); returns it."""
    if layers is None or layers == (0, len(params.layers)):
        return params
    params.layers = nn.ModuleList(list(params.layers)[layers[0]:layers[1]])
    return params


def stage_lora_adapter(adapter, layers: Optional[Tuple[int, int]]):
    """An adapter's per-target (A [L, in, r], B [L, r, out]) pairs cut
    to the stage's layers (JAX shards the stacks' L axis over pp)."""
    if layers is None:
        return adapter
    lo, hi = layers
    return dataclasses.replace(adapter, weights={
        tgt: (np.asarray(a)[lo:hi], np.asarray(b)[lo:hi])
        for tgt, (a, b) in adapter.weights.items()})


def cut(t, axis: int, rank: int, tp: int, parts=None):
    """Rank ``rank``'s shard of ``t`` (a tensor or numpy array) along
    ``axis``: each of ``parts`` (default: the whole axis) cut in ``tp``
    and the rank's pieces joined in order."""
    width = t.shape[axis]
    parts = parts or (width,)
    if sum(parts) != width:
        raise ValueError(f"parts {parts} do not tile axis {axis} of "
                         f"width {width}")
    pieces, start = [], 0
    for part in parts:
        if part % tp:
            raise ValueError(f"a part of width {part} does not divide "
                             f"by tp {tp}")
        step = part // tp
        lo = start + rank * step
        if isinstance(t, np.ndarray):
            pieces.append(np.take(t, np.arange(lo, lo + step), axis=axis))
        else:
            pieces.append(t.narrow(axis, lo, step))
        start += part
    if isinstance(t, np.ndarray):
        return np.concatenate(pieces, axis=axis)
    return torch.cat(pieces, dim=axis).contiguous()


def _replace(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Set parameter or buffer ``name`` of ``module`` to ``value``."""
    if name in module._buffers:
        module._buffers[name] = value
    else:
        setattr(module, name, nn.Parameter(value, requires_grad=False))


def _shard_projection(module: nn.Module, split: Split, rank: int,
                      tp: int) -> None:
    """Cut one projection module (``nn.Linear``, ``QuantLinear``) in
    place. A row-parallel bias moves to ``row_bias`` at tp > 1, added
    once after the reduce (models/llama.row_parallel)."""
    weight = "weight_int8" if hasattr(module, "weight_int8") else "weight"
    _replace(module, weight, cut(getattr(module, weight).data, split.axis,
                                 rank, tp, split.parts))
    if split.kind == "column":
        if hasattr(module, "scale"):
            _replace(module, "scale", cut(module.scale, 0, rank, tp,
                                          split.parts))
        if getattr(module, "bias", None) is not None:
            _replace(module, "bias", cut(module.bias.data, 0, rank, tp,
                                         split.parts))
    elif split.kind == "row" and tp > 1 and module.bias is not None:
        bias = module.bias.data
        module.bias = None
        module.register_parameter(
            "row_bias", nn.Parameter(bias, requires_grad=False))


def shard_module(module: nn.Module, name: str, specs: Dict[str, Split],
                 rank: int, tp: int) -> None:
    """Cut one module of a params tree, ``name`` its attribute in its
    parent, to rank ``rank``'s shard in place: a projection ``specs``
    names as column, row or vocab, or a layer's expert stacks. Any
    other module is replicated and left as it is."""
    split = specs.get(name)
    if split is not None and split.kind in ("column", "row", "vocab"):
        _shard_projection(module, split, rank, tp)
        return
    for leaf, split in specs.items():
        if split.kind == "expert" and leaf in module._parameters:
            _replace(module, leaf, cut(module._parameters[leaf].data,
                                       split.axis, rank, tp))


def shard_params(params: nn.Module, config: ModelConfig, rank: int,
                 tp: int) -> nn.Module:
    """Cut a full params module (any family, dense or int8) into rank
    ``rank``'s shard of ``tp``, in place; returns it. tp 1 leaves it
    as it is, and so does a module already built as this rank's shard
    (``build_rank_params``, the checkpoint loader)."""
    check_tp(config, tp)
    done = getattr(params, "tp_shard", (0, 1))
    if tp == 1 or done == (rank, tp):
        return params
    if done != (0, 1):
        raise ValueError(f"params already hold rank {done[0]}'s shard "
                         f"of tp {done[1]}")
    if not 0 <= rank < tp:
        raise ValueError(f"rank {rank} outside tp {tp}")
    specs = param_specs(config)
    with torch.no_grad():
        for path, module in list(params.named_modules()):
            shard_module(module, path.rpartition(".")[2], specs, rank, tp)
    params.tp_shard = (rank, tp)
    return params


def finish_module(params: nn.Module, path: str, config: ModelConfig,
                  rank: int = 0, tp: int = 1) -> None:
    """Make a module of a params tree whose own leaves are all in the
    rank's: an int8 target projection (``config.quantization``)
    quantized over its full weight, then the module cut to the rank's
    shard. JAX's order: a row-parallel projection's channel scales come
    from its whole input, not the rank's part."""
    parent, _, name = path.rpartition(".")
    module = params.get_submodule(path) if path else params
    if (config.quantization == "int8" and isinstance(module, nn.Linear)
            and parent.startswith("layers.")
            and name in fused_targets(config)):
        module = QuantLinear.from_linear(module)
        setattr(params.get_submodule(parent), name, module)
    if tp > 1:
        shard_module(module, name, param_specs(config), rank, tp)


def build_rank_params(config: ModelConfig, leaf: Callable, rank: int = 0,
                      tp: int = 1, dtype: Optional[torch.dtype] = None,
                      layers: Optional[Tuple[int, int]] = None
                      ) -> nn.Module:
    """Rank ``rank``'s params module of ``tp``, made one module at a
    time: ``leaf(path, shape, dtype)`` gives each full leaf on the
    device, in the module's parameter order, and each module is
    finished (``finish_module``) before the next is made. The device
    holds the rank's shard and one module in full, never the whole
    model. ``layers``: a pipeline stage's layer range; the leaves of
    the other layers are drawn (the draws stay the full model's) and
    dropped."""
    check_tp(config, tp)
    params = params_class(config)(config, torch.device("meta"), dtype)
    with torch.no_grad():
        for path, module in list(params.named_modules()):
            own = list(module.named_parameters(recurse=False))
            for name, p in own:
                full = f"{path}.{name}" if path else name
                value = leaf(full, tuple(p.shape), p.dtype)
                if in_layers(path, layers):
                    setattr(module, name, nn.Parameter(
                        value, requires_grad=False))
                del value
            if own and in_layers(path, layers):
                finish_module(params, path, config, rank, tp)
    params.tp_shard = (rank, tp)
    return keep_layers(params, layers)


def shard_cache(cache, rank: int, tp: int):
    """Rank ``rank``'s kv heads of a cache: per-layer [kv, pages, d,
    page] (axis 0), stacked [L, kv, ...] (axis 1), either as a QuantKV
    whose [(L,) kv, pages, page] scales are cut with it; a list of
    per-layer caches cut element by element."""
    if isinstance(cache, (list, tuple)):
        return [shard_cache(c, rank, tp) for c in cache]
    if isinstance(cache, QuantKV):
        axis = cache.data.dim() - 4
        return QuantKV(cut(cache.data, axis, rank, tp),
                       cut(cache.scale, axis, rank, tp))
    return cut(cache, cache.dim() - 4, rank, tp)


def shard_lora_adapter(adapter, rank: int, tp: int):
    """An adapter's per-target (A [L, in, r], B [L, r, out]) pairs cut
    as their base projections: a column-parallel target's B on its
    output columns, a row-parallel target's A on its input rows (the
    delta is then a partial sum, reduced with the base product)."""
    if tp == 1:
        return adapter
    weights = {}
    for tgt, (a, b) in adapter.weights.items():
        a, b = np.asarray(a), np.asarray(b)
        if tgt in ROW_PARALLEL_TARGETS:
            weights[tgt] = (cut(a, 1, rank, tp), b)
        else:
            weights[tgt] = (a, cut(b, 2, rank, tp))
    return dataclasses.replace(adapter, weights=weights)
