"""HF checkpoint loading, the JAX package's ``engine/weights.py`` in the
port: a local model directory's ``config.json`` and weights into the
port's params module of its architecture (models/registry.py).

Weight names follow the HF conventions of the six architectures the
registry serves: Llama, Mistral and Qwen2 (``model.layers.N.self_attn
.q_proj.weight``, ...), Mixtral (the same attention, and
``block_sparse_moe.experts.E.w1/w3/w2`` for each expert's gate, up and
down), OPT (``model.decoder.layers.N...``) and GPT-2
(``transformer.h.N...``). HF stores an ``nn.Linear`` weight as [out,
in], the port's layout, so nothing is transposed except GPT-2's Conv1D
weights ([in, out]: ``c_attn``, ``attn.c_proj``, ``c_fc``,
``mlp.c_proj``); q, k and v land in their column blocks of the fused
``qkv`` projection (GPT-2's ``c_attn`` already is that projection),
llama's gate and up in ``gate_up``. The JAX tie rule holds: a llama or
mixtral checkpoint with no ``lm_head.weight`` ties the head to the
embeddings (``config.tie_word_embeddings`` set True). Keys no leaf
takes (rotary caches, GPT-2's attention-mask buffers, a tied head) are
skipped, as the JAX loader skips them.

Weights are ``*.safetensors`` files, read by the port's own reader
(engine/safetensors_io.py) in sorted file order, or, without any,
``pytorch_model*.bin`` files through ``torch.load(weights_only=True)``.
Each tensor goes to the device in the config's dtype as it is read, so
host memory holds one tensor at a time (one ``.bin`` shard at a time),
not the whole model.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.safetensors_io import iter_tensors
from production_stack_tpu_torch.models.registry import params_class
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

# A leaf's piece: (port parameter path, index into it, transpose).
Piece = Tuple[str, tuple, bool]
_ALL = (slice(None),)


def checkpoint_files(model_dir: str) -> Tuple[str, List[str]]:
    """("safetensors" | "bin", the weight files in sorted order)."""
    names = sorted(os.listdir(model_dir))
    st = [n for n in names if n.endswith(".safetensors")]
    if st:
        return "safetensors", [os.path.join(model_dir, n) for n in st]
    bins = [n for n in names
            if n.endswith(".bin") and n.startswith("pytorch_model")]
    if bins:
        return "bin", [os.path.join(model_dir, n) for n in bins]
    raise FileNotFoundError(
        f"No safetensors/pytorch_model.bin found in {model_dir}")


def iter_checkpoint(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of every weight of the directory."""
    kind, files = checkpoint_files(model_dir)
    for path in files:
        if kind == "safetensors":
            yield from iter_tensors(path)
            continue
        state = torch.load(path, map_location="cpu", weights_only=True)
        for name in list(state):
            yield name, state.pop(name)


def load_model_config(model_dir: str, name: str = "") -> ModelConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    return ModelConfig.from_hf_config(hf, name=name or model_dir)


def _llama_attention(config: ModelConfig, i: int, rest: str
                     ) -> Optional[Piece]:
    """The llama-family attention and norm leaves of layer ``i``
    (``rest`` is the key after ``layers.{i}.``)."""
    nh, nkv, d = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    rows = {"q_proj": (0, nh * d), "k_proj": (nh * d, (nh + nkv) * d),
            "v_proj": ((nh + nkv) * d, (nh + 2 * nkv) * d)}
    m = re.fullmatch(r"self_attn\.([qkv])_proj\.(weight|bias)", rest)
    if m:
        if m.group(2) == "bias" and not config.attention_bias:
            return None
        lo, hi = rows[f"{m.group(1)}_proj"]
        return f"layers.{i}.qkv.{m.group(2)}", (slice(lo, hi),), False
    return {
        "input_layernorm.weight": (f"layers.{i}.attn_norm", _ALL, False),
        "self_attn.o_proj.weight": (f"layers.{i}.o.weight", _ALL, False),
        "post_attention_layernorm.weight": (f"layers.{i}.mlp_norm", _ALL,
                                            False),
    }.get(rest)


def _llama_piece(config: ModelConfig, name: str) -> Optional[Piece]:
    name = name.removeprefix("model.")
    top = {"embed_tokens.weight": ("embed", _ALL, False),
           "norm.weight": ("final_norm", _ALL, False),
           "lm_head.weight": ("lm_head.weight", _ALL, False)}
    if name in top:
        return top[name]
    m = re.fullmatch(r"layers\.(\d+)\.(.+)", name)
    if not m:
        return None
    i, rest = int(m.group(1)), m.group(2)
    piece = _llama_attention(config, i, rest)
    if piece is not None or config.architecture == "mixtral":
        return piece or _mixtral_piece(config, i, rest)
    ffn = config.intermediate_size
    return {
        "mlp.gate_proj.weight": (f"layers.{i}.gate_up.weight",
                                 (slice(0, ffn),), False),
        "mlp.up_proj.weight": (f"layers.{i}.gate_up.weight",
                               (slice(ffn, 2 * ffn),), False),
        "mlp.down_proj.weight": (f"layers.{i}.down.weight", _ALL, False),
    }.get(rest)


def _mixtral_piece(config: ModelConfig, i: int, rest: str
                   ) -> Optional[Piece]:
    if rest == "block_sparse_moe.gate.weight":
        return f"layers.{i}.moe_gate.weight", _ALL, False
    m = re.fullmatch(r"block_sparse_moe\.experts\.(\d+)\.(w[123])\.weight",
                     rest)
    if not m:
        return None
    e, which = int(m.group(1)), m.group(2)
    if which == "w2":  # down, [H, F] into w_down [H, E, F]
        return f"layers.{i}.w_down", (slice(None), e), False
    return (f"layers.{i}.{'w_gate' if which == 'w1' else 'w_up'}", (e,),
            False)


def _opt_piece(config: ModelConfig, name: str) -> Optional[Piece]:
    name = name.removeprefix("model.").removeprefix("decoder.")
    top = {"embed_tokens.weight": "embed",
           "embed_positions.weight": "pos_embed",
           "final_layer_norm.weight": "final_norm_w",
           "final_layer_norm.bias": "final_norm_b"}
    if name in top:
        return top[name], _ALL, False
    m = re.fullmatch(r"layers\.(\d+)\.(.+)", name)
    if not m:
        return None
    i, rest = int(m.group(1)), m.group(2)
    hd = config.num_attention_heads * config.head_dim
    m = re.fullmatch(r"self_attn\.([qkv])_proj\.(weight|bias)", rest)
    if m:
        j = "qkv".index(m.group(1))
        return (f"layers.{i}.qkv.{m.group(2)}",
                (slice(j * hd, (j + 1) * hd),), False)
    leaf = {"self_attn_layer_norm.weight": "attn_norm_w",
            "self_attn_layer_norm.bias": "attn_norm_b",
            "self_attn.out_proj.weight": "o.weight",
            "self_attn.out_proj.bias": "o.bias",
            "final_layer_norm.weight": "mlp_norm_w",
            "final_layer_norm.bias": "mlp_norm_b",
            "fc1.weight": "fc1.weight", "fc1.bias": "fc1.bias",
            "fc2.weight": "fc2.weight", "fc2.bias": "fc2.bias"}.get(rest)
    return None if leaf is None else (f"layers.{i}.{leaf}", _ALL, False)


def _gpt2_piece(config: ModelConfig, name: str) -> Optional[Piece]:
    del config
    name = name.removeprefix("transformer.")
    top = {"wte.weight": "embed", "wpe.weight": "pos_embed",
           "ln_f.weight": "final_norm_w", "ln_f.bias": "final_norm_b"}
    if name in top:
        return top[name], _ALL, False
    m = re.fullmatch(r"h\.(\d+)\.(.+)", name)
    if not m:
        return None
    i, rest = int(m.group(1)), m.group(2)
    # Conv1D weights are [in, out]: transposed to the nn.Linear layout.
    leaf = {"ln_1.weight": ("attn_norm_w", False),
            "ln_1.bias": ("attn_norm_b", False),
            "attn.c_attn.weight": ("qkv.weight", True),
            "attn.c_attn.bias": ("qkv.bias", False),
            "attn.c_proj.weight": ("o.weight", True),
            "attn.c_proj.bias": ("o.bias", False),
            "ln_2.weight": ("mlp_norm_w", False),
            "ln_2.bias": ("mlp_norm_b", False),
            "mlp.c_fc.weight": ("fc1.weight", True),
            "mlp.c_fc.bias": ("fc1.bias", False),
            "mlp.c_proj.weight": ("fc2.weight", True),
            "mlp.c_proj.bias": ("fc2.bias", False)}.get(rest)
    return None if leaf is None else (f"layers.{i}.{leaf[0]}", _ALL,
                                      leaf[1])


_PIECES = {"llama": _llama_piece, "mistral": _llama_piece,
           "qwen2": _llama_piece, "mixtral": _llama_piece,
           "opt": _opt_piece, "gpt2": _gpt2_piece}


def load_weights(model_dir: str, config: ModelConfig,
                 dtype: Optional[torch.dtype] = None,
                 device=None, rank: int = 0, tp: int = 1,
                 layers=None) -> nn.Module:
    """The checkpoint in ``model_dir`` as ``config``'s params module on
    ``device`` (the card unless the CPU is asked for), in ``dtype``
    (default the config's): rank ``rank``'s shard of ``tp``, with the
    int8 targets quantized when ``config.quantization`` asks. Each
    module is finished (``parallel/mesh.finish_module``: quantized,
    then cut) as soon as its last piece is in, so the device holds the
    rank's shard and the modules still being filled, never the whole
    model. ``layers``: a pipeline stage's [lo, hi) layer range, whose
    layers alone are read (the others' tensors are skipped). Raises if
    a leaf of the module is missing from the checkpoint."""
    from production_stack_tpu_torch.engine.model_runner import (
        resolve_device,
    )
    from production_stack_tpu_torch.parallel.mesh import (
        check_tp,
        finish_module,
        in_layers,
        keep_layers,
    )
    device = resolve_device(device)
    dtype = dtype or config.torch_dtype
    if config.architecture not in _PIECES:
        raise ValueError(f"Unknown architecture: {config.architecture}")
    check_tp(config, tp)
    piece_of = _PIECES[config.architecture]
    # The module tree on the meta device: each leaf is made on the
    # device when its first piece arrives, and set into its module
    # when its last has.
    params = params_class(config)(config, torch.device("meta"), dtype)
    shapes = {path: p.shape for path, p in params.named_parameters()
              if in_layers(path, layers)}
    pending: Dict[str, set] = {}
    for path in shapes:
        pending.setdefault(path.rpartition(".")[0], set()).add(path)
    leaves: Dict[str, torch.Tensor] = {}
    filled: Dict[str, int] = {}
    loaded = 0
    with torch.no_grad():
        for name, tensor in iter_checkpoint(model_dir):
            piece = piece_of(config, name)
            if piece is None or (name.endswith("lm_head.weight")
                                 and getattr(params, "lm_head", 0) is None):
                continue
            path, index, transpose = piece
            if path not in shapes:
                continue  # another stage's layer
            if path not in leaves:
                if filled.get(path):
                    continue  # already complete and set
                leaves[path] = torch.empty(shapes[path], dtype=dtype,
                                           device=device)
                filled[path] = 0
            src = tensor.to(device=device, dtype=dtype)
            dst = leaves[path][index]
            dst.copy_(src.T if transpose else src)
            filled[path] += dst.numel()
            if filled[path] < leaves[path].numel():
                continue
            leaf = leaves.pop(path)
            loaded += leaf.numel() * leaf.element_size()
            owner, _, attr = path.rpartition(".")
            module = params.get_submodule(owner) if owner else params
            setattr(module, attr, nn.Parameter(leaf, requires_grad=False))
            pending[owner].discard(path)
            if not pending[owner]:
                finish_module(params, owner, config, rank, tp)
    if (getattr(params, "lm_head", None) is not None
            and "lm_head.weight" not in filled
            and config.architecture in ("llama", "mistral", "qwen2",
                                        "mixtral")):
        # JAX's rule: no head in the checkpoint ties it to the
        # embeddings.
        config.tie_word_embeddings = True
        params.lm_head = None
        shapes.pop("lm_head.weight")
    missing = [path for path, shape in shapes.items()
               if filled.get(path, 0) != shape.numel()]
    if missing:
        raise ValueError(f"{model_dir}: the checkpoint does not hold "
                         f"(all of) {missing[:8]}"
                         + (" ..." if len(missing) > 8 else ""))
    params.tp_shard = (rank, tp)
    keep_layers(params, layers)
    logger.info("Loaded %s weights from %s (%.2f GB in %s on %s, rank "
                "%d of %d)", config.architecture, model_dir, loaded / 1e9,
                dtype, device, rank, tp)
    return params
