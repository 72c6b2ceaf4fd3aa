"""Multi-LoRA adapter serving, the JAX package's ``engine/lora.py`` in
the port.

Every adapter slot lives on the device in stacked tensors, A [L, S, in,
r] and B [L, S, r, out] per target projection (L layers, S = max_loras
+ 1 slots) and ``scaling`` [S] f32; a batch row selects its adapter by
a gather on a per-row slot id vector (``lora_ids``), so mixed base and
adapter rows run in one step of one shape. Slot 0 stays zero: the base
model. On the card the stacks are inputs of the captured step graphs at
fixed addresses, so ``install_adapter`` writes a slot IN PLACE (the JAX
function returns a new pytree): a graph captured before an adapter was
registered reads it at its next replay.

Adapter files use the HF PEFT format: ``adapter_config.json`` (r,
lora_alpha) and ``adapter_model.safetensors`` (or the ``.npz``
fallback) with ``...layers.{i}.<proj>.lora_A.weight`` keys (GPT-2's
``...h.{i}.``). The safetensors file is read by the port's own reader
(engine/safetensors_io.py), so the port needs no package for it. Ranks
below ``max_lora_rank`` are zero-padded so every adapter fits the
static stack shape.

Targets per architecture, the JAX maps: the llama family's seven
projections; OPT's and GPT-2's q, k, v, o, fc1 and fc2 (GPT-2's fused
``c_attn`` trains one pair, A shared by q, k and v and B split in
three); Mixtral's attention only. Under tensor parallelism a rank's
stacks have its widths (allocated from the rank's config) and every
install cuts the adapter as the base projections are cut
(``parallel/mesh.shard_lora_adapter``, JAX ``lora_stack_specs``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.safetensors_io import read_safetensors
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

# PEFT module name -> the JAX stacked-param name, per architecture
# (mistral and qwen2 take llama's).
_TARGET_MAP = {
    "llama": {
        "q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo",
        "gate_proj": "w_gate", "up_proj": "w_up", "down_proj": "w_down",
    },
    "opt": {
        "q_proj": "wq", "k_proj": "wk", "v_proj": "wv",
        "out_proj": "wo", "fc1": "fc1", "fc2": "fc2",
    },
    "mixtral": {
        "q_proj": "wq", "k_proj": "wk", "v_proj": "wv",
        "o_proj": "wo",
    },
    # GPT-2 fuses q/k/v into c_attn; handled apart in load_peft_adapter
    # (A is shared, B is split three ways).
    "gpt2": {
        "attn.c_proj": "wo", "c_fc": "fc1", "mlp.c_proj": "fc2",
    },
}


def target_shapes(config: ModelConfig) -> Dict[str, Tuple[int, int]]:
    """(in_dim, out_dim) of every LoRA-targetable projection."""
    h = config.hidden_size
    nh, nkv, d = (config.num_attention_heads,
                  config.num_key_value_heads, config.head_dim)
    ffn = config.intermediate_size
    if config.architecture in ("opt", "gpt2"):
        return {
            "wq": (h, nh * d), "wk": (h, nh * d), "wv": (h, nh * d),
            "wo": (nh * d, h), "fc1": (h, ffn), "fc2": (ffn, h),
        }
    if config.architecture == "mixtral":
        # Expert weights are not LoRA targets; attention only.
        return {
            "wq": (h, nh * d), "wk": (h, nkv * d), "wv": (h, nkv * d),
            "wo": (nh * d, h),
        }
    return {
        "wq": (h, nh * d), "wk": (h, nkv * d), "wv": (h, nkv * d),
        "wo": (nh * d, h), "w_gate": (h, ffn), "w_up": (h, ffn),
        "w_down": (ffn, h),
    }


@dataclasses.dataclass
class LoRAAdapter:
    """One loaded adapter: per-target (A [L, in, r], B [L, r, out])."""

    name: str
    rank: int
    scaling: float
    # target name -> (A, B) numpy arrays, already rank-padded.
    weights: Dict[str, Tuple[np.ndarray, np.ndarray]]


def empty_lora_stack(config: ModelConfig, max_loras: int,
                     max_lora_rank: int,
                     device: Union[str, torch.device] = "cpu") -> Dict:
    """All-zero adapter stacks in the model's dtype (slot 0 stays zero
    forever: the base model)."""
    slots = max_loras + 1
    layers = config.num_hidden_layers
    kw = {"dtype": config.torch_dtype, "device": device}
    a, b = {}, {}
    for tgt, (d_in, d_out) in target_shapes(config).items():
        a[tgt] = torch.zeros((layers, slots, d_in, max_lora_rank), **kw)
        b[tgt] = torch.zeros((layers, slots, max_lora_rank, d_out), **kw)
    return {"a": a, "b": b,
            "scaling": torch.zeros((slots,), dtype=torch.float32,
                                   device=device)}


def install_adapter(stack: Dict, slot: int, adapter: LoRAAdapter) -> Dict:
    """Write one adapter into a stack slot, in place (every tensor keeps
    its address); returns ``stack``.

    Targets the adapter does not train are zeroed, so re-registering a
    name never leaves stale weights from the slot's previous occupant.
    An unknown target raises before anything is written."""
    for tgt in adapter.weights:
        if tgt not in stack["a"]:
            raise ValueError(f"Unknown LoRA target {tgt!r}")
    with torch.no_grad():
        for tgt in stack["a"]:
            pair = adapter.weights.get(tgt)
            a_slot = stack["a"][tgt][:, slot]
            b_slot = stack["b"][tgt][:, slot]
            if pair is None:
                a_slot.zero_()
                b_slot.zero_()
            else:
                a_slot.copy_(torch.as_tensor(np.asarray(pair[0])))
                b_slot.copy_(torch.as_tensor(np.asarray(pair[1])))
        stack["scaling"][slot] = float(adapter.scaling)
    return stack


def layer_stacks(stack: Optional[Dict], layer: int) -> Optional[Dict]:
    """One layer's {"a": {target: [S, in, r]}, "b": {...}} views."""
    if stack is None:
        return None
    return {"a": {t: v[layer] for t, v in stack["a"].items()},
            "b": {t: v[layer] for t, v in stack["b"].items()}}


def lora_delta(x: torch.Tensor, lora_layer: Dict, target: str,
               lora_ids: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``scale_b * (x @ A[id_b]) @ B[id_b]`` per batch row, in x's
    dtype: x [B, T, in], lora_ids [B], scale [B] f32."""
    a_sel = lora_layer["a"][target][lora_ids]  # [B, in, r]
    b_sel = lora_layer["b"][target][lora_ids]  # [B, r, out]
    delta = torch.einsum("bti,bir->btr", x, a_sel)
    delta = torch.einsum("btr,bro->bto", delta, b_sel)
    return delta * scale[:, None, None].to(x.dtype)


def lora_matmul(x: torch.Tensor, base, lora_layer: Optional[Dict],
                targets: Union[str, Sequence[str]],
                lora_ids: Optional[torch.Tensor],
                scale: Optional[torch.Tensor]) -> torch.Tensor:
    """``x @ W + scale_b * (x @ A[id_b]) @ B[id_b]`` per batch row.

    ``base`` is the projection module: an ``nn.Linear`` (dense) or a
    ``QuantLinear`` (int8, engine/quantization.py). A fused projection
    names its targets in column order (qkv: wq, wk, wv; gate_up:
    w_gate, w_up), and each target's delta lands in its own column
    block. Without ``lora_layer`` it is the base product alone."""
    out = base(x)
    if lora_layer is None:
        return out
    if isinstance(targets, str):
        targets = (targets,)
    deltas = [lora_delta(x, lora_layer, t, lora_ids, scale)
              for t in targets]
    return out + (deltas[0] if len(deltas) == 1
                  else torch.cat(deltas, dim=-1))


def _read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """The tensors of a safetensors file as numpy arrays: F32 and F16 as
    stored, BF16 widened to f32 (numpy has no bf16)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in read_safetensors(path).items()}


def load_peft_adapter(path: str, config: ModelConfig, max_lora_rank: int,
                      name: Optional[str] = None) -> LoRAAdapter:
    """Load a HuggingFace PEFT adapter directory.

    Expects ``adapter_config.json`` (r, lora_alpha) and
    ``adapter_model.safetensors`` (or ``.npz`` fallback) with keys
    ``...model.layers.{i}.self_attn.q_proj.lora_A.weight`` of shape
    [r, in] (A) and [out, r] (B), transposed here to row-major matmul
    layout and zero-padded to ``max_lora_rank``."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    rank = int(acfg["r"])
    alpha = float(acfg.get("lora_alpha", rank))
    if rank > max_lora_rank:
        raise ValueError(
            f"Adapter rank {rank} exceeds --max-lora-rank {max_lora_rank}")
    st_path = os.path.join(path, "adapter_model.safetensors")
    if os.path.exists(st_path):
        raw = _read_safetensors(st_path)
    else:
        npz = np.load(os.path.join(path, "adapter_model.npz"))
        raw = {k: npz[k] for k in npz.files}

    tmap = _TARGET_MAP.get(config.architecture, _TARGET_MAP["llama"])
    layers = config.num_hidden_layers
    shapes = target_shapes(config)
    per_target: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    def find(i: int, proj: str, kind: str):
        for key in raw:
            # Llama/OPT name layers "...layers.{i}."; GPT-2 "...h.{i}.".
            if ((f"layers.{i}." in key or f"h.{i}." in key)
                    and f"{proj}." in key and f"lora_{kind}" in key):
                return raw[key]
        return None

    for proj, tgt in tmap.items():
        d_in, d_out = shapes[tgt]
        a_stack = np.zeros((layers, d_in, max_lora_rank), np.float32)
        b_stack = np.zeros((layers, max_lora_rank, d_out), np.float32)
        found = False
        for i in range(layers):
            a = find(i, proj, "A")  # [r, in]
            b = find(i, proj, "B")  # [out, r]
            if a is None or b is None:
                continue
            found = True
            r = a.shape[0]
            a_stack[i, :, :r] = np.asarray(a, np.float32).T
            b_stack[i, :r, :] = np.asarray(b, np.float32).T
        if found:
            per_target[tgt] = (a_stack, b_stack)

    if config.architecture == "gpt2":
        # GPT-2's q/k/v live in one fused c_attn [h, 3h] projection.
        # PEFT trains one (A [r, h], B [3h, r]) pair for it; B split in
        # thirds gives each of wq/wk/wv (A, B_chunk): the low-rank
        # update decomposes exactly, the three outputs being disjoint
        # column blocks of c_attn.
        h = config.hidden_size
        a_stack = np.zeros((layers, h, max_lora_rank), np.float32)
        b_stacks = {t: np.zeros((layers, max_lora_rank, h), np.float32)
                    for t in ("wq", "wk", "wv")}
        found = False
        for i in range(layers):
            a = find(i, "c_attn", "A")  # [r, h]
            b = find(i, "c_attn", "B")  # [3h, r]
            if a is None or b is None:
                continue
            found = True
            r = a.shape[0]
            a_stack[i, :, :r] = np.asarray(a, np.float32).T
            bf = np.asarray(b, np.float32)
            for j, t in enumerate(("wq", "wk", "wv")):
                b_stacks[t][i, :r, :] = bf[j * h:(j + 1) * h, :].T
        if found:
            for t in ("wq", "wk", "wv"):
                per_target[t] = (a_stack, b_stacks[t])
    if not per_target:
        raise ValueError(f"No LoRA weights found under {path}")
    return LoRAAdapter(
        name=name or os.path.basename(os.path.normpath(path)),
        rank=rank, scaling=alpha / rank, weights=per_target)


class LoRARegistry:
    """Name -> slot bookkeeping over the device-resident stack."""

    def __init__(self, config: ModelConfig, max_loras: int,
                 max_lora_rank: int,
                 device: Union[str, torch.device] = "cpu", shard=None):
        self.config = config
        # Under tp: the rank's cut of an adapter (the names, slots and
        # cache roots are the full adapter's on every rank).
        self._shard = shard
        self.max_loras = max_loras
        self.max_lora_rank = max_lora_rank
        self.stack = empty_lora_stack(config, max_loras, max_lora_rank,
                                      device)
        self.slots: Dict[str, int] = {}
        # Per-slot prefix-cache namespace roots: adapter KV (wk/wv carry
        # the deltas) must never hit base or other-adapter pages, and a
        # name registered again with new weights must not hit its own
        # stale pages, on the card or in a persistent offload tier
        # (content-addressed, see register()).
        self._cache_roots: Dict[int, int] = {}

    def register(self, adapter: LoRAAdapter) -> int:
        if adapter.name in self.slots:
            slot = self.slots[adapter.name]
        else:
            if len(self.slots) >= self.max_loras:
                raise ValueError(f"All {self.max_loras} LoRA slots in use")
            slot = len(self.slots) + 1  # slot 0 = base
        # Install before committing the name -> slot mapping: an adapter
        # naming a projection this architecture does not expose must not
        # stay registered against an all-zero slot (which would serve
        # the base model under its name).
        install_adapter(self.stack, slot, adapter if self._shard is None
                        else self._shard(adapter))
        self.slots[adapter.name] = slot
        # Content-addressed: identical weights keep their prefix-cache
        # and offload reuse; new weights under the same name get a fresh
        # namespace, across restarts too. The JAX registry's digest.
        h = hashlib.sha256(f"lora:{adapter.name}".encode())
        for tgt in sorted(adapter.weights):
            a, b = adapter.weights[tgt]
            h.update(tgt.encode())
            h.update(np.ascontiguousarray(a).tobytes())
            h.update(np.ascontiguousarray(b).tobytes())
        h.update(repr(adapter.scaling).encode())
        self._cache_roots[slot] = int.from_bytes(h.digest()[:8], "big")
        logger.info("LoRA adapter %r installed in slot %d (rank %d)",
                    adapter.name, slot, adapter.rank)
        return slot

    def slot_for(self, name: Optional[str]) -> int:
        if name is None:
            return 0
        return self.slots[name]

    def cache_root(self, slot: int) -> int:
        """Prefix-cache chain root for a slot (0 = base namespace)."""
        if slot == 0:
            return 0
        return self._cache_roots[slot]

    def names(self) -> List[str]:
        return list(self.slots)
