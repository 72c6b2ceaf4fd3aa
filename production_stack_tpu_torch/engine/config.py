"""Engine configuration objects.

The same field names as the JAX engine's configuration, with torch
dtypes in place of ``jnp`` ones. Only the fields of the port's slice
are here: one llama-family model on one device, full-precision or
int8 KV in per-layer or stacked pages, continuous batching with the
async pipeline, decode bursts, the unified ragged step and
prompt-lookup speculative decoding. Parallelism, offload, LoRA, QoS,
autotuning and the KV economy join the port with the features that
read them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

_DTYPE_MAP = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclasses.dataclass
class ModelConfig:
    """Architecture hyperparameters (HF-config compatible field names)."""

    name: str = "tiny-llama"
    architecture: str = "llama"  # llama | mistral | qwen2
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_hidden_layers: int = 22
    num_attention_heads: int = 32
    num_key_value_heads: int = 4
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "bfloat16"
    # Qwen2-style q/k/v projection biases on the llama-family body.
    attention_bias: bool = False

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPE_MAP[self.dtype]


@dataclasses.dataclass
class CacheConfig:
    """Paged KV cache geometry."""

    page_size: int = 16  # tokens per page
    num_pages: int = 1024  # total pages in device memory
    enable_prefix_caching: bool = True
    # Device buffer layout (models/llama.py cached_attention):
    #   auto      -> per_layer: the JAX engine's rule, under which only
    #                pipeline/context-parallel configs resolve to
    #                stacked, and the port has neither (resolved by the
    #                runner).
    #   stacked   -> one [L, kv, pages, d, page_size] buffer per k/v;
    #                layer writes are in-place scatters through the
    #                layer's view, and the kernels read the layer in
    #                place.
    #   per_layer -> a list of L [kv, pages, d, page_size] buffers.
    cache_layout: str = "auto"
    # KV page storage:
    #   auto / bf16 -> pages in the model's dtype (an f32 model keeps
    #                  f32 pages); the two spellings are synonyms.
    #   int8        -> pages quantized on write with one f32 scale per
    #                  (kv head, page, slot) (ops/quant_kv.py) and
    #                  dequantized inside the attention kernels;
    #                  EngineConfig spends the same device bytes on
    #                  more pages (about 1.9x at bf16 widths).
    kv_cache_dtype: str = "auto"

    def __post_init__(self):
        if self.cache_layout not in ("auto", "stacked", "per_layer"):
            raise ValueError(
                "cache.cache_layout must be 'auto', 'stacked' or "
                f"'per_layer' (got {self.cache_layout!r})")
        if self.kv_cache_dtype not in ("auto", "bf16", "int8"):
            raise ValueError(
                "cache.kv_cache_dtype must be 'auto', 'bf16' or 'int8' "
                f"(got {self.kv_cache_dtype!r})")

    def max_tokens(self) -> int:
        return self.page_size * self.num_pages

    def resolved_kv_dtype(self) -> str:
        """'int8' or 'bf16' (the full-precision family; its pages are
        in the model's dtype)."""
        return "int8" if self.kv_cache_dtype == "int8" else "bf16"

    def kv_slot_bytes(self, model: "ModelConfig") -> int:
        """Device bytes one cached token costs per kv head per k-or-v
        plane: head_dim values plus, for int8, one f32 scale."""
        if self.resolved_kv_dtype() == "int8":
            return model.head_dim + 4
        return model.head_dim * model.torch_dtype.itemsize

    def kv_bytes_per_token(self, model: "ModelConfig") -> int:
        """Total KV bytes appended per committed token (k and v,
        all layers, all kv heads)."""
        return (2 * model.num_hidden_layers
                * model.num_key_value_heads
                * self.kv_slot_bytes(model))


@dataclasses.dataclass
class SchedulerConfig:
    """Continuous-batching shape budget."""

    max_num_seqs: int = 8  # decode batch width (padded)
    max_model_len: int = 2048
    prefill_chunk_size: int = 512  # chunked prefill unit
    # Distinct sequences whose next chunks batch into one prefill
    # step (fixed row count; rows pad with the trash page).
    prefill_batch_size: int = 4
    # Decode iterations chained in one dispatch (the sampled tokens
    # feed back on the device; one host round trip per K tokens).
    # 1 = off (as in JAX, values below 1 read as 1).
    decode_steps: int = 1
    # Overlapped async pipeline: plan and dispatch decode step N+1 —
    # feeding step N's sampled tokens forward as a device tensor —
    # before step N's results are read back to the host. Composes with
    # decode_steps > 1: burst windows run synchronously between
    # pipelined single-step stretches.
    async_scheduling: bool = False
    # Unified ragged step: plan prefill chunks INTO decode steps and
    # execute the mixed batch as one [rows, W] block.
    unified_step: bool = False
    # Draft-free speculative decoding (prompt lookup, engine/spec.py):
    # propose up to K continuation tokens per row from each sequence's
    # own n-gram history and verify all K + 1 positions in ONE ragged
    # step. 0 = off. Composes with async_scheduling (the ahead plan
    # assumes one committed token per row and drops the rows whose
    # verify committed more), with unified_step (drafts ride the
    # mixed step's decode rows) and with decode_steps > 1 as a hybrid
    # (steps whose drafts pay for the burst they displace verify; the
    # rest run the burst).
    speculative_k: int = 0
    # Minimum n-gram length the proposer must match in the sequence's
    # history before drafting its continuation.
    speculative_min_match: int = 2
    max_queue_len: int = 1024

    def __post_init__(self):
        if self.speculative_k < 0:
            raise ValueError("speculative_k must be >= 0 (0 = off)")
        if self.speculative_k > 0 and self.speculative_min_match < 1:
            raise ValueError("speculative_min_match must be >= 1")

    def max_pages_per_seq(self, page_size: int) -> int:
        return math.ceil(self.max_model_len / page_size)


@dataclasses.dataclass
class EngineConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    seed: int = 0

    def __post_init__(self):
        if self.model.architecture not in ("llama", "mistral", "qwen2"):
            raise NotImplementedError(
                "the port serves the llama family (llama, mistral, "
                f"qwen2); got {self.model.architecture!r}")
        if self.cache.resolved_kv_dtype() == "int8" and not getattr(
                self.cache, "_kv_pages_expanded", False):
            # Spend the same device bytes on more, narrower pages: a
            # full-precision slot is head_dim * itemsize bytes, an int8
            # slot head_dim + 4 (its f32 scale). The sentinel lives on
            # the CacheConfig object because dataclasses.replace(self)
            # runs __post_init__ again on the same, expanded instance.
            full_slot = self.model.head_dim * self.model.torch_dtype.itemsize
            expanded = (self.cache.num_pages * full_slot
                        // (self.model.head_dim + 4))
            self.cache = dataclasses.replace(
                self.cache, num_pages=max(expanded, self.cache.num_pages))
            self.cache._kv_pages_expanded = True


def bench_1b_model_config() -> ModelConfig:
    """The 1B-class llama geometry the benchmark server runs."""
    return ModelConfig(
        name="llama-1b-class",
        architecture="llama",
        vocab_size=32128,
        hidden_size=2048,
        intermediate_size=5632,
        num_hidden_layers=16,
        num_attention_heads=32,
        num_key_value_heads=8,
        head_dim=64,
        max_position_embeddings=2048,
        dtype="bfloat16",
    )


def tiny_model_config(architecture: str = "llama") -> ModelConfig:
    """A tiny model for tests that runs anywhere."""
    if architecture != "llama":
        raise NotImplementedError(
            f"the port serves the llama family (got {architecture!r})")
    return ModelConfig(
        name=f"tiny-{architecture}",
        architecture=architecture,
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2,
        max_position_embeddings=512,
        dtype="float32",
    )
