"""Engine configuration objects.

The same field names as the JAX engine's configuration, with torch
dtypes in place of ``jnp`` ones. Only the fields of the port's slice
are here: one model of the six architectures the JAX registry names
(llama, mistral, qwen2, opt, gpt2, mixtral; ``ModelConfig.from_hf_config``
reads a checkpoint's ``config.json``) on one device, full-precision or
int8 KV in per-layer or stacked pages, continuous batching with the
async pipeline, decode bursts, the unified ragged step and
prompt-lookup speculative decoding, weight-only int8 projections
(``ModelConfig.quantization``), multi-LoRA adapters (``LoRAConfig``),
the KV offload tiers (``OffloadConfig``), QoS classes and shedding
(``QoSConfig``), the KV economy's summary and watermarks
(``KVEconConfig``), the self-tuning controllers' policy
(``AutotuneConfig``), the disaggregation role, stream checkpoints, the
step watchdog and the AWAITING_KV timeout, deferred KV writes in
decode bursts (``SchedulerConfig.deferred_kv_writes``) and tensor
parallelism with its mesh plan (``ParallelConfig``). Pipeline and
context parallelism join the port with the features that read them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from production_stack_tpu_torch.qos import parse_priority

_DTYPE_MAP = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float16": torch.float16,
}


@dataclasses.dataclass
class ModelConfig:
    """Architecture hyperparameters (HF-config compatible field names)."""

    name: str = "tiny-llama"
    architecture: str = "llama"  # llama | opt | gpt2 | mistral | qwen2 | mixtral
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
    # OPT/GPT-2 specifics. do_layer_norm_before is read from an OPT
    # config and, as in the JAX model, not acted on: every OPT layer
    # normalizes before its attention and MLP.
    do_layer_norm_before: bool = True
    activation: str = "silu"  # silu (llama) | relu (opt) | gelu (gpt2)
    # Qwen2-style q/k/v projection biases on the llama-family body.
    attention_bias: bool = False
    # Mixtral-style sparse MoE (architecture == "mixtral").
    num_local_experts: int = 0
    num_experts_per_tok: int = 2
    # Weight-only quantization: none | int8 (engine/quantization.py).
    quantization: str = "none"
    # The --attention-impl the server was given (auto | pallas | xla |
    # pallas-interpret), which deferred KV writes' eligibility reads.
    attention_impl: str = "auto"

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPE_MAP[self.dtype]

    @classmethod
    def from_hf_config(cls, hf: dict, name: str = "") -> "ModelConfig":
        """Build from a HuggingFace ``config.json`` dict: the JAX
        function's field mapping and defaults, field for field."""
        arch = (hf.get("architectures") or ["LlamaForCausalLM"])[0].lower()
        if "gpt2" in arch:
            return cls(
                name=name or hf.get("_name_or_path", "gpt2"),
                architecture="gpt2",
                vocab_size=hf["vocab_size"],
                hidden_size=hf["n_embd"],
                intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"],
                num_hidden_layers=hf["n_layer"],
                num_attention_heads=hf["n_head"],
                num_key_value_heads=hf["n_head"],
                max_position_embeddings=hf["n_positions"],
                tie_word_embeddings=True,
                activation="gelu",
                dtype="bfloat16",
            )
        if "mixtral" in arch:
            return cls(
                name=name or hf.get("_name_or_path", "mixtral"),
                architecture="mixtral",
                vocab_size=hf["vocab_size"],
                hidden_size=hf["hidden_size"],
                intermediate_size=hf["intermediate_size"],
                num_hidden_layers=hf["num_hidden_layers"],
                num_attention_heads=hf["num_attention_heads"],
                num_key_value_heads=hf.get(
                    "num_key_value_heads", hf["num_attention_heads"]),
                head_dim=hf.get("head_dim"),
                max_position_embeddings=hf.get(
                    "max_position_embeddings", 4096),
                rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
                rope_theta=hf.get("rope_theta", 1e6),
                tie_word_embeddings=hf.get("tie_word_embeddings", False),
                num_local_experts=hf.get("num_local_experts", 8),
                num_experts_per_tok=hf.get("num_experts_per_tok", 2),
                activation="silu",
                dtype="bfloat16",
            )
        if "opt" in arch:
            return cls(
                name=name or hf.get("_name_or_path", "opt"),
                architecture="opt",
                vocab_size=hf["vocab_size"],
                hidden_size=hf["hidden_size"],
                intermediate_size=hf.get("ffn_dim", 4 * hf["hidden_size"]),
                num_hidden_layers=hf["num_hidden_layers"],
                num_attention_heads=hf["num_attention_heads"],
                num_key_value_heads=hf["num_attention_heads"],
                max_position_embeddings=hf["max_position_embeddings"],
                tie_word_embeddings=hf.get("tie_word_embeddings", True),
                do_layer_norm_before=hf.get("do_layer_norm_before", True),
                activation="relu",
                dtype="bfloat16",
            )
        qwen = "qwen2" in arch
        return cls(
            name=name or hf.get("_name_or_path", "llama"),
            architecture="qwen2" if qwen else "llama",
            # Qwen2 puts biases on q/k/v (HF Qwen2Attention); plain
            # Llama exposes the same switch via attention_bias.
            attention_bias=(True if qwen
                            else hf.get("attention_bias", False)),
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get(
                "num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            rope_theta=hf.get("rope_theta", 10000.0),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            activation="silu",
            dtype="bfloat16",
        )


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
    # Deferred KV writes inside a decode burst: each iteration's K/V go
    # into dense [B, K, kv, d] tails and flush to the pages once a
    # burst (engine/model_runner.py). Llama family; needs
    # decode_steps > 1; excludes speculative_k (EngineConfig).
    deferred_kv_writes: bool = False
    max_queue_len: int = 1024

    def __post_init__(self):
        if self.speculative_k < 0:
            raise ValueError("speculative_k must be >= 0 (0 = off)")
        if self.speculative_k > 0 and self.speculative_min_match < 1:
            raise ValueError("speculative_min_match must be >= 1")

    def max_pages_per_seq(self, page_size: int) -> int:
        return math.ceil(self.max_model_len / page_size)


@dataclasses.dataclass
class ParallelConfig:
    """The mesh of the JAX ParallelConfig but its dp axis: tp x sp x pp
    ranks, one card each over NCCL. ``tensor_parallel_size`` ranks
    split the heads and the MLP (parallel/mesh.py);
    ``pipeline_parallel_size`` stages split the layers
    (parallel/pipeline_serving.py); ``context_parallel_size`` ranks
    prefill a prompt of at least ``long_prefill_threshold`` tokens (by
    default 2 x prefill_chunk_size) in one dispatch, its sequence
    sharded over them, attention by ring attention
    (parallel/context_serving.py). ``num_slices`` forces the topology
    into that many equal slices (0: discover; one host is one slice);
    ``mesh_placement`` overrides the per-axis placement
    ("tp=ici,pp=any"; 'auto' keeps tp and sp inside one slice)."""

    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    context_parallel_size: int = 1
    long_prefill_threshold: Optional[int] = None
    num_slices: int = 0
    mesh_placement: str = "auto"

    def __post_init__(self):
        if self.tensor_parallel_size < 1:
            raise ValueError("parallel.tensor_parallel_size must be >= 1")
        if self.pipeline_parallel_size < 1:
            raise ValueError("parallel.pipeline_parallel_size must be >= 1")
        if self.context_parallel_size < 1:
            raise ValueError("parallel.context_parallel_size must be >= 1")
        if self.num_slices < 0:
            raise ValueError("parallel.num_slices must be >= 0")
        # Placement typos are refused here, not at the first dispatch.
        from production_stack_tpu_torch.parallel.topology import (
            parse_placement,
        )
        parse_placement(self.mesh_placement)

    @property
    def world_size(self) -> int:
        """Ranks of the tp x sp x pp world."""
        return (self.tensor_parallel_size * self.pipeline_parallel_size
                * self.context_parallel_size)


@dataclasses.dataclass
class LoRAConfig:
    """Multi-LoRA serving (the reference's --enable-lora pass-through;
    see engine/lora.py)."""

    enable: bool = False
    max_loras: int = 8  # adapter slots (slot 0 is always the base model)
    max_lora_rank: int = 16


@dataclasses.dataclass
class OffloadConfig:
    """KV offload tiers (engine/offload.py): host RAM, then a remote
    cache server."""

    enable: bool = False
    host_pool_bytes: int = 2 * 1024 ** 3
    remote_url: Optional[str] = None


@dataclasses.dataclass
class KVEconConfig:
    """Cluster KV economy knobs (docs/kv_economy.md): the summary
    tracker behind GET /kv/summary and the host pool's eviction
    hysteresis. The cache server takes the same flag spellings for its
    own policy, with its own defaults (engine/cache_server.py)."""

    # Hot chains advertised in the /kv/summary snapshot.
    summary_top_k: int = 64
    # Decayed hit count a chain needs before it is advertised as hot.
    admit_hits: int = 2
    # Seconds an idle chain stays in the summary tracker (0 = no TTL).
    ttl_s: float = 900.0
    # Host offload pool fill fractions: above high, evict down to low.
    # 1.0/1.0 evicts exactly at capacity.
    watermark_high: float = 1.0
    watermark_low: float = 1.0

    def __post_init__(self):
        if self.summary_top_k < 1:
            raise ValueError("kvecon.summary_top_k must be >= 1")
        if self.admit_hits < 1:
            raise ValueError("kvecon.admit_hits must be >= 1")
        if self.ttl_s < 0:
            raise ValueError("kvecon.ttl_s must be >= 0")
        if not 0.0 < self.watermark_low <= self.watermark_high <= 1.0:
            raise ValueError(
                "kvecon watermarks must satisfy 0 < low <= high <= 1 "
                f"(got low={self.watermark_low!r} "
                f"high={self.watermark_high!r})")


@dataclasses.dataclass
class QoSConfig:
    """Overload quality of service (docs/qos.md): priority classes,
    preempt-to-offload and the server's shed gate."""

    # Class assumed for requests without an x-priority header.
    default_priority: str = "batch"
    # Under page pressure, ship the preemption victim's committed KV
    # pages to the offload tier (when one is configured) and restore
    # them on re-admission instead of recomputing the prompt.
    preempt_to_offload: bool = True
    # Waiting-queue fill fraction (of max_queue_len) past which the
    # server sheds non-interactive requests with 429 + Retry-After.
    shed_threshold: float = 0.95

    def __post_init__(self):
        parse_priority(self.default_priority)
        if not 0.0 < self.shed_threshold <= 1.0:
            raise ValueError(
                "qos.shed_threshold must be in (0, 1] "
                f"(got {self.shed_threshold!r})")


@dataclasses.dataclass
class AutotuneConfig:
    """Self-tuning controller policy (autotune/).

    Shared cadence/guardrail knobs plus the per-controller clamp
    bands the autotuner enforces. The mode gate is the contract:
    ``off`` never even constructs controllers' tick path, ``shadow``
    computes and span-logs decisions without applying them (the A/B
    story), ``on`` closes the loop.
    """

    # off | shadow | on (autotune.MODES).
    mode: str = "off"
    # Seconds between controller ticks (the bounded cadence).
    interval_s: float = 2.0
    # Relative dead-band: proposals within this fraction of the
    # current knob value are dropped (hysteresis against jitter).
    dead_band: float = 0.05
    # Comma-separated controller-name allowlist, or "all".
    controllers: str = "all"
    # Guardrail blame window: a perf-drift flip / 5m-burn rise
    # freezes every controller that applied a decision this recently.
    freeze_window_s: float = 30.0
    # 5m SLO burn rate at/above which a rise trips the guardrail.
    burn_threshold: float = 1.0
    # Decode ITL p99 target the prefill-budget controller steers
    # toward (grow mixed-step admission while under, shrink over).
    target_itl_ms: float = 50.0
    # Clamp floors/caps for individual controllers. Spec-k cap is
    # --speculative-k itself; checkpoint interval floors/caps bound
    # the halving/doubling walk; shed floor keeps QoS from shedding
    # more than operators signed up for.
    min_spec_k: int = 1
    min_checkpoint_interval_tokens: int = 64
    max_checkpoint_interval_tokens: int = 4096
    min_shed_threshold: float = 0.5

    def __post_init__(self):
        if self.mode not in ("off", "shadow", "on"):
            raise ValueError(
                "autotune.mode must be 'off', 'shadow' or 'on' "
                f"(got {self.mode!r})")
        if self.interval_s <= 0:
            raise ValueError("autotune.interval_s must be > 0")
        if not 0.0 <= self.dead_band < 1.0:
            raise ValueError(
                "autotune.dead_band must be in [0, 1) "
                f"(got {self.dead_band!r})")
        if self.freeze_window_s <= 0:
            raise ValueError("autotune.freeze_window_s must be > 0")
        if self.min_spec_k < 1:
            raise ValueError("autotune.min_spec_k must be >= 1")
        if not 0.0 < self.min_shed_threshold <= 1.0:
            raise ValueError(
                "autotune.min_shed_threshold must be in (0, 1] "
                f"(got {self.min_shed_threshold!r})")
        if (self.min_checkpoint_interval_tokens < 1
                or self.max_checkpoint_interval_tokens
                < self.min_checkpoint_interval_tokens):
            raise ValueError(
                "autotune checkpoint interval bounds must satisfy "
                "1 <= min <= max (got "
                f"min={self.min_checkpoint_interval_tokens!r} "
                f"max={self.max_checkpoint_interval_tokens!r})")


@dataclasses.dataclass
class EngineConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    cache: CacheConfig = dataclasses.field(default_factory=CacheConfig)
    scheduler: SchedulerConfig = dataclasses.field(
        default_factory=SchedulerConfig)
    offload: OffloadConfig = dataclasses.field(
        default_factory=OffloadConfig)
    qos: QoSConfig = dataclasses.field(default_factory=QoSConfig)
    kvecon: KVEconConfig = dataclasses.field(
        default_factory=KVEconConfig)
    autotune: AutotuneConfig = dataclasses.field(
        default_factory=AutotuneConfig)
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    seed: int = 0
    # Disaggregated serving role:
    #   both    -> monolithic engine (default): prefill and decode.
    #   prefill -> computes the prompt's KV, ships its committed pages
    #              to the offload tier and answers a handoff descriptor
    #              instead of a token stream (POST /v1/disagg/prefill).
    #   decode  -> takes handoffs (POST /v1/disagg/handoff), restores
    #              the shipped pages and streams from the second token.
    engine_role: str = "both"
    # Seconds a sequence parked in AWAITING_KV waits for an unreachable
    # offload tier before it degrades to a full recompute.
    handoff_timeout_s: float = 30.0
    # Per-card peak FLOP/s for the observatory's MFU gauge
    # (engine/perf_observatory.py). 0 = resolve from the device-name
    # table; an unknown device (the CPU included) then reports MFU 0.
    device_peak_flops: float = 0.0
    # Every N generated tokens, ship a streaming sequence's committed
    # KV pages to the offload tier and publish a resume descriptor (the
    # token journal) for the router (docs/crash_recovery.md). 0 = off.
    # Without an offload tier only the journal is published.
    checkpoint_interval_tokens: int = 0
    # Seconds one engine step may run before /health answers 503.
    # 0 = off.
    step_watchdog_s: float = 0.0

    def __post_init__(self):
        if self.engine_role not in ("prefill", "decode", "both"):
            raise ValueError(
                "engine_role must be 'prefill', 'decode' or 'both' "
                f"(got {self.engine_role!r})")
        if self.handoff_timeout_s < 0:
            raise ValueError("handoff_timeout_s must be >= 0")
        if self.device_peak_flops < 0:
            raise ValueError("device_peak_flops must be >= 0")
        if self.checkpoint_interval_tokens < 0:
            raise ValueError("checkpoint_interval_tokens must be >= 0")
        if self.step_watchdog_s < 0:
            raise ValueError("step_watchdog_s must be >= 0")
        if (self.engine_role == "prefill"
                and self.scheduler.speculative_k > 0):
            # A prefill-role engine hands off after the first token:
            # speculation, which speeds up decode, would be a config
            # that lies. Async scheduling there is legal and inert (no
            # decode steps to overlap); the server's 'auto' resolves
            # it off.
            raise ValueError(
                "engine_role='prefill' is incompatible with "
                "speculative_k > 0 (speculation speeds up decode; a "
                "prefill-role engine hands off after the first token)")
        if (self.scheduler.speculative_k > 0
                and self.scheduler.deferred_kv_writes):
            raise ValueError(
                "speculative_k is incompatible with deferred_kv_writes "
                "(the verify step writes draft KV eagerly so accepted "
                "tokens can attend to it)")
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
        # Learned-position models (gpt2, opt) index a fixed
        # [max_positions, h] table: cap the serving length at it, as
        # the JAX engine does (its gathers clamp silently; the forwards
        # here clamp explicitly, so a pad slot indexes in range too).
        if (self.model.architecture in ("gpt2", "opt")
                and self.scheduler.max_model_len
                > self.model.max_position_embeddings):
            from production_stack_tpu_torch.utils.log import init_logger
            init_logger(__name__).warning(
                "max_model_len %d exceeds %s's position table (%d); "
                "clamping to %d",
                self.scheduler.max_model_len, self.model.architecture,
                self.model.max_position_embeddings,
                self.model.max_position_embeddings)
            self.scheduler = dataclasses.replace(
                self.scheduler,
                max_model_len=self.model.max_position_embeddings)


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
    """A tiny model for tests that runs anywhere (llama, opt or gpt2,
    the JAX presets)."""
    return ModelConfig(
        name=f"tiny-{architecture}",
        architecture=architecture,
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=2,
        num_attention_heads=4,
        num_key_value_heads=2 if architecture == "llama" else 4,
        max_position_embeddings=512,
        activation={"llama": "silu", "opt": "relu",
                    "gpt2": "gelu"}[architecture],
        dtype="float32",
    )
