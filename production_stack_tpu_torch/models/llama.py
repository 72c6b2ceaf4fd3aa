"""Llama-family model (Llama 2/3, Mistral, Qwen2-style GQA decoders).

Weights are an ``nn.Module`` (``LlamaParams``) of per-layer
``nn.Linear``s, with q/k/v and gate/up fused into one projection each;
``forward`` is a plain function over them, the counterpart of the JAX
package's ``llama.forward``. Attention reads and writes the paged KV
cache in either layout: a list of L [kv, pages, d, page] buffers
(per_layer) or one stacked [L, kv, pages, d, page] buffer (stacked),
each, for an int8 cache, a ``QuantKV`` of int8 pages and their
per-slot scales. ``forward`` updates it IN PLACE (the JAX version
threads updated copies through). Every projection goes through
``engine/lora.lora_matmul``: its base product is the ``nn.Linear``, or
for weight-only int8 (``engine/quantization.QuantLinear``) the
quantized product, plus, with adapter stacks and per-row slot ids,
each row's LoRA delta (the fused qkv and gate_up take their targets'
deltas in their column blocks). ``encode`` is the cache-free dense
forward the pooled routes run (engine/embeddings.py), over unquantized
weights only; ``forward_train`` is ``encode`` and the head, the
differentiable forward of training. ``self_attention`` (and its
``attention_inputs``), ``random_init``, ``lora_args`` and
``select_slots`` serve the other families too (models/opt.py, gpt2.py,
mixtral.py).

``forward`` is ``embed``, ``decoder_layers`` and ``head`` in turn, and
each family has the three (with a layer's ``attn_norm``, ``mlp_norm``
and ``mlp``): a pipeline stage runs its own layers through
``decoder_layers`` (its params hold only those, so the stacked cache
and the adapter stacks are indexed stage-locally), and the
context-parallel prefill composes a layer from its parts around ring
attention (parallel/pipeline_serving.py, context_serving.py).

Tensor parallelism (``tp``, a ``parallel/collectives`` group): every
forward takes the rank's shard (``parallel/mesh.shard_params``) and
the config of that shard (``mesh.rank_model_config``: the rank's
heads), and closes each row-parallel product with one all-reduce
(``row_parallel``: the LoRA delta of the target is summed inside it,
and a replicated bias is added once, after it); a vocab-sharded
``lm_head``'s logits are gathered (``lm_logits``). With ``tp`` None
the forward is the single-device one, bit for bit.

Deferred KV writes (``kv_tail``, decode steps of a burst, llama family
only as in JAX): each layer's K/V go into the burst's dense tails
(``ops/attention.write_to_tail``) instead of the pages, and the decode
kernel's tail form attends over the pages and the tail; the runner
flushes the tails to the pages once a burst.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.lora import layer_stacks, lora_matmul
from production_stack_tpu_torch.ops.attention import (
    page_slots,
    write_slots,
    write_to_tail,
)
from production_stack_tpu_torch.ops.paged_attention_cuda import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_tail_attention,
    paged_decode_tail_attention_plain,
)
from production_stack_tpu_torch.ops.prefill_attention_cuda import (
    paged_prefill_attention,
    paged_prefill_attention_plain,
)
from production_stack_tpu_torch.ops.ragged_attention_cuda import (
    paged_ragged_attention,
    paged_ragged_attention_plain,
)
from production_stack_tpu_torch.ops.rope import apply_rope

ATTENTION_IMPLS = ("cuda", "plain", "plain_bf16p")
# The step kinds the runner names (never inferred from shapes: a
# [32, 5] verify block and a small prefill block both have T > 1).
STEP_KINDS = ("decode", "prefill", "ragged")
# The LoRA targets of the fused projections, in column order.
QKV_TARGETS = ("wq", "wk", "wv")
GATE_UP_TARGETS = ("w_gate", "w_up")


class LlamaLayer(nn.Module):
    def __init__(self, config: ModelConfig, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        h, ffn = config.hidden_size, config.intermediate_size
        nh, nkv, d = (config.num_attention_heads,
                      config.num_key_value_heads, config.head_dim)
        kw = {"dtype": dtype, "device": device}
        self.attn_norm = nn.Parameter(torch.ones(h, **kw))
        self.qkv = nn.Linear(h, (nh + 2 * nkv) * d,
                             bias=config.attention_bias, **kw)
        self.o = nn.Linear(nh * d, h, bias=False, **kw)
        self.mlp_norm = nn.Parameter(torch.ones(h, **kw))
        self.gate_up = nn.Linear(h, 2 * ffn, bias=False, **kw)
        self.down = nn.Linear(ffn, h, bias=False, **kw)


class LlamaParams(nn.Module):
    """The weights of one llama-family model."""

    def __init__(self, config: ModelConfig, device: torch.device,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dtype = dtype or config.torch_dtype
        kw = {"dtype": dtype, "device": device}
        self.embed = nn.Parameter(
            torch.empty(config.vocab_size, config.hidden_size, **kw))
        self.layers = nn.ModuleList(
            LlamaLayer(config, dtype, device)
            for _ in range(config.num_hidden_layers))
        self.final_norm = nn.Parameter(torch.ones(config.hidden_size,
                                                  **kw))
        self.lm_head = (None if config.tie_word_embeddings else
                        nn.Linear(config.hidden_size, config.vocab_size,
                                  bias=False, **kw))
        self.requires_grad_(False)


def dispatch_attention(config: ModelConfig, q, k_cache, v_cache,
                       page_table, positions, kv_lens, kind: str,
                       impl: Optional[str] = None,
                       layer: Optional[int] = None) -> torch.Tensor:
    """Attention over one layer's paged cache (a per-layer buffer, or
    the stacked cache at ``layer``) for the step ``kind``:
    "decode" (T == 1) through the decode kernel, "prefill" chunks
    through the chunked-prefill kernel, "ragged" blocks (unified mixed
    steps and speculative verify steps) through the ragged kernel.

    A ragged row's descriptor is rebuilt from the planner's layout
    invariant, as the JAX forward does: every row kind satisfies
    ``positions[:, 0] == kv_lens - 1 - last_index``, so ``last_index =
    kv_lens - 1 - positions[:, 0]``; a pad row has kv_len 0.

    ``impl`` is "cuda" (the kernel wrappers, which take the plain
    version for CPU tensors), "plain" (the plain versions, on any
    device) or "plain_bf16p" (the plain versions rounded as the card's
    kernels round: for bf16 and f16 queries the prefill and ragged walks
    feed their probabilities to p . v in the query's type, as the
    tensor-core walk does; decode and f32 queries take the f32 walk, as
    their kernels do). The
    default follows the tensors: "cuda" on the card, "plain" on the
    CPU; the engine never asks for a plain impl on the card.
    """
    del config  # shapes come from the tensors
    impl = impl or ("cuda" if q.is_cuda else "plain")
    if impl not in ATTENTION_IMPLS:
        raise ValueError(f"attention impl must be one of "
                         f"{ATTENTION_IMPLS} (got {impl!r})")
    cuda = impl == "cuda"
    # The walks that feed 16-bit probabilities to p . v on the card.
    rounded = ({"p_dtype": q.dtype}
               if impl == "plain_bf16p"
               and q.dtype in (torch.bfloat16, torch.float16) else {})
    if kind == "decode":
        fn = paged_decode_attention if cuda else paged_decode_attention_plain
        return fn(q[:, 0], k_cache, v_cache, page_table, kv_lens,
                  layer=layer)[:, None]
    if kind == "prefill":
        fn = (paged_prefill_attention if cuda
              else paged_prefill_attention_plain)
        return fn(q, k_cache, v_cache, page_table, positions, kv_lens,
                  layer=layer, **rounded)
    if kind == "ragged":
        fn = paged_ragged_attention if cuda else paged_ragged_attention_plain
        last_index = (kv_lens - 1 - positions[:, 0]).to(torch.int32)
        return fn(q, k_cache, v_cache, page_table, kv_lens, last_index,
                  layer=layer, **rounded)
    raise ValueError(f"step kind must be one of {STEP_KINDS} "
                     f"(got {kind!r})")


def tail_attention(q, k, v, kc, vc, page_table, positions, kv_lens,
                   valid, tails, layer: int, at: Optional[int],
                   impl: Optional[str] = None) -> torch.Tensor:
    """A deferred-write decode token: its K/V into the layer's burst
    tails (slot = position - the frozen ``kv_lens``; rows not ``valid``
    leave their tails as they are), then one softmax over the pages
    (positions < kv_lens) and the tail (slot s at kv_lens + s, while at
    most the query's position), through the decode kernel's tail form
    ("cuda") or its plain version."""
    kt, vt = tails[0][layer], tails[1][layer]
    slot = positions[:, 0] - kv_lens
    active = valid[:, 0]
    write_to_tail(kt, k, slot, active)
    write_to_tail(vt, v, slot, active)
    impl = impl or ("cuda" if q.is_cuda else "plain")
    fn = (paged_decode_tail_attention if impl == "cuda"
          else paged_decode_tail_attention_plain)
    q_pos = positions[:, 0].to(torch.int32).contiguous()
    return fn(q[:, 0], kc, vc, page_table, kv_lens, kt, vt, q_pos,
              layer=at)[:, None]


def cached_attention(config: ModelConfig, q, k, v, k_cache, v_cache,
                     page_table, positions, kv_lens, slots, layer: int,
                     kind: str, impl: Optional[str] = None,
                     valid: Optional[torch.Tensor] = None,
                     kv_tail=None) -> torch.Tensor:
    """Write one layer's K/V into the cache (in place) and attend.

    ``k_cache``/``v_cache`` are the per_layer lists (the layer's own
    buffer is written and read) or the stacked caches (written at
    ``layer`` in place, and read there by the kernels, which take the
    layer index). ``slots`` is the step's (pages, offsets) from
    ``ops.attention.page_slots``, shared by every layer. A QuantKV
    cache is written through the quantizing path (``write_slots``
    quantizes each slot's row with its own scale), and the kernels
    dequantize on read. With ``kv_tail`` (a deferred burst's decode
    step) the cache is only read: see ``tail_attention``."""
    if isinstance(k_cache, (list, tuple)):
        kc, vc, at = k_cache[layer], v_cache[layer], None
    else:
        kc, vc, at = k_cache, v_cache, layer
    if kv_tail is not None:
        return tail_attention(q, k, v, kc, vc, page_table, positions,
                              kv_lens, valid, kv_tail, layer, at, impl)
    write_slots(kc, k, *slots, layer=at)
    write_slots(vc, v, *slots, layer=at)
    return dispatch_attention(config, q, kc, vc, page_table, positions,
                              kv_lens, kind, impl=impl, layer=at)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)


def random_leaf(name: str, shape, dtype: torch.dtype,
                generator: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """One leaf of ``random_init``, by its parameter name: unit norms,
    zero biases, N(0, 0.02) for the rest (one draw from ``generator``,
    which must live on ``device``)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.endswith("norm") or leaf.endswith("norm_w"):
        return torch.ones(shape, dtype=dtype, device=device)
    if leaf == "bias" or leaf.endswith("norm_b"):
        return torch.zeros(shape, dtype=dtype, device=device)
    noise = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
    return noise.mul_(0.02).to(dtype)


def random_init(params: nn.Module, generator: torch.Generator,
                device: torch.device) -> nn.Module:
    """Fill a params module of any family in place: N(0, 0.02)
    projections, experts, embeddings and position tables, unit norms,
    zero biases (the JAX inits' distribution, not their bits), drawn in
    the module's parameter order (``random_leaf``)."""
    for name, p in params.named_parameters():
        p.copy_(random_leaf(name, p.shape, p.dtype, generator, device))
    return params


def init_params(config: ModelConfig, generator: torch.Generator,
                device: torch.device) -> LlamaParams:
    """Random-init parameters (for tests, benchmarks and cold starts):
    ``random_init`` over a ``LlamaParams``."""
    return random_init(LlamaParams(config, device), generator, device)


def row_parallel(x: torch.Tensor, base, ll, targets, ids, lora_scale,
                 tp=None) -> torch.Tensor:
    """A row-parallel projection (attention's output, the MLP's down):
    the rank's partial product with its LoRA delta, summed over the
    ranks by ONE all-reduce, then the replicated bias (``row_bias``,
    parallel/mesh.py) added once. Without ``tp`` it is ``lora_matmul``."""
    out = lora_matmul(x, base, ll, targets, ids, lora_scale)
    if tp is None:
        return out
    out = tp.all_reduce(out)
    bias = getattr(base, "row_bias", None)
    return out if bias is None else out + bias


def attention_inputs(config: ModelConfig, lp: nn.Module, a_in: torch.Tensor,
                     positions: torch.Tensor, ll, ids, lora_scale,
                     rope: bool = True):
    """One layer's q [B, T, nh, d], k and v [B, T, nkv, d] from its
    normed input: the fused q/k/v projection (``lp.qkv``, with its bias
    if the family has one, and its LoRA deltas), then RoPE where the
    family uses it (llama, mixtral; OPT and GPT-2 add learned positions
    to the embeddings instead). ``config`` gives the rank's heads."""
    nh, nkv, d = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    b, t = a_in.shape[:2]
    q, k, v = lora_matmul(a_in, lp.qkv, ll, QKV_TARGETS, ids,
                          lora_scale).split([nh * d, nkv * d, nkv * d],
                                            dim=-1)
    q = q.reshape(b, t, nh, d)
    k = k.reshape(b, t, nkv, d)
    v = v.reshape(b, t, nkv, d)
    if rope:
        q = apply_rope(q, positions, config.rope_theta)
        k = apply_rope(k, positions, config.rope_theta)
    else:
        q = q.contiguous()  # a view of the fused projection's output
    return q, k, v


def self_attention(config: ModelConfig, lp: nn.Module, a_in: torch.Tensor,
                   positions: torch.Tensor, page_table, kv_lens, k_cache,
                   v_cache, slots, layer: int, kind: str,
                   impl: Optional[str], ll, ids, lora_scale,
                   rope: bool = True, tp=None,
                   valid: Optional[torch.Tensor] = None,
                   kv_tail=None) -> torch.Tensor:
    """One layer's attention from its normed input to the output
    projection, shared by every family: ``attention_inputs``, the cache
    write and the step kind's kernel, then ``lp.o`` (row-parallel under
    ``tp``) with its LoRA deltas."""
    b, t = a_in.shape[:2]
    q, k, v = attention_inputs(config, lp, a_in, positions, ll, ids,
                               lora_scale, rope)
    attn = cached_attention(config, q, k, v, k_cache, v_cache, page_table,
                            positions, kv_lens, slots, layer, kind,
                            impl=impl, valid=valid, kv_tail=kv_tail)
    return row_parallel(attn.reshape(b, t, -1), lp.o, ll, "wo", ids,
                        lora_scale, tp)


def mlp(config: ModelConfig, lp: nn.Module, m_in: torch.Tensor, ll, ids,
        lora_scale, tp=None) -> torch.Tensor:
    """The gated SiLU MLP of one layer on its normed input, the down
    projection row-parallel under ``tp``."""
    gate, up = lora_matmul(m_in, lp.gate_up, ll, GATE_UP_TARGETS, ids,
                           lora_scale).chunk(2, dim=-1)
    return row_parallel(F.silu(gate) * up, lp.down, ll, "w_down", ids,
                        lora_scale, tp)


def attn_norm(config: ModelConfig, lp: nn.Module,
              x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, lp.attn_norm, config.rms_norm_eps)


def mlp_norm(config: ModelConfig, lp: nn.Module,
             x: torch.Tensor) -> torch.Tensor:
    return rms_norm(x, lp.mlp_norm, config.rms_norm_eps)


def lora_args(lora, lora_ids):
    """(per-row adapter slots, their scales), or (None, None) without
    adapter stacks."""
    if lora is None:
        return None, None
    ids = lora_ids.long()
    return ids, lora["scaling"][ids]  # [B], [B]


def forward(params: LlamaParams, config: ModelConfig,
            tokens: torch.Tensor, positions: torch.Tensor,
            page_table: torch.Tensor, kv_lens: torch.Tensor,
            valid: torch.Tensor, k_cache, v_cache, *, kind: str,
            impl: Optional[str] = None,
            select: Optional[torch.Tensor] = None,
            lora=None, lora_ids: Optional[torch.Tensor] = None,
            tp=None, kv_tail=None) -> torch.Tensor:
    """One model invocation over a (possibly padded) token block:
    ``embed``, ``decoder_layers``, ``head``.

    Args:
      tokens:     [B, T] token ids
      positions:  [B, T] absolute positions (0 for padded slots)
      page_table: [B, max_pages] int32 physical page ids (page 0 = trash)
      kv_lens:    [B] int32 valid cached tokens AFTER this block is written
      valid:      [B, T] mask of real (non-padding) tokens
      k_cache/v_cache: L-lists of [kv_heads, num_pages, head_dim,
                  page_size] buffers, or stacked [L, kv_heads, ...]
                  buffers (either as QuantKVs for int8), written IN
                  PLACE
      kind:       the step kind, "decode", "prefill" or "ragged" (see
                  dispatch_attention)
      impl:       attention impl (see dispatch_attention)
      select:     optional [B, S] int64 indices into T: logits only at
                  those slots (the sampled positions), so a prefill
                  step never materializes [B, T, vocab]
      lora:       optional adapter stacks (engine/lora.py), layer-leading
      lora_ids:   [B] adapter slot per batch row (0 = base model)
      tp:         the rank's tensor-parallel group (params and config
                  the rank's shard), or None
      kv_tail:    a deferred burst's (k tails, v tails), L-lists of
                  [B, S, kv, d] written in place; ``kv_lens`` is then
                  the frozen count of tokens in the pages (decode only)

    Returns f32 logits [B, T, vocab], or [B, S, vocab] with ``select``
    (the full vocabulary on every rank under ``tp``). Every family's
    forward (models/opt.py, gpt2.py, mixtral.py) has this contract
    (``kv_tail`` is the llama family's only, as in JAX).
    """
    x = embed(params, config, tokens, positions)
    x = decoder_layers(params, config, x, positions, page_table, kv_lens,
                       valid, k_cache, v_cache, kind=kind, impl=impl,
                       lora=lora, lora_ids=lora_ids, tp=tp,
                       kv_tail=kv_tail)
    return head(params, config, x, select, tp)


def embed(params: LlamaParams, config: ModelConfig, tokens: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    """The token embeddings [B, T, H] (a pipeline's stage 0 computes
    them)."""
    del config, positions  # llama has no position table
    return F.embedding(tokens.long(), params.embed)


def decoder_layers(params: nn.Module, config: ModelConfig, x: torch.Tensor,
                   positions, page_table, kv_lens, valid, k_cache, v_cache,
                   *, kind: str, impl: Optional[str] = None, lora=None,
                   lora_ids: Optional[torch.Tensor] = None, tp=None,
                   kv_tail=None) -> torch.Tensor:
    """Every layer of ``params.layers`` over the hidden states ``x``
    (``forward``'s arguments): a pipeline stage's params hold its layers
    only, its cache and adapter stacks those layers', so the layer index
    here is the stage-local one."""
    slots = page_slots(page_table, positions, valid,
                       k_cache[0].shape[-1])
    ids, lora_scale = lora_args(lora, lora_ids)
    for layer, lp in enumerate(params.layers):
        ll = layer_stacks(lora, layer)
        a_in = attn_norm(config, lp, x)
        x = x + self_attention(config, lp, a_in, positions, page_table,
                               kv_lens, k_cache, v_cache, slots, layer,
                               kind, impl, ll, ids, lora_scale, tp=tp,
                               valid=valid, kv_tail=kv_tail)
        x = x + mlp(config, lp, mlp_norm(config, lp, x), ll, ids,
                    lora_scale, tp)
    return x


def head(params: LlamaParams, config: ModelConfig, x: torch.Tensor,
         select: Optional[torch.Tensor] = None, tp=None) -> torch.Tensor:
    """f32 logits of the final hidden states (at ``select``'s slots):
    the final norm and ``lm_logits``."""
    x = select_slots(x, select)
    x = rms_norm(x, params.final_norm, config.rms_norm_eps)
    return lm_logits(x, params, tp)


def lm_logits(x: torch.Tensor, params: nn.Module, tp=None) -> torch.Tensor:
    """f32 logits of the final hidden states: the tied embedding
    (replicated, nothing to gather) or ``lm_head`` (vocab-sharded under
    ``tp``: the ranks' logits gathered to the full vocabulary, rank
    order, on every rank)."""
    if getattr(params, "lm_head", None) is None:
        return F.linear(x, params.embed).float()
    logits = F.linear(x, params.lm_head.weight)
    return (logits if tp is None else tp.all_gather(logits)).float()


def select_slots(x: torch.Tensor,
                 select: Optional[torch.Tensor]) -> torch.Tensor:
    """``x`` [B, T, H] at ``select``'s [B, S] slots, or all of it."""
    if select is None:
        return x
    return torch.take_along_dim(x, select[:, :, None], dim=1)


def forward_train(params: LlamaParams, config: ModelConfig,
                  tokens: torch.Tensor) -> torch.Tensor:
    """Cache-free dense causal forward for training and fine-tuning, the
    JAX package's ``llama.forward_train``: ``encode``, then the head;
    f32 logits [B, T, vocab]. The serving numerics without a paged cache
    or a kernel, and no inference or no-grad mode on the path, so it
    records autograd whenever the caller has set ``requires_grad`` on
    the leaves (``LlamaParams`` are made without it:
    ``params.requires_grad_(True)``). The llama family: llama, mistral
    and qwen2 with its q/k/v biases."""
    return lm_logits(encode(params, config, tokens), params)


def encode(params: LlamaParams, config: ModelConfig,
           tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Dense causal forward returning final-norm hidden states
    [B, T, hidden]: the JAX package's ``llama.encode``, which the
    /v1/embeddings, score and rerank routes pool (engine/embeddings.py).

    No paged cache and no kernel: every row attends within the block
    through f32 einsum scores, masked causally with -1e30 and
    softmaxed, in the JAX function's order of operations (the TPU runs
    it outside Pallas as well). Pad tokens sit after a row's last real
    token, so the causal mask keeps them out of every real position.
    Under ``tp`` (the rank's shard and config) the output and down
    projections are row-parallel.
    """
    x = F.embedding(tokens.long(), params.embed)
    x = encode_layers(params.layers, config, x, tp)
    return rms_norm(x, params.final_norm, config.rms_norm_eps)


def encode_layers(layers, config: ModelConfig, x: torch.Tensor,
                  tp=None) -> torch.Tensor:
    """``encode``'s dense causal layers over hidden states [B, T, H]
    (a pipeline stage runs its own; parallel/pipeline.py)."""
    nh, nkv, d = (config.num_attention_heads, config.num_key_value_heads,
                  config.head_dim)
    b, t = x.shape[:2]
    positions = torch.arange(t, device=x.device)[None, :].expand(b, t)
    causal = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    group = nh // nkv
    for lp in layers:
        a_in = rms_norm(x, lp.attn_norm, config.rms_norm_eps)
        q, k, v = lp.qkv(a_in).split([nh * d, nkv * d, nkv * d], dim=-1)
        q = apply_rope(q.reshape(b, t, nh, d), positions,
                       config.rope_theta)
        k = apply_rope(k.reshape(b, t, nkv, d), positions,
                       config.rope_theta)
        v = v.reshape(b, t, nkv, d)
        qg = q.reshape(b, t, nkv, group, d)
        scores = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                              k.float()) / math.sqrt(d)
        scores = torch.where(causal, scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        attn = torch.einsum("bkgts,bskd->btkgd", probs,
                            v.float()).reshape(b, t, nh * d).to(x.dtype)
        x = x + row_parallel(attn, lp.o, None, "wo", None, None, tp)
        m_in = rms_norm(x, lp.mlp_norm, config.rms_norm_eps)
        gate, up = lp.gate_up(m_in).chunk(2, dim=-1)
        x = x + row_parallel(F.silu(gate) * up, lp.down, None, "w_down",
                             None, None, tp)
    return x
