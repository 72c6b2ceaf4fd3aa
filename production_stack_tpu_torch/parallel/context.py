"""Context parallelism's dense forward: the whole model with the
sequence sharded over an sp group, the JAX package's
``parallel/context.py`` in the port (forward only; JAX's dp axis of the
batch is not modelled, the port serves no dp).

Each rank takes its [B, T/n] slice of the tokens, with global positions
``idx * T/n + arange(T/n)``; norms, projections and the MLP are local,
and attention is ring attention (ops/ring_attention.py) over the
group. The logits are gathered along the sequence, so every rank
returns the [B, T, vocab] of JAX's sharded output.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.ops.ring_attention import ring_attention


def context_parallel_forward(params, config: ModelConfig,
                             tokens: torch.Tensor, sp) -> torch.Tensor:
    """Dense causal forward of a llama-family model (the numerics of
    ``models/llama.encode`` with ring attention's online softmax) over
    ``tokens`` [B, T], T divisible by the sp size. Returns f32 logits
    [B, T, vocab] on every rank."""
    n, idx = sp.size, sp.rank
    b, t = tokens.shape
    if t % n:
        raise ValueError(f"sequence {t} must divide by the sp size {n}")
    tl = t // n
    positions = (idx * tl + torch.arange(tl, device=tokens.device)
                 )[None, :].expand(b, tl)
    x = F.embedding(tokens[:, idx * tl:(idx + 1) * tl].long(), params.embed)
    for lp in params.layers:
        a_in = llama.attn_norm(config, lp, x)
        q, k, v = llama.attention_inputs(config, lp, a_in, positions, None,
                                         None, None)
        attn = ring_attention(q, k, v, sp, causal=True)
        x = x + lp.o(attn.reshape(b, tl, -1))
        x = x + llama.mlp(config, lp, llama.mlp_norm(config, lp, x), None,
                          None, None)
    return sp.all_gather(llama.head(params, config, x), dim=1)
