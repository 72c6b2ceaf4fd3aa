"""Ring attention: exact causal attention over a sequence-sharded ring,
the JAX package's ``ops/ring_attention.py`` in the port.

Every sp rank holds a T/n slice of the sequence; the K/V blocks rotate
around the ring one hop at a time (the group's ``shift``, JAX's
``ppermute`` i -> i + 1 mod n) and attention accumulates with an online
softmax in f32 (running max, sum and output), so the [T, T] score
matrix never exists on one rank. The block math is JAX's, in its order
of operations: grouped-query heads, global positions ``idx * t +
arange(t)``, scores scaled by 1 / sqrt(d) and masked with -1e30. It is
plain PyTorch: the JAX function reaches no ``pl.pallas_call`` (it is
``lax`` einsums), and on the card each block is two batched matmuls.
K and V ride one hop together (one collective a hop), and the hop
after the last block, whose result JAX discards, is not taken.

It is differentiable, as JAX's is: while autograd records, each hop is
``parallel/collectives.hop``, whose backward is the reverse hop (n - 1
of them a call, the last block taking none forward or back); the
running max is held constant (the result does not depend on it), so
the gradient takes no path through it.

``ring_attention_dense`` is the single-process reference: causal GQA
attention over the whole sequence in f32, for the tests and the card's
check.
"""

from __future__ import annotations

import math

import torch

from production_stack_tpu_torch.parallel.collectives import hop

NEG_INF = -1e30


def _scale(d: int) -> float:
    # JAX: 1 / sqrt(asarray(d, f32)), an f32 value.
    return float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(d))))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, causal: bool = True) -> torch.Tensor:
    """Exact attention with q/k/v sharded along the sequence over
    ``group``'s ranks (an sp group: ``rank``, ``size``, ``shift``).

    Args:
      q: [B, T_local, num_q_heads, head_dim], this rank's query shard
        (rank i covers global positions [i T_local, (i + 1) T_local)).
      k, v: [B, T_local, num_kv_heads, head_dim], its K/V shard
        (num_q_heads a multiple of num_kv_heads).
      causal: mask by global position.

    Returns [B, T_local, num_q_heads, head_dim] in q's dtype.
    """
    n, idx = group.size, group.rank
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = _scale(d)
    dev = q.device
    qg = q.float().reshape(b, t, hkv, g, d)
    q_pos = idx * t + torch.arange(t, device=dev)
    m = torch.full((b, hkv, g, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, g, t), dtype=torch.float32, device=dev)
    o = torch.zeros((b, hkv, g, t, d), dtype=torch.float32, device=dev)
    kv = torch.stack([k, v])
    for step in range(n):
        src = (idx - step) % n  # whose K/V block this hop holds
        kv_pos = src * t + torch.arange(t, device=dev)
        scores = torch.einsum("btkgd,bskd->bkgts", qg, kv[0].float()) * scale
        if causal:
            mask = kv_pos[None, :] <= q_pos[:, None]  # [Tq, Tkv]
            scores = torch.where(mask, scores, NEG_INF)
        new_m = torch.maximum(m, scores.amax(dim=-1)).detach()
        # A fully masked block keeps new_m finite through the old m; the
        # first hop's diagonal block is never fully masked.
        correction = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[..., None])
        l = l * correction + p.sum(dim=-1)
        o = o * correction[..., None] + torch.einsum(
            "bkgts,bskd->bkgtd", p, kv[1].float())
        m = new_m
        if step < n - 1:
            kv = hop(group, kv)
    out = o / l[..., None]  # [B, kv, g, Tq, d]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, hq, d).to(q.dtype)


def ring_attention_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Attention over the whole [B, T, heads, d] sequence on one
    process, f32 scores and softmax (GQA as above): what the ring
    computes, in one block."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.float().reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v.float())
    return out.reshape(b, t, hq, d).to(q.dtype)
