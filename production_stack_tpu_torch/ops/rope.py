"""Rotary position embeddings (RoPE), the Llama flavor.

A pure function of positions, so packed prefill chunks and scattered
decode batches share it (no precomputed table).
"""

import torch


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotate q or k.

    Args:
      x: [..., seq, heads, head_dim]
      positions: [..., seq] absolute token positions
      theta: rope base frequency
    """
    head_dim = x.shape[-1]
    half = head_dim // 2
    freq_exponents = (torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    timescale = theta ** freq_exponents  # [half]
    angles = positions[..., None].float() / timescale  # [..., seq, half]
    angles = angles[..., None, :]  # broadcast over heads
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
