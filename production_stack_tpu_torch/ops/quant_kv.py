"""Quantized paged-KV container: int8 pages plus per-slot f32 scales.

The port's copy of the JAX package's ``ops/quant_kv.py``. The ``data``
leaf keeps the page layout of a full-precision cache, one
``[kv_heads, num_pages, head_dim, page_size]`` buffer per layer or one
stacked ``[L, ...]`` buffer, stored as int8. The ``scale`` leaf drops
the head_dim axis: one f32 symmetric scale per (layer, kv head, page,
page slot), ``[(L,) kv_heads, num_pages, page_size]``. Per-slot
scales make every incremental write exact: a decode commit, a draft
written early for a verify step or a pad slot sent to trash page 0
writes only its own slot and that slot's scale, and never rescales a
neighbour.

``QuantKV`` is not a tuple: the per_layer cache lists hold one per
layer, and the container reads as one array-like object. ``shape``,
``dim()`` and ``dtype`` are the data leaf's, so rank checks and
``shape[-1]`` (the page size) work unchanged, and ``__getitem__``
applies the same index to both leaves. That is valid for every index the engine uses
(``[layer]``, ``[:, page_table]``, ``[:, page_id]``, ``[:, :,
page_id]``), all of which touch only the leading ``[L?, kv, pages]``
axes the two leaves share; ``[layer]`` of a stacked cache is a view of
both leaves (the same storage, no copy).
"""

from __future__ import annotations

import torch

# Symmetric int8 with an amax / 127 scale, floored so an all-zero slot
# stays invertible (the JAX package's constants).
_QMAX = 127.0
_SCALE_FLOOR = 1e-8


class QuantKV:
    """int8 KV pages plus their per-(kv head, page, slot) f32 scales."""

    __slots__ = ("data", "scale")

    def __init__(self, data: torch.Tensor, scale: torch.Tensor):
        self.data = data
        self.scale = scale

    @property
    def shape(self) -> torch.Size:
        return self.data.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    def dim(self) -> int:
        return self.data.dim()

    def __getitem__(self, idx) -> "QuantKV":
        return QuantKV(self.data[idx], self.scale[idx])

    def __repr__(self) -> str:
        return (f"QuantKV(data={tuple(self.data.shape)}, "
                f"scale={tuple(self.scale.shape)})")


def quantize_kv(x: torch.Tensor):
    """Quantize new KV rows ``[..., head_dim]`` to (int8, f32 scale).

    The scale is the amax over the trailing head_dim axis / 127, one
    per (token, kv head) row, floored at 1e-8; values round half to
    even (``torch.round``, as ``jnp.round``) and clip to +-127. Returns
    ``(q, scale)``: ``q`` int8 shaped like ``x``, ``scale`` f32 shaped
    ``x.shape[:-1]``.
    """
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / _QMAX, min=_SCALE_FLOOR)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def quant_cache_zeros(shape, device=None) -> QuantKV:
    """A zero quantized cache for the page layout ``shape`` =
    ``[..., num_pages, head_dim, page_size]``."""
    shape = tuple(shape)
    scale_shape = shape[:-2] + (shape[-1],)
    return QuantKV(torch.zeros(shape, dtype=torch.int8, device=device),
                   torch.zeros(scale_shape, dtype=torch.float32,
                               device=device))
