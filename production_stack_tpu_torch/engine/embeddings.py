"""Engine-side /v1/embeddings: pooled hidden states of the served model,
the JAX package's ``engine/embeddings.py`` in the port.

A dense forward (``models.llama.encode``) produces final-norm hidden
states, pooled per sequence (the last real token's, or the mean over
real tokens) and L2-normalized in f32. The score and rerank routes
take the cosine of two such vectors.

Inputs are padded to power-of-two token buckets from 16 up to
``max_len`` and a batch width of 8, the JAX package's shapes. A chunk
runs eagerly, not as a step graph: the server runs it on the engine
loop's thread between two steps (``EngineLoop.call``) and counts it as
an eager step of reason ``embed``. The JAX package's multihost step
bridge has no counterpart: the port serves one device. Weight-only
int8 params are refused, as in JAX (the pooled routes answer 501).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import ModelConfig
from production_stack_tpu_torch.engine.quantization import (
    has_quantized_leaves,
)
from production_stack_tpu_torch.engine.sequence import in_vocab
from production_stack_tpu_torch.models import llama

_POOLING_MODES = ("last", "mean")


class Embedder:
    """Bucketed embedding runner over the serving weights."""

    def __init__(self, config: ModelConfig, params, max_len: int,
                 pooling: str = "last", batch_width: int = 8,
                 encode_fn: Optional[Callable] = None):
        if pooling not in _POOLING_MODES:
            raise ValueError(
                f"pooling must be one of {_POOLING_MODES}, got {pooling!r}"
            )
        if config.architecture not in ("llama", "mistral", "qwen2"):
            raise NotImplementedError(
                "embeddings are implemented for the llama family "
                f"(got architecture={config.architecture!r})"
            )
        if has_quantized_leaves(params):
            raise NotImplementedError(
                "embeddings/score/rerank need unquantized weights "
                "(weight-only int8 is serving-path only)"
            )
        self.config = config
        self.params = params
        self.device = params.embed.device
        # [B, T] device tokens -> final-norm hidden states: the runner's
        # encode (every tp rank on its shard), or llama.encode here.
        self._encode = encode_fn or (
            lambda toks: llama.encode(self.params, self.config, toks))
        self.max_len = max_len
        self.pooling = pooling
        self.batch_width = batch_width

    def _bucket(self, n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_len)

    def run_chunk(self, tokens: np.ndarray,
                  lengths: np.ndarray) -> np.ndarray:
        """One padded chunk: [B, T] tokens, [B] real lengths ->
        [B, hidden] unit vectors (f32, on the host)."""
        with torch.inference_mode():
            toks = torch.from_numpy(tokens).to(self.device)
            lens = torch.from_numpy(lengths).to(self.device)
            hidden = self._encode(toks)
            b, t = toks.shape
            if self.pooling == "last":
                idx = torch.clamp(lens - 1, min=0).long()
                pooled = hidden[torch.arange(b, device=self.device), idx]
            else:
                mask = (torch.arange(t, device=self.device)[None, :]
                        < lens[:, None])
                m = mask[..., None].to(hidden.dtype)
                pooled = (hidden * m).sum(dim=1) / torch.clamp(
                    m.sum(dim=1), min=1.0)
            pooled = pooled.float()
            norm = torch.linalg.norm(pooled, dim=-1, keepdim=True)
            return (pooled / torch.clamp(norm, min=1e-12)).cpu().numpy()

    def embed_batch(self, token_lists: List[List[int]],
                    run: Optional[Callable] = None) -> np.ndarray:
        """Embed tokenized inputs; returns [N, hidden] float32. Each
        input's ids are mapped into the vocabulary as the JAX gather
        reads them (``sequence.in_vocab``) before its chunk is
        published or reaches the device. ``run`` executes each chunk's
        zero-argument function (the server's: on the engine loop's
        thread); None calls it here."""
        out = np.zeros((len(token_lists), self.config.hidden_size),
                       np.float32)
        i = 0
        while i < len(token_lists):
            chunk = token_lists[i:i + self.batch_width]
            t = self._bucket(max(len(x) for x in chunk))
            b = self.batch_width
            tokens = np.zeros((b, t), np.int32)
            lengths = np.zeros((b,), np.int32)
            for j, ids in enumerate(chunk):
                ids = in_vocab(ids[:t], self.config.vocab_size)
                tokens[j, :len(ids)] = ids
                lengths[j] = len(ids)

            def fn(tokens=tokens, lengths=lengths):
                return self.run_chunk(tokens, lengths)

            pooled = fn() if run is None else run(fn)
            out[i:i + len(chunk)] = pooled[:len(chunk)]
            i += len(chunk)
        return out


def parse_embedding_input(raw, tokenizer,
                          max_len: Optional[int] = None
                          ) -> List[List[int]]:
    """OpenAI `input` field: str | [str] | [int] | [[int]] -> token lists."""
    if isinstance(raw, str):
        items = [raw]
    elif isinstance(raw, list) and raw and all(
            isinstance(x, int) for x in raw):
        items = [raw]
    elif isinstance(raw, list):
        items = raw
    else:
        raise ValueError("'input' must be a string, list of strings, "
                         "or token array(s)")
    token_lists: List[List[int]] = []
    for item in items:
        if isinstance(item, str):
            ids = tokenizer.encode(item)
        elif isinstance(item, list) and all(
                isinstance(x, int) for x in item):
            ids = list(item)
        else:
            raise ValueError("'input' entries must be strings or "
                             "integer token arrays")
        if not ids:
            raise ValueError("'input' entries must not be empty")
        if max_len is not None:
            ids = ids[:max_len]
        token_lists.append(ids)
    return token_lists
