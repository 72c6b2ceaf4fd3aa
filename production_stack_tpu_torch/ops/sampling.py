"""Token sampling on the device: temperature, top-k, top-p and greedy,
per-row parameters so one batch mixes sampling configs, the step of a
decode burst (sample, then freeze rows at a stop token or their
budget) and the speculative acceptance rule the unified step samples
through.

Randomness comes from ``torch.Generator``s: the engine's stream for
unseeded rows, and for a seeded row a generator seeded from (seed,
emitted-token index) alone, so identical seeded requests reproduce
identical samples whatever the batch. The bits differ from the JAX
package's (``jax.random`` keys); the distributions do not.

The per-row knobs (temperature, top_p, top_k) arrive as CPU tensors:
the all-greedy check is then a host decision and never waits for the
device, so a greedy step's sampled tokens stay on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _mask_top_k_top_p(scaled: torch.Tensor, top_p: torch.Tensor,
                      top_k: torch.Tensor) -> torch.Tensor:
    """NEG_INF-mask every logit outside its row's top-k/top-p set.

    Args:
      scaled: [B, vocab] temperature-scaled logits
      top_p:  [B] (1.0 => disabled)
      top_k:  [B] int (0 => disabled)
    """
    b, vocab = scaled.shape
    sorted_logits, sort_idx = torch.sort(scaled, dim=-1, descending=True,
                                         stable=True)
    ranks = torch.arange(vocab, device=scaled.device)[None, :]
    k = torch.where(top_k > 0, top_k, vocab)
    topk_mask = ranks < k[:, None]
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumprobs = torch.cumsum(sorted_probs, dim=-1)
    topp_mask = (cumprobs - sorted_probs) < top_p[:, None]
    masked_sorted = torch.where(topk_mask & topp_mask, sorted_logits,
                                NEG_INF)
    return torch.empty_like(scaled).scatter_(-1, sort_idx, masked_sorted)


def _categorical(logits: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from softmax(logits) (exponential race: argmax
    of p / Exp(1) noise), with no host synchronisation."""
    probs = torch.softmax(logits.float(), dim=-1)
    noise = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / noise, dim=-1)


_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer: every input bit reaches every output
    bit."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def _seeded_generator(seed: int, emitted: int,
                      device: torch.device) -> torch.Generator:
    """The generator of a seeded row's draw at emitted-token index
    ``emitted``. The (seed, index) key is mixed before seeding: the
    CPU generator keeps only the low 32 bits of its seed, which would
    otherwise hold the index alone and drop the request's seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_mix64(((seed & 0xFFFFFFFF) << 32)
                           | (emitted & 0xFFFFFFFF)))
    return gen


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_p: torch.Tensor, top_k: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  seeds: Optional[torch.Tensor] = None,
                  emitted: Optional[torch.Tensor] = None,
                  seed_mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Sample one token per row.

    Args:
      logits:      [B, vocab] float32 (on the device)
      temperature: [B] CPU (0 => greedy)
      top_p:       [B] CPU (1.0 => disabled)
      top_k:       [B] CPU int (0 => disabled)
      generator:   the engine's stream, used for unseeded rows
      seeds:       optional [B] CPU per-row request seeds
      emitted:     [B] CPU tokens generated so far per row (with seeds)
      seed_mask:   [B] CPU bool, True where the row is seeded (with
                   seeds)

    Returns [B] int64 token ids on the logits' device.
    """
    greedy_tokens = torch.argmax(logits, dim=-1)
    if not bool((temperature > 0).any()):
        # All-greedy batch: no sort, no softmax, no randomness.
        return greedy_tokens
    dev = logits.device
    safe_temp = torch.where(temperature > 0, temperature, 1.0)
    scaled = logits / safe_temp.to(dev)[:, None]
    if bool(((top_k > 0) | (top_p < 1.0)).any()):
        scaled = _mask_top_k_top_p(scaled, top_p.to(dev), top_k.to(dev))
    sampled = _categorical(scaled, generator)
    if seeds is not None:
        if seed_mask is None or emitted is None:
            raise ValueError(
                "sample_tokens: seeds requires seed_mask and emitted")
        for i in torch.nonzero(seed_mask).flatten().tolist():
            gen = _seeded_generator(int(seeds[i]), int(emitted[i]), dev)
            sampled[i] = _categorical(scaled[i:i + 1], gen)[0]
    stochastic = (temperature > 0).to(dev)
    return torch.where(stochastic, sampled, greedy_tokens)


def burst_sample_step(logits: torch.Tensor, active: torch.Tensor,
                      emitted: torch.Tensor, budgets: torch.Tensor,
                      stop_tokens: torch.Tensor, temperature: torch.Tensor,
                      top_p: torch.Tensor, top_k: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      seeds: Optional[torch.Tensor] = None,
                      emitted_index: Optional[torch.Tensor] = None,
                      seed_mask: Optional[torch.Tensor] = None):
    """One iteration of a decode burst: sample every row, then freeze
    the rows that finished, all on the device (the JAX runner's
    ``_burst_sample_step`` for the options the port serves).

    Args:
      logits:      [B, vocab] float32 of this iteration (device)
      active:      [B] bool, rows still decoding (device)
      emitted:     [B] int32 tokens each row emitted so far in this
                   burst (device)
      budgets:     [B] int32 tokens each row may emit
                   (``sequence.decode_budget``) (device)
      stop_tokens: [B, S] int32 stop set per row, -1 padded (device)
      temperature/top_p/top_k/generator/seeds/seed_mask: as in
                   sample_tokens
      emitted_index: [B] CPU, a seeded row's absolute emitted-token
                   index at this iteration (tokens emitted before the
                   burst plus the iteration number), computed on the
                   host so the burst never reads ``emitted`` back

    Returns (out, sampled, emitted, active_next): ``out`` [B] holds the
    sampled token of each active row and -1 for a frozen one; a row
    freezes after it samples a stop token or reaches its budget.
    """
    sampled = sample_tokens(logits, temperature, top_p, top_k,
                            generator=generator, seeds=seeds,
                            emitted=emitted_index, seed_mask=seed_mask)
    out = torch.where(active, sampled, -1)
    emitted = emitted + active.to(emitted.dtype)
    hit_stop = (sampled[:, None] == stop_tokens).any(dim=-1)
    active_next = active & ~hit_stop & (emitted < budgets)
    return out, sampled, emitted, active_next


def spec_verify(logits: torch.Tensor, drafts: torch.Tensor,
                draft_lens: torch.Tensor, temperature: torch.Tensor,
                top_p: torch.Tensor, top_k: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
    """Vectorized speculative-decoding acceptance rule.

    One forward pass scored S = K+1 positions per row: the row's last
    committed token followed by its K draft tokens (padded).
    ``logits[:, j]`` is the model's distribution for the token at
    offset j past the committed length. Greedy rows accept draft j iff
    it equals the argmax at offset j; stochastic rows accept it with
    probability p_j(d_j) under the row's full sampling distribution
    and on rejection draw from the residual (the draft masked out).
    Every row emits one token past its accepted prefix. A draft-free
    row (draft_lens 0) reduces to one plain sample — at temperature 0,
    the argmax.

    Args:
      logits:      [B, S, vocab] raw logits (device)
      drafts:      [B, S-1] int draft tokens, -1 padded (device)
      draft_lens:  [B] int in [0, S-1] (device)
      temperature/top_p/top_k: [B] CPU, as in sample_tokens
      generator:   the engine's stream

    Returns [B, S] int64: row i's emitted tokens in its first
    ``accepted_i + 1`` slots, -1 beyond.
    """
    b, s, vocab = logits.shape
    dev = logits.device
    pos = torch.arange(s, device=dev)[None, :]
    in_draft = pos[:, :-1] < draft_lens[:, None]  # [B, S-1]
    dsafe = torch.clamp(drafts, min=0).long()
    # Residual removal mask: at offset j the draft token is excluded
    # from the replacement draw; the bonus column removes nothing.
    remove = torch.zeros((b, s, vocab), dtype=torch.bool, device=dev)
    remove[:, :-1].scatter_(-1, dsafe[..., None], in_draft[..., None])

    greedy_targets = torch.argmax(logits, dim=-1)
    greedy_final = torch.argmax(logits.masked_fill(remove, NEG_INF),
                                dim=-1)
    accept = (drafts.long() == greedy_targets[:, :-1]) & in_draft
    final = greedy_final
    if bool((temperature > 0).any()):
        stochastic = (temperature > 0).to(dev)
        safe_temp = torch.where(temperature > 0, temperature, 1.0).to(dev)
        scaled = (logits / safe_temp[:, None, None]).reshape(b * s, vocab)
        masked = _mask_top_k_top_p(
            scaled, top_p.to(dev).repeat_interleave(s),
            top_k.to(dev).repeat_interleave(s)).reshape(b, s, vocab)
        probs = torch.softmax(masked, dim=-1)
        p_draft = torch.take_along_dim(probs[:, :-1], dsafe[..., None],
                                       dim=-1)[..., 0]
        u = torch.rand((b, s - 1), generator=generator, device=dev)
        accept = torch.where(stochastic[:, None], u < p_draft,
                             accept) & in_draft
        resampled = _categorical(
            masked.masked_fill(remove, NEG_INF).reshape(b * s, vocab),
            generator).reshape(b, s)
        final = torch.where(stochastic[:, None], resampled, greedy_final)
    a = torch.cumprod(accept.long(), dim=-1).sum(dim=-1)  # [B]
    drafts_padded = torch.nn.functional.pad(drafts.long(), (0, 1))
    return torch.where(pos < a[:, None], drafts_padded,
                       torch.where(pos == a[:, None], final, -1))
