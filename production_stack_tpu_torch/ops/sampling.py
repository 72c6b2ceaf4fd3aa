"""Token sampling on the device: temperature, top-k, top-p and greedy,
per-row parameters so one batch mixes sampling configs, the step of a
decode burst (sample, then freeze rows at a stop token or their
budget) and the speculative acceptance rule the unified step samples
through. Before sampling, the per-row options rewrite the logits in the
JAX step's order (``apply_sampling_options``): penalties, ``logit_bias``,
``min_tokens`` suppression, then the guided-decoding mask; logprobs
(``token_logprobs``) are taken from the raw logits.

Randomness comes from ``torch.Generator``s: the engine's stream for
unseeded rows, and for a seeded row a generator seeded from (seed,
emitted-token index) alone, so identical seeded requests reproduce
identical samples whatever the batch. The bits differ from the JAX
package's (``jax.random`` keys); the distributions do not.

The sampler's branches (all-greedy, stochastic, stochastic with a
top-k/top-p mask: ``sampler_mode``) are host decisions taken from the
per-row knobs (temperature, top_p, top_k) on the host, so they never
wait for the device and a greedy step's sampled tokens stay on the
card. The knobs themselves may be CPU tensors (the mode is then read
from them) or device tensors with the mode given: a step replayed as a
CUDA graph (engine/step_graphs.py) reads its knobs from the graph's
static inputs, and its mode is part of the graph's key.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30

# The sampler's host branches: every row greedy; some row stochastic
# with no top-k/top-p mask; some row stochastic and some row masked.
GREEDY, RANDOM, RANDOM_MASKED = "greedy", "random", "random_masked"


def sampler_mode(temperature, top_p, top_k) -> str:
    """The branch the sampler takes for these per-row knobs (numpy
    arrays or CPU tensors; never device tensors, which would wait for
    the device)."""
    if not bool((temperature > 0).any()):
        return GREEDY
    if bool(((top_k > 0) | (top_p < 1.0)).any()):
        return RANDOM_MASKED
    return RANDOM


def apply_penalties(logits: torch.Tensor, counts: torch.Tensor,
                    prompt_mask: torch.Tensor, presence: torch.Tensor,
                    frequency: torch.Tensor,
                    repetition: torch.Tensor) -> torch.Tensor:
    """Sampling penalties, per row: OpenAI presence/frequency over the
    tokens generated so far, vLLM/HF repetition over prompt and output
    (positive logits divided by r, negative multiplied), repetition
    first on the raw logits.

    Args:
      logits:      [B, vocab] f32
      counts:      [B, vocab] int occurrences in the output so far
      prompt_mask: [B, vocab] bool, True where the token is in the prompt
      presence/frequency: [B] f32 (0 disables)
      repetition:  [B] f32 (1 disables)
    """
    countsf = counts.to(logits.dtype)
    seen_out = countsf > 0
    rep = repetition[:, None]
    repeated = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen_out | prompt_mask, repeated, logits)
    logits = logits - presence[:, None] * seen_out.to(logits.dtype)
    return logits - frequency[:, None] * countsf


def apply_suppression(logits: torch.Tensor, ids: torch.Tensor,
                      remaining: torch.Tensor,
                      emitted: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """``min_tokens``: add NEG_INF to each row's stop ids while the row
    is under its minimum.

    Args:
      ids:       [B, W] int stop ids, -1 padded
      remaining: [B] int tokens the row must still emit before a stop
                 may be generated (as of the payload)
      emitted:   [B] tokens this dispatch emitted so far (a burst), or
                 None (one token a dispatch: ``remaining`` is current)
    """
    under = remaining > 0 if emitted is None else emitted < remaining
    pen = torch.where((ids >= 0) & under[:, None], NEG_INF, 0.0).to(
        logits.dtype)
    return logits.scatter_add(1, torch.clamp(ids, min=0).long(), pen)


def apply_guided_mask(logits: torch.Tensor, state: torch.Tensor,
                      mask_table: torch.Tensor) -> torch.Tensor:
    """NEG_INF every token the automaton disallows from a constrained
    row's state (``state`` [B], -1 = unconstrained). ``mask_table``
    [n_states, table width] stops at the byte and special ids
    (engine/guided.py TABLE_WIDTH); every id past it is inadmissible."""
    allowed = mask_table[torch.clamp(state, min=0).long()]
    pad = logits.shape[-1] - allowed.shape[-1]
    if pad > 0:
        allowed = torch.nn.functional.pad(allowed, (0, pad), value=False)
    return torch.where((state >= 0)[:, None] & ~allowed, NEG_INF, logits)


def guided_advance(state: torch.Tensor, sampled: torch.Tensor,
                   active: torch.Tensor,
                   transition: torch.Tensor) -> torch.Tensor:
    """The automaton's step on the device (a burst's carry): a
    constrained, active row moves to ``transition[state, sampled]``;
    the clamps keep the gather in bounds for the other rows."""
    width = transition.shape[1]
    nxt = transition[torch.clamp(state, min=0).long(),
                     torch.clamp(sampled, 0, width - 1).long()]
    return torch.where(active & (state >= 0), nxt.to(state.dtype), state)


def apply_sampling_options(logits: torch.Tensor, inputs: dict,
                           counts: Optional[torch.Tensor] = None,
                           emitted: Optional[torch.Tensor] = None,
                           state: Optional[torch.Tensor] = None,
                           guided_mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The per-row options of one sampling step, in the JAX step's
    order: penalties, ``logit_bias``, ``min_tokens`` suppression, the
    guided mask (last: the grammar wins). Each applies only when its
    inputs are in ``inputs`` (the step's device tensors, by the payload
    names of ``engine/model_runner.py``). A burst passes its carry:
    ``counts`` (occurrences so far), ``emitted`` and the automaton
    ``state``; otherwise they are read from ``inputs``."""
    if "pen_prompt_mask" in inputs:
        logits = apply_penalties(
            logits, inputs["pen_counts"] if counts is None else counts,
            inputs["pen_prompt_mask"], inputs["pen_presence"],
            inputs["pen_frequency"], inputs["pen_repetition"])
    if "logit_bias" in inputs:
        logits = logits + inputs["logit_bias"]
    if "sup_ids" in inputs:
        logits = apply_suppression(logits, inputs["sup_ids"],
                                   inputs["sup_rem"], emitted)
    if "fsm_state" in inputs:
        logits = apply_guided_mask(
            logits, inputs["fsm_state"] if state is None else state,
            guided_mask)
    return logits


def token_logprobs(logits: torch.Tensor, sampled: torch.Tensor, k: int):
    """The sampled token's logprob and the top-``k`` alternatives, from
    the raw distribution (before temperature and the options: the OpenAI
    ``logprobs`` contract).

    Args:
      logits:  [B, vocab] raw logits
      sampled: [B] int sampled ids

    Returns (sampled_logprob [B], top_ids [B, k], top_logprobs [B, k]).
    """
    lp = torch.log_softmax(logits.float(), dim=-1)
    sampled_lp = torch.gather(lp, 1, sampled.long()[:, None])[:, 0]
    top_lp, top_ids = torch.topk(lp, k, dim=-1)
    return sampled_lp, top_ids, top_lp


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
                  seed_mask: Optional[torch.Tensor] = None,
                  mode: Optional[str] = None) -> torch.Tensor:
    """Sample one token per row.

    Args:
      logits:      [B, vocab] float32 (on the device)
      temperature: [B] (0 => greedy), CPU, or on the device with ``mode``
      top_p:       [B] (1.0 => disabled), as temperature
      top_k:       [B] int (0 => disabled), as temperature
      generator:   the engine's stream, used for unseeded rows
      seeds:       optional [B] CPU per-row request seeds
      emitted:     [B] CPU tokens generated so far per row (with seeds)
      seed_mask:   [B] CPU bool, True where the row is seeded (with
                   seeds)
      mode:        the host branch (``sampler_mode``); default: read
                   from the CPU knobs

    Returns [B] int64 token ids on the logits' device.
    """
    mode = mode or sampler_mode(temperature, top_p, top_k)
    greedy_tokens = torch.argmax(logits, dim=-1)
    if mode == GREEDY:
        # All-greedy batch: no sort, no softmax, no randomness.
        return greedy_tokens
    dev = logits.device
    safe_temp = torch.where(temperature > 0, temperature, 1.0)
    scaled = logits / safe_temp.to(dev)[:, None]
    if mode == RANDOM_MASKED:
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
                      seed_mask: Optional[torch.Tensor] = None,
                      mode: Optional[str] = None):
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
      temperature/top_p/top_k/generator/seeds/seed_mask/mode: as in
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
                            emitted=emitted_index, seed_mask=seed_mask,
                            mode=mode)
    out = torch.where(active, sampled, -1)
    emitted = emitted + active.to(emitted.dtype)
    hit_stop = (sampled[:, None] == stop_tokens).any(dim=-1)
    active_next = active & ~hit_stop & (emitted < budgets)
    return out, sampled, emitted, active_next


def spec_verify(logits: torch.Tensor, drafts: torch.Tensor,
                draft_lens: torch.Tensor, temperature: torch.Tensor,
                top_p: torch.Tensor, top_k: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                mode: Optional[str] = None) -> torch.Tensor:
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
      temperature/top_p/top_k/mode: as in sample_tokens (any
                   stochastic row samples under its top-k/top-p mask,
                   whichever stochastic mode is given)
      generator:   the engine's stream

    Returns [B, S] int64: row i's emitted tokens in its first
    ``accepted_i + 1`` slots, -1 beyond.
    """
    mode = mode or sampler_mode(temperature, top_p, top_k)
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
    if mode != GREEDY:
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
