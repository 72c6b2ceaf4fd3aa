"""Text-domain prefix chains and the engine's hot-chain summary.

The port's copy of ``production_stack_tpu/kvecon/summary.py``: the
router compares an engine's advertised chains with its own, so they
must equal the JAX package's bit for bit.

Two hash domains coexist in the KV economy, one per purpose:

- Tier KEYS (engine/offload.py ``_stable_key``) are token-domain
  sha256 over the page's content chain — they address byte payloads
  and must be exact.
- Routing SUMMARIES live in the TEXT domain: the router cannot
  tokenize, so both sides chain-hash the request's prompt text in
  fixed-size character blocks with blake2b (the scheme
  ``PrefixAwarePolicy`` introduced). The engine observes the same
  canonical text the router routes on (``routable_text``), so a chain
  hash computed by the router for an incoming prompt is directly
  comparable against the hot chains an engine advertises at
  ``GET /kv/summary``.

Everything here is dependency-free and cheap: one blake2b pass per
request, no per-step cost.
"""

from __future__ import annotations

import hashlib
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

# ~64 tokens per block at 4 chars/token; must match
# PrefixAwarePolicy.BLOCK_CHARS (router/routing/logic.py delegates
# here so the two can never drift).
BLOCK_CHARS = 256
TOKENS_PER_BLOCK = BLOCK_CHARS // 4


def chain_text(text: str, block_chars: int = BLOCK_CHARS) -> List[int]:
    """Chained blake2b over fixed-size character blocks.

    blake2b, not builtin ``hash()``: str hashing is salted per process
    (PYTHONHASHSEED), so replicated routers and engines would score
    the same prefix with different chains. The chain must be a pure
    function of the text — verified across interpreters by
    tests/test_routing_logic.py.
    """
    out: List[int] = []
    h = b""
    for i in range(0, len(text), block_chars):
        block = text[i:i + block_chars]
        h = hashlib.blake2b(
            h + block.encode("utf-8", "surrogatepass"),
            digest_size=8,
        ).digest()
        out.append(int.from_bytes(h, "big"))
    return out


def routable_text(payload: dict) -> Optional[str]:
    """Stable text rendering of a request's prompt (chat history or
    completion prompt; None when the body carries neither).

    This is the canonical form BOTH sides hash: the router renders it
    from the request body before routing
    (router/services/request_service.py), and the engine server
    renders it from the same body shape when updating its summary —
    the \\x1f/\\x1e separators make the rendering injective so
    "role+content" boundaries can't alias across messages.
    """
    messages = payload.get("messages")
    if isinstance(messages, list):
        parts = []
        for m in messages:
            if isinstance(m, dict) and isinstance(m.get("content"), str):
                parts.append(f"{m.get('role', '')}\x1f{m['content']}")
        return "\x1e".join(parts) if parts else None
    prompt = payload.get("prompt")
    if isinstance(prompt, str):
        return prompt
    if isinstance(prompt, list) and prompt and \
            all(isinstance(p, str) for p in prompt):
        return "\x1e".join(prompt)
    return None


def expected_hit_blocks(chains: List[int],
                        hot: Iterable[int]) -> int:
    """Expected prefix-hit depth of a prompt against a hot-chain set.

    Chain hash i commits to the ENTIRE prefix up to block i, so the
    deepest advertised hash alone determines the match depth — the
    summary's top-k may have decayed intermediate blocks out, which
    must not truncate the estimate.
    """
    hot_set = set(hot)
    best = 0
    for i, h in enumerate(chains):
        if h in hot_set:
            best = i + 1
    return best


class PrefixSummaryTracker:
    """Hit-count-decayed top-k hot chains served by this engine.

    The engine server feeds every request's routable text through
    ``observe_text``; ``snapshot`` returns the admitted hot chains
    (``[[chain_hash, decayed_hits], ...]``) for ``GET /kv/summary``.

    Economy knobs (EngineConfig.kvecon, docs/kv_economy.md):
    - ``admit_hits``: a chain is advertised only once its decayed hit
      count reaches this floor — a prefix seen once is not "hot", and
      advertising it would pull follow-up traffic toward KV that was
      probably never worth keeping.
    - ``ttl_s``: chains idle longer than this are dropped outright
      (0 disables).
    - Hits decay exponentially with ``HALF_LIFE_S`` so the summary
      tracks what is hot NOW, not what was hot an hour ago.

    ``clock`` is injectable for deterministic tests.
    """

    HALF_LIFE_S = 300.0
    # Bounded memory: at most this many tracked chains per top_k slot.
    CAPACITY_FACTOR = 8

    def __init__(self, top_k: int = 64, admit_hits: int = 2,
                 ttl_s: float = 900.0, clock=time.monotonic):
        self.top_k = max(1, int(top_k))
        self.admit_hits = max(1, int(admit_hits))
        self.ttl_s = float(ttl_s)
        self._clock = clock
        # chain_hash -> [decayed_hits_at_last_seen, last_seen]
        self._chains: Dict[int, List[float]] = {}
        self._lock = threading.Lock()

    def _decayed(self, entry: List[float], now: float) -> float:
        hits, last = entry
        if now <= last:
            return hits
        return hits * 0.5 ** ((now - last) / self.HALF_LIFE_S)

    def observe_text(self, text: Optional[str]) -> None:
        if text:
            self.observe(chain_text(text))

    def observe(self, chains: List[int]) -> None:
        if not chains:
            return
        now = self._clock()
        with self._lock:
            for h in chains:
                entry = self._chains.get(h)
                if entry is None:
                    self._chains[h] = [1.0, now]
                else:
                    entry[0] = self._decayed(entry, now) + 1.0
                    entry[1] = now
            self._prune(now)

    def _prune(self, now: float) -> None:
        if self.ttl_s > 0:
            dead = [h for h, e in self._chains.items()
                    if now - e[1] > self.ttl_s]
            for h in dead:
                del self._chains[h]
        cap = self.top_k * self.CAPACITY_FACTOR
        if len(self._chains) > cap:
            ranked = sorted(self._chains.items(),
                            key=lambda kv: self._decayed(kv[1], now),
                            reverse=True)
            self._chains = dict(ranked[:cap])

    def snapshot(self) -> List[Tuple[int, float]]:
        """Admitted hot chains, hottest first: [(chain_hash, hits)]."""
        now = self._clock()
        with self._lock:
            self._prune(now)
            hot = [(h, self._decayed(e, now))
                   for h, e in self._chains.items()]
        hot = [(h, round(v, 3)) for h, v in hot
               if v >= self.admit_hits]
        hot.sort(key=lambda kv: (-kv[1], kv[0]))
        return hot[:self.top_k]

    def hot_count(self) -> int:
        return len(self.snapshot())

    def __len__(self) -> int:
        with self._lock:
            return len(self._chains)
