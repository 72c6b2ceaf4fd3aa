"""Managed shared-cache policy for the cluster cache server.

The port's copy of ``production_stack_tpu/kvecon/cluster_cache.py``,
behind the port's cache server (engine/cache_server.py).

``ManagedKVStore`` replaces the cache server's plain write-through
LRU (engine/cache_server.py) with an explicit economy:

- **Admission by demand promotion.** A chain's pages are accepted
  only after the chain has been *wanted* by ``admit_hits`` distinct
  requesters (engines / requests) — recorded on PUTs and on probe or
  fetch misses. A chain computed once and never asked for again never
  displaces genuinely shared prefixes. Rejected PUTs return
  ``{"admitted": false}`` with HTTP 200; the engine-side client
  treats that as success (satellite: no retry storm).
- **TTL + watermark eviction, coldest chains whole.** When stored
  bytes exceed ``watermark_high * max_bytes``, chains are evicted in
  coldest-first order (least-recent access) down to
  ``watermark_low * max_bytes``. Pages of a chain live and die
  together: a chain with its middle evicted is useless to the
  restore path (``lookup_chain`` walks parent→child), so partial
  eviction would waste both the bytes kept and the fetches spent.
- **Per-chain metadata** (hits, distinct requesters, last access,
  byte size, kv_dtype) for /stats and the kvcache:* metrics.

Chain grouping: the engine tags uploads with ``X-KV-Chain`` (the
stable key of the chain's ROOT page hash). Untagged pages form a
singleton chain keyed by their own key, which degrades exactly to
per-page LRU — legacy clients keep working.

The store is policy only — no HTTP here. ``clock`` is injectable so
tests can drive TTL/eviction state machines deterministically.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

CHAIN_HEADER = "X-KV-Chain"
REQUESTER_HEADER = "X-KV-Requester"


@dataclass
class ChainMeta:
    """Bookkeeping for one admitted (or still-courting) chain."""

    chain_id: str
    bytes: int = 0
    hits: int = 0
    last_access: float = 0.0
    kv_dtype: str = ""
    keys: List[str] = field(default_factory=list)
    requesters: Set[str] = field(default_factory=set)

    @property
    def demand(self) -> int:
        return len(self.requesters)


class ManagedKVStore:
    """Thread-safe shared prefix cache with admission and eviction."""

    def __init__(self, max_bytes: int, admit_hits: int = 2,
                 ttl_s: float = 900.0, watermark_high: float = 0.95,
                 watermark_low: float = 0.80, clock=time.monotonic):
        if not 0.0 < watermark_low <= watermark_high <= 1.0:
            raise ValueError(
                "require 0 < watermark_low <= watermark_high <= 1, got "
                f"low={watermark_low} high={watermark_high}")
        self.max_bytes = int(max_bytes)
        self.admit_hits = max(1, int(admit_hits))
        self.ttl_s = float(ttl_s)
        self.watermark_high = float(watermark_high)
        self.watermark_low = float(watermark_low)
        self._clock = clock
        self._lock = threading.Lock()
        self._blobs: Dict[str, bytes] = {}
        self._key_chain: Dict[str, str] = {}
        self._chains: Dict[str, ChainMeta] = {}
        # chain_id -> requesters wanting a chain we don't hold yet
        # (demand survives rejected PUTs so promotion can happen).
        self._courting: Dict[str, Tuple[Set[str], float]] = {}
        self.hits = 0
        self.misses = 0
        self.admissions = 0
        self.evictions = 0
        self.rejected_puts = 0

    # -- internals (call with lock held) --------------------------------

    def _bytes_stored(self) -> int:
        return sum(m.bytes for m in self._chains.values())

    def _chain_for(self, key: str, chain_id: Optional[str]) -> str:
        return chain_id or self._key_chain.get(key) or key

    def _record_demand(self, chain_id: str, requester: str,
                       now: float) -> int:
        meta = self._chains.get(chain_id)
        if meta is not None:
            meta.requesters.add(requester)
            return meta.demand
        reqs, _ = self._courting.get(chain_id, (set(), now))
        reqs.add(requester)
        self._courting[chain_id] = (reqs, now)
        if len(self._courting) > 65536:  # bound courting-table memory
            oldest = sorted(self._courting.items(),
                            key=lambda kv: kv[1][1])
            for cid, _ in oldest[:len(oldest) // 2]:
                del self._courting[cid]
        return len(reqs)

    def _drop_chain(self, chain_id: str) -> None:
        meta = self._chains.pop(chain_id, None)
        if meta is None:
            return
        for k in meta.keys:
            self._blobs.pop(k, None)
            self._key_chain.pop(k, None)

    def _sweep(self, now: float) -> None:
        if self.ttl_s > 0:
            for cid in [c for c, m in self._chains.items()
                        if now - m.last_access > self.ttl_s]:
                self._drop_chain(cid)
                self.evictions += 1
            for cid in [c for c, (_, t) in self._courting.items()
                        if now - t > self.ttl_s]:
                del self._courting[cid]
        high = self.watermark_high * self.max_bytes
        if self._bytes_stored() <= high:
            return
        low = self.watermark_low * self.max_bytes
        for cid in sorted(self._chains,
                          key=lambda c: self._chains[c].last_access):
            if self._bytes_stored() <= low:
                break
            self._drop_chain(cid)
            self.evictions += 1

    # -- public API ------------------------------------------------------

    def put(self, key: str, blob: bytes, chain_id: Optional[str] = None,
            requester: str = "", kv_dtype: str = "") -> bool:
        """Store a page; returns the admission verdict."""
        now = self._clock()
        requester = requester or "anon"
        with self._lock:
            cid = self._chain_for(key, chain_id)
            demand = self._record_demand(cid, requester, now)
            meta = self._chains.get(cid)
            if meta is None and demand < self.admit_hits:
                self.rejected_puts += 1
                return False
            if meta is None:
                reqs, _ = self._courting.pop(cid, (set(), now))
                meta = ChainMeta(chain_id=cid, kv_dtype=kv_dtype,
                                 requesters=reqs or {requester})
                self._chains[cid] = meta
                self.admissions += 1
            old = self._blobs.get(key)
            if old is not None:
                meta.bytes -= len(old)
            else:
                meta.keys.append(key)
            self._blobs[key] = blob
            self._key_chain[key] = cid
            meta.bytes += len(blob)
            meta.last_access = now
            self._sweep(now)
            # The new chain itself may have been swept if it alone
            # overshoots capacity; report what actually happened.
            return key in self._blobs

    def get(self, key: str, requester: str = "") -> Optional[bytes]:
        now = self._clock()
        with self._lock:
            self._sweep(now)
            blob = self._blobs.get(key)
            cid = self._chain_for(key, None)
            if blob is None:
                self.misses += 1
                self._record_demand(cid, requester or "anon", now)
                return None
            self.hits += 1
            meta = self._chains.get(cid)
            if meta is not None:
                meta.hits += 1
                meta.last_access = now
                if requester:
                    meta.requesters.add(requester)
            return blob

    def contains(self, key: str, requester: str = "") -> bool:
        """Probe (HEAD) — a miss records demand toward admission."""
        now = self._clock()
        with self._lock:
            self._sweep(now)
            if key in self._blobs:
                cid = self._chain_for(key, None)
                meta = self._chains.get(cid)
                if meta is not None:
                    meta.last_access = now
                return True
            self._record_demand(key, requester or "anon", now)
            return False

    def associate(self, key: str, chain_id: str) -> None:
        """Merge demand recorded under a bare page key into its chain
        (a probe miss only knows the key; the PUT knows the chain)."""
        with self._lock:
            if key == chain_id or key not in self._courting:
                return
            reqs, t = self._courting.pop(key)
            held, t2 = self._courting.get(chain_id, (set(), t))
            self._courting[chain_id] = (held | reqs, max(t, t2))

    def sweep(self) -> None:
        with self._lock:
            self._sweep(self._clock())

    def stats(self) -> dict:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": len(self._blobs),
                "bytes": self._bytes_stored(),
                "max_bytes": self.max_bytes,
                "chains": len(self._chains),
                "courting_chains": len(self._courting),
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0,
                "admissions": self.admissions,
                "evictions": self.evictions,
                "rejected_puts": self.rejected_puts,
                "admit_hits": self.admit_hits,
                "ttl_s": self.ttl_s,
                "watermark_high": self.watermark_high,
                "watermark_low": self.watermark_low,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._blobs)
