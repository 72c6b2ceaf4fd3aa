"""Paged KV cache management (host-side bookkeeping).

The device arrays live in the model runner; this module owns page
accounting: a free-list allocator plus a refcounted hash-based prefix
cache (vLLM's prefix caching, ``--enable-prefix-caching``, which the
reference chart passes through at
helm/templates/deployment-vllm-multi.yaml:76-79). Page 0 is reserved as
the trash page that padded writes land on (ops/attention.write_to_pages).

Capacity metrics feed the engine's ``/metrics``:
``vllm:gpu_cache_usage_perc`` and ``vllm:gpu_prefix_cache_hit_rate``
(scraped by the router, reference engine_stats.py:46-55).

Content hashes and refcounts are over token ids, so page accounting
does not depend on the cache's storage dtype. With an offload tier
(engine/offload.py) a hashed page about to be reused is handed to
``evict_listener`` first, and pages restored from a tier are registered
as cached (``register_restored_page``).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from production_stack_tpu_torch.engine.config import CacheConfig
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

PageHash = Tuple[int, Tuple[int, ...]]


@dataclass
class PageInfo:
    page_id: int
    ref_count: int = 0
    page_hash: Optional[PageHash] = None


class OutOfPagesError(RuntimeError):
    pass


class PagedCacheManager:
    """Allocates cache pages to sequences; shares full pages by content.

    Prefix sharing: a *full* page is identified by
    ``hash(parent_hash, tokens_in_page)``. When a new sequence's prompt
    starts with an already-cached chain of full pages, those pages are
    reused (ref_count++) and their tokens skip prefill entirely.
    Zero-ref hashed pages stay cached (LRU) until capacity pressure
    evicts them.
    """

    def __init__(self, config: CacheConfig):
        self.config = config
        self.page_size = config.page_size
        # Page 0 is the trash page; never allocated.
        self._free: List[int] = list(range(config.num_pages - 1, 0, -1))
        self._pages: Dict[int, PageInfo] = {}
        self._hash_to_page: Dict[PageHash, int] = {}
        # Zero-ref pages still holding reusable content, LRU order.
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        # Fired with (page_id, page_hash) just before a hashed page's
        # slot is reused: the offload tier's capture point.
        self.evict_listener = None
        # Stats
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0

    # ---- capacity ---------------------------------------------------------

    @property
    def num_free_pages(self) -> int:
        return len(self._free) + len(self._evictable)

    @property
    def num_used_pages(self) -> int:
        return (self.config.num_pages - 1) - self.num_free_pages

    def usage_perc(self) -> float:
        total = self.config.num_pages - 1
        return self.num_used_pages / total if total else 0.0

    def prefix_hit_rate(self) -> float:
        if self.prefix_query_tokens == 0:
            return 0.0
        return self.prefix_hit_tokens / self.prefix_query_tokens

    # ---- low-level page ops ----------------------------------------------

    def _pop_free_page(self) -> int:
        if self._free:
            page_id = self._free.pop()
        elif self._evictable:
            page_id, _ = self._evictable.popitem(last=False)  # LRU
            info = self._pages.pop(page_id)
            if info.page_hash is not None:
                self._hash_to_page.pop(info.page_hash, None)
                if self.evict_listener is not None:
                    try:
                        self.evict_listener(page_id, info.page_hash)
                    except Exception as e:  # offload is best-effort
                        logger.warning("KV evict listener failed: %s", e)
        else:
            raise OutOfPagesError("KV cache out of pages")
        self._pages[page_id] = PageInfo(page_id=page_id, ref_count=1)
        return page_id

    def _release_page(self, page_id: int) -> None:
        info = self._pages[page_id]
        info.ref_count -= 1
        if info.ref_count > 0:
            return
        if info.page_hash is not None and self.config.enable_prefix_caching:
            # Keep content for future prefix hits.
            self._evictable[page_id] = None
            self._evictable.move_to_end(page_id)
        else:
            del self._pages[page_id]
            self._free.append(page_id)

    def _revive_page(self, page_id: int) -> None:
        """Take a zero-ref cached page back into active use."""
        self._evictable.pop(page_id, None)
        self._pages[page_id].ref_count += 1

    # ---- sequence-facing API ---------------------------------------------

    @staticmethod
    def chain_hashes(token_ids: Sequence[int],
                     page_size: int,
                     root: int = 0) -> List[PageHash]:
        """Content hashes for each *full* page of a token prefix.

        ``root`` seeds the chain's first parent. It namespaces cache
        identity beyond token content — the engine passes the
        sequence's cache salt (Sequence.cache_salt), which is nonzero
        for LoRA-adapter requests: adapter deltas on wk/wv make the
        KV bytes adapter-specific, so a base-model prompt must never
        hit pages prefilled through an adapter (and vice versa).
        """
        hashes: List[PageHash] = []
        parent = root
        for start in range(0, len(token_ids) - page_size + 1, page_size):
            chunk = tuple(token_ids[start:start + page_size])
            h: PageHash = (parent, chunk)
            hashes.append(h)
            parent = hash(h)
        return hashes

    def match_prefix(self, token_ids: Sequence[int],
                     root: int = 0) -> List[int]:
        """Longest chain of cached full pages matching the prompt prefix.

        Returns the page ids (ref-counted up; caller owns them).
        """
        if not self.config.enable_prefix_caching:
            # Don't count queries the cache never sees: inflating the
            # denominator here would drag the reported hit rate toward
            # zero on pods running with prefix caching disabled.
            return []
        self.prefix_query_tokens += len(token_ids)
        matched: List[int] = []
        # Never match the *entire* prompt: the final token must be
        # recomputed so prefill produces logits for sampling.
        usable = len(token_ids) - 1
        for page_hash in self.chain_hashes(token_ids[:usable],
                                           self.page_size, root):
            page_id = self._hash_to_page.get(page_hash)
            if page_id is None:
                break
            self._revive_page(page_id)
            matched.append(page_id)
        self.prefix_hit_tokens += len(matched) * self.page_size
        return matched

    def allocate_pages(self, n: int) -> List[int]:
        """n fresh (private, unhashed) pages for a sequence."""
        if n > self.num_free_pages:
            raise OutOfPagesError(
                f"Need {n} pages, only {self.num_free_pages} free"
            )
        return [self._pop_free_page() for _ in range(n)]

    def commit_full_pages(self, token_ids: Sequence[int],
                          pages: List[int],
                          already_hashed: int,
                          root: int = 0) -> None:
        """Register content hashes for pages that have become full.

        Args:
          token_ids: the sequence's tokens written so far
          pages: the sequence's page list (matched + private)
          already_hashed: count of leading pages already registered
        """
        if not self.config.enable_prefix_caching:
            return
        hashes = self.chain_hashes(token_ids, self.page_size, root)
        for i in range(already_hashed, min(len(hashes), len(pages))):
            page_id = pages[i]
            info = self._pages.get(page_id)
            if info is None or info.page_hash is not None:
                continue
            existing = self._hash_to_page.get(hashes[i])
            if existing is None:
                info.page_hash = hashes[i]
                self._hash_to_page[hashes[i]] = page_id
            # If another page already owns this hash we simply leave this
            # page private; dedup happens for future sequences.

    def free_sequence(self, pages: List[int]) -> None:
        for page_id in pages:
            self._release_page(page_id)

    def register_restored_page(self, page_id: int,
                               page_hash: PageHash) -> None:
        """A page restored from an offload tier becomes a cached,
        hash-addressable page (later prompts hit it on the device)."""
        info = self._pages.get(page_id)
        if info is None or info.page_hash is not None:
            return
        if page_hash not in self._hash_to_page:
            info.page_hash = page_hash
            self._hash_to_page[page_hash] = page_id
