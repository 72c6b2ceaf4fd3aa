"""Cluster-wide KV economy (docs/kv_economy.md), the port's copy.

The KV cache stops being per-engine scratch and becomes a cluster
resource with an explicit economy:

- ``summary``: the text-domain chain-hash scheme shared by the router
  and the engines, plus the engine-side ``PrefixSummaryTracker`` that
  maintains the hot-chain summary exported at ``GET /kv/summary``.
- ``cluster_cache``: the managed shared-cache policy object
  (``ManagedKVStore``) behind the cache server — hit-count admission,
  TTL + LRU eviction under capacity watermarks, per-chain metadata.

The router's ``KVStateAwarePolicy`` (router/routing/logic.py) scores
candidates against the summaries; the engines' offload clients
(engine/offload.py) speak the admission protocol to the shared tier.
"""

from production_stack_tpu_torch.kvecon.cluster_cache import (  # noqa: F401
    CHAIN_HEADER,
    REQUESTER_HEADER,
    ChainMeta,
    ManagedKVStore,
)
from production_stack_tpu_torch.kvecon.summary import (  # noqa: F401
    BLOCK_CHARS,
    TOKENS_PER_BLOCK,
    PrefixSummaryTracker,
    chain_text,
    expected_hit_blocks,
    routable_text,
)
