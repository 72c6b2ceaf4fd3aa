"""KV cache offload tiers: device memory -> host RAM -> remote cache server.

The port's copy of ``production_stack_tpu/engine/offload.py``, on the
standard library and torch only. Pages move across tiers on page
granularity (``ModelRunner.read_page`` / ``write_page``):

  1. Device: the paged cache itself (kv_cache.PagedCacheManager).
  2. Host RAM: ``HostKVPool``, content-hash-keyed pages under an LRU
     byte budget.
  3. Remote: ``RemoteKVClient``, speaking the cache-server protocol
     (engine/cache_server.py here, or the JAX package's server: the
     wire is the same, byte for byte).

A page's payload is a tuple of CPU tensors in the cache's own element
type: (k, v) each [L, kv_heads, head_dim, page_size], or the int8
4-tuple (k, v, k_scale, v_scale) with [L, kv_heads, page_size] f32
scales. On the wire each tensor is one msgpack map of its raw bytes,
shape and dtype name (``float32``, ``float16``, ``bfloat16`` or
``int8``), as the JAX engine frames its numpy pages; a bf16 page is 2
bytes an element. numpy has no bf16, so the port holds pages as torch
tensors, which do. Pages are keyed by the prefix cache's chain hash
(``_stable_key``), the same key the JAX engine computes for the same
tokens, so a page restored from any tier equals the page a prefill
would compute, and a port pod and a JAX pod can share one remote tier.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading
import urllib.error
import urllib.request
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from production_stack_tpu_torch.engine.kv_cache import PageHash
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

# A page's KV payload: 2 tensors for full-precision pages, 4 (int8 data
# and f32 scales) for int8 pages. Tiers carry the tuple opaquely.
PagePayload = Tuple[torch.Tensor, ...]

# Wire-format version, folded into every tier key so pods running a
# different page layout never restore each other's bytes. The JAX
# engine's value: the two must move together.
KV_WIRE_VERSION = 3

# Page element types on the wire, by their wire names (numpy's names,
# and ml_dtypes' for bfloat16).
WIRE_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int8": torch.int8,
}
# Page dtypes a cache server accepts (engine/cache_server.py validates
# inbound payloads against this before storing them).
ALLOWED_WIRE_DTYPES = tuple(WIRE_DTYPES)
_WIRE_NAMES = {dtype: name for name, dtype in WIRE_DTYPES.items()}


def wire_dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a page element type; raises on any other."""
    try:
        return _WIRE_NAMES[dtype]
    except KeyError:
        raise TypeError(f"unsupported KV wire dtype {dtype}")


def wire_itemsize(name: str) -> int:
    return torch.empty((), dtype=WIRE_DTYPES[name]).element_size()


def payload_nbytes(payload: PagePayload) -> int:
    return sum(t.numel() * t.element_size() for t in payload)


def tensor_to_wire(t: torch.Tensor) -> dict:
    """One page tensor as its wire map: raw bytes, shape, dtype name."""
    name = wire_dtype_name(t.dtype)
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    return {"data": flat.view(torch.uint8).numpy().tobytes(),
            "shape": list(t.shape), "dtype": name}


def tensor_from_wire(a: dict) -> torch.Tensor:
    """Inverse of ``tensor_to_wire`` (a copy: the tensor owns its
    memory)."""
    dtype = WIRE_DTYPES[a["dtype"]]
    shape = tuple(a["shape"])
    if not a["data"]:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(bytearray(a["data"]),
                            dtype=dtype).reshape(shape)


def encode_payload(payload: PagePayload) -> bytes:
    """A page as the JAX engine's wire frame: msgpack {"version",
    "arrays": [{"data", "shape", "dtype"}, ...]}."""
    return packb({"version": KV_WIRE_VERSION,
                  "arrays": [tensor_to_wire(t) for t in payload]})


def decode_arrays(arrays: list) -> PagePayload:
    return tuple(tensor_from_wire(a) for a in arrays)


def _stable_key(page_hash: PageHash, kv_dtype: str = "") -> str:
    """Serializable, process-independent key for a chain hash.

    ``kv_dtype`` namespaces the key by page storage format so int8 and
    full-precision pods sharing a remote cache never restore each
    other's payloads into a mismatched cache."""
    parent, tokens = page_hash
    raw = (f"v{KV_WIRE_VERSION}:{kv_dtype}:{parent}:"
           f"{','.join(map(str, tokens))}").encode()
    return hashlib.sha256(raw).hexdigest()


# ---- msgpack, the subset the wire uses ---------------------------------------
#
# Maps, str, bin 8/16/32, ints, arrays, bool and nil, each in the
# smallest form, as the msgpack package packs them (use_bin_type): a
# frame packed here is byte-identical to one packed there.


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(0xA0 | n)
        elif n < 1 << 8:
            out += struct.pack(">BB", 0xD9, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDA, n)
        else:
            out += struct.pack(">BI", 0xDB, n)
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 1 << 8:
            out += struct.pack(">BB", 0xC4, n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xC5, n)
        else:
            out += struct.pack(">BI", 0xC6, n)
        out += data
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(0x90 | n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDC, n)
        else:
            out += struct.pack(">BI", 0xDD, n)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(0x80 | n)
        elif n < 1 << 16:
            out += struct.pack(">BH", 0xDE, n)
        else:
            out += struct.pack(">BI", 0xDF, n)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for code, fmt, bits in ((0xCC, ">BB", 8), (0xCD, ">BH", 16),
                                (0xCE, ">BI", 32), (0xCF, ">BQ", 64)):
            if v < 1 << bits:
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"int {v} too large to pack")
    else:
        for code, fmt, bits in ((0xD0, ">Bb", 8), (0xD1, ">Bh", 16),
                                (0xD2, ">Bi", 32), (0xD3, ">Bq", 64)):
            if v >= -(1 << (bits - 1)):
                out += struct.pack(fmt, code, v)
                return
        raise OverflowError(f"int {v} too small to pack")


def unpackb(data: bytes):
    """Decode one msgpack object; raises ValueError on a malformed or
    truncated frame, on trailing bytes, and on any type outside the
    wire's subset."""
    view = memoryview(data)
    try:
        obj, pos = _unpack(view, 0)
    except (IndexError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"invalid msgpack: {e}")
    if pos != len(view):
        raise ValueError("invalid msgpack: trailing bytes")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LENGTHS = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
            0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
            0xDC: ">H", 0xDD: ">I",  # array
            0xDE: ">H", 0xDF: ">I"}  # map


def _take(view: memoryview, pos: int, n: int) -> memoryview:
    if pos + n > len(view):
        raise ValueError("invalid msgpack: truncated")
    return view[pos:pos + n]


def _unpack(view: memoryview, pos: int):
    code = view[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _FIXED:
        fmt = _FIXED[code]
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, _take(view, pos, size))[0], pos + size
    kind = None
    if 0xA0 <= code <= 0xBF:
        kind, n = "str", code & 0x1F
    elif 0x90 <= code <= 0x9F:
        kind, n = "array", code & 0x0F
    elif 0x80 <= code <= 0x8F:
        kind, n = "map", code & 0x0F
    elif code in _LENGTHS:
        fmt = _LENGTHS[code]
        size = struct.calcsize(fmt)
        n = struct.unpack(fmt, _take(view, pos, size))[0]
        pos += size
        kind = ("str" if code in (0xD9, 0xDA, 0xDB) else
                "bin" if code in (0xC4, 0xC5, 0xC6) else
                "array" if code in (0xDC, 0xDD) else "map")
    if kind is None:
        raise ValueError(f"invalid msgpack: unsupported type 0x{code:02x}")
    if kind == "str":
        return str(_take(view, pos, n), "utf-8"), pos + n
    if kind == "bin":
        return bytes(_take(view, pos, n)), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(view, pos)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        key, pos = _unpack(view, pos)
        if isinstance(key, (list, dict)):
            raise ValueError("invalid msgpack: unhashable map key")
        out[key], pos = _unpack(view, pos)
    return out, pos


# ---- tiers --------------------------------------------------------------------


class HostKVPool:
    """LRU pool of KV pages in host RAM.

    Eviction runs on watermark hysteresis: a put that would push usage
    past ``watermark_high * max_bytes`` evicts oldest-first down to
    ``watermark_low * max_bytes``. The defaults (1.0/1.0) evict exactly
    at capacity."""

    def __init__(self, max_bytes: int = 2 * 1024 ** 3,
                 watermark_high: float = 1.0,
                 watermark_low: float = 1.0):
        if not 0.0 < watermark_low <= watermark_high <= 1.0:
            raise ValueError(
                "require 0 < watermark_low <= watermark_high <= 1, "
                f"got low={watermark_low} high={watermark_high}")
        self.max_bytes = max_bytes
        self.watermark_high = watermark_high
        self.watermark_low = watermark_low
        self._pool: "OrderedDict[str, PagePayload]" = OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._pool)

    @property
    def used_bytes(self) -> int:
        return self._bytes

    def put(self, key: str, payload: PagePayload) -> None:
        size = payload_nbytes(payload)
        with self._lock:
            if key in self._pool:
                self._pool.move_to_end(key)
                return
            high = self.watermark_high * self.max_bytes
            low = self.watermark_low * self.max_bytes
            if self._bytes + size > high:
                while self._bytes + size > low and self._pool:
                    _, evicted = self._pool.popitem(last=False)
                    self._bytes -= payload_nbytes(evicted)
                    self.evictions += 1
            if self._bytes + size <= self.max_bytes:
                self._pool[key] = payload
                self._bytes += size

    def get(self, key: str) -> Optional[PagePayload]:
        with self._lock:
            payload = self._pool.get(key)
            if payload is not None:
                self._pool.move_to_end(key)
                self.hits += 1
            else:
                self.misses += 1
            return payload

    def contains(self, key: str) -> bool:
        with self._lock:
            return key in self._pool


class RemoteKVClient:
    """Client of the remote shared KV cache server, on urllib: PUT, GET
    and HEAD /kv/<key>, POST /kv/batch_get, msgpack-framed."""

    def __init__(self, base_url: str, timeout_s: float = 5.0,
                 requester: str = ""):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        # Sent as X-KV-Requester so the managed cache counts DISTINCT
        # engines demanding a chain (kvecon/cluster_cache.py).
        self.requester = requester
        # The engine's view of the shared tier, exported as the
        # vllm:kv_cluster_* counters.
        self.hits = 0
        self.misses = 0
        self.admissions = 0
        self.rejections = 0

    def _headers(self, chain: Optional[str] = None) -> Dict[str, str]:
        headers = {}
        if self.requester:
            headers["X-KV-Requester"] = self.requester
        if chain:
            headers["X-KV-Chain"] = chain
        return headers

    def _request(self, method: str, path: str, data: Optional[bytes] = None,
                 chain: Optional[str] = None) -> Tuple[int, bytes]:
        """(status, body); an HTTP error status is returned, a
        transport failure raises."""
        req = urllib.request.Request(
            self.base_url + path, data=data, method=method,
            headers=self._headers(chain))
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def put(self, key: str, payload: PagePayload,
            chain: Optional[str] = None) -> bool:
        try:
            status, body = self._request("PUT", f"/kv/{key}",
                                         encode_payload(payload), chain)
        except Exception as e:
            logger.warning("Remote KV put failed: %s", e)
            return False
        if status != 200:
            return False
        # A managed cache answers 200 with an admission verdict;
        # {"admitted": false} ("not promoted yet") is success for the
        # write-through path: the server recorded the demand. A bare
        # 200 body counts as admitted.
        try:
            verdict = json.loads(body)
        except ValueError:
            verdict = {}
        if isinstance(verdict, dict) and verdict.get("admitted") is False:
            self.rejections += 1
        else:
            self.admissions += 1
        return True

    def get(self, key: str) -> Optional[PagePayload]:
        try:
            status, body = self._request("GET", f"/kv/{key}")
            if status != 200:
                self.misses += 1
                return None
            payload = decode_arrays(unpackb(body)["arrays"])
        except Exception as e:
            logger.warning("Remote KV get failed: %s", e)
            return None
        self.hits += 1
        return payload

    def contains(self, key: str) -> bool:
        return self.probe(key) is True

    def probe(self, key: str) -> Optional[bool]:
        """``contains`` with errors told apart: True/False is the
        server's answer, None a transport failure (tier unreachable
        right now)."""
        try:
            status, _ = self._request("HEAD", f"/kv/{key}")
        except Exception:
            return None
        return status == 200

    def batch_get(self, keys: List[str]) -> Dict[str, PagePayload]:
        """Many pages in one round trip (POST /kv/batch_get); only the
        keys the server holds come back. Falls back to one GET a key
        against a server without the route. The dtype allowlist is
        checked again here before any buffer is read."""
        if not keys:
            return {}
        try:
            status, body = self._request(
                "POST", "/kv/batch_get", packb({"keys": list(keys)}))
            if status in (404, 405):
                out = {}
                for key in keys:
                    payload = self.get(key)
                    if payload is not None:
                        out[key] = payload
                return out
            if status != 200:
                return {}
            blobs = unpackb(body).get("blobs")
            if not isinstance(blobs, list) or len(blobs) != len(keys):
                return {}
            out = {}
            for key, blob in zip(keys, blobs):
                if blob is None:
                    continue
                arrays = unpackb(blob)["arrays"]
                if any(a["dtype"] not in ALLOWED_WIRE_DTYPES
                       for a in arrays):
                    continue
                out[key] = decode_arrays(arrays)
        except Exception as e:
            logger.warning("Remote KV batch_get failed: %s", e)
            return {}
        self.hits += len(out)
        self.misses += len(keys) - len(out)
        return out


class KVOffloadManager:
    """Moves KV pages between the device cache and the offload tiers.

    - ``offload_page(page_hash, *payload)``: a hashed page leaving the
      device (evicted, checkpointed or shipped by a preemption).
    - ``lookup_chain(hashes)``: longest prefix of page hashes held in
      the host or remote tier.
    - ``fetch_many(hashes)``: their payloads, for ``write_page``.

    ``kv_dtype`` is folded into every tier key (``_stable_key``)."""

    def __init__(self, host_pool: Optional[HostKVPool] = None,
                 remote: Optional[RemoteKVClient] = None,
                 kv_dtype: str = ""):
        self.host = host_pool or HostKVPool()
        self.remote = remote
        self.kv_dtype = kv_dtype
        self.restored_pages = 0
        self.offloaded_pages = 0

    def _key(self, page_hash: PageHash) -> str:
        return _stable_key(page_hash, self.kv_dtype)

    def key_for(self, page_hash: PageHash) -> str:
        """Public tier key for a chain hash."""
        return self._key(page_hash)

    def handoff_ready(self, page_hash: PageHash) -> Optional[bool]:
        """Is a shipped page reachable in some tier? True/False is
        definitive; None means the remote tier could not be probed."""
        key = self._key(page_hash)
        if self.host.contains(key):
            return True
        if self.remote is None:
            return False
        return self.remote.probe(key)

    def chain_id(self, root_hash: PageHash) -> str:
        """Cluster-cache chain id of a page chain: the tier key of its
        root page, sent as X-KV-Chain so the managed cache groups a
        chain's pages (kvecon/cluster_cache.py)."""
        return self._key(root_hash)

    def offload_page(self, page_hash: PageHash, *payload: torch.Tensor,
                     chain: Optional[str] = None) -> None:
        key = self._key(page_hash)
        self.host.put(key, payload)
        self.offloaded_pages += 1
        if self.remote is not None:
            self.remote.put(key, payload, chain=chain)

    def lookup_chain(self, hashes: List[PageHash]) -> int:
        """How many leading pages of ``hashes`` can be restored."""
        n = 0
        for page_hash in hashes:
            key = self._key(page_hash)
            if self.host.contains(key):
                n += 1
                continue
            if self.remote is not None and self.remote.contains(key):
                n += 1
                continue
            break
        return n

    def fetch_many(self, hashes: List[PageHash]) -> List[
            Optional[PagePayload]]:
        """Payloads for ``hashes``, order-aligned (None = miss). Host
        hits serve locally; every remote miss goes out in one batch_get
        round trip, and fetched pages are promoted into the host
        tier."""
        keys = [self._key(h) for h in hashes]
        out: List[Optional[PagePayload]] = [self.host.get(k) for k in keys]
        missing = [k for k, p in zip(keys, out) if p is None]
        if missing and self.remote is not None:
            fetched = self.remote.batch_get(missing)
            for i, key in enumerate(keys):
                if out[i] is None and key in fetched:
                    out[i] = fetched[key]
                    self.host.put(key, fetched[key])
        return out

    def stats(self) -> Dict[str, float]:
        total = self.host.hits + self.host.misses
        stats = {
            "host_pages": len(self.host),
            "host_bytes": self.host.used_bytes,
            "host_hit_rate": (self.host.hits / total) if total else 0.0,
            "offloaded_pages": self.offloaded_pages,
            "restored_pages": self.restored_pages,
        }
        if self.remote is not None:
            stats.update({
                "cluster_hits": self.remote.hits,
                "cluster_misses": self.remote.misses,
                "cluster_admissions": self.remote.admissions,
                "cluster_rejections": self.remote.rejections,
            })
        return stats
