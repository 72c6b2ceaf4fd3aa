"""Remote shared KV cache server, on the standard library.

The port's copy of ``production_stack_tpu/engine/cache_server.py``, with
``http.server`` in place of aiohttp: a content-addressed page store over
HTTP with msgpack framing, shared by every engine started with
``--kv-remote-url``. The routes, payload validation, headers and
admission verdicts are the JAX server's, so port and JAX engines can
use either server:

- ``PUT /kv/<key>``: store a page frame; answers 200
  ``{"admitted": bool}``, or 400 for a frame that fails validation;
- ``GET /kv/<key>`` (the stored frame, or 404) and ``HEAD /kv/<key>``
  (200 or 404; a miss records demand);
- ``POST /kv/batch_get``: msgpack ``{"keys": [...]}`` ->
  ``{"blobs": [frame or nil, ...]}``, at most ``BATCH_GET_MAX_KEYS``;
- ``GET /health``, ``/stats`` and ``/metrics`` (``kvcache:*``).

The store behind the routes is the managed cluster prefix cache
(kvecon/cluster_cache.py): admission by distinct-requester demand
(``X-KV-Requester``, else the peer address), TTL and coldest-chain
eviction under watermarks, chains grouped by ``X-KV-Chain``.
``build_cache_server``'s defaults (admit_hits 1, no TTL, watermarks
1.0) store on first write; the command line defaults to the managed
policy.

Run: ``python -m production_stack_tpu_torch.engine.cache_server --port 8100``
"""

from __future__ import annotations

import argparse
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from production_stack_tpu_torch.engine.offload import (
    ALLOWED_WIRE_DTYPES,
    packb,
    unpackb,
    wire_itemsize,
)
from production_stack_tpu_torch.kvecon.cluster_cache import (
    CHAIN_HEADER,
    REQUESTER_HEADER,
    ManagedKVStore,
)
from production_stack_tpu_torch.utils.log import init_logger

logger = init_logger(__name__)

# Upper bound on keys per batched GET: bounds the response and keeps
# one request from holding the store lock for long.
BATCH_GET_MAX_KEYS = 1024
# The largest request body accepted (the JAX server's client_max_size).
MAX_BODY_BYTES = 256 * 1024 ** 2


def _validate_payload(blob: bytes) -> Optional[str]:
    """An error string (-> 400) for anything that is not a well-formed
    per-array msgpack frame with allowlisted dtypes and buffers that
    match their shapes; None for a good frame."""
    try:
        obj = unpackb(blob)
    except Exception:
        return "payload is not valid msgpack"
    if not isinstance(obj, dict) or not isinstance(
            obj.get("arrays"), list) or not obj["arrays"]:
        return "payload missing 'arrays' list"
    for a in obj["arrays"]:
        if not isinstance(a, dict):
            return "array entry is not a map"
        dtype_name = a.get("dtype")
        if dtype_name not in ALLOWED_WIRE_DTYPES:
            return f"dtype {dtype_name!r} not in allowlist"
        shape = a.get("shape")
        data = a.get("data")
        if (not isinstance(shape, list) or not isinstance(data, bytes)
                or not all(isinstance(d, int) and d >= 0
                           for d in shape)):
            return "array entry missing shape/data"
        n = wire_itemsize(dtype_name)
        for d in shape:
            n *= d
        if n != len(data):
            return "array data size does not match shape/dtype"
    return None


def _wire_dtype(blob: bytes) -> str:
    """First array's dtype, for the chain metadata (the payload was
    already validated)."""
    try:
        return str(unpackb(blob)["arrays"][0]["dtype"])
    except Exception:
        return ""


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: "CacheHTTPServer"

    def log_message(self, fmt, *args):  # quiet access log
        logger.debug("%s " + fmt, self.address_string(), *args)

    def _requester(self) -> str:
        # The peer address stands in for clients without the header.
        return (self.headers.get(REQUESTER_HEADER, "")
                or self.client_address[0] or "anon")

    def _key(self) -> Optional[str]:
        path = self.path.split("?", 1)[0]
        if path.startswith("/kv/") and len(path) > len("/kv/"):
            return path[len("/kv/"):]
        return None

    def _send(self, status: int, body: bytes = b"",
              content_type: str = "application/json",
              head: bool = False) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        if not head:
            self.wfile.write(body)

    def _json(self, status: int, obj) -> None:
        self._send(status, json.dumps(obj).encode())

    def _error(self, status: int, message: str) -> None:
        self._json(status, {"error": {"message": message}})

    def _body(self) -> Optional[bytes]:
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            self.close_connection = True
            self._error(413, "request body too large")
            return None
        return self.rfile.read(length)

    def do_PUT(self):
        key = self._key()
        if key is None:
            self._error(404, "no route")
            return
        blob = self._body()
        if blob is None:
            return
        err = _validate_payload(blob)
        if err is not None:
            self._error(400, err)
            return
        store = self.server.store
        chain = self.headers.get(CHAIN_HEADER) or None
        if chain:
            # Demand recorded against the bare key (probe misses do not
            # know the chain) merges into the chain before the verdict.
            store.associate(key, chain)
        admitted = store.put(key, blob, chain_id=chain,
                             requester=self._requester(),
                             kv_dtype=_wire_dtype(blob))
        self._json(200, {"admitted": admitted})

    def do_HEAD(self):
        key = self._key()
        if key is None:
            self._send(404, head=True)
            return
        found = self.server.store.contains(key, requester=self._requester())
        self._send(200 if found else 404, head=True)

    def do_GET(self):
        store = self.server.store
        path = self.path.split("?", 1)[0]
        key = self._key()
        if key is not None:
            blob = store.get(key, requester=self._requester())
            if blob is None:
                self._send(404)
            else:
                self._send(200, blob, "application/octet-stream")
        elif path == "/health":
            self._json(200, {"status": "ok"})
        elif path == "/stats":
            self._json(200, store.stats())
        elif path == "/metrics":
            self._send(200, _metrics(store.stats()).encode(), "text/plain")
        else:
            self._error(404, "no route")

    def do_POST(self):
        if self.path.split("?", 1)[0] != "/kv/batch_get":
            self._error(404, "no route")
            return
        body = self._body()
        if body is None:
            return
        try:
            obj = unpackb(body)
        except Exception:
            self._error(400, "body is not valid msgpack")
            return
        keys = obj.get("keys") if isinstance(obj, dict) else None
        if (not isinstance(keys, list)
                or not all(isinstance(k, str) for k in keys)):
            self._error(400, "body missing 'keys' list")
            return
        if len(keys) > BATCH_GET_MAX_KEYS:
            self._error(400, f"too many keys (max {BATCH_GET_MAX_KEYS})")
            return
        rid = self._requester()
        blobs = [self.server.store.get(k, requester=rid) for k in keys]
        self._send(200, packb({"blobs": blobs}), "application/octet-stream")


def _metrics(s: dict) -> str:
    lines = []
    for name, kind, key in (
            ("kvcache:entries", "gauge", "entries"),
            ("kvcache:bytes", "gauge", "bytes"),
            ("kvcache:hit_rate", "gauge", "hit_rate"),
            ("kvcache:chains", "gauge", "chains"),
            ("kvcache:hits_total", "counter", "hits"),
            ("kvcache:misses_total", "counter", "misses"),
            ("kvcache:admissions_total", "counter", "admissions"),
            ("kvcache:evictions_total", "counter", "evictions"),
            ("kvcache:rejected_puts_total", "counter", "rejected_puts")):
        lines += [f"# TYPE {name} {kind}", f"{name} {s[key]}"]
    lines.append("")
    return "\n".join(lines)


class CacheHTTPServer(ThreadingHTTPServer):
    """The cache server bound to its address; ``serve_forever`` (or a
    thread running it) serves, ``shutdown`` stops it."""

    daemon_threads = True

    def __init__(self, address, store: ManagedKVStore):
        super().__init__(address, _Handler)
        self.store = store

    @property
    def url(self) -> str:
        host, port = self.server_address[:2]
        return f"http://{host}:{port}"


def build_cache_server(max_bytes: int = 8 * 1024 ** 3,
                       admit_hits: int = 1,
                       ttl_s: float = 0.0,
                       watermark_high: float = 1.0,
                       watermark_low: float = 1.0,
                       clock=None, host: str = "127.0.0.1",
                       port: int = 0) -> CacheHTTPServer:
    """The server bound to ``host:port`` (0: any free port), not yet
    serving."""
    store = ManagedKVStore(
        max_bytes, admit_hits=admit_hits, ttl_s=ttl_s,
        watermark_high=watermark_high, watermark_low=watermark_low,
        **({"clock": clock} if clock is not None else {}))
    return CacheHTTPServer((host, port), store)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="tpu-kv-cache-server-torch")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8100)
    parser.add_argument("--max-bytes", type=int, default=8 * 1024 ** 3)
    # Managed-cache policy. Pass --kv-admit-hits 1 --kv-ttl-s 0
    # --kv-watermark-high 1.0 --kv-watermark-low 1.0 to store every
    # page on its first write.
    parser.add_argument(
        "--kv-admit-hits", type=int, default=2,
        help="Distinct requesters that must want a chain before its "
             "pages are stored")
    parser.add_argument(
        "--kv-ttl-s", type=float, default=900.0,
        help="Seconds an idle chain survives before TTL eviction "
             "(0 disables)")
    parser.add_argument(
        "--kv-watermark-high", type=float, default=0.95,
        help="Stored-bytes fraction of --max-bytes that triggers "
             "coldest-chain eviction")
    parser.add_argument(
        "--kv-watermark-low", type=float, default=0.80,
        help="Fraction eviction drains down to once triggered")
    args = parser.parse_args(argv)
    server = build_cache_server(
        args.max_bytes, admit_hits=args.kv_admit_hits, ttl_s=args.kv_ttl_s,
        watermark_high=args.kv_watermark_high,
        watermark_low=args.kv_watermark_low, host=args.host,
        port=args.port)
    logger.info(
        "KV cache server on %s:%d (budget %d MiB, admit_hits=%d, "
        "ttl=%gs, watermarks %.2f/%.2f)",
        args.host, server.server_address[1], args.max_bytes // 2 ** 20,
        args.kv_admit_hits, args.kv_ttl_s,
        args.kv_watermark_high, args.kv_watermark_low)
    try:
        server.serve_forever(poll_interval=0.2)
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
