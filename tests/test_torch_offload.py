"""The port's KV offload tiers against the JAX package's: the host pool
(LRU, watermark hysteresis), the tier keys, the hand-written msgpack
codec against the ``msgpack`` package, the port's client against the
JAX cache server and the JAX client against the port's cache server for
every wire dtype, the cache server's payload validation and admission
verdicts (twins of ``tests/test_kv_offload.py`` and
``tests/test_kv_economy.py``), an evicted prefix restored from the host
pool with greedy parity, and the wire dtype of a page read off the
device: a bf16 page is 2 bytes an element, its frame byte-identical to
the JAX engine's frame of the same values.

Tolerance: pages and frames are compared byte for byte; greedy streams
token for token.
"""

import dataclasses
from unittest import mock

import msgpack
import numpy as np
import pytest
import torch

import jax

from production_stack_tpu.engine import config as jax_config
from production_stack_tpu.engine import offload as jax_offload
from production_stack_tpu.models import llama as jax_llama
from production_stack_tpu_torch.engine import cache_server
from production_stack_tpu_torch.engine import config as port_config
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.offload import (
    HostKVPool,
    KVOffloadManager,
    RemoteKVClient,
    _stable_key,
    encode_payload,
    packb,
    payload_nbytes,
    unpackb,
)
from production_stack_tpu_torch.engine.sequence import SamplingParams
from production_stack_tpu_torch.models.convert import params_from_numpy
from tests.test_torch_crash_recovery import _serve_app_in_thread, serve_cache

torch.set_num_threads(2)


def _payload(seed, shape=(2, 8, 2, 16)):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=gen),
            torch.randn(shape, generator=gen))


# ---- host pool --------------------------------------------------------------


def test_host_pool_lru_eviction_and_refresh():
    entry = payload_nbytes(_payload(0))
    pool = HostKVPool(max_bytes=entry * 2)
    pool.put("a", _payload(1))
    pool.put("b", _payload(2))
    pool.put("c", _payload(3))  # evicts "a" (LRU)
    assert pool.get("a") is None
    assert pool.get("b") is not None and pool.get("c") is not None
    pool.get("b")  # refresh: "c" is now the oldest
    pool.put("d", _payload(4))
    assert pool.get("c") is None and pool.get("b") is not None
    assert pool.used_bytes == entry * 2 and pool.evictions == 2


def test_host_pool_watermark_hysteresis():
    """Past the high watermark a put evicts oldest-first down to the low
    one, in one batch, and then no put evicts until high again."""
    entry = payload_nbytes(_payload(0))
    pool = HostKVPool(max_bytes=entry * 10, watermark_high=0.8,
                      watermark_low=0.4)
    for i in range(8):
        pool.put(str(i), _payload(i))
    assert len(pool) == 8 and pool.evictions == 0
    pool.put("8", _payload(8))  # 9 > 8 entries: evict down to 4 in all
    assert len(pool) == 4 and pool.evictions == 5
    assert [pool.contains(str(i)) for i in range(9)] == [False] * 5 + [
        True] * 4
    for i in range(9, 13):
        pool.put(str(i), _payload(i))
    assert len(pool) == 8 and pool.evictions == 5
    with pytest.raises(ValueError, match="watermark"):
        HostKVPool(watermark_high=0.5, watermark_low=0.6)


def test_host_pool_holds_every_dtype_with_byte_accounting():
    payloads = _dtype_payloads()
    pool = HostKVPool(max_bytes=64 * 1024 ** 2)
    for name, payload in payloads.items():
        pool.put(name, payload)
    for name, payload in payloads.items():
        got = pool.get(name)
        assert [a.dtype for a in got] == [a.dtype for a in payload]
        assert all(torch.equal(a, b) for a, b in zip(got, payload))
    assert pool.used_bytes == sum(payload_nbytes(p)
                                  for p in payloads.values())


# ---- tier keys and the codec ---------------------------------------------------


@pytest.mark.parametrize("kv_dtype", ["", "float32", "bfloat16", "int8"])
def test_stable_key_equals_the_jax_key(kv_dtype):
    """The same chain hashes (the prefix cache's, over token ids) give
    the JAX engine's tier key, namespaced by dtype."""
    from production_stack_tpu.engine.kv_cache import (
        PagedCacheManager as JaxCache,
    )
    from production_stack_tpu_torch.engine.kv_cache import (
        PagedCacheManager,
    )
    tokens = list(range(3, 70))
    hashes = PagedCacheManager.chain_hashes(tokens, 16, 0)
    assert hashes == JaxCache.chain_hashes(tokens, 16, 0)
    assert [_stable_key(h, kv_dtype) for h in hashes] == [
        jax_offload._stable_key(h, kv_dtype) for h in hashes]
    assert len({_stable_key(hashes[0], d)
                for d in ("", "float32", "bfloat16", "int8")}) == 4


CODEC_CASES = [
    None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
    2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
    -2 ** 31, -2 ** 31 - 1, -2 ** 63, "", "a" * 31, "a" * 32, "é" * 200,
    "b" * 70000, b"", b"x" * 255, b"x" * 256, b"x" * 70000, [], [1] * 15,
    [1] * 16, list(range(70000)), {}, {str(i): i for i in range(15)},
    {str(i): [i, None] for i in range(16)},
    {"version": 3, "arrays": [{"data": b"\x01\x02", "shape": [1, 1],
                               "dtype": "bfloat16"}]},
    {"keys": ["k" * 64] * 3}, {"blobs": [b"\x00" * 300, None]},
]


@pytest.mark.parametrize("obj", CODEC_CASES,
                         ids=[f"case{i}" for i in range(len(CODEC_CASES))])
def test_codec_matches_the_msgpack_package(obj):
    """Packed here, the bytes are the msgpack package's (use_bin_type);
    each side unpacks the other's."""
    ours = packb(obj)
    assert ours == msgpack.packb(obj)
    assert msgpack.unpackb(ours) == obj or obj == msgpack.unpackb(ours)
    assert unpackb(msgpack.packb(obj)) == msgpack.unpackb(
        msgpack.packb(obj))


@pytest.mark.parametrize("blob", [
    b"", b"\xc1", b"\x92\x01", b"\x91\x01\x02", b"\xca\x00\x00\x00\x00",
    b"\xd9\x05ab", b"\xc6\xff\xff\xff\xff"],
    ids=["empty", "never-used", "short-array", "trailing", "float",
         "short-str", "short-bin"])
def test_codec_refuses_malformed_frames(blob):
    with pytest.raises(ValueError):
        unpackb(blob)


# ---- the remote tier across packages ---------------------------------------------


def _dtype_payloads():
    """One payload per page format the tiers carry: f32 and bf16 (k, v)
    pairs, and the int8 4-tuple with f32 scales."""
    gen = torch.Generator().manual_seed(7)
    shape = (2, 2, 32, 16)
    return {
        "float32": tuple(torch.randn(shape, generator=gen)
                         for _ in range(2)),
        "bfloat16": tuple(torch.randn(shape, generator=gen)
                          .to(torch.bfloat16) for _ in range(2)),
        "int8": (torch.randint(-127, 128, shape, generator=gen,
                               dtype=torch.int8),
                 torch.randint(-127, 128, shape, generator=gen,
                               dtype=torch.int8),
                 torch.rand((2, 2, 16), generator=gen),
                 torch.rand((2, 2, 16), generator=gen)),
    }


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A page tensor as the JAX engine holds it (ml_dtypes for bf16)."""
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.fixture(scope="module")
def jax_cache_url():
    from production_stack_tpu.engine.cache_server import build_cache_server
    url, stop = _serve_app_in_thread(build_cache_server(64 * 1024 ** 2))
    yield url
    stop()


@pytest.fixture(scope="module")
def port_cache_url():
    url, server = serve_cache()
    yield url
    server.shutdown()


@pytest.mark.parametrize("name", ["float32", "bfloat16", "int8"])
def test_port_client_against_the_jax_cache_server(jax_cache_url, name):
    payload = _dtype_payloads()[name]
    client = RemoteKVClient(jax_cache_url, requester="port")
    key = f"port-{name}"
    assert client.put(key, payload) and client.admissions == 1
    assert client.probe(key) is True and client.probe("nope") is False
    got = client.get(key)
    assert [a.dtype for a in got] == [a.dtype for a in payload]
    assert all(torch.equal(a, b) for a, b in zip(got, payload))
    batch = client.batch_get([key, "nope"])
    assert list(batch) == [key] and client.misses == 1
    # What the JAX client reads back is the same bytes, in its dtypes.
    theirs = jax_offload.RemoteKVClient(jax_cache_url).get(key)
    for a, b in zip(theirs, payload):
        assert a.dtype == _to_numpy(b).dtype
        assert a.tobytes() == _to_numpy(b).tobytes()


@pytest.mark.parametrize("name", ["float32", "bfloat16", "int8"])
def test_jax_client_against_the_port_cache_server(port_cache_url, name):
    payload = tuple(_to_numpy(t) for t in _dtype_payloads()[name])
    client = jax_offload.RemoteKVClient(port_cache_url, requester="jax")
    key = f"jax-{name}"
    assert client.put(key, payload) and client.admissions == 1
    assert client.probe(key) is True and client.probe("nope") is False
    got = client.get(key)
    for a, b in zip(got, payload):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert list(client.batch_get([key, "nope"])) == [key]
    # The port reads the JAX engine's frame back as its own tensors.
    mine = RemoteKVClient(port_cache_url).get(key)
    for a, b in zip(mine, _dtype_payloads()[name]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_batch_get_falls_back_to_one_get_a_key(port_cache_url):
    """Against a server without POST /kv/batch_get the client fetches
    each key with a GET."""
    client = RemoteKVClient(port_cache_url)
    payload = _dtype_payloads()["float32"]
    client.put("fallback", payload)
    with mock.patch.object(cache_server._Handler, "do_POST",
                           lambda self: self._error(405, "no route")):
        got = client.batch_get(["fallback", "nope"])
    assert list(got) == ["fallback"]
    assert all(torch.equal(a, b) for a, b in zip(got["fallback"], payload))


BAD_PAYLOADS = [
    b"\x00not msgpack at all",
    msgpack.packb({"no": "arrays"}),
    msgpack.packb({"arrays": []}),
    msgpack.packb({"arrays": ["x"]}),
    # float64 is not an allowed page dtype.
    msgpack.packb({"arrays": [{"data": b"\x00" * 32, "shape": [2, 2],
                               "dtype": "float64"}]}),
    # byte count disagrees with shape * itemsize.
    msgpack.packb({"arrays": [{"data": b"\x00" * 7, "shape": [2, 2],
                               "dtype": "float32"}]}),
    msgpack.packb({"arrays": [{"data": b"\x00" * 4, "shape": [2, 2],
                               "dtype": "bfloat16"}]}),
    # negative dim, and data that is not bytes.
    msgpack.packb({"arrays": [{"data": b"", "shape": [-1],
                               "dtype": "int8"}]}),
    msgpack.packb({"arrays": [{"data": "text", "shape": [4],
                               "dtype": "int8"}]}),
]


@pytest.mark.parametrize("i", range(len(BAD_PAYLOADS)))
def test_cache_server_rejects_bad_payloads(port_cache_url, i):
    """Junk bytes, disallowed dtypes and buffers that disagree with
    their shape are refused with 400 and never stored, with the JAX
    server's verdict."""
    import urllib.error
    import urllib.request
    blob = BAD_PAYLOADS[i]
    from production_stack_tpu.engine.cache_server import (
        _validate_payload as jax_validate,
    )
    assert cache_server._validate_payload(blob) == jax_validate(blob)
    req = urllib.request.Request(f"{port_cache_url}/kv/bad{i}", data=blob,
                                 method="PUT")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    assert RemoteKVClient(port_cache_url).probe(f"bad{i}") is False


def test_cache_server_admission_verdicts_and_chain_header():
    """PUT answers 200 {"admitted": bool}; distinct X-KV-Requester
    identities promote a chain tagged with X-KV-Chain; a rejected PUT
    is a success for the client, counted as a rejection."""
    import json
    import urllib.request
    url, server = serve_cache(admit_hits=2)
    try:
        payload = (torch.ones(2, 2),)
        a = RemoteKVClient(url, requester="engine-a")
        assert a.put("p0", payload, chain="root") is True
        assert a.rejections == 1 and a.admissions == 0
        assert a.probe("p0") is False
        assert a.put("p0", payload, chain="root") is True  # same identity
        assert a.rejections == 2
        b = RemoteKVClient(url, requester="engine-b")
        assert b.put("p0", payload, chain="root") is True
        assert b.admissions == 1 and b.rejections == 0
        got = a.get("p0")
        assert got is not None and a.hits == 1
        with urllib.request.urlopen(url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["rejected_puts"] == 2 and stats["admissions"] == 1
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
        assert "kvcache:rejected_puts_total 2" in text
        assert "kvcache:chains 1" in text
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
    finally:
        server.shutdown()


def test_offload_manager_chain_lookup_and_dtype_isolation():
    mgr = KVOffloadManager(host_pool=HostKVPool())
    hashes = [(0, (1, 2)), (hash((0, (1, 2))), (3, 4)),
              (hash((hash((0, (1, 2))), (3, 4))), (5, 6))]
    mgr.offload_page(hashes[0], *_payload(1))
    mgr.offload_page(hashes[1], *_payload(2))
    assert mgr.lookup_chain(hashes) == 2
    assert mgr.lookup_chain(hashes[1:]) == 1
    got = mgr.fetch_many(hashes)
    assert got[2] is None and torch.equal(got[0][0], _payload(1)[0])
    other = KVOffloadManager(host_pool=mgr.host, kv_dtype="int8")
    assert other.lookup_chain(hashes) == 0


# ---- the engine: eviction and restore ------------------------------------------


@pytest.fixture(scope="module")
def weights():
    cfg = jax_config.tiny_model_config("llama")
    return {k: np.asarray(v) for k, v in
            jax_llama.init_params(cfg, jax.random.PRNGKey(11)).items()}


def _engine(weights, num_pages, offload=True, kv_dtype="auto"):
    cfg = port_config.EngineConfig(
        model=port_config.tiny_model_config("llama"),
        cache=port_config.CacheConfig(page_size=16, num_pages=num_pages,
                                      kv_cache_dtype=kv_dtype),
        scheduler=port_config.SchedulerConfig(
            max_num_seqs=2, max_model_len=256, prefill_chunk_size=64),
        offload=port_config.OffloadConfig(
            enable=offload, host_pool_bytes=256 * 1024 ** 2))
    return LLMEngine(cfg, params=params_from_numpy(weights, cfg.model,
                                                   "cpu"), device="cpu")


@pytest.mark.parametrize("kv_dtype", ["auto", "int8"])
def test_evicted_prefix_restores_from_the_host_pool(weights, kv_dtype):
    """Fill the cache, evict a cached prefix into the host pool, and
    restore it: the greedy stream equals a recompute's (and an int8
    page travels as its 4-tuple of data and scales)."""
    def sampling():
        return SamplingParams(max_tokens=4, temperature=0.0,
                              ignore_eos=True)
    shared = list(range(1, 65))  # 64 tokens = 4 full pages
    expected = _engine(weights, 64, offload=False, kv_dtype=kv_dtype
                       ).generate(shared + [99, 98], sampling()
                                  ).output_token_ids
    # 15 usable pages; for int8, 5 pages of full-precision bytes expand
    # to about 17 int8 pages, as in the reference test.
    engine = _engine(weights, 5 if kv_dtype == "int8" else 16,
                     kv_dtype=kv_dtype)
    assert 10 < engine.config.cache.num_pages < 32
    assert engine.generate(shared + [99, 98], sampling()
                           ).output_token_ids == expected
    for i in range(4):  # unrelated prompts evict the shared pages
        engine.generate([200 + i] * 80, sampling())
    assert engine.offload.offloaded_pages > 0
    some = next(iter(engine.offload.host._pool.values()))
    assert [a.dtype for a in some] == (
        [torch.int8] * 2 + [torch.float32] * 2 if kv_dtype == "int8"
        else [torch.float32] * 2)
    before = engine.offload.restored_pages
    again = engine.generate(shared + [99, 98], sampling())
    assert engine.offload.restored_pages > before
    assert again.output_token_ids == expected
    stats = engine.stats()
    assert stats["kv_offload_restored_pages"] == (
        engine.offload.restored_pages)
    assert engine.metrics.preempt_restore_latency.n > 0


# ---- the wire dtype of a page read off the device --------------------------------


@pytest.mark.parametrize("layout", ["per_layer", "stacked"])
@pytest.mark.parametrize("dtype,kv_dtype,wire", [
    ("bfloat16", "auto", "bfloat16"), ("float32", "auto", "float32"),
    ("bfloat16", "int8", "int8")], ids=["bf16", "f32", "int8"])
def test_page_wire_dtype_matches_jax_read_page(layout, dtype, kv_dtype,
                                               wire):
    """A page leaves the card in the cache's own element type: bf16 is 2
    bytes an element under wire dtype "bfloat16" (not f32), and the
    wire frame is byte-identical to the JAX engine's frame of the same
    page values (written into its runner, read back by its
    ``read_page``)."""
    import jax.numpy as jnp
    from production_stack_tpu.engine.engine import LLMEngine as JaxEngine

    pcfg = port_config.EngineConfig(
        model=dataclasses.replace(port_config.tiny_model_config("llama"),
                                  dtype=dtype),
        cache=port_config.CacheConfig(page_size=16, num_pages=8,
                                      kv_cache_dtype=kv_dtype,
                                      cache_layout=layout))
    engine = LLMEngine(pcfg, device="cpu")
    m = pcfg.model
    layers, kv, d = m.num_hidden_layers, m.num_key_value_heads, m.head_dim
    gen = torch.Generator().manual_seed(3)
    if kv_dtype == "int8":
        page = (torch.randint(-127, 128, (layers, kv, d, 16),
                              generator=gen, dtype=torch.int8),
                torch.randint(-127, 128, (layers, kv, d, 16),
                              generator=gen, dtype=torch.int8),
                torch.rand((layers, kv, 16), generator=gen),
                torch.rand((layers, kv, 16), generator=gen))
    else:
        page = tuple(torch.randn((layers, kv, d, 16), generator=gen)
                     .to(m.torch_dtype) for _ in range(2))
    engine.runner.write_page(3, *page)
    got = engine.runner.read_page(3)
    assert all(torch.equal(a, b) and a.dtype == b.dtype
               for a, b in zip(got, page))
    frame = unpackb(encode_payload(got))
    assert frame["arrays"][0]["dtype"] == wire
    itemsize = {"bfloat16": 2, "float32": 4, "int8": 1}[wire]
    assert len(frame["arrays"][0]["data"]) == layers * kv * d * 16 * itemsize

    jcfg = jax_config.EngineConfig(
        model=dataclasses.replace(jax_config.tiny_model_config("llama"),
                                  dtype=dtype),
        cache=jax_config.CacheConfig(page_size=16, num_pages=8,
                                     kv_cache_dtype=kv_dtype,
                                     cache_layout=layout))
    ref = JaxEngine(jcfg)
    ref.runner.write_page(3, *[jnp.asarray(_to_numpy(t)) for t in page])
    theirs = [np.asarray(a) for a in ref.runner.read_page(3)]
    assert [str(a.dtype) for a in theirs] == [
        frame_a["dtype"] for frame_a in frame["arrays"]]
    jax_frame = msgpack.packb({"version": jax_offload.KV_WIRE_VERSION,
                               "arrays": [{"data": a.tobytes(),
                                           "shape": list(a.shape),
                                           "dtype": str(a.dtype)}
                                          for a in theirs]})
    assert encode_payload(got) == jax_frame
