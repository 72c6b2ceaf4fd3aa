"""What the paged-KV attention kernels share on the host side.

The decode kernel (ops/paged_attention_cuda.py), the chunked-prefill
kernel (ops/prefill_attention_cuda.py) and the ragged kernel
(ops/ragged_attention_cuda.py) are one machine with a different query
block and score mask; the device half of that machine is
``csrc/paged_kv_common.cuh``. This module holds the host
half:

- the build of the kernel library: ``nvcc`` compiles every ``csrc/*.cu``
  for ``sm_90a`` (one process per source, all started together), links
  one shared library with a plain C interface into
  ``build/kernels/<hash of the sources and flags>/``, and ``ctypes``
  loads it. The build runs at first use, from the checkout's sources
  only;
- the launch counters that show a run went through the kernels;
- operand checks common to the wrappers, and the split of an int8
  cache (a ``QuantKV``, ops/quant_kv.py) into its data and scales;
- the plain chunked page walk in torch: the same 128-token chunks,
  the same mask, the same online softmax (m, l, acc in f32), the same
  fold of an int8 cache's scales and the same zero output for a row
  with no cached tokens as the kernels. It is what a wrapper runs for
  CPU tensors, and what the kernels are compared with on the card. It
  also walks a range of chunks to the unnormalised state and merges
  such states, as the decode kernel's splits do, and can round the
  probabilities as the tensor-core walk does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from production_stack_tpu_torch.ops.quant_kv import QuantKV

NEG_INF = -1e30

# Tokens per step of the page walk: a chunk is 128 // page_size
# pages, so the kernels' thread layout is the same at every page size.
CHUNK_TOKENS = 128

# dtype codes of the C interface: of the query/output and of the
# cache's elements (an int8 cache's scales are always f32). Which
# (dtype, cache dtype, query group, head dim) the kernels are built
# for is listed once, in csrc/paged_kv_common.cuh
# (PSTT_FOR_EACH_GEOMETRY), and asked of the library.
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_CACHE_CODES = {**_DTYPE_CODES, torch.int8: 2}

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = (pathlib.Path(__file__).resolve().parents[2]
              / "build" / "kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libpstt_kernels.so"


class KernelCounters:
    """Plain-integer launch counters, one per kernel: a wrapper adds
    one where it launches its kernel and nowhere else. Calls to a
    plain version made with CUDA tensors are counted apart, so a run
    can show that the card's main path never fell back to them."""

    def __init__(self):
        self.launches: Dict[str, int] = {}
        self.plain_cuda_calls: Dict[str, int] = {}

    def launched(self, name: str) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1

    def plain_on_cuda(self, name: str) -> None:
        self.plain_cuda_calls[name] = (
            self.plain_cuda_calls.get(name, 0) + 1)

    def reset(self) -> None:
        self.launches.clear()
        self.plain_cuda_calls.clear()


COUNTERS = KernelCounters()


# ---- build and load -------------------------------------------------------


def kernel_sources():
    """The .cu sources and headers the library is built from."""
    return (sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh")))


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    sources, headers = kernel_sources()
    for path in sources + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built "
                       "with the CUDA toolkit on the machine with the "
                       "card")


def build_kernels(log: Optional[Callable[[str], None]] = None
                  ) -> pathlib.Path:
    """Build the kernel library if no build of these exact sources
    exists; returns its path. Raises with the compiler's output when a
    source does not compile. ``log`` receives the compiler's output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    out_dir = BUILD_ROOT / _source_digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _find_nvcc()
    sources, _ = kernel_sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-c", str(src),
             "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        failed = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            if log is not None and out:
                log(f"nvcc {src.name}:\n{out}")
            if proc.returncode:
                failed.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             "-o", tmp_lib, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"kernel link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib


_LIB = None
_LIB_LOCK = threading.Lock()


def kernel_lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_kernels()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            # Every launch ends with (layer, layer stride of the data,
            # layer stride of the scales, stream): see layer_args.
            layer = [i32, i64, i64, ptr]
            # decode: ... out, split scratch, 7 shape ints, the number
            # of splits and the chunks of one split.
            lib.pstt_paged_decode.argtypes = (
                [i32] * 2 + [ptr] * 9 + [i32] * 9 + layer)
            lib.pstt_paged_decode.restype = i32
            lib.pstt_paged_prefill.argtypes = (
                [i32] * 2 + [ptr] * 9 + [i32] * 8 + layer)
            lib.pstt_paged_prefill.restype = i32
            lib.pstt_paged_ragged.argtypes = (
                [i32] * 2 + [ptr] * 10 + [i32] * 8 + layer)
            lib.pstt_paged_ragged.restype = i32
            lib.pstt_kernel_supports.argtypes = [i32] * 4
            lib.pstt_kernel_supports.restype = i32
            _LIB = lib
        return _LIB


def check_launch(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` after a launch: a
    launch the card refused never runs, and no later synchronize
    reports it."""
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err}")


# ---- operand checks -------------------------------------------------------


def validate_layer_arg(cache, layer) -> bool:
    """The stacked-cache/layer-index contract of every paged writer and
    reader: a stacked [L, kv, pages, d, page] cache comes WITH its
    layer index, a per-layer [kv, pages, d, page] cache without. Returns
    whether the cache is stacked."""
    stacked = cache.dim() == 5
    if stacked != (layer is not None):
        raise ValueError(
            "layer index and cache rank must agree: pass a stacked "
            "[L, ...] cache WITH layer, or a per-layer [kv, ...] "
            f"cache WITHOUT (got ndim={cache.dim()}, layer={layer!r})")
    return stacked


def check_cache(k_cache, v_cache, layer: Optional[int] = None) -> None:
    """Reject the cache forms the wrappers do not take: a bare int8
    tensor (its scales are missing), a rank that disagrees with
    ``layer``, a layer index outside the stack, and anything not shaped
    [kv, pages, d, page] (per layer) or [L, kv, pages, d, page]
    (stacked). An int8 cache is a QuantKV whose scales are f32
    [(L,) kv, pages, page]."""
    if isinstance(k_cache, QuantKV) != isinstance(v_cache, QuantKV):
        raise ValueError("k_cache and v_cache must both be QuantKV or "
                         "both be full precision")
    for cache in (k_cache, v_cache):
        quantized = isinstance(cache, QuantKV)
        data = cache.data if quantized else cache
        if not isinstance(data, torch.Tensor):
            raise ValueError("expected a tensor or a QuantKV cache")
        if not quantized and data.dtype in (torch.int8, torch.uint8):
            raise ValueError(
                "an int8 KV cache needs its scales: pass a QuantKV "
                "(data and scale), not the bare int8 pages")
        if data.dim() not in (4, 5):
            raise ValueError(
                "expected a [kv, pages, d, page] cache or a stacked "
                f"[L, kv, pages, d, page] one, got shape "
                f"{tuple(data.shape)}")
        if validate_layer_arg(data, layer) and not (
                isinstance(layer, int) and 0 <= layer < data.shape[0]):
            raise ValueError(f"layer {layer!r} outside the stacked "
                             f"cache's {data.shape[0]} layers")
        if quantized:
            lead = tuple(data.shape[:-2])
            if data.dtype != torch.int8:
                raise ValueError("a QuantKV's data must be int8")
            if (cache.scale.dtype != torch.float32
                    or tuple(cache.scale.shape) != lead + data.shape[-1:]):
                raise ValueError(
                    "a QuantKV's scales must be f32 [(L,) kv, pages, "
                    f"page] = {lead + data.shape[-1:]}, got "
                    f"{cache.scale.dtype} {tuple(cache.scale.shape)}")


def layer_args(k_data: torch.Tensor, k_scale: Optional[torch.Tensor],
               layer: Optional[int]) -> Tuple[int, int, int]:
    """The launch's (layer, layer stride of the data, layer stride of
    the scales), in elements: the kernels read a stacked cache in place
    at ``layer``; the per-layer form is layer 0 with strides 0."""
    if layer is None:
        return 0, 0, 0
    return (layer, k_data.stride(0),
            0 if k_scale is None else k_scale.stride(0))


def split_cache(k_cache, v_cache) -> Tuple[torch.Tensor, torch.Tensor,
                                           Optional[torch.Tensor],
                                           Optional[torch.Tensor]]:
    """(k data, v data, k scale, v scale); the scales are None for a
    full-precision cache."""
    if isinstance(k_cache, QuantKV):
        return k_cache.data, v_cache.data, k_cache.scale, v_cache.scale
    return k_cache, v_cache, None, None


def check_kernel_operands(q, k_cache, v_cache, int_operands, out,
                          k_scale=None, v_scale=None) -> None:
    """Device, dtype, shape and contiguity checks before a launch;
    raises on anything the kernels do not take. ``k_cache``/``v_cache``
    are the caches' data, per layer or stacked: q's dtype, or int8 with
    f32 ``k_scale`` / ``v_scale`` beside them."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("kernel operands must be CUDA tensors")
    cache_dtype = q.dtype if k_scale is None else torch.int8
    for name, t, dtype in (("k_cache", k_cache, cache_dtype),
                           ("v_cache", v_cache, cache_dtype),
                           ("out", out, q.dtype)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}")
    if k_cache.shape != v_cache.shape:
        raise ValueError("k_cache and v_cache shapes differ")
    scales = ()
    if k_scale is not None:
        scales = (("k_scale", k_scale), ("v_scale", v_scale))
        for name, t in scales:
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 on {dev}")
    for name, t in int_operands:
        if t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32 on {dev}")
    for name, t in (("q", q), ("k_cache", k_cache),
                    ("v_cache", v_cache), ("out", out)) + scales + tuple(
                        int_operands):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    num_kv_heads, _, head_dim, page_size = k_cache.shape[-4:]
    if q.shape[-1] != head_dim:
        raise ValueError("q head_dim does not match the cache")
    check_kernel_shapes(q.shape[-2], num_kv_heads, head_dim, page_size,
                        q.dtype, cache_dtype)


def check_kernel_shapes(num_q_heads: int, num_kv_heads: int,
                        head_dim: int, page_size: int,
                        dtype: torch.dtype,
                        cache_dtype: Optional[torch.dtype] = None) -> None:
    """Raise NotImplementedError on a geometry the kernels are not
    built for (asked of the kernel library, which it loads).
    ``cache_dtype`` is the cache's element type (default ``dtype``;
    torch.int8 for an int8 cache). The runner calls it at start-up on
    the card, so an unsupported model fails there and not at its first
    step."""
    cache_dtype = cache_dtype or dtype
    if dtype not in _DTYPE_CODES or cache_dtype not in _CACHE_CODES:
        raise NotImplementedError(
            f"kernels take bf16 or f32 operands over a cache of the same "
            f"type or int8 (got {dtype} over {cache_dtype})")
    if num_q_heads % num_kv_heads:
        raise ValueError("num_q_heads must be a multiple of kv heads")
    group = num_q_heads // num_kv_heads
    if not kernel_lib().pstt_kernel_supports(
            _DTYPE_CODES[dtype], _CACHE_CODES[cache_dtype], group,
            head_dim):
        raise NotImplementedError(
            f"the kernels are not built for query group {group}, "
            f"head_dim {head_dim}, {dtype} over a {cache_dtype} cache "
            "(csrc/paged_kv_common.cuh PSTT_FOR_EACH_GEOMETRY lists "
            "what they are built for)")
    if (page_size > CHUNK_TOKENS or CHUNK_TOKENS % page_size
            or (page_size * cache_dtype.itemsize) % 16):
        raise NotImplementedError(
            f"page_size {page_size}: the kernels walk 128-token chunks "
            "of whole pages with 16-byte loads (page_size must divide "
            f"128 and hold a multiple of 16 bytes of {cache_dtype}, so "
            "a multiple of 16 for an int8 cache)")


def dtype_code(dtype: torch.dtype) -> int:
    return _DTYPE_CODES[dtype]


def cache_code(dtype: torch.dtype) -> int:
    return _CACHE_CODES[dtype]


def data_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's device address, or None (a null pointer) for None."""
    return None if t is None else t.data_ptr()


def counter_name(kernel: str, k_scale: Optional[torch.Tensor],
                 layer: Optional[int] = None) -> str:
    """A kernel's launch-counter name: each form counts apart
    (``<kernel>[_int8][_stacked]``), so a run shows which forms ran."""
    return (kernel + ("" if k_scale is None else "_int8")
            + ("" if layer is None else "_stacked"))


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---- plain page walk ------------------------------------------------------


def page_walk_plain(q_rows: torch.Tensor, k_cache: torch.Tensor,
                    v_cache: torch.Tensor, page_table: torch.Tensor,
                    kv_lens: torch.Tensor,
                    mask_fn: Callable[[torch.Tensor], torch.Tensor],
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None,
                    layer: Optional[int] = None,
                    p_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The kernels' page walk in torch.

    Args:
      q_rows:  [B, KV, R, D] query rows of each (row, kv head) block
      k/v_cache: [KV, pages, D, page_size] (int8 with scales), or the
               stacked [L, KV, pages, D, page_size] cache with ``layer``
      page_table: [B, max_pages]; kv_lens: [B]
      mask_fn: token positions [C] -> validity mask broadcastable to
               [B, KV, R, C] (the counterpart of the kernels' mask
               functor)
      k/v_scale: an int8 cache's f32 [(L,) KV, pages, page_size] scales
      layer:   the layer a stacked cache is read at, as a view: the walk
               is then the per-layer walk over ``k_cache[layer]``
      p_dtype: round the probabilities that enter p . v to this type
               (the tensor-core walk feeds them to the product as
               bf16); l still sums the unrounded ones. Default: none

    Walks ceil(kv_len / 128) chunks per row: pages of a chunk past
    ceil(kv_len / page_size) read as zeros, scores outside the mask
    are -1e30, and m, l, acc run the online softmax in f32. An int8
    cache follows the Pallas kernels' order: the scores are
    (q . k_int8) / sqrt(D) * k_scale[token], l sums the unscaled
    probabilities, and p * v_scale[token] enters p . v. Returns
    acc / max(l, 1e-30) in f32 — exact 0 for a row with kv_len 0.
    """
    _, l, acc = page_walk_partial(q_rows, k_cache, v_cache, page_table,
                                  kv_lens, mask_fn, k_scale, v_scale, layer,
                                  p_dtype=p_dtype)
    return acc / torch.clamp(l, min=1e-30)


def page_walk_partial(q_rows: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, page_table: torch.Tensor,
                      kv_lens: torch.Tensor,
                      mask_fn: Callable[[torch.Tensor], torch.Tensor],
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None,
                      layer: Optional[int] = None,
                      chunk_range: Optional[Tuple[int, int]] = None,
                      p_dtype: Optional[torch.dtype] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The walk of ``page_walk_plain`` over the chunks ``chunk_range`` =
    [begin, end) of every row (default: all), unnormalised: returns the
    online softmax's state (m [B, KV, R, 1], l [B, KV, R, 1], acc
    [B, KV, R, D]) in f32. A row with no chunk in the range keeps the
    empty state (-1e30, 0, 0), which is what a split of the decode
    kernel writes for it."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    b, kvh, rows, d = q_rows.shape
    page_size = k_cache.shape[-1]
    pages_per_chunk = max(1, CHUNK_TOKENS // page_size)
    chunk = pages_per_chunk * page_size
    dev = q_rows.device
    kv_lens = kv_lens.long()
    max_pages = page_table.shape[1]
    n_chunks = -(-max_pages // pages_per_chunk)
    if max_pages % pages_per_chunk:
        page_table = torch.nn.functional.pad(
            page_table, (0, n_chunks * pages_per_chunk - max_pages))
    page_table = page_table.long()
    pages_needed = -(-kv_lens // page_size)
    row_chunks = -(-kv_lens // chunk)
    walk = min(n_chunks, int(row_chunks.max()) if b else 0)
    begin, end = (0, walk) if chunk_range is None else chunk_range

    q = q_rows.float()
    scale = 1.0 / d ** 0.5
    m = torch.full((b, kvh, rows, 1), NEG_INF, device=dev)
    l = torch.zeros((b, kvh, rows, 1), device=dev)
    acc = torch.zeros((b, kvh, rows, d), device=dev)
    lane = torch.arange(pages_per_chunk, device=dev)
    for c in range(begin, min(end, walk)):
        ids = page_table[:, c * pages_per_chunk:(c + 1) * pages_per_chunk]
        live = (c * pages_per_chunk + lane)[None] < pages_needed[:, None]

        def stage(cache):
            tile = cache[:, ids].float()  # [KV, B, ppc, D, ps]
            tile = torch.where(live[None, :, :, None, None], tile, 0.0)
            return tile.permute(1, 0, 3, 2, 4).reshape(b, kvh, d, chunk)

        def stage_scale(scales):
            tile = scales[:, ids]  # [KV, B, ppc, ps]
            tile = torch.where(live[None, :, :, None], tile, 0.0)
            return tile.permute(1, 0, 2, 3).reshape(b, kvh, 1, chunk)

        k, v = stage(k_cache), stage(v_cache)
        s = (q @ k) * scale  # [B, KV, R, C]
        if k_scale is not None:
            s = s * stage_scale(k_scale)
        token_pos = c * chunk + torch.arange(chunk, device=dev)
        s = torch.where(mask_fn(token_pos), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        active = (c < row_chunks)[:, None, None, None]
        l = torch.where(active, l * alpha + p.sum(-1, keepdim=True), l)
        if v_scale is not None:
            p = p * stage_scale(v_scale)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = torch.where(active, acc * alpha + p @ v.transpose(-1, -2),
                          acc)
        m = torch.where(active, m_new, m)
    return m, l, acc


def merge_partials_plain(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor) -> torch.Tensor:
    """The decode kernel's merge of its splits' partials in torch.

    ``m``, ``l`` [S, ..., 1] and ``acc`` [S, ..., D] hold the S splits'
    softmax states, split-major. The merged output is
    sum_s e_s acc_s / max(sum_s e_s l_s, 1e-30) with e_s = exp(m_s -
    max_s m_s), summed in split order. Where every split is empty
    (m = -1e30, l = 0, acc = 0) the weights are exp(0) = 1 over zeros:
    exact 0, no NaN."""
    m_all = m.amax(0)
    tot = torch.zeros_like(acc[0])
    tot_l = torch.zeros_like(l[0])
    for s in range(m.shape[0]):
        e = torch.exp(m[s] - m_all)
        tot = tot + e * acc[s]
        tot_l = tot_l + e * l[s]
    return tot / torch.clamp(tot_l, min=1e-30)
