"""The port's safetensors reader, shared by the checkpoint loader
(engine/weights.py) and the LoRA adapter loader (engine/lora.py), so
the port needs no package for the format.

A file is a u64 little-endian header length, a JSON header mapping each
tensor name to its dtype, shape and [begin, end) byte offsets into the
data that follows, then the raw little-endian data. Tensors are read
one at a time with a seek and a read of exactly their bytes, so a
caller that moves each to the device as it comes holds one tensor in
host memory, never the file. F32, F16 and BF16 are read as stored
(BF16's two-byte words as int16, viewed as ``torch.bfloat16``).
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

# safetensors dtype -> (torch dtype, numpy dtype of the stored bytes).
_DTYPES = {
    "F32": (torch.float32, np.dtype("<f4")),
    "F16": (torch.float16, np.dtype("<f2")),
    "BF16": (torch.bfloat16, np.dtype("<i2")),
}


def read_header(path: str) -> Tuple[Dict[str, dict], int]:
    """(the header's tensor entries by name, the byte offset where the
    data starts); ``__metadata__`` is dropped."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n).decode("utf-8"))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_tensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) of every tensor of the file, in the order of
    their data, each read on its own."""
    header, base = read_header(path)
    with open(path, "rb") as f:
        for name, info in sorted(header.items(),
                                 key=lambda kv: kv[1]["data_offsets"][0]):
            yield name, _read(f, path, name, info, base)


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of the file, by name (CPU tensors)."""
    return dict(iter_tensors(path))


def _read(f, path: str, name: str, info: dict, base: int) -> torch.Tensor:
    dtype = info["dtype"]
    if dtype not in _DTYPES:
        raise ValueError(f"{path}: tensor {name!r} has dtype {dtype}; "
                         f"the reader takes {sorted(_DTYPES)}")
    torch_dtype, np_dtype = _DTYPES[dtype]
    begin, end = info["data_offsets"]
    shape = tuple(info["shape"])
    count = int(np.prod(shape)) if shape else 1
    if end - begin != count * np_dtype.itemsize:
        raise ValueError(f"{path}: tensor {name!r} spans {end - begin} "
                         f"bytes, its shape {shape} needs "
                         f"{count * np_dtype.itemsize}")
    f.seek(base + begin)
    buf = bytearray(end - begin)
    if f.readinto(buf) != len(buf):
        raise ValueError(f"{path}: tensor {name!r} runs past the file")
    arr = np.frombuffer(buf, dtype=np_dtype)
    arr = arr.astype(np_dtype.newbyteorder("="), copy=False).reshape(shape)
    out = torch.from_numpy(arr)
    return out.view(torch_dtype) if dtype == "BF16" else out
