"""A `.safetensors` reader with numpy only.

The format (`https://github.com/huggingface/safetensors`): an 8-byte
little-endian header length N, N bytes of JSON mapping each tensor name to
`{"dtype", "shape", "data_offsets": [begin, end]}` (offsets relative to the
byte after the header; a `__metadata__` entry of strings is skipped), then
the raw little-endian bytes of every tensor, C order.

`load_file` maps the file and returns {name: float32 numpy array} (F32
tensors as copy-on-write views of the map, the rest converted), the form
`utils/convert.load_torch_checkpoint` returns for a torch file.  F32, F16,
BF16, I32 and I64 are read; any other dtype raises.  The offsets must tile
the data section exactly (sorted, no gap, no overlap, ending at its end),
and each range must hold shape × item size bytes; a header that breaks any
of these, or runs past the file, raises `ValueError`.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np

# dtype name -> (numpy dtype of the stored words, bytes per element)
_DTYPES = {"F32": ("<f4", 4), "F16": ("<f2", 2), "BF16": ("<u2", 2),
           "I32": ("<i4", 4), "I64": ("<i8", 8)}


def _read_header(path: str):
    """(header dict without `__metadata__`, byte offset of the data section,
    file size)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: {size} bytes, no safetensors header")
        (n,) = struct.unpack("<Q", head)
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the file ({size} bytes)")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n, size


def _check_tiling(path: str, header: dict, data_bytes: int) -> None:
    spans = []
    for name, info in header.items():
        if info["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, not one of "
                             f"{sorted(_DTYPES)}")
        begin, end = info["data_offsets"]
        want = int(np.prod(info["shape"], dtype=np.int64)) * _DTYPES[info["dtype"]][1]
        if end - begin != want:
            raise ValueError(f"{path}: {name} spans {end - begin} bytes, its shape "
                             f"{info['shape']} needs {want}")
        spans.append((begin, end, name))
    pos = 0
    for begin, end, name in sorted(spans):
        if begin != pos:
            raise ValueError(f"{path}: {name} starts at {begin}, expected {pos} "
                             "(a gap or an overlap)")
        pos = end
    if pos != data_bytes:
        raise ValueError(f"{path}: tensors end at {pos}, the data section holds "
                         f"{data_bytes} bytes")


def load_file(path: str) -> Dict[str, np.ndarray]:
    """{name: float32 array} of every tensor in the file (integers converted
    too, as torch's `.float()` does)."""
    header, start, size = _read_header(path)
    _check_tiling(path, header, size - start)
    # copy-on-write map: float32 tensors come back as views of the file
    raw = (np.memmap(path, dtype=np.uint8, mode="c", offset=start) if size > start
           else np.zeros(0, np.uint8))
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        words = raw[begin:end].view(_DTYPES[info["dtype"]][0]).reshape(info["shape"])
        if info["dtype"] == "BF16":     # the high half of a float32
            out[name] = (words.astype(np.uint32) << 16).view(np.float32)
        else:
            out[name] = words.astype(np.float32, copy=False)
    return out

