"""Read an orbax checkpoint without orbax or tensorstore.

`restore(path)` gives the nested tree that `ocp.StandardCheckpointer()
.restore(path)` gives without a target, with numpy arrays for its arrays:

* the tree comes from `_METADATA`'s `tree_metadata`: a dict key (key_type 2)
  makes a dict, a sequence index (key_type 1) a list, as orbax restores
  tuples and lists alike; empty leaves come back as orbax gives them
  (`None` for None and optax's empty states, `{}`, `[]`, `()`), and `scalar`
  leaves as Python ints / floats;
* each array is read from zarr v2 (`<name>/.zarray`: C order, a regular
  chunk grid with `.`-separated chunk keys, `fill_value` null (zeros) or a
  value, compressor zstd or none) or zarr v3 (`<name>/zarr.json`: the
  `bytes` codec's endianness, `zstd`, `sharding_indexed` with its CRC-32C
  index, the default chunk-key encoding), as `_METADATA`'s `use_zarr3`
  says;
* the values live in the checkpoint's OCDBT database (`utils/ocdbt.py`)
  when `use_ocdbt` is true, else one directory per array.

bfloat16 arrays come back as `torch.bfloat16` CPU tensors holding the same
bits (numpy has no bfloat16); every other dtype (`<f4 <f2 <i4 <i8 <u4 bool`
and the other plain numpy dtypes) as a numpy array.  `to_float32` converts a
tree's bfloat16 leaves where a port module takes float32.  Chunks decode
straight into the array's buffer through the port's zstd decoder
(`utils/zstd.py`), several arrays at a time in threads (the decoder runs
outside the GIL).  A missing or corrupt file raises (`FileNotFoundError`,
`ValueError`).
"""
from __future__ import annotations

import json
import math
import os
import struct
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from . import zstd
from .ocdbt import Database

_V3_DTYPES = {"bool": "|b1", "int8": "|i1", "uint8": "|u1", "int16": "i2", "uint16": "u2",
              "int32": "i4", "uint32": "u4", "int64": "i8", "uint64": "u8", "float16": "f2",
              "float32": "f4", "float64": "f8", "bfloat16": "bfloat16"}


class _Store:
    """The checkpoint's values by key (`<array>/<file>`)."""

    def __init__(self, path: str, use_ocdbt: bool):
        self.path = path
        self.db = Database(path) if use_ocdbt else None

    def get(self, key: str) -> Optional[bytes]:
        if self.db is not None:
            return self.db.read(key) if key in self.db else None
        full = os.path.join(self.path, *key.split("/"))
        if not os.path.isfile(full):
            return None
        with open(full, "rb") as f:
            return f.read()


def _np_dtype(name: str, endian: str = "<"):
    """(numpy dtype to decode into, is bfloat16) for a zarr v2 dtype string or a
    zarr v3 data type (whose byte order the `bytes` codec gives)."""
    if name == "bfloat16":
        return np.dtype(endian + "u2"), True
    code = _V3_DTYPES.get(name, name)
    return np.dtype(code if code[:1] in "<>|" else endian + code), False


def _fill(shape, dtype: np.dtype, bf16: bool, fill) -> np.ndarray:
    arr = np.zeros(shape, dtype)
    if fill not in (None, 0, 0.0, False):
        if bf16:
            bits = np.array([fill], np.float32).view(np.uint32) >> 16
            arr[...] = bits.astype(np.uint16)
        else:
            arr[...] = fill
    return arr


def _chunk_into(raw: bytes, codec: Optional[str], dst: np.ndarray, what: str):
    """Decode one chunk's bytes (zstd or raw) into the C-contiguous `dst`."""
    view = dst.reshape(-1).view(np.uint8)
    if codec == "zstd":
        zstd.decompress(raw, out=view, name=what)
    elif codec is None:
        if len(raw) != view.size:
            raise ValueError(f"{what}: chunk of {len(raw)} bytes, expected {view.size}")
        view[...] = np.frombuffer(raw, np.uint8)
    else:
        raise ValueError(f"{what}: compressor {codec!r} is not read (zstd or none)")


def _assemble(shape, chunks, dtype, bf16, fill, read_chunk, what) -> np.ndarray:
    """The whole array from its regular chunk grid; read_chunk(index, shape)
    returns a C-order chunk of the full chunk shape or None (fill)."""
    shape, chunks = tuple(shape), tuple(chunks)
    grid = [math.ceil(s / c) if c else 1 for s, c in zip(shape, chunks)]
    if all(g == 1 for g in grid) and chunks == shape:
        out = read_chunk((0,) * len(shape))
        return out if out is not None else _fill(shape, dtype, bf16, fill)
    out = _fill(shape, dtype, bf16, fill)
    for idx in np.ndindex(*grid):
        c = read_chunk(idx)
        if c is None:
            continue
        sl = tuple(slice(i * k, min((i + 1) * k, s)) for i, k, s in zip(idx, chunks, shape))
        out[sl] = c[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def _read_zarr2(store: _Store, name: str, meta: Dict) -> np.ndarray:
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C":
        raise ValueError(f"{name}: zarr array in a layout not read ({meta})")
    if meta.get("filters"):
        raise ValueError(f"{name}: zarr filters {meta['filters']} are not read")
    dtype, bf16 = _np_dtype(meta["dtype"])
    comp = meta.get("compressor")
    codec = None if comp is None else comp.get("id")
    sep = meta.get("dimension_separator", ".")
    shape, chunks = meta["shape"], meta["chunks"]

    def chunk(idx):
        key = sep.join(str(i) for i in idx) if idx else "0"
        raw = store.get(f"{name}/{key}")
        if raw is None:
            return None
        c = np.empty(chunks, dtype)
        _chunk_into(raw, codec, c, f"{name}/{key}")
        return c
    return _finish(_assemble(shape, chunks, dtype, bf16, meta.get("fill_value"), chunk, name),
                   bf16)


def _bytes_codecs(codecs: List[Dict], name: str):
    """(endianness, compressor) of a plain zarr v3 codec chain."""
    endian, comp = "<", None
    for c in codecs:
        cfg = c.get("configuration", {})
        if c["name"] == "bytes":
            endian = ">" if cfg.get("endian") == "big" else "<"
        elif c["name"] == "zstd":
            comp = "zstd"
        else:
            raise ValueError(f"{name}: zarr v3 codec {c['name']!r} is not read")
    return endian, comp


def _read_zarr3(store: _Store, name: str, meta: Dict) -> np.ndarray:
    if meta.get("zarr_format") != 3 or meta.get("node_type", "array") != "array":
        raise ValueError(f"{name}: not a zarr v3 array")
    grid = meta["chunk_grid"]
    if grid.get("name") != "regular":
        raise ValueError(f"{name}: chunk grid {grid.get('name')!r} is not read")
    cke = meta.get("chunk_key_encoding", {"name": "default"})
    if cke.get("name") != "default":
        raise ValueError(f"{name}: chunk key encoding {cke.get('name')!r} is not read")
    sep = cke.get("configuration", {}).get("separator", "/")
    shape, chunks = meta["shape"], grid["configuration"]["chunk_shape"]
    codecs = meta["codecs"]
    shard = None
    if len(codecs) == 1 and codecs[0]["name"] == "sharding_indexed":
        shard = codecs[0]["configuration"]
        codecs = shard["codecs"]
        iendian, icomp = _bytes_codecs([c for c in shard["index_codecs"] if c["name"] != "crc32c"],
                                       name)
        if icomp is not None:
            raise ValueError(f"{name}: a compressed shard index is not read")
        index_crc = any(c["name"] == "crc32c" for c in shard["index_codecs"])
    endian, comp = _bytes_codecs(codecs, name)
    dtype, bf16 = _np_dtype(meta["data_type"], endian)
    fill = meta.get("fill_value")

    def outer(idx):
        key = "c" + "".join(sep + str(i) for i in idx)
        raw = store.get(f"{name}/{key}")
        if raw is None:
            return None
        what = f"{name}/{key}"
        if shard is None:
            c = np.empty(chunks, dtype)
            _chunk_into(raw, comp, c, what)
            return c
        inner = shard["chunk_shape"]
        n_inner = [math.ceil(c / i) if i else 1 for c, i in zip(chunks, inner)]
        count = int(np.prod(n_inner)) if n_inner else 1
        isize = 16 * count + (4 if index_crc else 0)
        if len(raw) < isize:
            raise ValueError(f"{what}: shard shorter than its index")
        at_start = shard.get("index_location", "end") == "start"
        index = raw[:isize] if at_start else raw[len(raw) - isize:]
        if index_crc and zstd.crc32c(index[:-4]) != struct.unpack("<I", index[-4:])[0]:
            raise ValueError(f"{what}: shard index checksum mismatch")
        ent = np.frombuffer(index[:16 * count], np.dtype(iendian + "u8")).reshape(count, 2)

        def inner_chunk(j):
            flat = int(np.ravel_multi_index(j, n_inner)) if j else 0
            off, nb = int(ent[flat, 0]), int(ent[flat, 1])
            if off == (1 << 64) - 1 and nb == (1 << 64) - 1:
                return None
            if off + nb > len(raw):
                raise ValueError(f"{what}: inner chunk past the shard's end")
            c = np.empty(inner, dtype)
            _chunk_into(raw[off:off + nb], comp, c, what)
            return c
        return _assemble(chunks, inner, dtype, bf16, fill, inner_chunk, what)
    return _finish(_assemble(shape, chunks, dtype, bf16, fill, outer, name), bf16)


def _finish(arr: np.ndarray, bf16: bool):
    if not arr.dtype.isnative:
        arr = arr.astype(arr.dtype.newbyteorder("="))
    if bf16:
        return torch.from_numpy(np.ascontiguousarray(arr)).view(torch.bfloat16)
    return arr


def _read_array(store: _Store, name: str, zarr3: bool):
    meta_key = f"{name}/zarr.json" if zarr3 else f"{name}/.zarray"
    raw = store.get(meta_key)
    if raw is None:
        raise ValueError(f"{store.path}: the checkpoint lacks {meta_key}")
    meta = json.loads(raw)
    return _read_zarr3(store, name, meta) if zarr3 else _read_zarr2(store, name, meta)


_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}


def restore(path: str) -> Any:
    """The tree `ocp.StandardCheckpointer().restore(path)` gives, arrays as
    numpy (bfloat16 as torch.bfloat16 tensors)."""
    path = str(path)
    meta_file = os.path.join(path, "_METADATA")
    if not os.path.isfile(meta_file):
        raise FileNotFoundError(f"{path}: not an orbax checkpoint (no _METADATA)")
    with open(meta_file) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise ValueError(f"{meta_file}: no tree_metadata (an orbax layout not read)")
    store = _Store(path, bool(meta.get("use_ocdbt", True)))
    if store.db is not None:
        store.db.keys()                   # index the b-tree once, before the reads
    zarr3 = bool(meta.get("use_zarr3", False))
    entries = []
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] if k["key_type"] == 2 else int(k["key"]) for k in entry["key_metadata"]]
        vtype = entry["value_metadata"]["value_type"]
        if vtype not in _EMPTY and vtype not in ("jax.Array", "np.ndarray", "scalar"):
            raise ValueError(f"{path}: leaf {keys} of type {vtype!r} is not read")
        entries.append((entry, keys, vtype))
    # the arrays decode in threads: the zstd decoder runs outside the GIL
    arrays = [(".".join(str(k) for k in keys)) for _, keys, vtype in entries
              if vtype not in _EMPTY]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        read = dict(zip(arrays, pool.map(lambda n: _read_array(store, n, zarr3), arrays)))
    root: Dict = {}
    sequences = set()
    for entry, keys, vtype in entries:
        sequences.update(tuple(keys[:i]) for i, k in enumerate(entry["key_metadata"])
                         if k["key_type"] == 1)
        if vtype in _EMPTY:
            value = _EMPTY[vtype]()
        else:
            value = read[".".join(str(k) for k in keys)]
            if vtype == "scalar":
                value = (value.float() if isinstance(value, torch.Tensor) else value).item()
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def build(n, at):          # a sequence's int-keyed dict becomes a list
        if not isinstance(n, dict):
            return n
        kids = {k: build(v, at + (k,)) for k, v in n.items()}
        if at not in sequences:
            return kids
        if sorted(kids) != list(range(len(kids))):
            raise ValueError(f"{path}: sequence {list(at)} has indices {sorted(kids)}")
        return [kids[i] for i in range(len(kids))]
    return build(root, ())


def to_float32(tree: Any) -> Any:
    """`tree` with its bfloat16 leaves as float32 numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_float32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_float32(v) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        return tree.float().numpy()
    return tree
