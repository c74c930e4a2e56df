"""A msgpack reader and writer for the parameter trees flax writes, with numpy
only.

`flax.serialization.msgpack_serialize` packs a nested dict of arrays with
msgpack (`https://github.com/msgpack/msgpack/blob/master/spec.md`); each
array is ext type 1, whose payload is itself a msgpack array
`[shape, dtype name, C-order bytes]`.  This module decodes that format
without the `msgpack` or `flax` packages:

  * nil, bool, every int and float width;
  * fixstr, str8/16/32 (UTF-8) and bin8/16/32 (bytes);
  * fixarray, array16/32 (lists), fixmap, map16/32 (dicts);
  * fixext1-16 and ext8/16/32 of code 1 (arrays).

An array comes back as a numpy array that owns its memory, except a dtype
name of `bfloat16`, which numpy lacks: its bytes are read as 16-bit words and
come back as a `torch.bfloat16` tensor.  Any other ext code (flax's complex
numbers and numpy scalars, codes 2 and 3), and any type byte outside the
list above, raises `ValueError` with the byte offset.  flax splits arrays
over 2³⁰ bytes into chunked dicts; this reader returns such a dict as it is.

`packb` writes the same layout, as `msgpack_serialize` of a tree flax's
`tree_map` has passed through (dict keys sorted at every level, every type
in its shortest form, as the `msgpack` package packs it); `save_flat`
writes a flat "a/b/c" tree to a file JAX's `load_bundle` reads.  Arrays of
2³⁰ bytes or more raise (flax would chunk them).
"""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np
import torch

NDARRAY_EXT = 1

# type byte -> (struct format of the fixed-width value, its size)
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# type byte -> (size of the length field, container kind)
_SIZED = {
    0xC4: (1, "bin"), 0xC5: (2, "bin"), 0xC6: (4, "bin"),
    0xC7: (1, "ext"), 0xC8: (2, "ext"), 0xC9: (4, "ext"),
    0xD9: (1, "str"), 0xDA: (2, "str"), 0xDB: (4, "str"),
    0xDC: (2, "array"), 0xDD: (4, "array"),
    0xDE: (2, "map"), 0xDF: (4, "map"),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.pos} (need {n} more)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        at = self.pos
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self.unpack(*_SCALARS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b], at)
        if b in _SIZED:
            width, kind = _SIZED[b]
            n = self.unpack(_LENGTH[width], width)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(n, at)
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at byte {at}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int, at: int):
        code = self.unpack(">b", 1)
        payload = self.take(n)
        if code != NDARRAY_EXT:
            raise ValueError(f"msgpack: ext code {code} at byte {at} (only {NDARRAY_EXT}, "
                             f"flax's ndarray, is read)")
        inner = _Reader(payload)
        shape, dtype, buf = inner.value()
        if dtype == "bfloat16":
            words = np.frombuffer(buf, dtype=np.int16).reshape(shape).copy()
            return torch.from_numpy(words).view(torch.bfloat16)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _header(out: bytearray, n: int, fix_base: int, fix_max: int, codes) -> None:
    """A length header: the fix form below fix_max, else the first of
    (code8, code16, code32) whose width holds n (None: no such width)."""
    if fix_base is not None and n < fix_max:
        out.append(fix_base | n)
        return
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 1 << (8 * width):
            out.append(code)
            out += struct.pack(_LENGTH[width], n)
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: bytearray, n: int) -> None:
    if 0 <= n < 128:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < lim:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: int {n} too large")
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if n >= -lim:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise ValueError(f"msgpack: int {n} too small")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _header(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k in sorted(obj):
            _pack(k, out)
            _pack(obj[k], out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_array(obj, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _pack_array(a, out: bytearray) -> None:
    """ext 1: [shape, dtype name, C-order bytes]; a bfloat16 tensor as its
    16-bit words under the name `bfloat16`."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            shape, name, raw = list(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
    if isinstance(a, np.ndarray):
        shape, name, raw = list(a.shape), a.dtype.name, np.ascontiguousarray(a).tobytes()
    if len(raw) >= 1 << 30:
        raise ValueError("msgpack: arrays of 2^30 bytes or more are chunked by flax")
    payload = bytearray()
    _pack([shape, name, raw], payload)
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", NDARRAY_EXT)
    out += payload


def packb(obj: Any) -> bytes:
    """Encode `obj` (nested dicts / lists of str, int, float, bool, None,
    bytes and arrays) as flax's `msgpack_serialize` does."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def unflatten(flat: Dict[str, Any]) -> Dict:
    """{"a/b": x} -> {"a": {"b": x}}."""
    tree: Dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def save_flat(path: str, flat: Dict[str, Any]) -> None:
    """Write a flat "a/b/c" tree as the nested file flax writes."""
    with open(path, "wb") as f:
        f.write(packb(unflatten(flat)))


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that spans all of `data`."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.data):
        raise ValueError(f"msgpack: {len(r.data) - r.pos} trailing bytes at byte {r.pos}")
    return out


def flatten(tree: Dict, prefix: str = "") -> Dict[str, Any]:
    """{"a": {"b": x}} -> {"a/b": x}."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def load_flat(path: str) -> Dict[str, Any]:
    """The tree of a file written by `flax.serialization.msgpack_serialize`,
    flattened to "a/b/c" keys, as `utils/weights.py` `bridge` takes it."""
    with open(path, "rb") as f:
        return flatten(unpackb(f.read()))
