"""Netpbm as Pillow 12.1's `PpmImagePlugin` reads it, in numpy.

`decode_netpbm(data)` gives `(pixels, mode, palette)` as
`np.asarray(Image.open(f))` and its mode:

* P1 and P4 (bitmaps, 1 = black) as "1"; P2 and P5 as "L", or as "I"
  where maxval passes 255; P3 and P6 as "RGB"; `Pf` (grey floats) as "F",
  stored bottom-up, big-endian for a positive scale and little-endian for
  a negative one; and Pillow's own P0CMYK, PyP, PyRGBA and PyCMYK;
* the header's tokens as Pillow reads them: whitespace-separated, `#`
  comments to the end of the line (a comment inside a token does not end
  it), at most 10 characters, Python's `int` and `float`;
* raw samples: maxval 255 as stored; 65535 grey as "I", kept as stored
  (3000 stays 3000); any other maxval scaled as round(v / maxval · 255) (or
  · 65535 for "I"), clipped, 16-bit big-endian from maxval 256 (so 16-bit
  colour comes out 8-bit);
* plain (ASCII) samples always scaled so, including maxval 255, values
  past maxval refused; plain bitmaps take `0` and `1` with or without
  whitespace between them.

P7 (PAM) and PF (colour floats) are not Netpbm files to Pillow: their
magic falls through to the other formats, as Pillow's does.  Data that
ends early raises `ValueError`, as Pillow's "not enough image data" and
"image file is truncated" do.
"""
from __future__ import annotations

import math

import numpy as np

from .png import bilevel
from .raster import NotThisFormat, Stream, sized, unpack

_WHITESPACE = b" \t\n\x0b\x0c\r"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L", b"P6": "RGB",
         b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P", b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
SAFEBLOCK = 1024 * 1024                       # Pillow's block of plain data


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[:1] == b"P" and prefix[1] in b"0123456fy"


def _magic(f: Stream) -> bytes:
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in _WHITESPACE:
            break
        magic += c
    return magic


def _token(f: Stream, name: str) -> bytes:
    token = b""
    while len(token) <= 10:
        c = f.read(1)
        if not c:
            break
        if c in _WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while f.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise ValueError(f"{name}: reached the end of the file while reading the Netpbm header")
    if len(token) > 10:
        raise ValueError(f"{name}: token too long in the Netpbm header")
    return token


def _int(token: bytes, name: str) -> int:
    try:
        return int(token)
    except ValueError as e:
        raise ValueError(f"{name}: bad number {token!r} in the Netpbm header") from e


class _Plain:
    """PpmPlainDecoder: the data in blocks of SAFEBLOCK bytes, comments cut
    out of each block as Pillow cuts them."""

    def __init__(self, data: bytes, at: int, name: str):
        self.f, self.spans, self.name = Stream(data, at), False, name

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def _ignore(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.f.read(SAFEBLOCK)
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                return block
            end = self._comment_end(block, start)
            if end == -1:
                self.spans = True
                return block[:start]
            block = block[:start] + block[end + 1:]

    def bits(self, total: int) -> bytes:
        data = b""
        while len(data) != total:
            block = self.f.read(SAFEBLOCK)
            if not block:
                break
            tokens = b"".join(self._ignore(block).split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise ValueError(f"{self.name}: invalid token {bad[:1]!r} in a plain bitmap")
            data = (data + tokens)[:total]
        return data

    def values(self, total: int, maxval: int) -> list:
        values, half = [], b""
        while len(values) != total:
            block = self.f.read(SAFEBLOCK)
            if not block:
                if not half:
                    break
                block = b" "
            block = self._ignore(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError(f"{self.name}: token too long in the plain data")
            for token in tokens:
                if len(token) > 10:
                    raise ValueError(f"{self.name}: token too long in the plain data")
                try:
                    v = int(token)
                except ValueError as e:
                    raise ValueError(f"{self.name}: bad number {token!r} in the plain "
                                     "data") from e
                if v < 0 or v > maxval:
                    raise ValueError(f"{self.name}: sample {v} outside 0-{maxval}")
                values.append(v)
                if len(values) == total:
                    break
        return values


def _scale(v: np.ndarray, maxval: int, out_max: int) -> np.ndarray:
    """round(v / maxval * out_max), Python's rounding (half to even)."""
    return np.round(v.astype(np.float64) / maxval * out_max)


def decode_netpbm(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, palette) of a Netpbm file as Pillow opens it."""
    f = Stream(data)
    magic = _magic(f)
    if magic not in MODES:
        raise NotThisFormat("not a PPM file")
    mode = MODES[magic]
    try:
        w, h = int(_token(f, name)), int(_token(f, name))
    except ValueError as e:
        raise ValueError(f"{name}: bad size in the Netpbm header") from e
    plain = magic in (b"P1", b"P2", b"P3")
    maxval, rawmode, scaled = 255, mode, plain
    if mode == "F":
        try:
            scale = float(_token(f, name))
        except ValueError as e:
            raise ValueError(f"{name}: bad scale in the Netpbm header") from e
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError(f"{name}: the scale must be finite and non-zero")
        rawmode = "<f4" if scale < 0 else ">f4"
    elif mode != "1":
        maxval = _int(_token(f, name), name)
        if not 0 < maxval < 65536:
            raise ValueError(f"{name}: maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
        if not plain:
            if maxval == 65535 and mode == "I":
                rawmode = ">u2"
            elif maxval != 255:
                scaled = True
    sized(w, h, mode)
    at, bands = f.tell(), _BANDS[mode]
    out_max = 65535 if mode == "I" else 255
    if plain and mode == "1":
        got = _Plain(data, at, name).bits(w * h)
        if len(got) < w * h:
            raise ValueError(f"{name}: not enough image data")
        px = np.frombuffer(got, np.uint8).reshape(h, w)
        return bilevel(px == ord("0")), mode, None
    if plain or scaled:
        if plain:
            got = _Plain(data, at, name).values(w * h * bands, maxval)
            if len(got) < w * h * bands:
                raise ValueError(f"{name}: not enough image data")
            v = _scale(np.asarray(got, np.int64), maxval, out_max)
        else:
            width = 1 if maxval < 256 else 2
            if (len(data) - at) // width < w * h * bands:
                raise ValueError(f"{name}: not enough image data")
            raw = np.frombuffer(data, ">u2" if width == 2 else np.uint8, w * h * bands, at)
            v = np.minimum(out_max, _scale(raw, maxval, out_max))
        v = v.astype(np.int32 if mode == "I" else np.uint8).reshape(
            (h, w) if bands == 1 else (h, w, bands))
    else:
        itemsize = {"<f4": 4, ">f4": 4, ">u2": 2}.get(rawmode, 1)
        stride = (w + 7) // 8 if mode == "1" else w * bands * itemsize
        if len(data) - at < stride * h:
            raise ValueError(f"{name}: image file is truncated (Netpbm data ends early)")
        raw = np.frombuffer(data, np.uint8, stride * h, at)
        if mode == "1":
            return unpack(raw.reshape(h, stride), "1;I", w), mode, None
        if itemsize > 1:
            v = raw.view(rawmode).reshape(h, w)
            v = (v[::-1] if mode == "F" else v).astype(np.float32 if mode == "F" else np.int32)
        else:
            v = unpack(raw.reshape(h, stride), mode, w)
    # a "P" image (PyP) has no palette: Pillow converts it through zeros
    return np.ascontiguousarray(v), mode, np.zeros((256, 3), np.uint8) if mode == "P" else None

