"""What the readers of the raster formats Pillow 12.1 decodes by itself share
(`utils/netpbm.py`, `tga.py`, `qoi.py`, `ico.py`, `pcx.py`, `sgi.py`,
`sun.py`, `psd.py`, `xbm.py`, `xpm.py`, `fits.py`): numpy and the standard
library only.

* `NotThisFormat`: what a reader raises where Pillow's plugin raises in
  `_open` one of the errors `Image.open` takes as "not this format"
  (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error)
  or leaves the image without a mode or with a size of 0: `read_image`
  then tries the next format, as `Image._open_core` does.  Every other
  refusal is a `ValueError`, which ends the search, as Pillow's other
  errors end `Image.open`.
* `Stream`: a file's bytes read as a plugin reads its file (`read`,
  `readline`, `seek`, `tell`; a read at the end gives fewer bytes; a seek
  before the start raises, as it does on a file on disk).
* `sized`: Pillow's checks of an opened image's size.
* `unpack`: Pillow's unpackers (`Unpack.c`) of the raw modes these formats
  store, rows [h, stride] of bytes -> pixels.
* `palette`: a raw palette as `putpalette` holds it: [256, 3], the entries
  after the given ones black.
* `rows_from`: stored rows as the raw decoder places them (bottom-up or
  top-down);
* `cmyk_rgb`: Pillow's CMYK to RGB conversion.
"""
from __future__ import annotations

import struct

import numpy as np

from .png import MAX_PIXELS, bilevel


class NotThisFormat(Exception):
    """The file is not this format: try the next one."""


class Stream:
    """A plugin's view of the file's bytes."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int = -1) -> bytes:
        end = len(self.data) if n < 0 else self.pos + n
        out = self.data[self.pos:end]
        self.pos = max(self.pos, min(end, len(self.data))) if n >= 0 else max(self.pos,
                                                                               len(self.data))
        return out

    def readline(self) -> bytes:
        end = self.data.find(b"\n", self.pos)
        end = len(self.data) if end < 0 else end + 1
        out = self.data[self.pos:end]
        self.pos = max(self.pos, end)
        return out

    def seek(self, pos: int, whence: int = 0) -> None:
        base = (0, self.pos, len(self.data))[whence]
        if base + pos < 0:
            raise ValueError("seek before the start of the file")
        self.pos = base + pos

    def tell(self) -> int:
        return self.pos


def unpack_from(fmt: str, b: bytes, at: int = 0) -> tuple:
    """struct.unpack_from, a short buffer being "not this format"."""
    try:
        return struct.unpack_from(fmt, b, at)
    except struct.error as e:
        raise NotThisFormat(str(e)) from e


def sized(w: int, h: int, mode: str = "x") -> None:
    """`ImageFile.__init__` and `_decompression_bomb_check` on an opened
    image: no mode or a size of 0 is not this format, a size past twice
    Pillow's limit is refused."""
    if not mode or w <= 0 or h <= 0:
        raise NotThisFormat(f"image of size {w}x{h}")
    if w * h > MAX_PIXELS:
        raise ValueError(f"image of {w}x{h} pixels could be a decompression bomb")


def rows_from(flat: np.ndarray, h: int, stride: int, orientation: int) -> np.ndarray:
    """The raw decoder's rows: [h, stride] with the stored first row at the
    bottom when `orientation` is negative."""
    rows = flat[:h * stride].reshape(h, stride)
    return rows[::-1] if orientation < 0 else rows


def bits(rows: np.ndarray, w: int, lsb: bool = False) -> np.ndarray:
    """[h, stride] bytes -> [h, w] bits (MSB first, or LSB first)."""
    return np.unpackbits(rows, axis=1, bitorder="little" if lsb else "big")[:, :w]


def unpack(rows: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """Pillow's unpacker for `rawmode`: [h, stride] uint8 -> pixels."""
    h = rows.shape[0]
    if rawmode in ("1", "1;I", "1;R"):
        b = bits(rows, w, lsb=rawmode == "1;R")
        return bilevel(b == (0 if rawmode == "1;I" else 1))
    if rawmode in ("P;1", "P;2", "P;4", "L;4"):
        depth = int(rawmode[-1])
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        v = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
        return v * np.uint8(17) if rawmode == "L;4" else v
    if rawmode in ("P;2L", "P;4L"):                  # bit planes, each (w + 7) // 8 bytes
        planes, s = int(rawmode[2]), (w + 7) // 8
        out = np.zeros((h, w), np.uint8)
        for p in range(planes):
            out |= (bits(rows[:, p * s:(p + 1) * s], w) << p).astype(np.uint8)
        return out
    if rawmode == "RGB;L":                           # three planes of w bytes
        return np.stack([rows[:, c * w:(c + 1) * w] for c in range(3)], -1)
    if rawmode in ("BGR;15", "BGR;16", "BGRA;15Z"):  # 16-bit little-endian pixels
        v = rows[:, :2 * w].astype(np.uint32)
        v = v[:, 0::2] | (v[:, 1::2] << 8)
        green = (v >> 5) & 63 if rawmode == "BGR;16" else (v >> 5) & 31
        chans = [((v >> (11 if rawmode == "BGR;16" else 10)) & 31) * 255 // 31,
                 green * 255 // (63 if rawmode == "BGR;16" else 31), (v & 31) * 255 // 31]
        if rawmode == "BGRA;15Z":                    # the top bit set: transparent
            chans.append(np.where(v & 0x8000, 0, 255))
        return np.stack(chans, -1).astype(np.uint8)
    if rawmode.endswith(";16B"):                     # the high byte of each sample
        n = 1 if rawmode.startswith("L") else len(rawmode) - 4
        px = rows[:, :2 * n * w:2].reshape(h, w, n)
        return px[..., 0] if n == 1 else px
    n = len(rawmode)                                 # one byte per channel: L, BGR, RGBX, ...
    px = rows[:, :n * w].reshape(h, w, n)
    if n == 1:
        return np.ascontiguousarray(px[..., 0])
    want = "RGBA" if "A" in rawmode else ("CMYK" if "K" in rawmode else "RGB")
    if rawmode == "LA":
        want = "LA"
    return np.ascontiguousarray(np.stack([px[..., rawmode.index(c)] for c in want], -1))


def palette(entries: np.ndarray) -> np.ndarray:
    """[n, 3+] palette entries -> the [256, 3] palette `putpalette` holds:
    the first 256 of them, black after them (indices past a short palette
    convert to black)."""
    pal = np.zeros((256, 3), np.uint8)
    m = min(len(entries), 256)
    pal[:m] = entries[:m, :3]
    return pal


def planar_palette(raw: bytes) -> np.ndarray:
    """An "RGB;L" palette (every red, then every green, then every blue)."""
    n = len(raw) // 3
    return palette(np.frombuffer(raw[:3 * n], np.uint8).reshape(3, n).T)


def cmyk_rgb(px: np.ndarray) -> np.ndarray:
    """Convert.c cmyk2rgb: nk − MULDIV255(c, nk) per channel, nk = 255 − K."""
    nk = 255 - px[..., 3:].astype(np.int32)
    t = px[..., :3].astype(np.int32) * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
