"""Sun raster files as Pillow 12.1's `SunImagePlugin` reads them: the header
and raw rows in numpy, RLE (type 2) in `native/lzw.cpp` (`sun_rle_decode`).

`decode_sun(data)` gives `(pixels, mode, palette)` as
`np.asarray(Image.open(f))`: depth 1 as "1" (1 = black), 4 and 8 as "L",
or "P" over an RGB colour map (at most 1024 bytes, planar: the reds, then
the greens, then the blues), 24 and 32 as "RGB" (BGR order, or RGB for
type 3; the fourth byte of 32-bit pixels skipped).  Raw rows are padded to
16 bits (types 0, 1, 3, 4, 5).  RLE runs are `0x80 n v` (n + 1 copies of
v; `0x80 0x00` a literal 0x80); Pillow's decoder fills rows of the
unpadded width, so where the rows carry padding (an odd byte count per
row) Pillow misreads the stream, and the port raises naming ROADMAP A.12.
"""
from __future__ import annotations

import numpy as np

from .lzw import rle_rows
from .raster import NotThisFormat, planar_palette, sized, unpack, unpack_from

MAGIC = 0x59A66A95
_RAW = {1: ("1", "1;I"), 4: ("L", "L;4"), 8: ("L", "L")}


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 4 and int.from_bytes(prefix[:4], "big") == MAGIC


def decode_sun(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, palette) of a Sun raster file as Pillow opens it."""
    _, w, h, depth, _, ftype, maptype, maplen = unpack_from(">8I", data)
    if depth in _RAW:
        mode, rawmode = _RAW[depth]
    elif depth in (24, 32):
        mode = "RGB"
        rawmode = ("RGB" if ftype == 3 else "BGR") + ("X" if depth == 32 else "")
    else:
        raise NotThisFormat("unsupported Sun raster depth")
    at, pal = 32, None
    if maplen:
        if maplen > 1024:
            raise NotThisFormat("unsupported Sun raster colour map length")
        if maptype != 1:
            raise NotThisFormat("unsupported Sun raster colour map type")
        pal = planar_palette(data[at:at + maplen])
        at += maplen
        if mode == "L":
            mode, rawmode = "P", rawmode.replace("L", "P")
    if ftype not in (0, 1, 2, 3, 4, 5):
        raise NotThisFormat("unsupported Sun raster file type")
    sized(w, h, mode)
    if mode != "P":
        pal = None
    if ftype == 2:
        row = (w * depth + 7) // 8
        if row % 2:
            raise ValueError(f"{name}: an RLE Sun raster whose rows are padded to 16 bits, "
                             "which Pillow misreads (it decodes rows of the unpadded width; "
                             "ROADMAP A.12)")
        rows = rle_rows("sun_rle", data[at:], row * h, row, h, name=name).reshape(h, row)
    else:
        row = ((w * depth + 15) // 16) * 2
        if len(data) - at < row * h:
            raise ValueError(f"{name}: image file is truncated (Sun raster data ends early)")
        rows = np.frombuffer(data, np.uint8, row * h, at).reshape(h, row)
    return np.ascontiguousarray(unpack(rows, rawmode, w)), mode, pal
