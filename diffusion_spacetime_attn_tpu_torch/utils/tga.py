"""Targa as Pillow 12.1's `TgaImagePlugin` reads it, in numpy (the RLE loop
in `native/lzw.cpp`).

`decode_tga(data)` gives `(pixels, mode, palette)` as
`np.asarray(Image.open(f))`:

* image types 1 / 9 (colour-mapped), 2 / 10 (true colour) and 3 / 11
  (grey), uncompressed and RLE (a run may not cross a row's end, a literal
  packet may);
* grey at 8 bits ("L"), 16 bits ("LA") and 1 bit ("1", uncompressed
  only); true colour at 16 bits (5-5-5 + an alpha bit that is 0 where
  opaque, Pillow's "BGRA;15Z": "RGBA"), 24 ("RGB") and 32 ("RGBA");
  colour-mapped 8-bit indices ("P") over a map of 16- or 24-bit entries
  that starts at the header's first index (the entries before it black);
* the origin bits: rows bottom-up unless bit 5 is set, mirrored when bit
  4 is set.

TGA has no magic number: a file is Targa where the header's checks pass,
as Pillow decides it.  What Pillow identifies but cannot decode (a 15-bit
colour map falls through; a 32-bit map, a map in a grey or true-colour
file, other depths for a type, a colour-mapped type without a map, a 1-bit
RLE image) raises `ValueError`.
"""
from __future__ import annotations

import numpy as np

from .lzw import rle_rows
from .raster import NotThisFormat, palette, rows_from, sized, unpack

RAWMODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA", (2, 16): "BGRA;15Z",
            (2, 24): "BGR", (2, 32): "BGRA"}
_MAPS = {16: "BGRA;15Z", 24: "BGR", 32: "BGRA"}


def decode_tga(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, palette) of a Targa file as Pillow opens it."""
    if len(data) < 18:
        raise NotThisFormat("not a TGA file")
    id_len, maptype, imagetype = data[0], data[1], data[2]
    depth, flags = data[16], data[17]
    w, h = int.from_bytes(data[12:14], "little"), int.from_bytes(data[14:16], "little")
    if maptype not in (0, 1) or w <= 0 or h <= 0 or depth not in (1, 8, 16, 24, 32):
        raise NotThisFormat("not a TGA file")
    if imagetype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif imagetype in (1, 9):
        mode = "P" if maptype else "L"
    elif imagetype in (2, 10):
        mode = "RGB" if depth == 24 else "RGBA"
    else:
        raise NotThisFormat("unknown TGA mode")
    orientation = 1 if flags & 0x20 else -1
    at = 18 + id_len
    pal, refuse = None, ""
    if maptype:
        start, size, mapdepth = (int.from_bytes(data[3:5], "little"),
                                 int.from_bytes(data[5:7], "little"), data[7])
        if mapdepth not in _MAPS:
            raise NotThisFormat("unknown TGA map depth")
        if mode != "P":
            refuse = f"a colour map in a Targa of mode {mode} (Pillow: unrecognized image mode)"
        elif mapdepth == 32:
            refuse = "a 32-bit Targa colour map (Pillow: unrecognized raw mode)"
        width = mapdepth // 8
        raw = bytes(width * start) + data[at:at + width * size]
        at += width * size
        n = len(raw) // width
        pal = palette(unpack(np.frombuffer(raw[:n * width], np.uint8)[None], _MAPS[mapdepth],
                             n)[0])
    sized(w, h, mode)
    if refuse:
        raise ValueError(f"{name}: {refuse}")
    rawmode = RAWMODES.get((imagetype & 7, depth))
    if rawmode is None:
        raise ValueError(f"{name}: cannot load this image (Targa type {imagetype} at "
                         f"{depth} bits, which Pillow does not decode)")
    if mode == "L" and rawmode == "P":
        raise ValueError(f"{name}: a colour-mapped Targa without a colour map (Pillow: unknown "
                         "raw mode)")
    stride = (w * depth + 7) // 8
    if imagetype & 8:
        if depth < 8:
            raise ValueError(f"{name}: a 1-bit Targa RLE image, which Pillow never completes "
                             "(image file is truncated)")
        flat = rle_rows("tga_rle", data[at:], stride * h, depth // 8, stride, h, name=name)
    else:
        if len(data) - at < stride * h:
            raise ValueError(f"{name}: image file is truncated (Targa data ends early)")
        flat = np.frombuffer(data, np.uint8, stride * h, at)
    px = unpack(rows_from(flat, h, stride, orientation), rawmode, w)
    if flags & 0x10:
        px = px[:, ::-1]
    return np.ascontiguousarray(px), mode, pal
