"""Blizzard's BLP textures as Pillow 12.1's `BlpImagePlugin` reads them: the
header and palettes in numpy, JPEG mips through `utils/jpeg.py`, DXT mips
through `native/bcn.cpp` (`utils/bcn.py`).

`decode_blp(data)` gives `(pixels, mode, None)` as
`np.asarray(Image.open(f))` of mip 0: "RGBA" where the header's alpha
field is non-zero, else "RGB".

* BLP1 JPEG (compression 0): the shared JPEG header joined to mip 0,
  checked as Pillow's JPEG reader checks it (`jpeg.pillow_header`), read as
  Pillow reads any JPEG (a four-channel stream as Adobe CMYK, inverted),
  converted to RGB and taken as BGR;
* BLP1 palette (compression 1, encodings 4 and 5) and BLP2 palette
  (encoding 1): 8-bit indices into a 256-entry BGRA palette;
* where mip 0 starts: BLP2 at the header's offset; BLP1 palette right
  after the palette, and BLP1 JPEG right after the JPEG header or at the
  header's offset if that lies further on, as Pillow reads them (Pillow's
  own BLP1 writer stores an offset 8 bytes short);
* BLP2 DXT (encoding 2) with alpha encoding 0, 1 or 7: DXT1, DXT3 or DXT5
  as Pillow's Python decoders give them (`bcn.decode(..., blp=True)`).

Where Pillow reads a file other than the format says, the port raises
naming ROADMAP A.12: a palette file with alpha (Pillow takes alpha from the
palette's fourth byte and reads the alpha plane after the indices as
more indices), a BLP1 JPEG with alpha whose stream has four channels
(the BGRA stream read as CMYK: alpha lost, colours multiplied by it), or
without alpha but with a fourth channel below 255 (colours multiplied by
it), a JPEG of another size than the header's (Pillow reads its rows at
the header's width), a DXT mip of a width that is not a multiple of 4
(Pillow's rows are 4·⌈w/4⌉ pixels long, read at a stride of w) or a DXT3
/ DXT5 mip without alpha (its RGBA pixels read as RGB).  What Pillow
refuses (another compression or encoding, data cut short) raises
`ValueError` naming BLP.
"""
from __future__ import annotations

import numpy as np

from . import bcn
from .jpeg import decode_jpeg, pillow_header
from .png import to_rgb
from .raster import NotThisFormat, cmyk_rgb, sized, unpack_from

MISREADS = "Pillow misreads it (ROADMAP A.12)"
DXT = {0: 1, 1: 2, 7: 3}          # BLP2 alpha encoding -> BCn


def _truncated(name: str) -> ValueError:
    return ValueError(f"{name}: BLP file is truncated (Pillow: Truncated File Read)")


def _indexed(data: bytes, pal_at: int, at: int, length: int, w: int, h: int, mode: str,
             name: str) -> np.ndarray:
    """`_read_bgra`: `length` indices from `at` into the BGRA palette at
    `pal_at`, the first w·h of them as pixels."""
    if len(data) < pal_at + 1024 or len(data) < at + length:
        raise _truncated(name)
    bgra = np.frombuffer(data, np.uint8, 1024, pal_at).reshape(256, 4)
    if length < w * h:
        raise ValueError(f"{name}: BLP mip 0 holds {length} of {w * h} pixels (Pillow: not "
                         "enough image data)")
    idx = np.frombuffer(data, np.uint8, w * h, at)
    return bgra[idx][:, [2, 1, 0, 3][:len(mode)]].reshape(h, w, len(mode))


def _jpeg(data: bytes, offset: int, length: int, w: int, h: int, alpha: bool, name: str):
    at = 160
    if len(data) < at:
        raise _truncated(name)
    size = int.from_bytes(data[156:160], "little")
    header = data[at:at + size]
    at += size
    if len(header) < size or len(data) < max(at, offset) + length:
        raise _truncated(name)
    at = max(at, offset)                       # Pillow skips forward to mip 0 only
    jpeg = header + data[at:at + length]
    try:
        pillow_header(jpeg, name)
    except NotThisFormat as e:
        raise ValueError(f"{name}: BLP1 JPEG that Pillow's JPEG reader refuses: {e}") from e
    img = decode_jpeg(jpeg, name)
    sized(img.shape[1], img.shape[0])
    if img.ndim == 3 and img.shape[2] == 4:
        if alpha:
            raise ValueError(f"{name}: BLP1 JPEG with alpha: its BGRA stream is read as CMYK "
                             "and the alpha lost; " + MISREADS)
        if img[..., 3].any():
            raise ValueError(f"{name}: BLP1 JPEG whose fourth channel is not 255: the colours "
                             "are multiplied by it; " + MISREADS)
        rgb = cmyk_rgb(img)
    else:
        rgb = to_rgb(img[..., None] if img.ndim == 2 else img)
    if img.shape[:2] != (h, w):
        if img.shape[0] * img.shape[1] < w * h:
            raise ValueError(f"{name}: BLP1 JPEG of {img.shape[1]}x{img.shape[0]} for a "
                             f"{w}x{h} image (Pillow: not enough image data)")
        raise ValueError(f"{name}: BLP1 JPEG of {img.shape[1]}x{img.shape[0]} for a {w}x{h} "
                         "image: " + MISREADS)
    bgr = rgb[..., ::-1]
    if alpha:
        bgr = np.concatenate([bgr, np.full((h, w, 1), 255, np.uint8)], -1)
    return np.ascontiguousarray(bgr)


def decode_blp(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, None) of a BLP1 or BLP2 file as Pillow opens it."""
    version = data[:4]
    (compression,) = unpack_from("<i", data, 4)
    if version == b"BLP1":
        alpha = unpack_from("<I", data, 8)[0] != 0
        w, h = unpack_from("<II", data, 12)
        (encoding,) = unpack_from("<i", data, 20)
    else:
        encoding, alpha, alpha_encoding = unpack_from("<bbb", data, 8)
        alpha = alpha != 0
        w, h = unpack_from("<II", data, 12)
    mode = "RGBA" if alpha else "RGB"
    sized(w, h, mode)
    start = 28 if version == b"BLP1" else 20
    if len(data) < start + 128:
        raise _truncated(name)
    offset = int.from_bytes(data[start:start + 4], "little")
    length = int.from_bytes(data[start + 64:start + 68], "little")
    if version == b"BLP1":
        if compression == 0:
            return _jpeg(data, offset, length, w, h, alpha, name), mode, None
        if compression != 1 or encoding not in (4, 5):
            raise ValueError(f"{name}: BLP1 of compression {compression}, encoding {encoding}, "
                             "which Pillow 12.1 does not read")
        if alpha and len(data) >= 1180 + length >= 1180 + w * h:
            raise ValueError(f"{name}: BLP1 palette image with alpha: " + MISREADS)
        # Pillow reads mip 0 right after the palette, wherever the header puts it
        return _indexed(data, 156, 1180, length, w, h, mode, name), mode, None
    if len(data) < 148 + 1024:
        raise _truncated(name)
    if compression != 1 or encoding not in (1, 2) or (encoding == 2 and
                                                      alpha_encoding not in DXT):
        raise ValueError(f"{name}: BLP2 of compression {compression}, encoding {encoding}, "
                         f"alpha encoding {alpha_encoding}, which Pillow 12.1 does not read")
    if encoding == 1:
        if alpha and len(data) >= offset + length >= offset + w * h:
            raise ValueError(f"{name}: BLP2 palette image with alpha: " + MISREADS)
        return _indexed(data, 148, offset, length, w, h, mode, name), mode, None
    n = DXT[alpha_encoding]
    need = offset + ((w + 3) // 4) * ((h + 3) // 4) * bcn.block_bytes(n)
    if len(data) < need:
        raise _truncated(name)
    if w % 4 or (n > 1 and not alpha):
        raise ValueError(f"{name}: BLP2 DXT{2 * n - 1} mip of width {w}"
                         f"{'' if alpha else ' without alpha'}: " + MISREADS)
    return bcn.decode(data[offset:need], n, w, h, blp=True, alpha=alpha, name=name), mode, None
