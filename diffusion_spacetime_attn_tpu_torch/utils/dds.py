"""DirectDraw Surface (DDS) as Pillow 12.1's `DdsImagePlugin` reads it: the
header in Python, block-compressed data through `native/bcn.cpp`
(`utils/bcn.py`).

`decode_dds(data)` gives `(pixels, mode, palette)` as
`np.asarray(Image.open(f))`, of the top mip level of the first surface:

* `DDPF_RGB` with three masks ("RGB") or, with `DDPF_ALPHAPIXELS`, four
  ("RGBA"), at any bit count: each pixel the little-endian value of
  bitcount // 8 bytes (bytes past the file's end read as 0, as Pillow's
  decoder reads them), each channel (value & mask) >> (the mask's trailing
  zeros) scaled as Pillow scales it, int(v / (mask >> zeros) * 255) in
  double precision (a 5-6-5 red of 16 gives 131);
* `DDPF_LUMINANCE`: 8 bits "L", 16 bits with alpha "LA";
* `DDPF_PALETTEINDEXED8`: a 1024-byte RGBA palette, then 8-bit indices
  ("P"; the palette's alpha is not in `palette`, which `convert` reads as
  Pillow's conversion does);
* FOURCC DXT1, DXT3, DXT5 (BC1-BC3, "RGBA"), BC4U / ATI1 (BC4, "L"), BC5U
  / ATI2 and BC5S (BC5, "RGB"), and DX10 with the DXGI formats of Pillow's
  list: BC1, BC2, BC3 TYPELESS / UNORM, BC4 TYPELESS / UNORM, BC5
  TYPELESS / UNORM / SNORM, BC6H UF16 / SF16, BC7 TYPELESS / UNORM /
  UNORM_SRGB, R8G8B8A8 TYPELESS / UNORM / UNORM_SRGB (raw "RGBA").  The sRGB
  formats are not converted (Pillow only notes their gamma).

Pillow seeks nowhere before the pixels: they start where the header (and
the palette or DX10 header) ends.  What Pillow refuses (another header
size, a header cut short, another FOURCC or DXGI format, BC1_UNORM_SRGB
among them, luminance of other bit counts, pixel data cut short) raises
`ValueError` naming DDS; a DX10 header cut before its format passes the
file on, as Pillow's `struct.error` does.  A signed BC6H block that Pillow
reads against the specification raises naming ROADMAP A.12
(`utils/bcn.py`).
"""
from __future__ import annotations

import numpy as np

from . import bcn
from .raster import NotThisFormat, palette, sized

RGB, LUMINANCE, PALETTE, FOURCC, ALPHAPIXELS = 0x40, 0x20000, 0x20, 0x4, 0x1
# FOURCC -> (BCn, Pillow's pixel format, mode)
FOURCCS = {b"DXT1": (1, "DXT1", "RGBA"), b"DXT3": (2, "DXT3", "RGBA"),
           b"DXT5": (3, "DXT5", "RGBA"), b"BC4U": (4, "BC4", "L"), b"ATI1": (4, "BC4", "L"),
           b"BC5S": (5, "BC5S", "RGB"), b"BC5U": (5, "BC5", "RGB"), b"ATI2": (5, "BC5", "RGB")}
# DXGI format -> (BCn or None for raw RGBA, pixel format, mode)
DXGI = {70: (1, "BC1", "RGBA"), 71: (1, "BC1", "RGBA"), 73: (2, "BC2", "RGBA"),
        74: (2, "BC2", "RGBA"), 76: (3, "BC3", "RGBA"), 77: (3, "BC3", "RGBA"),
        79: (4, "BC4", "L"), 80: (4, "BC4", "L"), 82: (5, "BC5", "RGB"), 83: (5, "BC5", "RGB"),
        84: (5, "BC5S", "RGB"), 95: (6, "BC6H", "RGB"), 96: (6, "BC6HS", "RGB"),
        97: (7, "BC7", "RGBA"), 98: (7, "BC7", "RGBA"), 99: (7, "BC7", "RGBA"),
        27: (None, "", "RGBA"), 28: (None, "", "RGBA"), 29: (None, "", "RGBA")}


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"DDS "


def _u32(b: bytes, at: int) -> int:
    return int.from_bytes(b[at:at + 4], "little")


def _masked(data: bytes, at: int, w: int, h: int, bitcount: int, masks) -> np.ndarray:
    """`DdsRgbDecoder`: bitcount // 8 bytes a pixel from `at`, each mask's
    bits scaled to 8; pixels past the file's end read as 0."""
    step, n = bitcount // 8, w * h
    src = np.frombuffer(data, np.uint8)
    k = min(n, -(-(len(src) - at) // step)) if step and len(src) > at else 0
    pos = at + np.arange(k, dtype=np.int64)[:, None] * step + np.arange(min(step, 4))
    ok = pos < len(src)
    byte = np.where(ok, src[np.where(ok, pos, 0)], 0).astype(np.uint64)
    value = (byte << (np.arange(byte.shape[1], dtype=np.uint64) * 8)).sum(1, dtype=np.uint64)
    out = np.zeros((n, len(masks)), np.uint8)
    for c, mask in enumerate(masks):
        if mask:
            shift = (mask & -mask).bit_length() - 1
            total = mask >> shift
            v = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(np.float64)
            out[:k, c] = (v / total * 255).astype(np.uint8)
    return out.reshape(h, w, len(masks))


def _raw(data: bytes, at: int, w: int, h: int, c: int, name: str) -> np.ndarray:
    if len(data) - at < w * h * c:
        raise ValueError(f"{name}: image file is truncated (DDS pixel data ends early)")
    px = np.frombuffer(data, np.uint8, w * h * c, at)
    return px.reshape((h, w) if c == 1 else (h, w, c)).copy()


def decode_dds(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, palette) of a DDS file as Pillow opens it."""
    if len(data) < 8:
        raise NotThisFormat("not a DDS file")
    if _u32(data, 4) != 124:
        raise ValueError(f"{name}: DDS header of {_u32(data, 4)} bytes (Pillow 12.1 reads 124 "
                         "only)")
    if len(data) < 128:
        raise ValueError(f"{name}: DDS header cut short ({len(data) - 8} of 120 bytes)")
    height, width = _u32(data, 12), _u32(data, 16)
    pfflags, fourcc, bitcount = _u32(data, 80), data[84:88], _u32(data, 88)
    at, pal, pixel_format = 128, None, ""
    if pfflags & RGB:
        mode = "RGBA" if pfflags & ALPHAPIXELS else "RGB"
        masks = [_u32(data, 92 + 4 * k) for k in range(len(mode))]
        sized(width, height, mode)
        return _masked(data, at, width, height, bitcount, masks), mode, None
    if pfflags & LUMINANCE:
        if bitcount == 8:
            mode = "L"
        elif bitcount == 16 and pfflags & ALPHAPIXELS:
            mode = "LA"
        else:
            raise ValueError(f"{name}: DDS luminance of {bitcount} bits, which Pillow 12.1 does "
                             "not read")
        n = None
    elif pfflags & PALETTE:
        mode, n = "P", None
        raw = data[at:at + 1024]
        pal = palette(np.frombuffer(raw[:len(raw) // 4 * 4], np.uint8).reshape(-1, 4))
        at += len(raw)
    elif pfflags & FOURCC:
        if fourcc == b"DX10":
            if len(data) < 132:
                raise NotThisFormat("DDS: DX10 header cut short")
            fmt = _u32(data, 128)
            if fmt not in DXGI:
                raise ValueError(f"{name}: DDS of DXGI format {fmt}, which Pillow 12.1 does not "
                                 "read")
            n, pixel_format, mode = DXGI[fmt]
            at = min(148, len(data))
        elif fourcc in FOURCCS:
            n, pixel_format, mode = FOURCCS[fourcc]
        else:
            raise ValueError(f"{name}: DDS of pixel format {fourcc!r}, which Pillow 12.1 does "
                             "not read")
    else:
        raise ValueError(f"{name}: DDS of pixel format flags {pfflags:#x}, which Pillow 12.1 "
                         "does not read")
    sized(width, height, mode)
    if n is None:
        return _raw(data, at, width, height, len(mode), name), mode, pal
    return bcn.decode(data[at:], n, width, height, pixel_format, name=f"{name} (DDS)"), mode, None
