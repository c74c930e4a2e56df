"""BMP as Pillow 12.1's `BmpImagePlugin` reads it, in numpy.

`decode_bmp(data)` gives `(pixels, mode, palette)`: `pixels` equals
`np.asarray(Image.open(f))` (bool [H, W] for mode "1", uint8 [H, W] for
"L" and "P", [H, W, 3] for "RGB", [H, W, 4] for "RGBA"), `mode` is
`Image.open(f).mode` and `palette` the "P" image's palette as uint8
[256, 3] (None for the other modes).  It reads

* the core (OS/2 1.x, 12 bytes), INFO (40), V2-V3 (52, 56), OS/2 2.x (64),
  V4 (108) and V5 (124) headers, top-down rows (a negative height) and
  bottom-up ones;
* 1-, 4- and 8-bit palettes (BGR for the core header, BGRX otherwise); a
  palette of greys 0, 1, ... (or black and white for two colours) makes
  the image "L" (or "1"), as Pillow drops such a palette;
* 16-bit (5-5-5, or 5-6-5 with `BI_BITFIELDS`), 24- and 32-bit pixels, and
  the 32-bit bitfield layouts Pillow knows (byte-aligned masks, with or
  without alpha);
* RLE8 and RLE4 with Pillow's own decoder's rules: runs cut at the row's
  end, end of line, end of bitmap, the delta escape (whose offsets it
  reads from the two bytes after the escape's own two), absolute runs
  padded to a 16-bit boundary of the file, RLE4's absolute run taking
  count // 2 bytes.

Where Pillow refuses a file (an unknown header, depth, compression or
bitfield layout, a palette of more than 65,536 colours, missing pixel data)
this raises `ValueError`.  Indices past a palette shorter than 256 entries
convert to black, as in Pillow.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from .raster import NotThisFormat, sized, unpack

_MASK_MODES = {                      # Pillow's 32-, 24- and 16-bit bitfield layouts
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}
_HEADERS = (12, 40, 52, 56, 64, 108, 124)


def _fail(name: str, why: str):
    raise ValueError(f"{name}: {why}")


def _u16(b, at):
    return struct.unpack_from("<H", b, at)[0]


def _u32(b, at):
    return struct.unpack_from("<I", b, at)[0]


def _rle(data: bytes, pos: int, w: int, h: int, rle4: bool, name: str) -> np.ndarray:
    """BmpRleDecoder.decode: the indices in file row order."""
    out = bytearray()
    x, need, n = 0, w * h, len(data)
    while len(out) < need:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            count = min(count, max(0, w - x)) if x + count > w else count
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                     # end of line
            out += b"\x00" * (-len(out) % w)
            x = 0
        elif byte == 1:                     # end of bitmap
            break
        elif byte == 2:                     # delta: Pillow reads two bytes, then two more
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                _fail(name, "truncated RLE delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += b"\x00" * (right + up * w)
            x = len(out) % w
        else:                               # absolute run
            nbytes = byte // 2 if rle4 else byte
            run = data[pos:pos + nbytes]
            pos += len(run)
            if rle4:
                for v in run:
                    out += bytes([v >> 4, v & 15])
            else:
                out += run
            if len(run) < nbytes:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < need:
        _fail(name, "not enough image data (RLE stream ends early)")
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w)


def decode_bmp(data: bytes, name: str = "<bytes>") -> Tuple[np.ndarray, str,
                                                            Optional[np.ndarray]]:
    """(pixels, mode, palette) of a BMP file, as Pillow opens it."""
    if len(data) < 18 or data[:2] != b"BM":
        _fail(name, "not a BMP file")
    return decode_dib(data, name, 14, _u32(data, 10))


def accept_dib(prefix: bytes) -> bool:
    """Pillow's "DIB" format: a bitmap without the file header."""
    return len(prefix) >= 4 and _u32(prefix, 0) in _HEADERS


def decode_dib(data: bytes, name: str = "<bytes>", at: int = 0, offset: int = 0,
               cursor: bool = False, half: str = "", with_offset: bool = False) -> Tuple:
    """`BmpImageFile._bitmap`: the bitmap whose header starts at `at`, its
    pixels at `offset` (0: right after the header, masks and palette, as a
    header-less DIB and an icon's entries store them).  `cursor`: Pillow's
    32-bit cursor case (the header at byte 22), read with alpha; `half`
    ("cur" or "ico") reads the lower half of the stored height, the colour
    bitmap of a cursor or an icon (its mask stored above it), with the size
    checks of `CurImageFile` or of `IcoFile.frame`.  `with_offset` adds
    the pixel data's offset to the result."""
    n = len(data)
    if at + 4 > n:
        raise NotThisFormat("truncated bitmap header size")
    hsize = _u32(data, at)
    if at + hsize > n:
        _fail(name, "truncated BMP header")
    if hsize not in _HEADERS:
        _fail(name, f"unsupported BMP header type ({hsize})")
    h = data[at + 4:at + hsize]
    pos = at + hsize
    direction = -1
    if hsize == 12:
        w, ht, bits = _u16(h, 0), _u16(h, 2), _u16(h, 6)
        comp, colors, pad = 0, 0, 3
    else:
        flip = h[7] == 0xFF
        direction = 1 if flip else -1
        w = _u32(h, 0)
        ht = (2 ** 32 - _u32(h, 4)) if flip else _u32(h, 4)
        bits, comp, colors, pad = _u16(h, 10), _u32(h, 12), _u32(h, 28), 4
        if comp == 3:
            if len(h) >= 48:
                masks = [_u32(h, 36 + 4 * i) for i in range(4 if len(h) >= 52 else 3)]
                if len(masks) == 3:
                    masks.append(0)
            else:
                if pos + 12 > n:
                    raise NotThisFormat("truncated BMP bitfields")
                masks = [_u32(data, pos + 4 * i) for i in range(3)] + [0]
                pos += 12
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _RAW:
        _fail(name, f"unsupported BMP pixel depth ({bits})")
    mode = "P" if bits <= 8 else "RGB"
    rawmode = _RAW[bits]
    rle = False
    if comp == 3:
        key = (bits, tuple(masks)) if bits == 32 else (bits, tuple(masks[:3]))
        if key not in _MASK_MODES:
            _fail(name, "unsupported BMP bitfields layout")
        rawmode = _MASK_MODES[key]
        if bits == 32 and "A" in rawmode:
            mode = "RGBA"
    elif comp == 0:
        if bits == 32 and cursor:
            rawmode, mode = "BGRA", "RGBA"
    elif comp in (1, 2):
        rle = True
    else:
        _fail(name, f"unsupported BMP compression ({comp})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            _fail(name, f"unsupported BMP palette size ({colors})")
        raw_pal = data[pos:pos + pad * colors]
        pos += len(raw_pal)
        ents = [raw_pal[i * pad:i * pad + 3] for i in range(len(raw_pal) // pad)]
        greys = (0, 255) if colors == 2 else range(colors)
        if all(i < len(ents) and ents[i] == bytes([v]) * 3 for i, v in enumerate(greys)):
            mode = "1" if colors == 2 else "L"
            rawmode = mode
        else:
            palette = np.zeros((256, 3), np.uint8)   # indices past the palette: black
            m = min(len(ents), 256)
            if m:
                bgr = np.frombuffer(b"".join(ents[:m]), np.uint8).reshape(m, 3)
                palette[:m] = bgr[:, ::-1]
    if half == "cur":
        ht //= 2
    sized(w, ht)
    if half == "ico":
        ht //= 2
        if ht == 0:
            _fail(name, "an icon bitmap of one row (no colour rows)")
    offset = offset or pos
    if rle:
        if mode == "1" or (mode == "L" and bits != 8):
            _fail(name, "RLE data in a two-colour or short grey BMP is not read")
        px = _rle(data, offset, w, ht, comp == 2, name)
    else:
        if mode in ("1", "L") and bits not in (1, 8):
            _fail(name, f"a {bits}-bit grey BMP is not read")
        stride = ((w * bits + 31) >> 3) & ~3
        if offset + stride * ht > n:
            _fail(name, "image file is truncated (BMP pixel data ends early)")
        raw = np.frombuffer(data, np.uint8, stride * ht, offset).reshape(ht, stride)
        px = unpack(raw, rawmode, w)
    if direction == -1:
        px = px[::-1]
    if with_offset:
        return np.ascontiguousarray(px), mode, palette, offset
    return np.ascontiguousarray(px), mode, palette
