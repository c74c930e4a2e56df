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
this raises `ValueError`.  A palette shorter than 256 entries is padded
with Pillow's greyscale ramp.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

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
MAX_PIXELS = 2 * 89478485            # Pillow's decompression-bomb error


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


def _unpack(raw: np.ndarray, rawmode: str, w: int) -> np.ndarray:
    """Pillow's unpacker for one of the raw modes, rows [h, stride] -> pixels."""
    if rawmode in ("P;1", "1"):
        bits = np.unpackbits(raw, axis=1)[:, :w]
        return bits.astype(bool) if rawmode == "1" else bits
    if rawmode == "P;4":
        nib = np.stack([raw >> 4, raw & 15], -1).reshape(raw.shape[0], -1)
        return nib[:, :w]
    if rawmode in ("P", "L"):
        return raw[:, :w]
    if rawmode in ("BGR;15", "BGR;16"):
        px = raw[:, :2 * w].astype(np.uint32)
        v = px[:, 0::2] | (px[:, 1::2] << 8)
        if rawmode == "BGR;15":
            chans = ((v >> 10) & 31, (v >> 5) & 31, v & 31)
            scale = (31, 31, 31)
        else:
            chans = ((v >> 11) & 31, (v >> 5) & 63, v & 31)
            scale = (31, 63, 31)
        return np.stack([c * 255 // s for c, s in zip(chans, scale)], -1).astype(np.uint8)
    n = len(rawmode)                        # byte-per-channel layouts: BGR, BGRX, ABGR, ...
    px = raw[:, :n * w].reshape(raw.shape[0], w, n)
    want = "RGBA" if "A" in rawmode else "RGB"
    return np.ascontiguousarray(np.stack([px[..., rawmode.index(c)] for c in want], -1))


def decode_bmp(data: bytes, name: str = "<bytes>") -> Tuple[np.ndarray, str,
                                                            Optional[np.ndarray]]:
    """(pixels, mode, palette) of a BMP file, as Pillow opens it."""
    n = len(data)
    if n < 18 or data[:2] != b"BM":
        _fail(name, "not a BMP file")
    offset, hsize = _u32(data, 10), _u32(data, 14)
    if hsize not in _HEADERS:
        _fail(name, f"unsupported BMP header type ({hsize})")
    if 14 + hsize > n:
        _fail(name, "truncated BMP header")
    h = data[18:14 + hsize]
    pos = 14 + hsize
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
                    _fail(name, "truncated BMP bitfields")
                masks = [_u32(data, pos + 4 * i) for i in range(3)] + [0]
                pos += 12
    if w <= 0 or ht <= 0 or w * ht > MAX_PIXELS:
        _fail(name, f"BMP of size {w}x{ht}")
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
    elif comp in (1, 2):
        rle = True
    elif comp != 0:
        _fail(name, f"unsupported BMP compression ({comp})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            _fail(name, f"unsupported BMP palette size ({colors})")
        raw_pal = data[pos:pos + pad * colors]
        ents = [raw_pal[i * pad:i * pad + 3] for i in range(len(raw_pal) // pad)]
        greys = (0, 255) if colors == 2 else range(colors)
        if all(i < len(ents) and ents[i] == bytes([v]) * 3 for i, v in enumerate(greys)):
            mode = "1" if colors == 2 else "L"
            rawmode = mode
        else:
            palette = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)  # Pillow's ramp
            m = min(len(ents), 256)
            if m:
                bgr = np.frombuffer(b"".join(ents[:m]), np.uint8).reshape(m, 3)
                palette[:m] = bgr[:, ::-1]
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
        px = _unpack(raw, rawmode, w)
    if direction == -1:
        px = px[::-1]
    return np.ascontiguousarray(px), mode, palette
