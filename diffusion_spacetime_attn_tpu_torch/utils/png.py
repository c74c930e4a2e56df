"""8-bit PNG files without an imaging library (zlib and struct only).

`encode_png` gives the bytes of an RGB file with filter type 0 on every row
(the HTTP front sends them), and `write_png` writes them.  `decode_png`
reads what they wrote and the 8-bit grey, grey + alpha, RGB and RGBA files
other tools write (non-interlaced; every filter type 0-4 undone), so the
evaluation can read images it did not write; `read_png` does so from a
path.  `to_rgb` and `to_grey` convert as PIL's `convert("RGB")` and
`convert("L")` do (alpha dropped; ITU-R 601-2 luma in PIL's integer
arithmetic).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> channels (grey, RGB, grey+alpha, RGBA)


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> the bytes of an 8-bit RGB PNG."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(rgb, np.uint8))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """[H, W, 3] uint8 as an 8-bit RGB PNG file."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(ftype: int, line: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One scanline's bytes with its filter undone (PNG spec section 9)."""
    if ftype == 0:
        return line
    if ftype == 1:                                   # Sub: running sum per channel
        return np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ftype == 2:                                   # Up
        return line + prior
    if ftype not in (3, 4):
        raise ValueError(f"PNG filter type {ftype}")
    out = bytearray(line.tobytes())
    up = prior.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        if ftype == 3:                               # Average
            out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
        else:                                        # Paeth
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + _paeth(a, up[i], c)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path: str) -> np.ndarray:
    """`decode_png` of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An 8-bit grey, grey + alpha, RGB or RGBA PNG's bytes -> [H, W, 1, 2, 3
    or 4] uint8; raises for
    any other bit depth, colour type or interlacing (`name` names the source
    in the message)."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{name}: bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace}; only 8-bit non-interlaced grey / RGB (+ alpha) is read")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{name}: {raw.size} bytes of image data, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter(int(rows[y, 0]), rows[y, 1:], prior, bpp)
    return out.reshape(h, w, bpp)


def to_rgb(img: np.ndarray) -> np.ndarray:
    """[H, W, 1-4] uint8 (`decode_png`) -> [H, W, 3]: alpha dropped, grey
    repeated, as PIL's `convert("RGB")`."""
    c = img.shape[-1]
    if c in (1, 2):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def to_grey(img: np.ndarray) -> np.ndarray:
    """[H, W, 1-4] uint8 -> [H, W] uint8 luma, as PIL's `convert("L")`:
    (19595·R + 38470·G + 7471·B + 2¹⁵) >> 16."""
    if img.shape[-1] in (1, 2):
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000) >> 16
    return luma.astype(np.uint8)
