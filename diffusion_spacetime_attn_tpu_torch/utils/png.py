"""PNG files without an imaging library (zlib and struct only).

`encode_png` gives the bytes of an RGB file with filter type 0 on every row
(the HTTP front sends them), and `write_png` writes them.  `decode_picture`
reads every PNG Pillow 12.1 reads, as `Image.open` gives it: every bit
depth and colour type (grey at 1, 2, 4, 8 and 16 bits, palettes at 1, 2, 4
and 8 bits with PLTE, RGB, grey + alpha and RGBA at 8 and 16 bits), Adam7
interlacing, every filter type 0-4; it returns `(pixels, mode, palette)`
with `pixels` equal to `np.asarray(Image.open(f))` in Pillow's mode
(`_MODES`, Pillow's rawmodes: 2- and 4-bit grey scaled by 85 and 17,
16-bit colour cut to its high bytes, 16-bit grey kept as "I;16") and a
"P" file's palette as uint8 [256, 3].  Where Pillow refuses a file (a bad
signature, a bad checksum on a chunk before the image data, a short
header, an unknown filter, image data that ends early) it raises
`ValueError`.  `decode_png` gives the 8-bit grey, grey + alpha, RGB and
RGBA files as [H, W, 1-4] uint8 (what `read_png` reads from a path);
`to_rgb` and `to_grey` convert those as PIL's `convert("RGB")` and
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


# (bit depth, colour type) -> (Pillow's mode, samples per pixel)
_MODES = {(1, 0): "1", (2, 0): "L", (4, 0): "L", (8, 0): "L", (16, 0): "I;16",
          (8, 2): "RGB", (16, 2): "RGB",
          (1, 3): "P", (2, 3): "P", (4, 3): "P", (8, 3): "P",
          (8, 4): "LA", (16, 4): "RGBA", (8, 6): "RGBA", (16, 6): "RGBA"}
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
MAX_PIXELS = 2 * 89478485      # Pillow's decompression-bomb error (every reader here)
# Adam7: (x0, y0, dx, dy) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def bilevel(mask: np.ndarray) -> np.ndarray:
    """A mode "1" image's pixels as `np.asarray` gives them: bool, with
    Pillow's stored bytes (0 and 255) under it."""
    return np.where(mask, 255, 0).astype(np.uint8).view(np.bool_)


def read_png(path: str) -> np.ndarray:
    """`decode_png` of a file."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunks(data: bytes, name: str):
    """(header, palette bytes or None, the IDAT stream) of a PNG, checking
    the CRC of every chunk before the first IDAT as Pillow's `_open` does."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, idat, header, plte = 8, [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if n > 0x7FFFFFFF or pos + 12 + n > len(data):
            if tag == b"IDAT" or idat:       # Pillow reads the image data there is
                idat.append(data[pos + 8:pos + 8 + n] if tag == b"IDAT" else b"")
                break
            raise ValueError(f"{name}: truncated PNG file ({tag!r} chunk)")
        body = data[pos + 8:pos + 8 + n]
        if not idat and tag != b"IDAT":
            (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
            if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
                raise ValueError(f"{name}: broken PNG file (bad header checksum in {tag!r})")
        pos += 12 + n
        if tag == b"IHDR":
            if n < 13:
                raise ValueError(f"{name}: truncated IHDR chunk")
            header = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE":
            plte = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND" or idat:
            break                            # Pillow stops at the first chunk after IDAT
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    if not idat:
        raise ValueError(f"{name}: no image data (IDAT) in the PNG file")
    return header, plte, b"".join(idat)


def _unpack(rows: np.ndarray, w: int, depth: int, spp: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w * spp] (uint8 or, at 16
    bits, big-endian uint16)."""
    if depth == 16:
        return rows.view(">u2")[:, :w * spp].astype(np.uint16)
    if depth == 8:
        return rows[:, :w * spp]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    out = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return out.reshape(rows.shape[0], -1)[:, :w]


def _image_rows(raw: np.ndarray, w: int, h: int, depth: int, spp: int, name: str):
    """Undo the filters of one (sub)image of w x h pixels at the start of
    `raw` -> (samples [h, w * spp], bytes used)."""
    if w == 0 or h == 0:
        return np.zeros((h, w * spp), np.uint16 if depth == 16 else np.uint8), 0
    bpp = max(1, depth * spp // 8)
    stride = (w * spp * depth + 7) // 8
    need = h * (stride + 1)
    if raw.size < need:
        raise ValueError(f"{name}: image file is truncated ({raw.size} bytes of image data, "
                         f"{need} needed)")
    rows = raw[:need].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter(int(rows[y, 0]), rows[y, 1:], prior, bpp)
    return _unpack(out, w, depth, spp), need


def decode_picture(data: bytes, name: str = "<bytes>"):
    """A PNG's bytes -> (pixels, mode, palette) as Pillow 12.1 opens it."""
    header, plte, stream = _chunks(data, name)
    w, h, depth, ctype, _, filt, interlace = header
    if (depth, ctype) not in _MODES:
        raise ValueError(f"{name}: bit depth {depth} with colour type {ctype} is not a PNG "
                         "Pillow reads")
    if filt:
        raise ValueError(f"{name}: unknown filter category {filt}")
    if w == 0 or h == 0 or w * h > MAX_PIXELS:
        raise ValueError(f"{name}: PNG of {w}x{h} pixels")
    mode, spp = _MODES[(depth, ctype)], _SAMPLES[ctype]
    palette = None
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        palette = np.zeros((256, 3), np.uint8)
        n = min(len(plte) // 3, 256)
        palette[:n] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
    if interlace not in (0, 1):
        raise ValueError(f"{name}: unknown interlace method {interlace}")
    passes = [(x0, y0, dx, dy, max(0, -(-(w - x0) // dx)), max(0, -(-(h - y0) // dy)))
              for x0, y0, dx, dy in (_ADAM7 if interlace else ((0, 0, 1, 1),))]
    need = sum(ph * ((pw * spp * depth + 7) // 8 + 1) for *_, pw, ph in passes if pw)
    try:                                     # as Pillow, no more than the rows take
        raw = np.frombuffer(zlib.decompressobj().decompress(stream, need), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{name}: corrupt PNG image data ({e})") from e
    samples = np.zeros((h, w, spp), np.uint16 if depth == 16 else np.uint8)
    at = 0
    for x0, y0, dx, dy, pw, ph in passes:
        sub, used = _image_rows(raw[at:], pw, ph, depth, spp, name)
        at += used
        samples[y0::dy, x0::dx] = sub.reshape(ph, pw, spp)
    px = samples
    if mode == "1":
        return bilevel(px[..., 0]), mode, None
    if mode in ("L", "P", "I;16"):
        px = px[..., 0]
        if depth in (2, 4) and mode == "L":
            px = px * np.uint8(255 // ((1 << depth) - 1))      # Pillow's L;2 and L;4
        return np.ascontiguousarray(px), mode, palette
    if depth == 16:
        px = (px >> 8).astype(np.uint8)                        # the high byte of each sample
        if ctype == 4:                                         # LA;16B -> RGBA
            px = px[..., [0, 0, 0, 1]]
    return np.ascontiguousarray(px), mode, None


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An 8-bit grey, grey + alpha, RGB or RGBA PNG's bytes -> [H, W, 1, 2,
    3 or 4] uint8; raises for any other bit depth or colour type, which
    `decode_picture` (or `utils/image_io.read_image`) reads (`name` names
    the source in the message)."""
    header, _, _ = _chunks(data, name)
    depth, ctype = header[2], header[3]
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"{name}: bit depth {depth}, colour type {ctype}; decode_png gives "
                         "8-bit grey / RGB (+ alpha) samples, utils/image_io.read_image "
                         "reads every PNG")
    px, _, _ = decode_picture(data, name)
    return px.reshape(px.shape[0], px.shape[1], -1)


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
