"""TIFF as Pillow 12.1's `TiffImagePlugin` (with libtiff 4.7) opens it: the
first image file directory (IFD), in numpy.

`decode_tiff(data)` gives `(pixels, mode, palette)`: `pixels` equals
`np.asarray(Image.open(f))`, `mode` is Pillow's mode and `palette` a "P"
image's palette as uint8 [256, 3] (the 16-bit ColorMap divided by 256, as
Pillow reads it; entries the map does not have are black).  It reads

* little- (II) and big-endian (MM) files, strips and tiles, chunky and
  planar samples;
* compression none (1), PackBits (32773), LZW (5; `utils/lzw.py`, C++) and
  Deflate (8, 32946; zlib), with horizontal differencing (predictor 2) at 8
  and 16 bits;
* photometric 0 and 1 (white or black is zero) at 1, 2, 4, 8 and 16 bits:
  mode "1", "L" (2- and 4-bit samples scaled by 85 and 17, photometric 0
  inverted, as Pillow's rawmodes `1;I`, `L;4I`, `L;I` do) or "I;16" /
  "I;16B" (16 bits: Pillow inverts nothing there), and grey + alpha ("LA");
* photometric 2 (RGB, 8-bit) with no extra sample, an unused one (mode
  "RGB") or alpha (ExtraSamples 2 or none: "RGBA" as stored; 1, associated
  alpha: divided out as Pillow's `RGBa` rawmode does);
* photometric 3 (a palette, at 1, 2, 4 and 8 bits) and 5 (CMYK, 8-bit).

Everything else raises `ValueError` naming ROADMAP A.12 and the tag's
value: JPEG-in-TIFF (compression 6 and 7), CCITT (2, 3, 4) and the other
codings, float and signed samples, YCbCr, LAB, fill order 2, an
orientation that swaps the axes, BigTIFF.  Only the first page is read, as
`Image.open` reads it.  Corrupt files (tags past the end of the file, strips
that decode to fewer bytes than their rows need) raise `ValueError` too.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .lzw import tiff_unpack
from .png import MAX_PIXELS, bilevel

_A12 = " (ROADMAP A.12 lists what the port does not read)"
# IFD field type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2), 9: ("i", 4),
          16: ("Q", 8), 17: ("q", 8)}
_CODINGS = {2: "CCITT modified Huffman", 3: "CCITT Group 3", 4: "CCITT Group 4",
            6: "old-style JPEG", 7: "JPEG", 32771: "raw 16", 32809: "ThunderScan",
            34676: "SGILog", 34677: "SGILog24", 34925: "LZMA", 50000: "Zstandard",
            50001: "WebP", 34712: "JPEG 2000"}
_PHOTOMETRIC = {4: "transparency mask", 6: "YCbCr", 8: "CIE L*a*b*", 9: "ICC L*a*b*",
                10: "ITU L*a*b*", 32844: "LogL", 32845: "LogLuv"}


def _fail(name: str, msg: str):
    raise ValueError(f"{name}: {msg}")


def _tags(data: bytes, name: str) -> Tuple[str, Dict[int, List[int]]]:
    """The byte order and the integer tags of the first IFD."""
    if data[:4] == b"II*\x00":
        bo = "<"
    elif data[:4] == b"MM\x00*":
        bo = ">"
    elif data[:4] in (b"II+\x00", b"MM\x00+"):
        _fail(name, "BigTIFF is not read" + _A12)
    else:
        _fail(name, "not a TIFF file")
    if len(data) < 8:
        _fail(name, "truncated TIFF header")
    (at,) = struct.unpack(bo + "I", data[4:8])
    if at + 2 > len(data):
        _fail(name, "the first IFD lies past the end of the file")
    (n,) = struct.unpack(bo + "H", data[at:at + 2])
    if at + 2 + 12 * n > len(data):
        _fail(name, "truncated IFD")
    tags: Dict[int, List[int]] = {}
    for i in range(n):
        e = at + 2 + 12 * i
        tag, typ, count = struct.unpack(bo + "HHI", data[e:e + 8])
        if typ not in _TYPES:
            continue                                   # text, rationals, floats: not used here
        code, size = _TYPES[typ]
        nbytes = size * count
        if nbytes <= 4:
            raw = data[e + 8:e + 8 + nbytes]
        else:
            (off,) = struct.unpack(bo + "I", data[e + 8:e + 12])
            if off + nbytes > len(data):
                _fail(name, f"tag {tag}'s values lie past the end of the file")
            raw = data[off:off + nbytes]
        tags[tag] = list(struct.unpack(bo + code * count, raw))
    return bo, tags


def _undo_predictor(block: np.ndarray) -> np.ndarray:
    """Horizontal differencing undone on [rows, cols, spp] samples (mod 2^bits)."""
    return np.cumsum(block, axis=1, dtype=block.dtype)


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int, bo: str,
             name: str) -> np.ndarray:
    """Bytes of `rows` rows (each padded to a byte) -> [rows, cols, spp]."""
    if bits == 16:
        need = rows * cols * spp * 2
        if len(raw) < need:
            _fail(name, "strip or tile data ends early")
        return np.frombuffer(raw[:need], bo + "u2").astype(np.uint16).reshape(rows, cols, spp)
    stride = (cols * spp * bits + 7) // 8
    if len(raw) < rows * stride:
        _fail(name, "strip or tile data ends early")
    b = np.frombuffer(raw[:rows * stride], np.uint8).reshape(rows, stride)
    if bits == 8:
        return b.reshape(rows, cols, spp)
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    v = ((b[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows, -1)
    return v[:, :cols * spp].reshape(rows, cols, spp)


def decode_tiff(data: bytes, name: str = "<bytes>") -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """(pixels, mode, palette) of a TIFF file's first image."""
    bo, t = _tags(data, name)
    one = lambda tag, default=None: t[tag][0] if t.get(tag) else default
    if 256 not in t or 257 not in t:
        _fail(name, "TIFF without ImageWidth / ImageLength")
    w, h = one(256), one(257)
    if w == 0 or h == 0 or w * h > MAX_PIXELS:
        _fail(name, f"TIFF of {w}x{h} pixels")
    comp = one(259, 1)
    if comp not in (1, 5, 8, 32773, 32946):
        _fail(name, f"TIFF compression {comp} ({_CODINGS.get(comp, 'unknown')}) is not read"
              + _A12)
    photo = one(262, 0)
    if photo not in (0, 1, 2, 3, 5):
        _fail(name, f"TIFF photometric interpretation {photo} "
              f"({_PHOTOMETRIC.get(photo, 'unknown')}) is not read" + _A12)
    if one(266, 1) != 1:
        _fail(name, f"TIFF fill order {one(266)} is not read" + _A12)
    if one(274, 1) in (5, 6, 7, 8):
        _fail(name, f"TIFF orientation {one(274)} (axes swapped) is not read" + _A12)
    fmt = set(t.get(339, [1]))
    if fmt != {1}:
        _fail(name, f"TIFF sample format {sorted(fmt)} (signed or float samples) is not read"
              + _A12)
    extra = tuple(t.get(338, ()))
    spp = one(277, 1)
    bps = list(t.get(258, [1]))
    if len(bps) == 1 and spp > 1:
        bps = bps * spp
    bps = bps[:spp]
    if len(bps) != spp or len(set(bps)) != 1:
        _fail(name, f"TIFF bits per sample {bps} with {spp} samples per pixel is not read" + _A12)
    bits = bps[0]
    base = {0: 1, 1: 1, 2: 3, 3: 1, 5: 4}[photo]
    untagged = photo == 2 and spp == 4 and not extra      # RGBA without ExtraSamples
    if spp != base + len(extra) and not untagged:
        _fail(name, f"TIFF of {spp} samples per pixel with photometric {photo} and extra "
              f"samples {list(extra)} is not read" + _A12)
    ok = {0: (1, 2, 4, 8, 16), 1: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(photo, (8,))
    if bits not in ok or (bits == 16 and (bo == ">" and photo == 0)):
        _fail(name, f"TIFF of {bits}-bit samples with photometric {photo} is not read" + _A12)
    if photo in (0, 1, 3, 5) and extra and not (photo == 1 and bits == 8 and extra == (2,)):
        _fail(name, f"TIFF extra samples {list(extra)} with photometric {photo} are not read"
              + _A12)
    if photo == 2 and extra not in ((), (0,), (1,), (2,), (999,)):
        _fail(name, f"TIFF extra samples {list(extra)} with RGB are not read" + _A12)
    planar = one(284, 1)
    if planar not in (1, 2):
        _fail(name, f"TIFF planar configuration {planar} is not read" + _A12)
    pred = one(317, 1)
    if pred not in (1, 2) or (pred == 2 and bits not in (8, 16)):
        _fail(name, f"TIFF predictor {pred} at {bits} bits is not read" + _A12)
    if comp in (1, 32773):
        pred = 1             # Pillow's raw reader and libtiff's PackBits ignore the predictor
    tiled = 324 in t
    # Pillow's planar readers: its own (uncompressed) takes RGB, RGBA and
    # CMYK, but sizes the tiles of an RGBA without ExtraSamples as if it had
    # three samples; libtiff's takes associated alpha too, and gives alpha
    # without ExtraSamples as associated
    if planar == 2 and spp > 1 and not (
            photo == 5 or photo == 2 and (extra in ((), (2,), (999,)) or extra == (1,)
                                          and comp != 1)
            and not (untagged and tiled and comp == 1)):
        _fail(name, f"planar TIFF of photometric {photo} with extra samples {list(extra)} is "
              "not read" + _A12)
    if untagged:
        extra = (1,) if planar == 2 and comp != 1 else (2,)

    if tiled:
        cw, ch = one(322), one(323)
        if not cw or not ch:
            _fail(name, "TIFF tiles without TileWidth / TileLength")
        offsets, counts = t[324], t.get(325, [])
    else:
        cw, ch = w, min(one(278, h) or h, h)
        offsets, counts = t.get(273, []), t.get(279, [])
    across, down = -(-w // cw), -(-h // ch)
    planes = spp if planar == 2 and spp > 1 else 1
    per = spp // planes
    if len(offsets) < across * down * planes or (comp != 1 and len(counts) < len(offsets)):
        _fail(name, f"TIFF with {len(offsets)} strips or tiles, {across * down * planes} needed")
    dtype = np.uint16 if bits == 16 else np.uint8
    out = np.zeros((h, w, spp), dtype)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                rows = ch if tiled else min(ch, h - ty * ch)
                need = rows * ((cw * per * bits + 7) // 8)
                off = offsets[k]
                if comp == 1:
                    raw = data[off:off + need]
                else:
                    if off + counts[k] > len(data):
                        _fail(name, "truncated TIFF file (strip or tile data)")
                    chunk = data[off:off + counts[k]]
                    if comp in (8, 32946):
                        try:
                            raw = zlib.decompressobj().decompress(chunk, need)
                        except zlib.error as e:
                            _fail(name, f"corrupt Deflate data ({e})")
                    else:
                        raw = tiff_unpack(comp, chunk, need, name)
                if len(raw) < need:
                    _fail(name, "strip or tile data ends early")
                s = _samples(raw, rows, cw, per, bits, bo, name)
                if pred == 2:
                    s = _undo_predictor(s)
                y0, x0 = ty * ch, tx * cw
                blk = s[:min(rows, h - y0), :min(cw, w - x0)]
                out[y0:y0 + blk.shape[0], x0:x0 + blk.shape[1], p * per:(p + 1) * per] = blk
                k += 1
    return _pixels(out, photo, bits, bo, extra, t, name)


def _pixels(s: np.ndarray, photo: int, bits: int, bo: str, extra: tuple, t: dict, name: str):
    """Samples [h, w, spp] -> Pillow's (pixels, mode, palette)."""
    if photo in (0, 1):
        v = s[..., 0]
        if bits == 1:
            return bilevel(v == (1 if photo == 1 else 0)), "1", None
        if bits == 16:
            return (np.ascontiguousarray(v.astype(">u2")), "I;16B", None) if bo == ">" else \
                (np.ascontiguousarray(v), "I;16", None)
        v = v * np.uint8(255 // ((1 << bits) - 1))
        if photo == 0:
            v = 255 - v
        if s.shape[-1] == 2:
            return np.ascontiguousarray(np.stack([v, s[..., 1]], -1)), "LA", None
        return np.ascontiguousarray(v), "L", None
    if photo == 3:
        cmap = t.get(320)
        if cmap is None or len(cmap) < 3:
            _fail(name, "palette TIFF without a ColorMap")
        n = len(cmap) // 3
        pal = np.zeros((256, 3), np.uint8)
        m = min(n, 256)
        pal[:m] = (np.asarray(cmap, np.int64).reshape(3, n)[:, :m].T // 256).astype(np.uint8)
        return np.ascontiguousarray(s[..., 0]), "P", pal
    if photo == 5:
        return np.ascontiguousarray(s), "CMYK", None
    if not extra or extra == (0,):
        return np.ascontiguousarray(s[..., :3]), "RGB", None
    if extra == (1,):                                # Pillow's RGBa: alpha divided out
        a = s[..., 3:4].astype(np.int32)
        rgb = np.where(a == 0, 0, np.clip(s[..., :3].astype(np.int32) * 255 // np.maximum(a, 1),
                                          0, 255))
        return np.concatenate([rgb, a], -1).astype(np.uint8), "RGBA", None
    return np.ascontiguousarray(s), "RGBA", None
