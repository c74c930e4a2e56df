"""TIFF as Pillow 12.1's `TiffImagePlugin` (with libtiff 4.7) opens it: the
first image file directory (IFD), in numpy.

`decode_tiff(data)` gives `(pixels, mode, palette)`: `pixels` equals
`np.asarray(Image.open(f))`, `mode` is Pillow's mode and `palette` a "P" or
"PA" image's palette as uint8 [256, 3] (the 16-bit ColorMap divided by 256,
as Pillow reads it; entries the map does not have are black).  A file is
read where Pillow's table of layouts (`OPEN_INFO`: photometric
interpretation, sample format, fill order, bits per sample, extra samples)
has it, at that table's mode:

* classic TIFF and BigTIFF (version 43, 8-byte offsets; little-endian only,
  as Pillow reads it), II and MM, strips and tiles, chunky and planar;
* compression none (1), PackBits (32773), LZW (5; `utils/lzw.py`, C++),
  ThunderScan (32809; `utils/lzw.py`, C++),
  Deflate (8, 32946; zlib), LZMA (34925; the standard library's `lzma`),
  Zstandard (50000; `utils/zstd.py`), JPEG (7; `utils/jpeg.py`, JPEGTables
  put before each strip's stream, photometric YCbCr converted to RGB as
  libtiff's JPEGCOLORMODE_RGB does) and CCITT modified Huffman, Group 3
  (1-D and 2-D) and Group 4 (2, 3, 4; `utils/ccitt.py`, C++); horizontal
  differencing (predictor 2) at 8, 16 and 32 bits and the floating-point
  predictor (3);
* fill order 2: every strip's bytes bit-reversed before they are decoded,
  as libtiff reverses them;
* photometric 0 and 1 at 1, 2, 4, 8, 12 and 16 bits: "1", "L" (2- and
  4-bit samples scaled by 85 and 17, photometric 0 inverted, as Pillow's
  rawmodes `1;I`, `L;4I`, `L;I` do), "I;16" / "I;16B", grey + alpha
  ("LA"); signed 8-bit samples as their bytes ("L"), signed 16- and 32-bit
  and unsigned 32-bit ones as "I" (int32), 32-bit floats as "F";
* photometric 2 (RGB, 8- and 16-bit, the latter cut to its high byte as
  Pillow's `RGB;16L` rawmodes cut it) with unused extra samples (mode
  "RGB") or alpha (ExtraSamples 2 or none: "RGBA" as stored; 1, associated
  alpha: divided out as Pillow's `RGBa` rawmodes do);
* photometric 3 (a palette, at 1, 2, 4 and 8 bits, "P"; with alpha, "PA"),
  5 (CMYK, 8- and 16-bit) and 8 (CIE L*a*b*, 8-bit, "LAB" as stored);
* photometric 6 (YCbCr): JPEG-compressed as above; under the other codings
  and old-style JPEG (6, one whole JPEG stream) as libtiff's RGBA interface
  converts it (data units of subsampling 1x1, 1x2, 2x1, 2x2, 4x1, 4x2,
  each unit's chroma over its block; TIFFYCbCrToRGB's fixed-point tables
  from YCbCrCoefficients and ReferenceBlackWhite);
* orientation (tag 274) 2-8, applied after decoding as Pillow's
  `exif_transpose` does: 2 fliplr, 3 rot180, 4 flipud, 5 transpose, 6
  rot270, 7 the anti-transpose, 8 rot90.

Everything else raises `ValueError` naming ROADMAP A.12 and the tag's
value.  That includes what Pillow refuses (a layout its table lacks,
uncompressed YCbCr in one plane, big-endian BigTIFF, the codings SGILog,
WebP and JPEG 2000), what it reads byte-swapped (a big-endian compressed
file of signed or float samples: libtiff hands over native-order samples
that Pillow swaps again) or wrongly (the planar layouts listed in
`_planar_refused`; YCbCr subsampled 4x4, which libtiff decodes to zeros or
shifted blocks at some sizes), and what the port does not read although
Pillow does: CCITT RLEW (32771; libtiff 4.7.1's own round trip decodes to
"bad code words") and old-style JPEG other than one whole JPEG stream.
Only the first page is read, as `Image.open` reads it.  Corrupt files
(tags past the end of the file, strips that decode to fewer bytes than
their rows need, codes no table holds) raise `ValueError` too.
"""
from __future__ import annotations

import lzma
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import ccitt, zstd
from .jpeg import decode_jpeg
from .lzw import thunder_unpack, tiff_unpack
from .png import MAX_PIXELS, bilevel

_A12 = " (ROADMAP A.12 lists what the port does not read)"
_PIL_REFUSES = "; Pillow 12.1 refuses it too" + _A12
# IFD field type -> (struct code, bytes)
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2), 9: ("i", 4),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
_SIZES = {2: 1, 5: 8, 7: 1, 10: 8, 11: 4, 12: 8}       # the types not read as integers
_BYTES_TAGS = (347,)                                      # JPEGTables
# the YCbCr subsamplings libtiff's RGBA interface decodes (putcontig8bitYCbCr*tile)
_YCC_SUB = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2))
_RATIONAL_TAGS = (529, 532)                               # YCbCrCoefficients, ReferenceBlackWhite
# the codings Pillow 12.1 (libtiff 4.7 as built for it) refuses
_CODINGS = {34676: "SGILog", 34677: "SGILog24", 50001: "WebP", 34712: "JPEG 2000"}
_READ = (1, 2, 3, 4, 5, 6, 7, 8, 32773, 32809, 32946, 34925, 50000)
_PREDICTED = (5, 8, 32946, 34925, 50000)                  # libtiff's codecs with a predictor
_REVERSED = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _open_info() -> Dict[tuple, str]:
    """Pillow 12.1's `TiffImagePlugin.OPEN_INFO` as {(photometric, sample
    format, fill order, bits per sample, extra samples): mode}; `_II_ONLY`
    are its keys for little-endian files only."""
    t: Dict[tuple, str] = {}

    def add(mode, photo, bps, extra=(), fmt=(1,), fills=(1,)):
        for f in fills:
            t[(photo, fmt, f, bps, extra)] = mode

    for photo in (0, 1):
        for bits, mode in ((1, "1"), (2, "L"), (4, "L"), (8, "L")):
            add(mode, photo, (bits,), fills=(1, 2))
    add("L", 1, (8,), fmt=(2,))
    add("I;16", 1, (12,))
    add("I;16", 0, (16,))
    add("I;16", 1, (16,), fills=(1, 2))
    add("I", 1, (16,), fmt=(2,))
    add("F", 0, (32,), fmt=(3,))
    add("F", 1, (32,), fmt=(3,))
    add("I", 1, (32,))
    add("I", 1, (32,), fmt=(2,))
    add("LA", 1, (8, 8), (2,))
    add("RGB", 2, (8,) * 3, fills=(1, 2))
    add("RGBA", 2, (8,) * 4)                                 # no ExtraSamples
    for a, mode in ((0, "RGB"), (1, "RGBA"), (2, "RGBA")):
        for unused in range(3):
            add(mode, 2, (8,) * (4 + unused), (a,) + (0,) * unused)
    add("RGBA", 2, (8,) * 4, (999,))                         # Corel Draw 10
    add("RGB", 2, (16,) * 3)
    add("RGBA", 2, (16,) * 4)
    for a, mode in ((0, "RGB"), (1, "RGBA"), (2, "RGBA")):
        add(mode, 2, (16,) * 4, (a,))
    for bits in (1, 2, 4, 8):
        add("P", 3, (bits,), fills=(1, 2))
    add("P", 3, (8, 8), (0,))
    add("PA", 3, (8, 8), (2,))
    for unused in range(3):
        add("CMYK", 5, (8,) * (4 + unused), (0,) * unused)
    add("CMYK", 5, (16,) * 4)
    add("L", 6, (8,))
    add("RGB", 6, (8,) * 3)
    add("LAB", 8, (8,) * 3)
    return t


_OPEN_INFO = _open_info()
_II_ONLY = {(1, (1,), 1, (12,), ()), (0, (1,), 1, (16,), ()), (1, (1,), 2, (16,), ()),
            (1, (1,), 1, (32,), ())}


def _fail(name: str, msg: str):
    raise ValueError(f"{name}: {msg}")


def _tags(data: bytes, name: str) -> Tuple[str, Dict[int, List[int]]]:
    """The byte order and the integer tags of the first IFD (classic TIFF or
    BigTIFF); JPEGTables (347) as its bytes."""
    if data[:4] == b"II*\x00":
        bo, big = "<", False
    elif data[:4] == b"MM\x00*":
        bo, big = ">", False
    elif data[:4] == b"II+\x00":
        bo, big = "<", True
    elif data[:4] == b"MM\x00+":
        _fail(name, "big-endian BigTIFF is not read" + _PIL_REFUSES)
    else:
        _fail(name, "not a TIFF file")
    if big:
        if len(data) < 16:
            _fail(name, "truncated BigTIFF header")
        size, zero, at = struct.unpack(bo + "HHQ", data[4:16])
        if size != 8 or zero != 0:
            _fail(name, f"BigTIFF with {size}-byte offsets")
        count_fmt, entry, off_fmt, slot = "Q", 20, "Q", 8
    else:
        if len(data) < 8:
            _fail(name, "truncated TIFF header")
        (at,) = struct.unpack(bo + "I", data[4:8])
        count_fmt, entry, off_fmt, slot = "H", 12, "I", 4
    head = 8 if big else 2
    if at + head > len(data):
        _fail(name, "the first IFD lies past the end of the file")
    (n,) = struct.unpack(bo + count_fmt, data[at:at + head])
    if at + head + entry * n > len(data):
        _fail(name, "truncated IFD")
    tags: Dict[int, List[int]] = {}
    for i in range(n):
        e = at + head + entry * i
        tag, typ = struct.unpack(bo + "HH", data[e:e + 4])
        (count,) = struct.unpack(bo + off_fmt, data[e + 4:e + 4 + slot])
        size = _TYPES[typ][1] if typ in _TYPES else _SIZES.get(typ, 0)
        if not size or (typ not in _TYPES and tag not in _BYTES_TAGS + _RATIONAL_TAGS):
            continue                               # text, floats, other rationals: not used
        nbytes = size * count
        v = e + 4 + slot
        if nbytes <= slot:
            raw = data[v:v + nbytes]
        else:
            (off,) = struct.unpack(bo + off_fmt, data[v:v + slot])
            if off + nbytes > len(data):
                _fail(name, f"tag {tag}'s values lie past the end of the file")
            raw = data[off:off + nbytes]
        if tag in _BYTES_TAGS:
            tags[tag] = list(raw)
            continue
        if tag in _RATIONAL_TAGS:
            if typ not in (5, 10, 11):
                continue
            if typ == 11:
                tags[tag] = [float(v) for v in np.frombuffer(raw, bo + "f4")]
                continue
            v = np.frombuffer(raw, bo + ("u4" if typ == 5 else "i4")).astype(np.float64)
            tags[tag] = [float(np.float32(a / b)) if b else float("nan")
                         for a, b in zip(v[0::2], v[1::2])]
            continue
        code = _TYPES[typ][0]
        tags[tag] = list(struct.unpack(bo + code * count, raw))
    return bo, tags


def _unpack_bits(b: np.ndarray, rows: int, n: int, bits: int) -> np.ndarray:
    """[rows, stride] bytes of `bits`-bit samples, most significant bit
    first, each row padded to a byte -> [rows, n] integers."""
    if 8 % bits == 0:
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        v = ((b[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(rows, -1)
        return v[:, :n]
    v = np.unpackbits(b, axis=1)[:, :n * bits].reshape(rows, n, bits).astype(np.uint16)
    return (v << np.arange(bits - 1, -1, -1, dtype=np.uint16)).sum(-1, dtype=np.uint16)


def _dtype(bits: int, fmt: int, bo: str) -> np.dtype:
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    return np.dtype(f"{bo}{kind}{bits // 8}")


def _samples(raw: bytes, rows: int, cols: int, spp: int, bits: int, fmt: int, bo: str,
             name: str) -> np.ndarray:
    """Bytes of `rows` rows (each padded to a byte) -> [rows, cols, spp]:
    uint8 below 8 bits (uint16 at 12), else the file's integers or floats."""
    if bits in (16, 32):
        need = rows * cols * spp * bits // 8
        if len(raw) < need:
            _fail(name, "strip or tile data ends early")
        return np.frombuffer(raw[:need], _dtype(bits, fmt, bo)).reshape(rows, cols, spp)
    stride = (cols * spp * bits + 7) // 8
    if len(raw) < rows * stride:
        _fail(name, "strip or tile data ends early")
    b = np.frombuffer(raw[:rows * stride], np.uint8).reshape(rows, stride)
    if bits == 8:
        return b.reshape(rows, cols, spp)
    return _unpack_bits(b, rows, cols * spp, bits).reshape(rows, cols, spp)


def _undo_predictor(block: np.ndarray) -> np.ndarray:
    """Horizontal differencing undone on [rows, cols, spp] samples (mod 2^bits,
    on the samples' bits whatever their type, as libtiff's integer sums)."""
    u = block.astype(block.dtype.newbyteorder("=")).view(f"u{block.dtype.itemsize}")
    return np.cumsum(u, axis=1, dtype=u.dtype).view(block.dtype.newbyteorder("="))


def _undo_float_predictor(raw: bytes, rows: int, cols: int, spp: int, name: str) -> np.ndarray:
    """libtiff's fpAcc: each row's bytes summed across samples, then read as
    byte planes (most significant first) of 32-bit floats, in native order."""
    n = cols * spp
    if len(raw) < rows * n * 4:
        _fail(name, "strip or tile data ends early")
    b = np.frombuffer(raw[:rows * n * 4], np.uint8).reshape(rows, n * 4 // spp, spp)
    b = np.cumsum(b, axis=1, dtype=np.uint8).reshape(rows, 4, n)
    return np.ascontiguousarray(b[:, ::-1].transpose(0, 2, 1)).view("<f4").reshape(rows, cols, spp)


def _jpeg_tables(t: dict, name: str) -> bytes:
    """JPEGTables (347): an abbreviated stream, SOI to EOI, or nothing."""
    tables = bytes(t.get(347, ()))
    if tables and not (tables[:2] == b"\xff\xd8" and tables[-2:] == b"\xff\xd9"):
        _fail(name, "TIFF JPEGTables that are no SOI ... EOI stream")
    return tables


def _sof(stream: bytes) -> Optional[Tuple[int, List[Tuple[int, int]]]]:
    """(precision, [(h, v) sampling per component]) of a JPEG stream's frame."""
    i = 2
    while i + 4 <= len(stream):
        if stream[i] != 0xFF:
            return None
        m = stream[i + 1]
        if m == 0xFF:
            i += 1
            continue
        (n,) = struct.unpack(">H", stream[i + 2:i + 4])
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            seg = stream[i + 4:i + 2 + n]
            if len(seg) < 6:
                return None
            nc = seg[5]
            return seg[0], [(seg[7 + 3 * k] >> 4, seg[7 + 3 * k] & 15) for k in range(nc)
                            if 8 + 3 * k < len(seg)]
        i += 2 + n
    return None


def _jpeg_block(chunk: bytes, tables: bytes, rows: int, cols: int, spp: int, photo: int,
                sub: Tuple[int, int], name: str) -> np.ndarray:
    """One strip or tile of a JPEG-compressed TIFF: the tables' stream put
    before it, YCbCr converted to RGB (libtiff's JPEGCOLORMODE_RGB), any
    other components as they are; libtiff's checks of the stream's size and
    sampling against the tags."""
    if chunk[:2] != b"\xff\xd8":
        _fail(name, "JPEG strip or tile without an SOI marker")
    stream = tables[:-2] + chunk[2:] if tables else chunk
    frame = _sof(stream)
    if frame is None:
        _fail(name, "JPEG strip or tile without a frame header")
    precision, sampling = frame
    if precision != 8 or len(sampling) != spp:
        _fail(name, f"JPEG strip of {len(sampling)} components at {precision} bits, the "
              f"tags say {spp} at 8")
    want = [sub] + [(1, 1)] * (spp - 1) if photo == 6 else [(1, 1)] * spp
    if sampling != want:
        _fail(name, f"improper JPEG sampling factors {sampling} (libtiff expects {want})")
    px = decode_jpeg(stream, name, colour=1 if photo == 6 else 0)
    if px.shape[:2] != (rows, cols):
        _fail(name, f"JPEG strip or tile of {px.shape[1]}x{px.shape[0]}, expected {cols}x{rows}")
    return px.reshape(rows, cols, spp)


def _decode_chunk(comp: int, chunk: bytes, need: int, rows: int, cols: int, t: dict,
                  name: str) -> bytes:
    """The bytes of one strip or tile (already bit-reversed for fill order 2)."""
    if comp == 1:
        return chunk
    if comp in (8, 32946):
        try:
            return zlib.decompressobj().decompress(chunk, need)
        except zlib.error as e:
            _fail(name, f"corrupt Deflate data ({e})")
    if comp == 34925:
        try:
            return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(chunk, need)
        except lzma.LZMAError as e:
            _fail(name, f"corrupt LZMA data ({e})")
    if comp == 50000:
        return zstd.decompress(chunk, name=name)[:need]
    if comp in (2, 3, 4):
        opts = (t.get(292 if comp == 3 else 293) or [0])[0]
        return ccitt.decode(comp, opts, chunk, cols, rows, name)
    if comp == 32809:
        return thunder_unpack(chunk, cols, rows, name)
    return tiff_unpack(comp, chunk, need, name)


def _planar_refused(photo: int, extra: tuple, comp: int, bits: int, untagged: bool,
                    tiled: bool) -> bool:
    """The planar layouts Pillow reads wrongly or not at all.  Its own
    reader (uncompressed) takes 8-bit RGB, RGBA and CMYK, but sizes the tiles
    of an RGBA without ExtraSamples as if it had three samples; libtiff's
    (compressed) takes those and 16-bit RGB, RGBA and CMYK."""
    if comp != 1 and bits == 16:
        return not (photo == 5 or photo == 2 and extra in ((), (1,), (2,)) and not untagged)
    if photo == 5 and bits == 8:
        return False
    if photo != 2 or bits == 16:
        return True
    if extra in ((), (2,), (999,)) or extra == (1,) and comp != 1:
        return untagged and tiled and comp == 1
    return True


def decode_tiff(data: bytes, name: str = "<bytes>") -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """(pixels, mode, palette) of a TIFF file's first image."""
    bo, t = _tags(data, name)
    one = lambda tag, default=None: t[tag][0] if t.get(tag) else default  # noqa: E731
    if 256 not in t or 257 not in t:
        _fail(name, "TIFF without ImageWidth / ImageLength")
    w, h = one(256), one(257)
    if w == 0 or h == 0 or w * h > MAX_PIXELS:
        _fail(name, f"TIFF of {w}x{h} pixels")
    comp = one(259, 1)
    if comp not in _READ:
        known = _CODINGS.get(comp)
        what = known or {32771: "CCITT RLEW"}.get(comp, "unknown")
        _fail(name, f"TIFF compression {comp} ({what}) is not read"
              + (_PIL_REFUSES if known else _A12))
    if comp == 6:
        return _orient(_old_jpeg(data, t, w, h, name), one(274, 1)), "RGB", None
    photo = one(262, 0)
    fill = one(266, 1)
    fmt = tuple(t.get(339, [1]))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    extra = tuple(t.get(338, ()))
    spp = one(277, 1)
    bps = tuple(t.get(258, [1]))
    if spp > 6:
        _fail(name, f"TIFF of {spp} samples per pixel" + _PIL_REFUSES)
    if len(bps) > spp:
        bps = bps[:spp]
    elif len(bps) == 1 and spp > 1:
        bps = bps * spp
    key = (photo, fmt, fill, bps, extra)
    mode = _OPEN_INFO.get(key)
    if mode is None or (bo == ">" and key in _II_ONLY):
        _fail(name, f"TIFF of photometric interpretation {photo}, sample format {list(fmt)}, "
              f"fill order {fill}, bits per sample {list(bps)} and extra samples "
              f"{list(extra)} is not read" + _PIL_REFUSES)
    if mode == "I;16" and bo == ">":
        mode = "I;16B"
    bits = bps[0]
    planar = one(284, 1)
    if planar not in (1, 2):
        _fail(name, f"TIFF planar configuration {planar} is not read" + _A12)
    sub = tuple(t.get(530, [2, 2]))[:2]
    ycc = photo == 6 and spp == 3 and comp != 7          # libtiff's RGBA interface
    if ycc and comp == 1:
        _fail(name, "uncompressed TIFF YCbCr is not read" + (
            _PIL_REFUSES if planar == 1 else
            ": Pillow reads its planes as RGB, unconverted" + _A12))
    if ycc and (sub not in _YCC_SUB or (planar == 2 and sub != (1, 1))):
        _fail(name, f"TIFF YCbCr of subsampling {list(sub)} in planar configuration "
              f"{planar} is not read" + (
                  ": libtiff's 4x4 path gives zeros or shifted blocks at some sizes" + _A12
                  if sub == (4, 4) and planar == 1 else _PIL_REFUSES))
    if photo == 6 and spp == 1 and comp != 1:
        _fail(name, f"TIFF YCbCr of one sample with compression {comp}" + _PIL_REFUSES)
    if comp == 1 and fill == 2 and (photo == 0 and bits == 8 or photo == 3 and bits < 8):
        _fail(name, f"uncompressed TIFF of fill order 2, photometric {photo} at {bits} bits "
              "(Pillow has no rawmode for it)" + _PIL_REFUSES)
    if comp in (2, 3, 4) and (bits != 1 or spp != 1):
        _fail(name, f"CCITT-coded TIFF of {spp} samples of {bits} bits" + _PIL_REFUSES)
    if comp == 32809 and (bits != 4 or spp != 1 or 324 in t):
        _fail(name, f"ThunderScan TIFF of {spp} samples of {bits} bits"
              + (" in tiles" if 324 in t else "") + _PIL_REFUSES)
    if comp == 7 and bits != 8:
        _fail(name, f"JPEG-compressed TIFF of {bits}-bit samples" + _PIL_REFUSES)
    if bo == ">" and comp != 1 and fmt != (1,) and bits > 8:
        _fail(name, f"big-endian compressed TIFF of sample format {list(fmt)} at {bits} bits "
              "is not read: Pillow reads it byte-swapped" + _A12)
    untagged = photo == 2 and spp == 4 and not extra      # RGBA without ExtraSamples
    tiled = 324 in t
    if planar == 2 and spp > 1 and not (ycc and sub == (1, 1)) and (
            comp == 7 or comp == 1 and fill == 2
            or _planar_refused(photo, extra, comp, bits, untagged, tiled)):
        _fail(name, f"planar TIFF of photometric {photo} with extra samples {list(extra)} "
              f"at {bits} bits is not read" + _A12)
    pred = one(317, 1) if comp in _PREDICTED else 1
    units = ycc and planar == 1 and sub != (1, 1)        # subsampled data units
    if units and pred != 1:
        _fail(name, f"TIFF YCbCr of subsampling {list(sub)} with predictor {pred}" + _A12)
    if pred not in (1, 2, 3) or (pred == 2 and bits not in (8, 16, 32)) or (
            pred == 3 and (fmt != (3,) or bits != 32)):
        _fail(name, f"TIFF predictor {pred} at {bits} bits, sample format {list(fmt)}"
              + _PIL_REFUSES)
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
    tables = _jpeg_tables(t, name) if comp == 7 else b""
    if units and ((tiled and (cw % sub[0] or ch % sub[1])) or (ch % sub[1] and ch < h)):
        _fail(name, f"TIFF YCbCr strips or tiles of {cw}x{ch} with subsampling {list(sub)}"
              + _A12)
    dtype = _dtype(bits, fmt[0], "=") if bits in (16, 32) else np.uint16 if bits > 8 else np.uint8
    out = np.zeros((h, w, spp), dtype)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                rows = ch if tiled else min(ch, h - ty * ch)
                need = rows * ((cw * per * bits + 7) // 8)
                if units:                    # TIFFVStripSize: whole data units
                    need = -(-rows // sub[1]) * -(-cw // sub[0]) * (sub[0] * sub[1] + 2)
                off = offsets[k]
                size = need if comp == 1 else counts[k]
                if off + size > len(data) and comp != 1:
                    _fail(name, "truncated TIFF file (strip or tile data)")
                chunk = data[off:off + size]
                if fill == 2:
                    chunk = _REVERSED[np.frombuffer(chunk, np.uint8)].tobytes()
                if comp == 7:
                    s = _jpeg_block(chunk, tables, rows, cw, per, photo, sub, name)
                else:
                    raw = _decode_chunk(comp, chunk, need, rows, cw, t, name)
                    if len(raw) < need:
                        _fail(name, "strip or tile data ends early")
                    if units:
                        s = _ycbcr_units(raw, rows, cw, sub)
                    elif pred == 3:
                        s = _undo_float_predictor(raw, rows, cw, per, name)
                    else:
                        s = _samples(raw, rows, cw, per, bits, fmt[0], bo, name)
                        if pred == 2:
                            s = _undo_predictor(s)
                y0, x0 = ty * ch, tx * cw
                blk = s[:min(rows, h - y0), :min(cw, w - x0)]
                out[y0:y0 + blk.shape[0], x0:x0 + blk.shape[1], p * per:(p + 1) * per] = blk
                k += 1
    if ycc:
        px, pal = _ycbcr_rgb(out, t, name), None
    else:
        px, pal = _pixels(out, mode, photo, bits, bo, extra, t, name)
    return _orient(px, one(274, 1)), mode, pal


def _old_jpeg(data: bytes, t: dict, w: int, h: int, name: str) -> np.ndarray:
    """Old-style JPEG (compression 6) as libtiff's OJPEG codec and RGBA
    interface give it: the components decoded without colour conversion,
    chroma repeated over its block, then libtiff's YCbCr -> RGB tables.
    Read where the image is one complete JPEG stream: the one
    JPEGInterchangeFormat (513) points at, or the only strip's."""
    one = lambda tag, default=None: t[tag][0] if t.get(tag) else default  # noqa: E731
    bps = set(t.get(258, [8]))
    if (one(262) != 6 or one(277, 3) != 3 or bps != {8} or one(284, 1) != 1
            or one(512, 1) != 1):
        _fail(name, "TIFF compression 6 (old-style JPEG) other than baseline YCbCr of 8-bit "
              "samples in one plane is not read" + _A12)
    if t.get(513):
        at, n = one(513), one(514, len(data) - one(513))
        stream = data[at:at + n]
    elif len(t.get(273, [])) == 1 and t.get(279):
        stream = data[t[273][0]:t[273][0] + t[279][0]]
    else:
        _fail(name, "TIFF compression 6 (old-style JPEG) without one whole JPEG stream "
              "(tables in tags, or a stream split over strips) is not read" + _A12)
    if stream[:2] != b"\xff\xd8":
        _fail(name, "TIFF compression 6 (old-style JPEG) whose stream has no SOI marker"
              + _A12)
    planes = decode_jpeg(stream, name, colour=2)
    if planes.ndim != 3 or planes.shape != (h, w, 3):
        _fail(name, f"old-style JPEG stream of {planes.shape[:2]} for a {w}x{h} TIFF" + _A12)
    return _ycbcr_rgb(planes, t, name)


def _ycbcr_units(raw: bytes, rows: int, cols: int, sub: Tuple[int, int]) -> np.ndarray:
    """Subsampled YCbCr data units (sh·sv luma samples, then Cb, Cr) ->
    [rows, cols, 3] with each unit's chroma over its block, as libtiff's
    RGBA interface (putcontig8bitYCbCr*tile) spreads it."""
    sh, sv = sub
    bw, bh = -(-cols // sh), -(-rows // sv)
    u = np.frombuffer(raw[:bw * bh * (sh * sv + 2)], np.uint8).reshape(bh, bw, sh * sv + 2)
    y = u[..., :sh * sv].reshape(bh, bw, sv, sh).transpose(0, 2, 1, 3).reshape(bh * sv, bw * sh)
    chroma = np.repeat(np.repeat(u[..., sh * sv:], sv, 0), sh, 1)
    return np.concatenate([y[..., None], chroma], -1)[:rows, :cols]


def _ycbcr_rgb(s: np.ndarray, t: dict, name: str) -> np.ndarray:
    """libtiff's TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB on [h, w, (Y, Cb, Cr)]:
    16-bit fixed-point tables from YCbCrCoefficients (529) and
    ReferenceBlackWhite (532), float32 as libtiff computes them."""
    f32 = np.float32
    luma = [f32(v) for v in (t.get(529) or [0.299, 0.587, 0.114])[:3]]
    ref = [f32(v) for v in (t.get(532) or [0, 255, 128, 255, 128, 255])[:6]]
    if len(luma) < 3 or len(ref) < 6 or not all(np.isfinite(luma + ref)) or luma[1] == 0:
        _fail(name, "TIFF YCbCr with invalid YCbCrCoefficients or ReferenceBlackWhite")

    def fix(x):                      # libtiff's FIX(CLAMP(x, 0, 2)) at 16 fractional bits
        return int(np.floor(np.float64(min(max(x, f32(0)), f32(2))) * 65536 + 0.5))

    f1 = f32(2) - f32(2) * luma[0]
    f3 = f32(2) - f32(2) * luma[2]
    d1, d2, d3, d4 = fix(f1), -fix(luma[0] * f1 / luma[1]), fix(f3), -fix(luma[2] * f3 / luma[1])

    def code2v(c, rb, rw, cr):       # Code2V: (c - (int32) rb) * cr / (rw - rb), in float
        d = rw - rb
        v = (c - int(rb)).astype(np.float32) * f32(cr) / (d if d != 0 else f32(1))
        return np.clip(v, f32(-128 * 32), f32(128 * 32)).astype(np.int64)

    x = np.arange(256, dtype=np.int64) - 128
    cr = code2v(x, ref[4] - f32(128), ref[5] - f32(128), 127)
    cb = code2v(x, ref[2] - f32(128), ref[3] - f32(128), 127)
    y_tab = code2v(x + 128, ref[0], ref[1], 255)
    cr_r, cb_b = (d1 * cr + 32768) >> 16, (d3 * cb + 32768) >> 16
    cr_g, cb_g = d2 * cr, d4 * cb + 32768
    y, b_, r_ = (s[..., k].astype(np.int64) for k in range(3))
    rgb = np.stack([y_tab[y] + cr_r[r_], y_tab[y] + ((cb_g[b_] + cr_g[r_]) >> 16),
                    y_tab[y] + cb_b[b_]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _orient(px: np.ndarray, orientation: int) -> np.ndarray:
    """Pillow's exif_transpose of tag 274 (2-8; other values leave the
    image as it is, as Pillow leaves it)."""
    turn = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
            5: lambda a: a.swapaxes(0, 1), 6: lambda a: np.rot90(a, -1),
            7: lambda a: a[::-1, ::-1].swapaxes(0, 1), 8: lambda a: np.rot90(a, 1)}.get(orientation)
    return px if turn is None else np.ascontiguousarray(turn(px))


def _pixels(s: np.ndarray, mode: str, photo: int, bits: int, bo: str, extra: tuple, t: dict,
            name: str):
    """Samples [h, w, spp] -> Pillow's (pixels, palette) for `mode`."""
    if mode in ("P", "PA"):
        cmap = t.get(320)
        if cmap is None or len(cmap) < 3:
            _fail(name, "palette TIFF without a ColorMap")
        n = len(cmap) // 3
        pal = np.zeros((256, 3), np.uint8)
        m = min(n, 256)
        pal[:m] = (np.asarray(cmap, np.int64).reshape(3, n)[:, :m].T // 256).astype(np.uint8)
        px = s[..., 0] if mode == "P" else s[..., :2]
        return np.ascontiguousarray(px), pal
    if bits == 16 and mode not in ("I;16", "I;16B", "I"):
        s = (s >> 8).astype(np.uint8)                # Pillow's ;16 rawmodes: the high byte
    if mode == "1":
        return bilevel(s[..., 0] == (1 if photo == 1 else 0)), None
    if mode in ("I;16", "I;16B"):
        v = s[..., 0].astype(np.uint16)
        return np.ascontiguousarray(v.astype(">u2") if mode == "I;16B" else v), None
    if mode == "I":
        return np.ascontiguousarray(s[..., 0].astype(np.int32)), None
    if mode == "F":
        return np.ascontiguousarray(s[..., 0].astype(np.float32)), None
    if mode in ("L", "LA") and photo in (0, 1):
        v = s[..., 0].view(np.uint8) if s.dtype == np.int8 else s[..., 0]
        v = v * np.uint8(255 // ((1 << bits) - 1))
        if photo == 0:
            v = 255 - v
        if mode == "LA":
            return np.ascontiguousarray(np.stack([v, s[..., 1]], -1)), None
        return np.ascontiguousarray(v), None
    if mode == "L":                                   # YCbCr of one sample: its bytes
        return np.ascontiguousarray(s[..., 0]), None
    if mode == "CMYK":
        return np.ascontiguousarray(s[..., :4]), None
    if mode in ("RGB", "LAB"):
        return np.ascontiguousarray(s[..., :3]), None
    if extra[:1] == (1,):                            # Pillow's RGBa: alpha divided out
        a = s[..., 3:4].astype(np.int32)
        rgb = np.where(a == 0, 0, np.clip(s[..., :3].astype(np.int32) * 255 // np.maximum(a, 1),
                                          0, 255))
        return np.concatenate([rgb, a], -1).astype(np.uint8), None
    return np.ascontiguousarray(s[..., :4]), None
