"""ctypes binding of the port's JPEG codec (`native/jpeg.cpp`).

`encode_jpeg(img, quality)` gives the bytes PIL's `Image.save(buf, "JPEG",
quality=q)` writes for a uint8 [H, W, 3] (4:2:0) or [H, W] / [H, W, 1]
image (greyscale), and `decode_jpeg(data)` the pixels PIL's `Image.open`
gives for a baseline, extended or progressive file, Huffman- or
arithmetic-coded, or a lossless 8-bit one, at sampling factors 1-4:
[H, W, 3] for a YCbCr or RGB-coded file (mode "RGB"), [H, W, 4] for a CMYK
or YCCK one (mode "CMYK", inverted as PIL reads Adobe files), [H, W] for a
greyscale one.  The codec follows libjpeg-turbo's integer arithmetic at
its defaults (ISLOW DCTs, fancy upsampling, block smoothing), so both equal
PIL byte for byte; `tests/test_torch_image_io.py`,
`tests/test_torch_formats.py` and `tests/test_torch_image_formats.py` hold
them to it.  Hierarchical and 12-bit files raise `ValueError` naming the
marker, its offset and ROADMAP A.12, as PIL refuses them; so do corrupt and
truncated files, where PIL refuses them.

The source is compiled at first use with `g++ -O2 -fPIC -std=c++17
-shared` into the package's `_build/` (listed in `.gitignore`) under a name
that carries a hash of the source and flags, so an edited source is
rebuilt.  There is no Python fallback: a missing compiler or a failed build
raises `NativeBuildError`.  Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .native_bpe import load_shared
from .raster import NotThisFormat

SOURCE = Path(__file__).resolve().parents[1] / "native" / "jpeg.cpp"

_state: dict = {}
_ERR = 512
_U8P = ctypes.POINTER(ctypes.c_uint8)
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "jpeg_encode": (ctypes.c_int, [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                   ctypes.POINTER(_U8P), ctypes.POINTER(ctypes.c_size_t),
                                   ctypes.c_char_p, ctypes.c_int]),
    "jpeg_decode": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(_U8P), _IP,
                                   _IP, _IP, ctypes.c_char_p, ctypes.c_int]),
    "jpeg_decode_as": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                      ctypes.POINTER(_U8P), _IP, _IP, _IP, ctypes.c_char_p,
                                      ctypes.c_int]),
    "jpeg_free": (None, [ctypes.c_void_p])}


def load_library() -> ctypes.CDLL:
    """The loaded codec, built on first use; a failed build is raised again
    on every later call without compiling again."""
    return load_shared(_state, SOURCE, "jpeg_codec", "the JPEG codec", _SIGNATURES)


def encode_jpeg(img: np.ndarray, quality: int = 75) -> bytes:
    """The JPEG file of a uint8 [H, W, 3] (RGB, 4:2:0) or [H, W] / [H, W, 1]
    (greyscale) image, as PIL's `save(buf, "JPEG", quality=quality)` writes
    it."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg takes [H, W] or [H, W, 3], got {img.shape}")
    lib = load_library()
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR)
    rc = lib.jpeg_encode(img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
                         1 if img.ndim == 2 else 3, int(quality), ctypes.byref(out),
                         ctypes.byref(n), err, _ERR)
    if rc:
        raise ValueError(err.value.decode())
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.jpeg_free(out)


def decode_jpeg(data: bytes, name: str = "<bytes>", colour: int = -1) -> np.ndarray:
    """A JPEG's pixels: uint8 [H, W, 3] RGB, [H, W, 4] CMYK or [H, W] greyscale.
    `colour` -1 takes the components' colour space from the markers, as
    libjpeg does; 0 leaves the components as they are and 1 converts three
    from YCbCr to RGB, as libtiff asks of a JPEG-compressed TIFF's strips."""
    lib = load_library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR)
    rc = lib.jpeg_decode_as(data, len(data), colour, ctypes.byref(out), ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(c), err, _ERR)
    if rc:
        raise ValueError(f"{name}: {err.value.decode()}")
    try:
        shape = (h.value, w.value) + ((c.value,) if c.value > 1 else ())
        return np.frombuffer(ctypes.string_at(out, h.value * w.value * c.value),
                             np.uint8).reshape(shape).copy()
    finally:
        lib.jpeg_free(out)


def _i16(s: bytes, at: int = 0) -> int:
    if len(s) < at + 2:
        raise NotThisFormat("JPEG: a field cut short")
    return int.from_bytes(s[at:at + 2], "big")


def _photoshop(seg: bytes) -> None:
    """The 8BIM resource walk of Pillow's APP13 handler: a field cut short
    ends it, a resource name's length byte past the end is "not this
    format" (its IndexError)."""
    at = 14
    while seg[at:at + 4] == b"8BIM":
        if len(seg) < at + 6:
            return
        code = _i16(seg, at + 4)
        at += 6
        if at >= len(seg):
            raise NotThisFormat("JPEG: a Photoshop resource cut short")
        at += 1 + seg[at]
        at += at & 1
        if len(seg) < at + 4:
            return
        n = int.from_bytes(seg[at:at + 4], "big")
        at += 4
        if code == 0x03ED and len(seg[at:at + n]) < 14:
            return
        at += n + ((at + n) & 1)


def pillow_header(data: bytes, name: str = "<bytes>") -> None:
    """`JpegImageFile._open`'s walk over the markers up to the first SOS,
    with Pillow's checks: what Pillow takes as "not this format" (another
    magic, an unknown marker, a segment too short for its fields, a frame
    of other than 8 bits or 1, 3 or 4 components, no frame before the scan)
    raises `NotThisFormat`; a segment longer than the file (Pillow's
    "Truncated File Read") `ValueError`.  libjpeg's own checks are
    `decode_jpeg`'s."""
    if data[:3] != b"\xff\xd8\xff":
        raise NotThisFormat("not a JPEG file")
    pos, s, layers, size, icc = 3, b"\xff", 0, (0, 0), []

    def segment() -> bytes:
        nonlocal pos
        n = _i16(data[pos:pos + 2]) - 2
        pos += 2
        if n > 0 and pos + n > len(data):
            raise ValueError(f"{name}: JPEG segment past the end (Truncated File Read)")
        out = data[pos:pos + max(n, 0)]
        pos += max(n, 0)
        return out

    while True:
        if not s:
            raise NotThisFormat("JPEG: no scan")
        if s[0] != 0xFF:                          # junk between markers
            s, pos = data[pos:pos + 1], pos + 1
            continue
        s, pos = s + data[pos:pos + 1], pos + 1
        marker = _i16(s)
        if marker == 0xFFFF:
            s = b"\xff"
            continue
        if marker == 0xFF00:
            s, pos = data[pos:pos + 1], pos + 1
            continue
        if marker < 0xFFC0:
            raise NotThisFormat("JPEG: no marker found")
        low = marker & 0xFF
        if low in (0xC4, 0xCC, 0xDA, 0xDC, 0xDD, 0xDF, 0xFE):       # Skip, COM
            segment()
        elif 0xE0 <= low <= 0xEF:                                   # APP
            seg = segment()
            if (low == 0xE0 and seg[:4] == b"JFIF") or (low == 0xEE and seg[:5] == b"Adobe"):
                _i16(seg, 5)
            elif low == 0xE2 and seg[:12] == b"ICC_PROFILE\0":
                icc.append(seg)
            elif low == 0xED and seg[:14] == b"Photoshop 3.0\0":
                _photoshop(seg)
        elif low == 0xDB:                                           # DQT
            seg = segment()
            while seg:
                n = 1 + 64 * (1 if seg[0] < 16 else 2)
                if len(seg) < n:
                    raise NotThisFormat("JPEG: bad quantization table marker")
                seg = seg[n:]
        elif low in (0xC8,) or 0xD0 <= low <= 0xD9 or 0xF0 <= low <= 0xFD:
            pass                                                    # no segment
        else:                                                       # SOF, DHP
            seg = segment()
            size = (_i16(seg, 3), _i16(seg, 1))
            if seg[0] != 8:
                raise NotThisFormat(f"JPEG: cannot handle {seg[0]}-bit layers")
            if len(seg) < 6 or seg[5] not in (1, 3, 4):
                raise NotThisFormat("JPEG: cannot handle this many layers")
            layers = seg[5]
            if icc and len(sorted(icc)[0]) < 14:
                raise NotThisFormat("JPEG: an ICC profile segment cut short")
            icc = []
            if (len(seg) - 6) % 3:
                raise NotThisFormat("JPEG: a component cut short")
        if marker == 0xFFDA:
            break
        s, pos = data[pos:pos + 1], pos + 1
    if not layers or size[0] <= 0 or size[1] <= 0:
        raise NotThisFormat("JPEG: no frame before the scan")
