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
import threading
from pathlib import Path

import numpy as np

from .native_bpe import NativeBuildError, compile_shared

SOURCE = Path(__file__).resolve().parents[1] / "native" / "jpeg.cpp"

_lock = threading.Lock()
_state: dict = {}
_ERR = 512


def load_library() -> ctypes.CDLL:
    """The loaded codec, built on first use; a failed build is raised again
    on every later call without compiling again."""
    with _lock:
        if "error" in _state:
            raise NativeBuildError("the JPEG codec failed to build") from _state["error"]
        if "lib" not in _state:
            try:
                lib = ctypes.CDLL(str(compile_shared(SOURCE, "jpeg_codec")))
            except (NativeBuildError, OSError) as e:
                _state["error"] = e
                raise NativeBuildError(str(e)) from e
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.jpeg_encode.restype = ctypes.c_int
            lib.jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.POINTER(u8p),
                                        ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
                                        ctypes.c_int]
            lib.jpeg_decode.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(u8p),
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                                        ctypes.c_int]
            lib.jpeg_decode_as.restype = ctypes.c_int
            lib.jpeg_decode_as.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
                                           ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int),
                                           ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                                           ctypes.c_int]
            lib.jpeg_free.restype = None
            lib.jpeg_free.argtypes = [ctypes.c_void_p]
            _state["lib"] = lib
        return _state["lib"]


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
