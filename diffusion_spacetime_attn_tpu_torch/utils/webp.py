"""ctypes binding of the port's WebP decoder (`native/webp.cpp`).

`decode_webp(data)` gives `np.asarray(Image.open(f))` for a WebP file as
Pillow 12.1 (libwebp 1.6) opens it: uint8 [H, W, 3] (mode "RGB") or
[H, W, 4] ("RGBA", when the file says it has alpha).  Lossy (VP8), lossless
(VP8L) and extended files with alpha (ALPH) decode bit for bit; an animated
file gives its first frame on the canvas, as `Image.open` does.  Truncated
and corrupt files raise `ValueError` where libwebp refuses them.

The source is compiled at first use with g++ into the package's `_build/`
(`utils/native_bpe.compile_shared`), as the JPEG codec is; a failed build
raises `NativeBuildError`, and there is no Python fallback.  Nothing is built
when this module is imported.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from .native_bpe import NativeBuildError, compile_shared

SOURCE = Path(__file__).resolve().parents[1] / "native" / "webp.cpp"

_lock = threading.Lock()
_state: dict = {}
_ERR = 256


def load_library() -> ctypes.CDLL:
    """The loaded decoder, built on first use; a failed build is raised again
    on every later call without compiling again."""
    with _lock:
        if "error" in _state:
            raise NativeBuildError("the WebP decoder failed to build") from _state["error"]
        if "lib" not in _state:
            try:
                lib = ctypes.CDLL(str(compile_shared(SOURCE, "webp_decoder")))
            except (NativeBuildError, OSError) as e:
                _state["error"] = e
                raise NativeBuildError(str(e)) from e
            u8p = ctypes.POINTER(ctypes.c_uint8)
            ip = ctypes.POINTER(ctypes.c_int)
            lib.webp_decode.restype = ctypes.c_int
            lib.webp_decode.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(u8p),
                                        ip, ip, ip, ctypes.c_char_p, ctypes.c_int]
            lib.webp_free.restype = None
            lib.webp_free.argtypes = [ctypes.c_void_p]
            _state["lib"] = lib
        return _state["lib"]


def decode_webp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A WebP file's pixels: uint8 [H, W, 3] or [H, W, 4]."""
    lib = load_library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h, alpha = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR)
    if lib.webp_decode(bytes(data), len(data), ctypes.byref(out), ctypes.byref(w),
                       ctypes.byref(h), ctypes.byref(alpha), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    try:
        rgba = np.frombuffer(ctypes.string_at(out, h.value * w.value * 4), np.uint8)
    finally:
        lib.webp_free(out)
    rgba = rgba.reshape(h.value, w.value, 4)
    return rgba.copy() if alpha.value else np.ascontiguousarray(rgba[..., :3])
