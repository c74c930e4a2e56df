"""ctypes binding of the port's Zstandard decoder (`native/zstd.cpp`).

`decompress(data)` gives the bytes of every frame in `data` (RFC 8878:
concatenated and skippable frames, raw / RLE / compressed blocks, Huffman
literals and FSE sequences in every mode, the XXH64 content checksum
verified), as `zstandard.ZstdDecompressor().decompressobj().decompress`
does; `tests/test_torch_orbax.py` holds it to that.  Frames that state their
content size decode straight into one buffer of that size, and `out=` takes
a caller's writable buffer (a numpy array) of the exact size; otherwise the
output grows.  A frame that names a dictionary, and corrupt or truncated
input, raise `ValueError`.

The source is compiled at first use with g++ into the package's `_build/`
(`utils/native_bpe.compile_shared`), as the JPEG codec is; a failed build
raises `NativeBuildError`, and there is no Python fallback.  Nothing is built
when this module is imported.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .native_bpe import NativeBuildError, compile_shared

SOURCE = Path(__file__).resolve().parents[1] / "native" / "zstd.cpp"

_lock = threading.Lock()
_state: dict = {}
_ERR = 256


def load_library() -> ctypes.CDLL:
    """The loaded decoder, built on first use; a failed build is raised again
    on every later call without compiling again."""
    with _lock:
        if "error" in _state:
            raise NativeBuildError("the zstd decoder failed to build") from _state["error"]
        if "lib" not in _state:
            try:
                lib = ctypes.CDLL(str(compile_shared(SOURCE, "zstd_decoder")))
            except (NativeBuildError, OSError) as e:
                _state["error"] = e
                raise NativeBuildError(str(e)) from e
            u8p = ctypes.POINTER(ctypes.c_uint8)
            sz = ctypes.c_size_t
            lib.zstd_content_size.restype = ctypes.c_int64
            lib.zstd_content_size.argtypes = [ctypes.c_void_p, sz]
            lib.zstd_decode_into.restype = ctypes.c_int
            lib.zstd_decode_into.argtypes = [ctypes.c_void_p, sz, ctypes.c_void_p, sz,
                                             ctypes.POINTER(sz), ctypes.c_char_p, ctypes.c_int]
            lib.zstd_decode_alloc.restype = ctypes.c_int
            lib.zstd_decode_alloc.argtypes = [ctypes.c_void_p, sz, ctypes.POINTER(u8p),
                                              ctypes.POINTER(sz), ctypes.c_char_p, ctypes.c_int]
            lib.zstd_free.restype = None
            lib.zstd_free.argtypes = [ctypes.c_void_p]
            lib.zstd_crc32c.restype = ctypes.c_uint32
            lib.zstd_crc32c.argtypes = [ctypes.c_void_p, sz]
            _state["lib"] = lib
        return _state["lib"]


def _src(data) -> np.ndarray:
    return np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else \
        np.ascontiguousarray(data).view(np.uint8).reshape(-1)


def content_size(data) -> Optional[int]:
    """The summed content size the frames state, or None where one states none."""
    src = _src(data)
    n = load_library().zstd_content_size(src.ctypes.data, src.size)
    return None if n < 0 else int(n)


def decompress(data, out: Optional[np.ndarray] = None, name: str = "<bytes>"):
    """The decoded bytes of every frame in `data` (bytes, memoryview or a
    uint8 array).  With `out` (a C-contiguous writable array whose byte size
    is the content's) it fills `out` and returns it; else it returns bytes."""
    lib = load_library()
    src = _src(data)
    err = ctypes.create_string_buffer(_ERR)
    n = ctypes.c_size_t()
    if out is None:
        size = content_size(src)
        if size is not None:
            return decompress(src, np.empty(size, np.uint8), name).tobytes()
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        if lib.zstd_decode_alloc(src.ctypes.data, src.size, ctypes.byref(ptr), ctypes.byref(n),
                                 err, _ERR):
            raise ValueError(f"{name}: {err.value.decode()}")
        try:
            return ctypes.string_at(ptr, n.value)
        finally:
            lib.zstd_free(ptr)
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("decompress: out must be a C-contiguous writable array")
    if lib.zstd_decode_into(src.ctypes.data, src.size, out.ctypes.data, out.nbytes,
                            ctypes.byref(n), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    if n.value != out.nbytes:
        raise ValueError(f"{name}: zstd data decodes to {n.value} bytes, expected {out.nbytes}")
    return out


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of `data`, as OCDBT stores it."""
    src = _src(data)
    return int(load_library().zstd_crc32c(src.ctypes.data, src.size))
