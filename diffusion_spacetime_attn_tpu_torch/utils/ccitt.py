"""ctypes binding of the port's CCITT bilevel decoders (`native/ccitt.cpp`),
which `utils/tiff.py` uses for TIFF compressions 2 (modified Huffman), 3
(Group 3, 1-D or 2-D by T4Options) and 4 (Group 4), as libtiff's
`tif_fax3.c` decodes them.

`decode(coding, options, data, width, rows)` gives the rows as libtiff
fills them: (width + 7) // 8 bytes each, most significant bit first, 1
where the code's run is black.  Data that ends early, codes no table holds,
rows whose runs do not sum to the width and uncompressed mode raise
`ValueError`.

The source is compiled at first use with g++ into the package's `_build/`
(`utils/native_bpe.compile_shared`), as the JPEG codec is; a failed build
raises `NativeBuildError`, and there is no Python fallback.  Nothing is built
when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .native_bpe import load_shared

SOURCE = Path(__file__).resolve().parents[1] / "native" / "ccitt.cpp"

_state: dict = {}
_ERR = 256
_SIGNATURES = {"ccitt_decode": (ctypes.c_int, [
    ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
    ctypes.POINTER(ctypes.c_uint8), ctypes.c_char_p, ctypes.c_int])}


def load_library() -> ctypes.CDLL:
    """The loaded decoders, built on first use; a failed build is raised
    again on every later call without compiling again."""
    return load_shared(_state, SOURCE, "ccitt_decoder", "the CCITT decoders", _SIGNATURES)


def decode(coding: int, options: int, data: bytes, width: int, rows: int,
           name: str = "<bytes>") -> bytes:
    """`rows` rows of `width` pixels of one strip or tile, packed 1 bit a
    pixel, each row padded to a byte."""
    lib = load_library()
    out = np.zeros(rows * ((width + 7) // 8), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if lib.ccitt_decode(coding, options, bytes(data), len(data), width, rows,
                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out.tobytes()
