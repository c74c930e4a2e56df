"""ctypes binding of the port's LZW and PackBits decoders and the raster
formats' byte-run loops (`native/lzw.cpp`), which `utils/gif.py`,
`utils/tiff.py` and the readers of `utils/image_io.py` use.

`gif_frame` decodes one GIF frame's LZW data into its rectangle of a canvas
(interlaced or not), as Pillow's GIF decoder writes it; `tiff_unpack` gives
the bytes of one TIFF strip or tile compressed with LZW (libtiff's early
change) or PackBits, and `thunder_unpack` of one ThunderScan strip.
`rle_rows` runs one of the raster loops (`LOOPS`: PSD's PackBits, Targa,
PCX, SGI and Sun raster RLE, QOI) and gives its rows in file order as
Pillow's decoder fills them.  Data that
ends before the frame is complete, and codes no encoder writes, raise
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

SOURCE = Path(__file__).resolve().parents[1] / "native" / "lzw.cpp"

# the raster loops: C entry -> its arguments between (data, size) and (out, err)
LOOPS = {"packbits_rows_decode": ("size", "size"),          # row bytes, rows
         "tga_rle_decode": ("int", "size", "size"),          # pixel bytes, row bytes, rows
         "pcx_rle_decode": ("size", "size"),
         "sgi_rle_decode": ("int", "int", "int", "int"),     # xsize, rows, bands, bytes
         "sun_rle_decode": ("size", "size"),
         "qoi_decode": ("size", "int")}                      # pixels, bands
_CTYPE = {"int": ctypes.c_int, "size": ctypes.c_size_t}
_state: dict = {}
_ERR = 256
_U8P = ctypes.POINTER(ctypes.c_uint8)
_SIGNATURES = {
    "gif_lzw_decode": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, _U8P, ctypes.c_int,
                                      ctypes.c_char_p, ctypes.c_int]),
    "tiff_unpack": (ctypes.c_int, [ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t, _U8P,
                                   ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
                                   ctypes.c_char_p, ctypes.c_int]),
    "thunder_decode": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
                                      _U8P, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_int]),
    **{fn: (ctypes.c_int, [ctypes.c_char_p, ctypes.c_size_t] + [_CTYPE[a] for a in args]
            + [_U8P, ctypes.c_char_p, ctypes.c_int]) for fn, args in LOOPS.items()}}


def load_library() -> ctypes.CDLL:
    """The loaded decoders, built on first use; a failed build is raised
    again on every later call without compiling again."""
    return load_shared(_state, SOURCE, "lzw_decoder", "the LZW decoders", _SIGNATURES)


def gif_frame(data: bytes, bits: int, canvas: np.ndarray, x0: int, y0: int, w: int, h: int,
              interlace: bool, name: str = "<bytes>") -> None:
    """Decode a frame's LZW sub-blocks (`data`, from the byte after the
    minimum code size `bits`) into canvas[y0:y0 + h, x0:x0 + w] in place."""
    if not (canvas.dtype == np.uint8 and canvas.flags.c_contiguous and canvas.ndim == 2
            and 0 <= x0 and x0 + w <= canvas.shape[1] and 0 <= y0 and y0 + h <= canvas.shape[0]):
        raise ValueError(f"{name}: the frame does not lie on the canvas")
    lib = load_library()
    err = ctypes.create_string_buffer(_ERR)
    at = canvas.ctypes.data + y0 * canvas.shape[1] + x0
    if lib.gif_lzw_decode(bytes(data), len(data), bits, w, h, int(interlace),
                          ctypes.cast(at, ctypes.POINTER(ctypes.c_uint8)), canvas.shape[1],
                          err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")


def tiff_unpack(compression: int, data: bytes, size: int, name: str = "<bytes>") -> bytes:
    """Up to `size` bytes of one LZW (5) or PackBits (32773) strip or tile."""
    lib = load_library()
    out = np.zeros(size, np.uint8)
    got = ctypes.c_size_t()
    err = ctypes.create_string_buffer(_ERR)
    if lib.tiff_unpack(compression, bytes(data), len(data),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size,
                       ctypes.byref(got), err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out[:got.value].tobytes()


def thunder_unpack(data: bytes, width: int, rows: int, name: str = "<bytes>") -> bytes:
    """`rows` rows of `width` 4-bit pixels of one ThunderScan (32809) strip."""
    lib = load_library()
    out = np.zeros(rows * ((width + 1) // 2), np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if lib.thunder_decode(bytes(data), len(data), width, rows,
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size, err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out.tobytes()


def rle_rows(loop: str, data: bytes, size: int, *args: int, name: str = "<bytes>") -> np.ndarray:
    """The `size` output bytes of one raster loop (`LOOPS`, without the
    `_decode`) over `data`; bytes the loop leaves unwritten are zero."""
    fn = getattr(load_library(), loop + "_decode")
    out = np.zeros(size, np.uint8)
    err = ctypes.create_string_buffer(_ERR)
    if fn(bytes(data), len(data), *args, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
          err, _ERR):
        raise ValueError(f"{name}: {err.value.decode()}")
    return out
