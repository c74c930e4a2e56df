"""ctypes binding of the port's block-compressed texture decoders
(`native/bcn.cpp`), which `utils/dds.py`, `utils/blp.py` and `utils/ftex.py`
use.

`decode(data, n, width, height)` gives the pixels Pillow 12.1's "bcn"
decoder writes for BCn `n` (1-7) with the pixel format Pillow passes
(`pixel_format` "BC5S" or "BC6HS": signed), as
`np.asarray(Image.frombytes(mode, size, data, "bcn", (n, pixel_format)))`:
[H, W, 4] for BC1, BC2, BC3 and BC7 (RGBA), [H, W] for BC4 (L), [H, W, 3]
for BC5 and BC6H (RGB); partial blocks at a right or bottom edge are cut
off.  `blp=True` gives what BLP2's Python DXT1 / DXT3 / DXT5 decoders
give instead (5-6-5 expanded by shifting alone; DXT1 without `alpha`:
RGB).  Data that ends before the last block raises `ValueError`, as
Pillow's decoder stops with "image file is truncated".  Where Pillow reads
a signed BC6H block against the specification (`native/bcn.cpp`), `decode`
raises naming ROADMAP A.12 unless `strict=False`.

The source is compiled at first use with g++ into the package's `_build/`
(`utils/native_bpe.load_shared`), as the JPEG codec is; a failed build
raises `NativeBuildError`, and there is no Python fallback.  Nothing is
built when this module is imported.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from .native_bpe import load_shared

SOURCE = Path(__file__).resolve().parents[1] / "native" / "bcn.cpp"
# the image mode Pillow's "bcn" decoder writes for each n
MODES = {1: "RGBA", 2: "RGBA", 3: "RGBA", 4: "L", 5: "RGB", 6: "RGB", 7: "RGBA"}

_state: dict = {}
_ERR = 256
_SIGNATURES = {"bcn_decode": (ctypes.c_int, [
    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int])}


def load_library() -> ctypes.CDLL:
    """The loaded decoders, built on first use; a failed build is raised
    again on every later call without compiling again."""
    return load_shared(_state, SOURCE, "bcn_decoder", "the BCn decoders", _SIGNATURES)


def block_bytes(n: int) -> int:
    """Bytes per 4x4 block: 8 for BC1 and BC4, 16 for the rest."""
    return 8 if n in (1, 4) else 16


def decode(data: bytes, n: int, width: int, height: int, pixel_format: str = "",
           blp: bool = False, alpha: bool = True, strict: bool = True,
           name: str = "<bytes>") -> np.ndarray:
    """`width` x `height` pixels of BCn `n` from the blocks in `data`."""
    blocks = ((width + 3) // 4) * ((height + 3) // 4)
    if len(data) < blocks * block_bytes(n):      # before the image is allocated
        raise ValueError(f"{name}: image file is truncated (BC{n} data of {len(data)} bytes "
                         f"for {blocks} blocks)")
    lib = load_library()
    channels = len(MODES[n]) if not (blp and n == 1 and not alpha) else 3
    out = np.zeros((height, width, channels), np.uint8)
    flags = (pixel_format in ("BC5S", "BC6HS")) | 2 * blp | 4 * strict
    err = ctypes.create_string_buffer(_ERR)
    rc = lib.bcn_decode(bytes(data), len(data), n, flags, width, height, channels,
                        out.ctypes.data, err, _ERR)
    if rc == 2:
        raise ValueError(f"{name}: Pillow misreads it: {err.value.decode()} (ROADMAP A.12)")
    if rc:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out[..., 0] if channels == 1 else out
