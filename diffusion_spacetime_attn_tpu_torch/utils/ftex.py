"""FTEX (the texture files of Independence War 2: Edge of Chaos, `.ftc` /
`.ftu`) as Pillow 12.1's `FtexImagePlugin` reads them.

`decode_ftex(data)` gives `(pixels, mode, None)` as
`np.asarray(Image.open(f))` of the first mip: format 0, DXT1 through
`native/bcn.cpp` ("RGBA", `utils/bcn.py`); format 1, raw RGB.  Pillow
reads one format only: another format count (Pillow's `assert`), another
format, a negative mip offset (a file's seek fails) and mip data cut short
raise `ValueError` naming FTEX; a header cut short, or one whose size is
not positive, passes the file on, as Pillow's `struct.error` and size check
do.
"""
from __future__ import annotations

import numpy as np

from . import bcn
from .raster import sized, unpack_from


def decode_ftex(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, None) of an FTEX file as Pillow opens it."""
    _, w, h, _, count = unpack_from("<5i", data, 4)
    if count != 1:
        raise ValueError(f"{name}: FTEX of {count} formats (Pillow 12.1 reads one)")
    fmt, where = unpack_from("<2i", data, 24)
    if where < 0:
        raise ValueError(f"{name}: FTEX mip at byte {where}")
    (size,) = unpack_from("<i", data, where)
    mip = data[where + 4:] if size < 0 else data[where + 4:where + 4 + size]
    if fmt not in (0, 1):
        raise ValueError(f"{name}: FTEX of format {fmt}, which Pillow 12.1 does not read")
    mode = "RGBA" if fmt == 0 else "RGB"
    sized(w, h, mode)
    if fmt == 0:
        return bcn.decode(mip, 1, w, h, name=f"{name} (FTEX)"), mode, None
    if len(mip) < w * h * 3:
        raise ValueError(f"{name}: image file is truncated (FTEX data ends early)")
    return np.frombuffer(mip, np.uint8, w * h * 3).reshape(h, w, 3).copy(), mode, None
