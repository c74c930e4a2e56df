"""QOI ("Quite OK Image") as Pillow 12.1's `QoiImagePlugin` reads it: the
header in Python, the op stream in `native/lzw.cpp` (`qoi_decode`).

`decode_qoi(data)` gives `(pixels, mode, None)` as `np.asarray(Image.open(f))`:
"RGB" for 3 channels, "RGBA" for any other count; the colour space byte is
not read.  The ops are QOI's (RGB, RGBA, INDEX, DIFF, LUMA, RUN over a
previous pixel that starts opaque black and an index of 64 pixels that
starts zero); a 3-channel file's RGBA ops still set the alpha that the
index hashes, as Pillow's decoder keeps it.  The end marker is not
checked; data that ends before the last pixel raises `ValueError`.
"""
from __future__ import annotations

from .lzw import rle_rows
from .raster import NotThisFormat, sized


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"qoif"


def decode_qoi(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, None) of a QOI file as Pillow opens it."""
    if len(data) < 13:
        raise NotThisFormat("not a QOI file")
    w, h = int.from_bytes(data[4:8], "big"), int.from_bytes(data[8:12], "big")
    mode = "RGB" if data[12] == 3 else "RGBA"
    sized(w, h, mode)
    bands = len(mode)
    px = rle_rows("qoi", data[14:], w * h * bands, w * h, bands, name=name)
    return px.reshape(h, w, bands), mode, None
