"""SGI images as Pillow 12.1's `SgiImagePlugin` reads them: the header and
verbatim data in numpy, RLE in `native/lzw.cpp` (`sgi_rle_decode`).

`decode_sgi(data)` gives `(pixels, mode, None)` as `np.asarray(Image.open(f))`:
1 channel as "L" (dimension 1 or 2), 3 as "RGB", 4 as "RGBA" (dimension 3),
rows bottom-up; 16-bit samples come out as their high bytes, as Pillow's
"L;16B" / "RGB;16B" give them.  Verbatim data is planar (a plane per
channel); RLE rows are read through the start and length tables after the
512-byte header, one row buffer kept from row to row as Pillow's decoder
keeps it (a row whose packets end early keeps the rest of the row before;
a row Pillow stops at stays zero, as in Pillow).  Another compression,
dimension or channel count raises `ValueError` where Pillow refuses it.
"""
from __future__ import annotations

import numpy as np

from .lzw import rle_rows
from .raster import NotThisFormat, sized

MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L;16B", (2, 2, 1): "L;16B",
         (1, 3, 3): "RGB", (2, 3, 3): "RGB;16B", (1, 3, 4): "RGBA", (2, 3, 4): "RGBA;16B"}
HEADER = 512


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and int.from_bytes(prefix[:2], "big") == 474


def decode_sgi(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, None) of an SGI image as Pillow opens it."""
    if len(data) < 12:
        raise NotThisFormat("not an SGI image file")
    compression, bpc = data[2], data[3]
    dim, w, h, z = (int.from_bytes(data[i:i + 2], "big") for i in (4, 6, 8, 10))
    rawmode = MODES.get((bpc, dim, z))
    if rawmode is None:
        raise ValueError(f"{name}: unsupported SGI image mode ({bpc} bytes, dimension {dim}, "
                         f"{z} channels)")
    mode = rawmode.split(";")[0]
    sized(w, h, mode)
    bands = len(mode)
    if compression == 0:
        page = w * h * bpc
        planes = []
        for c in range(bands):
            at = HEADER + c * page
            if len(data) - at < page:
                raise ValueError(f"{name}: image file is truncated (SGI data ends early)")
            plane = np.frombuffer(data, ">u2" if bpc == 2 else np.uint8, w * h, at)
            planes.append((plane >> 8 if bpc == 2 else plane).astype(np.uint8).reshape(h, w))
        px = np.stack(planes, -1)
    elif compression == 1:
        flat = rle_rows("sgi_rle", data[HEADER:], w * h * bands * bpc, w, h, bands, bpc,
                        name=name)
        px = flat.reshape(h, w, bands, bpc)[..., 0]
    else:
        raise ValueError(f"{name}: cannot load this image (SGI compression {compression})")
    px = px[::-1]
    return np.ascontiguousarray(px[..., 0] if bands == 1 else px), mode, None
