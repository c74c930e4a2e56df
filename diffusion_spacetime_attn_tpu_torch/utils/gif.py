"""GIF as Pillow 12.1's `GifImagePlugin` opens it: the first frame.

`decode_gif(data)` gives `(pixels, mode, palette)`: `pixels` equals
`np.asarray(Image.open(f))` (uint8 [H, W] palette indices or greys), `mode`
is Pillow's ("P" where the frame has a colour table, "L" where it has none
or its table is the identity ramp 0, 1, 2 ... as grey, which Pillow drops)
and `palette` the "P" frame's table as uint8 [256, 3] (entries the table
does not have are black, as Pillow's convert gives them).  An "L" frame
whose local table is the ramp keeps the global table as its palette:
Pillow's `convert` goes through it.  As Pillow, it

* takes the frame's local colour table before the global one;
* sizes the image to the logical screen, grown to the frame where the frame
  reaches past it;
* fills the pixels outside the frame with the frame's transparency index
  (from its graphic control extension), or 0 where it has none;
* decodes the frame's LZW data (`utils/lzw.py`, C++) in file order or in
  the four interlaced passes.

Files Pillow refuses raise `ValueError` (no GIF signature, no frame, image
data that ends before the frame is complete, codes no encoder writes);
later frames are not read, as `Image.open` does not read them.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from .lzw import gif_frame
from .png import MAX_PIXELS



def _palette_needed(p: bytes) -> bool:
    """Pillow's `_is_palette_needed`: a table other than the grey ramp."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - 2, 3))


def _table(p: bytes) -> np.ndarray:
    pal = np.zeros((256, 3), np.uint8)
    n = min(len(p) // 3, 256)
    pal[:n] = np.frombuffer(p[:3 * n], np.uint8).reshape(n, 3)
    return pal


def decode_gif(data: bytes, name: str = "<bytes>") -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """(pixels, mode, palette) of a GIF file's first frame."""
    if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
        raise ValueError(f"{name}: not a GIF file")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    pos = 13
    global_pal = None
    if flags & 0x80:
        n = 3 << ((flags & 7) + 1)
        p = data[pos:pos + n]
        if len(p) < n:
            raise ValueError(f"{name}: truncated GIF file (global colour table)")
        pos += n
        if _palette_needed(p):
            global_pal = p
    transparency = None

    def skip_blocks(at: int) -> int:
        while True:
            if at >= len(data):
                raise ValueError(f"{name}: truncated GIF file (extension)")
            k = data[at]
            at += 1 + k
            if k == 0:
                return at

    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise ValueError(f"{name}: image not found in GIF frame")
        tag = data[pos]
        pos += 1
        if tag == 0x21:                                   # an extension
            if pos >= len(data):
                raise ValueError(f"{name}: truncated GIF file (extension)")
            label = data[pos]
            pos += 1
            if label == 0xF9 and pos < len(data) and data[pos] >= 4 and pos + 5 <= len(data):
                if data[pos + 1] & 1:
                    transparency = data[pos + 4]
            pos = skip_blocks(pos)
        elif tag == 0x2C:                                 # an image descriptor
            if pos + 9 > len(data):
                raise ValueError(f"{name}: truncated GIF file (image descriptor)")
            x0, y0, fw, fh, lflags = struct.unpack("<HHHHB", data[pos:pos + 9])
            pos += 9
            frame_pal, grey = global_pal, False
            if lflags & 0x80:
                n = 3 << ((lflags & 7) + 1)
                p = data[pos:pos + n]
                if len(p) < n:
                    raise ValueError(f"{name}: truncated GIF file (local colour table)")
                pos += n
                grey = not _palette_needed(p)
                frame_pal = None if grey else p
            if pos >= len(data):
                raise ValueError(f"{name}: truncated GIF file (image data)")
            bits = data[pos]
            pos += 1
            break
        else:                                             # Pillow skips other bytes
            continue
    W, H = max(w, x0 + fw), max(h, y0 + fh)
    if W * H > MAX_PIXELS:
        raise ValueError(f"{name}: GIF of {W}x{H} pixels exceeds Pillow's decompression-bomb "
                         f"limit of {MAX_PIXELS}")
    canvas = np.full((H, W), transparency or 0, np.uint8)
    gif_frame(data[pos:], bits, canvas, x0, y0, fw, fh, bool(lflags & 0x40), name)
    if frame_pal is None:
        # a grey-ramp local table: Pillow's mode is "L", but its image keeps
        # the global table, through which it converts
        return canvas, "L", None if global_pal is None or not grey else _table(global_pal)
    return canvas, "P", _table(frame_pal)
