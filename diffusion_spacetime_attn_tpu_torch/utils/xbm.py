"""X11 bitmaps (XBM) as Pillow 12.1's `XbmImagePlugin` reads them, in Python
and numpy.

`decode_xbm(data)` gives `(pixels, "1", None)`: the header (`#define
<name>_width`, `_height`, an optional hot spot, then the last `_bits[]`
within the first 512 bytes) matched with Pillow's own expression, then
one byte per `x` found in the data (the two characters after it read as
hex digits), rows of (width + 7) // 8 bytes, bits least significant first,
a set bit white (True), as Pillow gives it.  A value of one hex digit
(`0x5`, which Pillow reads as 0x50) or of more than two (X10's 16-bit
`0x1234`) is read differently from the format's C syntax by Pillow, and
the port raises naming ROADMAP A.12.
"""
from __future__ import annotations

import re

import numpy as np

from .raster import NotThisFormat, sized, unpack

XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]"
)
HEX = b"0123456789abcdefABCDEF"


def accept(prefix: bytes) -> bool:
    return prefix.lstrip().startswith(b"#define")


def decode_xbm(data: bytes, name: str = "<bytes>"):
    """(pixels, "1", None) of an X11 bitmap as Pillow opens it."""
    m = XBM_HEAD.match(data[:512])
    if not m:
        raise NotThisFormat("not an XBM file")
    w, h = int(m.group("width")), int(m.group("height"))
    sized(w, h)
    stride = (w + 7) // 8
    need, pos = stride * h, m.end()
    out = bytearray(need)
    for i in range(need):
        pos = data.find(b"x", pos)
        if pos < 0 or pos + 3 > len(data):
            raise ValueError(f"{name}: image file is truncated (XBM data ends early)")
        digits = data[pos + 1:pos + 3]
        if (any(c not in HEX for c in digits)
                or (pos + 3 < len(data) and data[pos + 3] in HEX)):
            raise ValueError(f"{name}: an XBM value {data[pos - 1:pos + 5]!r} that is not two "
                             "hex digits, which Pillow misreads (ROADMAP A.12)")
        out[i] = int(digits, 16)
        pos += 3
    rows = np.frombuffer(bytes(out), np.uint8).reshape(h, stride)
    return unpack(rows, "1;R", w), "1", None
