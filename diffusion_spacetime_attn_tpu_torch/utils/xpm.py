"""X11 pixmaps (XPM) as Pillow 12.1's `XpmImagePlugin` reads them, in Python
and numpy.

`decode_xpm(data)` gives `(pixels, mode, palette)`: the values line
`"w h ncolors cpp`, then one colour line per colour, of which Pillow reads
the `c` key as `#RRGGBB` or `None` (transparency: such pixels are not in
Pillow's palette, so a file that uses them is refused, as Pillow refuses
it; a colour name is refused too); "P" over the colours in file order for
at most 256 colours, "RGB" above that; the pixels from every quoted string
after the colours (a `/* pixels */` line skipped once).  `#RGB` and
`#RRRRGGGGBBBB` are X11 colours that Pillow reads as one number cut into
bytes: the port raises naming ROADMAP A.12.
"""
from __future__ import annotations

import re

import numpy as np

from .raster import NotThisFormat, Stream, palette, sized
from .xbm import HEX

XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def accept(prefix: bytes) -> bool:
    return prefix[:9] == b"/* XPM */"


def decode_xpm(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, palette) of an X11 pixmap as Pillow opens it."""
    f = Stream(data)
    if not accept(f.read(9)):
        raise NotThisFormat("not an XPM file")
    while True:
        line = f.readline()
        if not line:
            raise NotThisFormat("broken XPM file")
        m = XPM_HEAD.match(line)
        if m:
            break
    try:
        w, h, ncolors, cpp = (int(g) for g in m.groups())
    except ValueError as e:
        raise ValueError(f"{name}: bad XPM values line") from e
    colours, transparent = {}, []
    for _ in range(ncolors):
        line = f.readline().rstrip()
        key, spec = line[1:cpp + 1], line[cpp + 1:-2].split()
        for i in range(0, len(spec), 2):
            if spec[i] == b"c":
                rgb = spec[i + 1] if i + 1 < len(spec) else None
                if rgb is None:
                    raise NotThisFormat("an XPM colour key without a value")
                if rgb == b"None":
                    transparent.append(key)
                elif rgb.startswith(b"#"):
                    digits = rgb[1:]
                    if len(digits) in (3, 9, 12) and all(c in HEX for c in digits):
                        raise ValueError(f"{name}: the XPM colour {rgb.decode()} is an X11 colour "
                                         "that Pillow misreads (ROADMAP A.12)")
                    try:
                        v = int(digits, 16)
                    except ValueError as e:
                        raise ValueError(f"{name}: bad XPM colour {rgb!r}") from e
                    colours[key] = ((v >> 16) & 255, (v >> 8) & 255, v & 255)
                else:
                    raise ValueError(f"{name}: cannot read the XPM colour {rgb!r} (Pillow "
                                     "reads #RRGGBB and None only)")
                break
        else:
            raise ValueError(f"{name}: an XPM colour without a 'c' key")
    mode = "RGB" if ncolors > 256 else "P"
    sized(w, h, mode)
    keys = list(colours)
    index = {k: i for i, k in enumerate(keys)}
    need = w * h * (3 if mode == "RGB" else 1)
    out = bytearray()
    header = False
    while len(out) < need:
        line = f.readline()
        if not line:
            break
        if line.rstrip() == b"/* pixels */" and not header:
            header = True
            continue
        line = b'"'.join(line.split(b'"')[1:-1])
        if cpp <= 0 and line:
            raise ValueError(f"{name}: XPM of {cpp} characters a pixel")
        for i in range(0, len(line), max(cpp, 1)):
            key = line[i:i + cpp]
            if key not in colours:
                raise ValueError(f"{name}: the XPM pixel {key!r} has no colour Pillow reads"
                                 + (" (transparent)" if key in transparent else ""))
            out += bytes(colours[key]) if mode == "RGB" else bytes([index[key]])
    if len(out) < need:
        raise ValueError(f"{name}: not enough image data")
    if mode == "RGB":
        return np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w, 3).copy(), mode, None
    pal = palette(np.asarray(list(colours.values()), np.uint8).reshape(-1, 3))
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(h, w).copy(), mode, pal
