"""A small raster of PIL's `ImageDraw` for the layout drawings, on a uint8
[H, W, 3] array in place.

`rectangle(img, xy, outline, width)` follows Pillow's outline rectangle
(`libImaging/Draw.c` ImagingDrawRectangle, coordinates truncated to int,
inclusive corners): the same pixels.  `ellipse(img, xy, outline=...,
width=...)` and `ellipse(img, xy, fill=...)` mark the pixels whose centres
fall in the ellipse inscribed in the box (or in its ring of `width`);
Pillow's own scan conversion differs on some boundary pixels.  `text(img,
xy, s, fill)` draws from the 6 x 11 bitmap font below: the glyphs of
Pillow's built-in bitmap font (`ImageFont.load_default_imagefont`, HPND
licence), one per printable ASCII character, each row six bits in the
base-64 alphabet; other characters draw as '?'.  Pillow's default font is
FreeType-rendered and is not carried over (ROADMAP C).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

_B64 = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
FONT_W, FONT_H = 6, 11
_GLYPHS = (
    "AAAAAAAAAAAAAAYYYYAYAAAAAUUUAAAAAAAUU+UU+UUAAIey8eG28IAAA4q8IeqOAAAAAcwY+s+AAAAMIQAAAAAA"
    "AAEIYYYYIEAAAQIMMMMIQAAAI8YkAAAAAAAAII+IIAAAAAAAAAAAMIQAAAAA+AAAAAAAAAAAAAYAAAACCEEIIQQA"
    "AAc22222cAAAAM8MMMM/AAAAc2GMY2+AAAAc2GcG2cAAAAGOW2/GGAAAA+w82Gm8AAAAc2w822cAAAA+2GMMYYAA"
    "AAc22c22cAAAAc22eG2cAAAAAAAYAAYAAAAAAAYAAYQgAAAMYwYMAAAAAAA8A8AAAAAAAYMGMYAAAAAAcmMYAYAA"
    "AAcymqqnwcAAAA8cU+23AAAAA828228AAAAAe2ww2cAAAAA822228AAAAA+w8w2+AAAAA+w8ww4AAAAAc2w+2eAA"
    "AAA32+223AAAAA8YYYY8AAAAAeMMss4AAAAA204827AAAAA4www2+AAAAAi22+qqAAAAA36622yAAAAAc2222cAA"
    "AAA8228w4AAAAAc2222cGAAAA822827AAAAAey8Om8AAAAA+aYYY8AAAAA32222cAAAAA32UccIAAAAArqq+cUAA"
    "AAAzeMMezAAAAAzzeMMeAAAAA+2MY2+AAAAcYYYYYYcAAAggQQIIEEAAAcMMMMMMcAAAIc2AAAAAAAAAAAAAAAA/"
    "AAYIEAAAAAAAAAAc2e2/AAAAww82228AAAAAAc2w2cAAAAOGe222fAAAAAAc2+weAAAAOY+YYY+AAAAAAb222eG8"
    "AAww82222AAAAMA8MMM/AAAAMA8MMMMM4AAww28483AAAA8MMMMM/AAAAAA8+qqqAAAAAAs2222AAAAAAc222cAA"
    "AAAA82228w4AAAAb222eGPAAAA3dYY8AAAAAAe4eH+AAAAYY+YYbOAAAAAA2222fAAAAAA22ccIAAAAAArq+eUAA"
    "AAAA7eMe3AAAAAA322UcYwAAAA+sY2+AAAAGMMYMMMGAAAAIIIIIIIAAAwYYMYYYwAAAAAasAAAAA"
)
_FONT = None


def _font() -> np.ndarray:
    """[95, 11, 6] bool glyphs of ASCII 32-126."""
    global _FONT
    if _FONT is None:
        bits = np.array([_B64.index(c) for c in _GLYPHS], np.uint8).reshape(95, FONT_H)
        _FONT = ((bits[..., None] >> np.arange(FONT_W - 1, -1, -1)) & 1).astype(bool)
    return _FONT


Color = Tuple[int, int, int]


def _paint(img: np.ndarray, mask: np.ndarray, x0: int, y0: int, color: Color) -> None:
    """Set img[y0:y0+h, x0:x0+w][mask] = color, clipped to the image."""
    h, w = mask.shape
    H, W = img.shape[:2]
    ys, xs = max(0, -y0), max(0, -x0)
    ye, xe = min(h, H - y0), min(w, W - x0)
    if ye <= ys or xe <= xs:
        return
    region = img[y0 + ys:y0 + ye, x0 + xs:x0 + xe]
    region[mask[ys:ye, xs:xe]] = color


def rectangle(img: np.ndarray, xy: Sequence[float], outline: Color, width: int = 1) -> None:
    """`draw.rectangle(xy, outline=outline, width=width)`: per ring i < width
    the rows y0 + i and y1 - i over [x0, x1] and the columns x0 + i and
    x1 - i from y0 + width towards y1 - width + 1 (excluded), as
    ImagingDrawRectangle."""
    x0, y0, x1, y1 = (int(v) for v in xy)
    if y0 > y1:
        y0, y1 = y1, y0
    H, W = img.shape[:2]
    width = max(width, 1)

    def hline(y, xa, xb):
        if 0 <= y < H:
            xa, xb = max(min(xa, xb), 0), min(max(xa, xb), W - 1)
            if xa <= xb:
                img[y, xa:xb + 1] = outline

    def vline(x, ya, yb):      # Pillow's vertical line8: from ya towards yb, yb excluded
        if 0 <= x < W:
            ya, yb = (ya, yb) if ya <= yb else (yb + 1, ya + 1)
            ya, yb = max(ya, 0), min(yb, H)
            if ya < yb:
                img[ya:yb, x] = outline

    for i in range(width):
        hline(y0 + i, x0, x1)
        hline(y1 - i, x0, x1)
        vline(x1 - i, y0 + width, y1 - width + 1)
        vline(x0 + i, y0 + width, y1 - width + 1)


def ellipse(img: np.ndarray, xy: Sequence[float], outline: Optional[Color] = None,
            fill: Optional[Color] = None, width: int = 1) -> None:
    """`draw.ellipse(xy, outline=..., fill=..., width=...)`: the pixels of
    the ellipse inscribed in [x0, x1] x [y0, y1] (inclusive), or of its ring
    of `width` pixels."""
    x0, y0, x1, y1 = (int(v) for v in xy)
    cx, cy = (x0 + x1 + 1) / 2.0, (y0 + y1 + 1) / 2.0
    a, b = (x1 - x0 + 1) / 2.0, (y1 - y0 + 1) / 2.0
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1]
    dx, dy = xs + 0.5 - cx, ys + 0.5 - cy
    inside = (dx / a) ** 2 + (dy / b) ** 2 <= 1.0
    if fill is not None:
        _paint(img, inside, x0, y0, fill)
    if outline is not None:
        ai, bi = a - width, b - width
        if ai > 0 and bi > 0:
            inside = inside & ((dx / ai) ** 2 + (dy / bi) ** 2 >= 1.0)
        _paint(img, inside, x0, y0, outline)


def text_size(s: str) -> Tuple[int, int]:
    """(width, height) in pixels of `s` in the bitmap font."""
    return FONT_W * len(s), FONT_H


def text(img: np.ndarray, xy: Sequence[float], s: str, fill: Color) -> None:
    """`draw.text(xy, s, fill=fill)` in the bitmap font."""
    font = _font()
    x, y = int(xy[0]), int(xy[1])
    for i, ch in enumerate(s):
        code = ord(ch)
        glyph = font[code - 32 if 32 <= code <= 126 else ord("?") - 32]
        _paint(img, glyph, x + FONT_W * i, y, fill)
