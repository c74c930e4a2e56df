"""Open an image file without an imaging library, as Pillow 12.1 opens and
converts it.

`read_image(data)` routes by magic bytes: PNG through `utils/png.decode_png`,
JPEG (baseline, extended and progressive; greyscale, YCbCr, RGB-coded, CMYK
and YCCK) through the port's codec (`utils/jpeg.py`), BMP through
`utils/bmp.py` and WebP (lossy, lossless, alpha, the first frame of an
animation) through `utils/webp.py`.  It gives a `Picture`: `pixels` equals
`np.asarray(Image.open(f))`, `mode` is its mode ("1", "L", "LA", "P",
"RGB", "RGBA", "CMYK") and `palette` a "P" image's [256, 3] palette.

`convert(picture, mode)` is Pillow's `convert("RGB")` / `convert("L")` in
its integer arithmetic: alpha dropped, grey repeated, "1" as 0 / 255, a
palette looked up, CMYK as (255 − K) − (C·(255 − K))/255 with Pillow's
rounded division, luma (19595·R + 38470·G + 7471·B + 2¹⁵) >> 16 from the
RGB.  `open_image(path, mode)` reads a file and converts it.  GIF, TIFF and
other formats raise `ValueError`, naming ROADMAP A.12; so do corrupt files,
where Pillow refuses them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .bmp import decode_bmp
from .jpeg import decode_jpeg
from .png import decode_png, to_grey, to_rgb
from .webp import decode_webp

_OTHER = {b"GIF8": "GIF", b"II*\x00": "TIFF", b"MM\x00*": "TIFF"}
_PNG_MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


class Picture(NamedTuple):
    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None


def read_image(data: bytes, name: str = "<bytes>") -> Picture:
    """The pixels and mode `Image.open` gives for a PNG, JPEG, BMP or WebP file."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        img = decode_png(data, name)
        return Picture(img[..., 0] if img.shape[-1] == 1 else img, _PNG_MODES[img.shape[-1]])
    if data[:2] == b"\xff\xd8":
        img = decode_jpeg(data, name)
        return Picture(img, "L" if img.ndim == 2 else {3: "RGB", 4: "CMYK"}[img.shape[-1]])
    if data[:2] == b"BM":
        return Picture(*decode_bmp(data, name))
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        img = decode_webp(data, name)
        return Picture(img, "RGBA" if img.shape[-1] == 4 else "RGB")
    kind = next((k for magic, k in _OTHER.items() if data.startswith(magic)), "unknown")
    raise ValueError(f"{name}: a {kind} file; the port reads PNG, JPEG, BMP and WebP "
                     "(ROADMAP A.12)")


def _cmyk_rgb(px: np.ndarray) -> np.ndarray:
    """Convert.c cmyk2rgb: nk − MULDIV255(c, nk) per channel, nk = 255 − K."""
    nk = 255 - px[..., 3:].astype(np.int32)
    t = px[..., :3].astype(np.int32) * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def convert(pic: Picture, mode: str) -> np.ndarray:
    """`np.asarray(image.convert(mode))` for mode "RGB" or "L"."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"mode {mode!r}: 'RGB' or 'L'")
    px = pic.pixels
    if pic.mode == "1":
        px = px.astype(np.uint8) * 255
        return np.repeat(px[..., None], 3, -1) if mode == "RGB" else px
    if pic.mode == "P":
        rgb = pic.palette[px]
    elif pic.mode == "CMYK":
        rgb = _cmyk_rgb(px)
    else:
        img = px[..., None] if px.ndim == 2 else px
        return to_rgb(img) if mode == "RGB" else to_grey(img)
    return rgb if mode == "RGB" else to_grey(rgb)


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's or JPEG's pixels as the file holds them: [H, W, 1-4] for a
    PNG, [H, W, 1], [H, W, 3] or [H, W, 4] (CMYK) for a JPEG; a BMP or WebP
    file's [H, W, C] after `read_image` (a palette looked up, "1" as 0 / 255)."""
    pic = read_image(data, name)
    if pic.mode in ("1", "P"):
        return convert(pic, "RGB")
    return pic.pixels[..., None] if pic.pixels.ndim == 2 else pic.pixels


def open_image(path: str, mode: Optional[str] = "RGB") -> np.ndarray:
    """`np.asarray(Image.open(path).convert(mode))`: uint8 [H, W, 3] for
    "RGB", [H, W] for "L", the file's own channels ([H, W, C],
    `decode_image`) for None."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image(data, path) if mode is None else convert(read_image(data, path), mode)
