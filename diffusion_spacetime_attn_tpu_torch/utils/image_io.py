"""Open an image file without an imaging library, as Pillow 12.1 opens and
converts it.

`read_image(data)` routes by magic bytes: PNG (every bit depth and colour
type, Adam7) through `utils/png.decode_picture`, JPEG (baseline, extended,
progressive, arithmetic-coded and lossless; greyscale, YCbCr, RGB-coded,
CMYK and YCCK) through the port's codec (`utils/jpeg.py`), BMP through
`utils/bmp.py`, WebP (lossy, lossless, alpha, the first frame of an
animation) through `utils/webp.py`, GIF (the first frame) through
`utils/gif.py` and TIFF (the first page; every coding, depth and sample
format Pillow reads, orientation applied) through `utils/tiff.py`.  It
gives a `Picture`: `pixels` equals `np.asarray(Image.open(f))`, `mode` is
its mode ("1", "L", "LA", "P", "PA", "I;16", "I;16B", "I", "F", "RGB",
"RGBA", "CMYK", "LAB") and `palette` a "P" or "PA" image's [256, 3]
palette.

`convert(picture, mode)` is Pillow's `convert("RGB")` / `convert("L")` in
its integer arithmetic: alpha dropped, grey repeated, "1" as 0 / 255, a
palette looked up ("P" and "PA"), 16-bit grey clipped to 255, 32-bit
integers ("I") clipped to 0-255, floats ("F") clipped and truncated
(−5.5, 127.6 and 300.2 give 0, 127 and 255; NaN 0), CMYK as (255 − K) −
(C·(255 − K))/255 with Pillow's rounded division, luma (19595·R + 38470·G
+ 7471·B + 2¹⁵) >> 16 from the RGB.  "LAB" raises `ValueError`: Pillow
converts it to RGB through LittleCMS (ImageCms, Lab D50 to sRGB), which
the port does not reproduce (ROADMAP A.12), and refuses it to "L".
`open_image(path, mode)` reads a file and converts it.  Other formats, and
the codings of these formats that Pillow reads and the port does not,
raise `ValueError` naming ROADMAP A.12; corrupt files raise `ValueError`
too, where Pillow refuses them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .bmp import decode_bmp
from .gif import decode_gif
from .jpeg import decode_jpeg
from .png import decode_picture, to_grey, to_rgb
from .tiff import decode_tiff
from .webp import decode_webp


class Picture(NamedTuple):
    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None


def read_image(data: bytes, name: str = "<bytes>") -> Picture:
    """The pixels and mode `Image.open` gives for a PNG, JPEG, BMP, WebP, GIF
    or TIFF file."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return Picture(*decode_picture(data, name))
    if data[:2] == b"\xff\xd8":
        img = decode_jpeg(data, name)
        return Picture(img, "L" if img.ndim == 2 else {3: "RGB", 4: "CMYK"}[img.shape[-1]])
    if data[:2] == b"BM":
        return Picture(*decode_bmp(data, name))
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        img = decode_webp(data, name)
        return Picture(img, "RGBA" if img.shape[-1] == 4 else "RGB")
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return Picture(*decode_gif(data, name))
    if data[:2] in (b"II", b"MM") and data[2:4] in (b"*\x00", b"\x00*", b"+\x00", b"\x00+"):
        return Picture(*decode_tiff(data, name))
    raise ValueError(f"{name}: not an image file the port reads (PNG, JPEG, BMP, WebP, GIF, "
                     "TIFF; ROADMAP A.12)")


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
    if pic.mode == mode:                              # Pillow copies the image as it is
        return px.copy()
    if pic.mode == "1":
        px = px.astype(np.uint8) * 255
        return np.repeat(px[..., None], 3, -1) if mode == "RGB" else px
    if pic.mode in ("I;16", "I;16B", "I", "F"):      # Convert.c I16_L, i2l, f2l: clipped
        v = np.nan_to_num(px, nan=0.0) if pic.mode == "F" else px
        grey = np.clip(v, 0, 255).astype(np.uint8)
        return np.repeat(grey[..., None], 3, -1) if mode == "RGB" else grey
    if pic.mode == "LAB":
        raise ValueError(f"conversion of an L*a*b* image to {mode!r}: Pillow converts it to "
                         "RGB through LittleCMS, which the port does not reproduce, and refuses "
                         "it to 'L' (ROADMAP A.12)")
    if pic.mode in ("P", "PA") or pic.palette is not None:
        rgb = pic.palette[px[..., 0] if pic.mode == "PA" else px]
    elif pic.mode == "CMYK":
        rgb = _cmyk_rgb(px)
    else:
        img = px[..., None] if px.ndim == 2 else px
        return to_rgb(img) if mode == "RGB" else to_grey(img)
    return rgb if mode == "RGB" else to_grey(rgb)


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An image's pixels as `read_image` gives them, as [H, W, C]: 8-bit
    grey, grey + alpha, RGB, RGBA, CMYK and L*a*b* as they are; "1", "P",
    "PA", 16-bit grey and 32-bit integer and float grey converted to RGB (a
    palette looked up, "1" as 0 / 255, the rest clipped to 0-255)."""
    pic = read_image(data, name)
    if pic.mode in ("1", "P", "PA", "I;16", "I;16B", "I", "F"):
        return convert(pic, "RGB")
    return pic.pixels[..., None] if pic.pixels.ndim == 2 else pic.pixels


def open_image(path: str, mode: Optional[str] = "RGB") -> np.ndarray:
    """`np.asarray(Image.open(path).convert(mode))`: uint8 [H, W, 3] for
    "RGB", [H, W] for "L", the file's own channels ([H, W, C],
    `decode_image`) for None."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image(data, path) if mode is None else convert(read_image(data, path), mode)
