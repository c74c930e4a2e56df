"""Open an image file without an imaging library, as PIL opens and
converts it.

`open_image(path, mode)` reads a file by its magic bytes: PNG through
`utils/png.decode_png`, JPEG through the port's codec (`utils/jpeg.py`);
`mode="RGB"` and `mode="L"` apply PIL's `convert("RGB")` / `convert("L")`
(alpha dropped, grey repeated; ITU-R 601-2 luma in PIL's integer
arithmetic, `utils/png.to_grey`).  WebP, BMP, GIF and other formats raise
`ValueError`, naming ROADMAP A.12.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .jpeg import decode_jpeg
from .png import decode_png, to_grey, to_rgb

_OTHER = {b"RIFF": "WebP", b"BM": "BMP", b"GIF8": "GIF", b"II*\x00": "TIFF", b"MM\x00*": "TIFF"}


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A PNG's or JPEG's pixels as the file holds them: [H, W, 1-4] for a
    PNG, [H, W, 3] or [H, W, 1] for a JPEG."""
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data, name)
    if data[:2] == b"\xff\xd8":
        img = decode_jpeg(data, name)
        return img[..., None] if img.ndim == 2 else img
    kind = next((k for magic, k in _OTHER.items() if data.startswith(magic)), "unknown")
    raise ValueError(f"{name}: a {kind} file; the port reads PNG and baseline JPEG only "
                     "(ROADMAP A.12)")


def open_image(path: str, mode: Optional[str] = "RGB") -> np.ndarray:
    """`np.asarray(Image.open(path).convert(mode))`: uint8 [H, W, 3] for
    "RGB", [H, W] for "L", the file's own channels ([H, W, C]) for None."""
    with open(path, "rb") as f:
        img = decode_image(f.read(), path)
    if mode is None:
        return img
    if mode == "RGB":
        return to_rgb(img)
    if mode == "L":
        return to_grey(img)
    raise ValueError(f"mode {mode!r}: 'RGB', 'L' or None")
