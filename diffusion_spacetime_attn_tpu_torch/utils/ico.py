"""Windows icons (ICO) and cursors (CUR) as Pillow 12.1's `IcoImagePlugin`
and `CurImagePlugin` open them, over `utils/png.py` and `utils/bmp.py`.

`decode_ico(data)` gives `(pixels, mode, palette)` of the entry `IcoFile`
puts first: the directory sorted by colour depth (bits per pixel, else
from the colour count, else 256), then by area, largest first, each sort
stable.  A PNG entry is that PNG in its own mode (a PNG whose size is not
the directory's raises where Pillow warns); a bitmap entry is the lower
half of its stored height (`bmp.decode_dib`) converted to "RGBA" with the
AND mask (rows padded to 32 bits, read back from the entry's end) as
alpha, 0 where the mask bit is set, or with every fourth byte of the
pixel data as alpha for a 32-bit entry, as Pillow applies them.

`decode_cur(data)` reads the cursor `CurImageFile` picks (the first one
both wider and taller than every earlier pick) as a plain bitmap of half
its stored height with no mask: "RGBA" where a 32-bit bitmap's header
sits at byte 22, as Pillow's special case reads it, its own mode
otherwise.
"""
from __future__ import annotations

import math

import numpy as np

from .bmp import decode_dib
from .png import decode_picture
from .raster import NotThisFormat, unpack, unpack_from

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"\0\0\1\0"


def accept_cur(prefix: bytes) -> bool:
    return prefix[:4] == b"\0\0\2\0"


def _rgba(px: np.ndarray, mode: str, pal) -> np.ndarray:
    """`Image.convert("RGBA")` of a bitmap's pixels."""
    if mode == "P":
        rgb = pal[px]
    elif mode == "1":
        rgb = np.repeat(px.view(np.uint8)[..., None], 3, -1)
    elif mode == "L":
        rgb = np.repeat(px[..., None], 3, -1)
    else:
        rgb = px[..., :3]
    return np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)


def decode_ico(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, palette) of an icon's first entry, as Pillow opens it."""
    (count,) = unpack_from("<H", data, 4)
    entries = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise NotThisFormat("truncated icon directory")
        width, height, nb_color = s[0] or 256, s[1] or 256, s[2]
        planes, bpp, size, offset = unpack_from("<HHII", s, 4)
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        entries.append((width, height, bpp, size, offset, depth))
    if not entries:
        raise NotThisFormat("an icon of no entries")
    entries.sort(key=lambda e: e[5])
    entries.sort(key=lambda e: e[0] * e[1], reverse=True)
    width, height, bpp, size, offset, _ = entries[0]
    if data[offset:offset + 8] == PNG_MAGIC:
        px, mode, pal = decode_picture(data[offset:], name)
        if (px.shape[1], px.shape[0]) != (width, height):
            raise ValueError(f"{name}: an icon's PNG of {px.shape[1]}x{px.shape[0]} where the "
                             f"directory says {width}x{height} (Pillow warns)")
        return px, mode, pal
    px, mode, pal, at = decode_dib(data, name, offset, half="ico", with_offset=True)
    h, w = px.shape[:2]
    if bpp == 32:
        alpha = data[at:at + w * h * 4][3::4]
        if len(alpha) < w * h:
            raise ValueError(f"{name}: not enough image data (an icon's alpha)")
        mask = np.frombuffer(alpha, np.uint8, w * h).reshape(h, w)[::-1]
    else:
        padded = w + (-w) % 32
        total = padded * h // 8
        start = offset + size - total
        if start < 0:
            raise ValueError(f"{name}: an icon's mask before the start of the file")
        raw = data[start:start + total]
        if len(raw) < total:
            raise ValueError(f"{name}: not enough image data (an icon's mask)")
        rows = np.frombuffer(raw, np.uint8).reshape(h, padded // 8)[::-1]
        mask = unpack(np.ascontiguousarray(rows), "1;I", w).view(np.uint8)
    out = _rgba(px, mode, pal)
    out[..., 3] = mask
    return out, "RGBA", None


def decode_cur(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, palette) of the cursor Pillow picks, as it opens it."""
    (count,) = unpack_from("<H", data, 4)
    pick = b""
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if not pick:
            pick = s
            continue
        try:
            if s[0] > pick[0] and s[1] > pick[1]:
                pick = s
        except IndexError as e:
            raise NotThisFormat("truncated cursor directory") from e
    if not pick:
        raise NotThisFormat("no cursors were found")
    (header,) = unpack_from("<I", pick, 12)
    at = header if header else min(6 + 16 * count, len(data))
    return decode_dib(data, name, at, cursor=header == 22, half="cur")
