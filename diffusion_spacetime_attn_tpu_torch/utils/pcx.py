"""PCX, and the first page of DCX, as Pillow 12.1's `PcxImagePlugin` and
`DcxImagePlugin` read them: the header in numpy, RLE in `native/lzw.cpp`
(`pcx_rle_decode`).

`decode_pcx(data)` gives `(pixels, mode, palette)` as
`np.asarray(Image.open(f))`:

* 1 bit, 1 plane: "1"; 1 bit, 2 or 4 planes: "P" over the header's
  16-colour palette; 8 bits, 1 plane (version 5): "L", or "P" where the
  256-colour palette after a 12 byte at the file's end is not the grey
  ramp; 8 bits, 3 planes (version 5): "RGB" from three planes a row;
* rows of Pillow's stride ((width · bits + 7) // 8, made even where the
  header's bytes per line differ from it).

Where the header's bytes per line are not that stride, Pillow decodes rows
of the wrong length, and where planes of a padded stride meet Pillow's
unpackers (bit planes at any padding, RGB at widths 1 and 3) it reads the
planes from the wrong offsets: both are read differently from the format's
specification, and the port raises naming ROADMAP A.12.  An 8-bit file
shorter than 769 bytes raises, as Pillow's seek before the start of a file
on disk does.  `decode_dcx` reads a DCX's first page, the 256-colour
palette again taken from the end of the whole file, as Pillow takes it.
"""
from __future__ import annotations

import numpy as np

from .lzw import rle_rows
from .raster import NotThisFormat, Stream, palette, sized, unpack, unpack_from

DCX_MAGIC = 0x3ADE68B1


def accept(prefix: bytes) -> bool:
    return len(prefix) >= 2 and prefix[0] == 10 and prefix[1] in (0, 2, 3, 5)


def accept_dcx(prefix: bytes) -> bool:
    return len(prefix) >= 4 and int.from_bytes(prefix[:4], "little") == DCX_MAGIC


def decode_pcx(data: bytes, name: str = "<bytes>", at: int = 0):
    """(pixels, mode, palette) of the PCX image whose header starts at `at`."""
    s = data[at:at + 68]
    if not accept(s):
        raise NotThisFormat("not a PCX file")
    x0, y0, x1, y1 = unpack_from("<4H", s, 4)
    x1, y1 = x1 + 1, y1 + 1
    if x1 <= x0 or y1 <= y0:
        raise NotThisFormat("bad PCX image size")
    if len(s) < 68:
        raise NotThisFormat("truncated PCX header")
    offset = at + len(s) + 60
    version, bits, planes = s[1], s[3], s[65]
    provided = int.from_bytes(s[66:68], "little")
    pal = None
    if bits == 1 and planes == 1:
        mode = rawmode = "1"
    elif bits == 1 and planes in (2, 4):
        mode, rawmode = "P", f"P;{planes}L"
        pal = palette(np.frombuffer(s[16:64], np.uint8).reshape(16, 3))
    elif version == 5 and bits == 8 and planes == 1:
        mode = rawmode = "L"
        f = Stream(data)
        try:
            f.seek(-769, 2)
        except ValueError as e:
            raise ValueError(f"{name}: an 8-bit PCX shorter than its 769-byte palette block "
                             "(Pillow's seek before the start of the file fails)") from e
        tail = f.read(769)
        if len(tail) == 769 and tail[0] == 12:
            entries = np.frombuffer(tail[1:], np.uint8).reshape(256, 3)
            if not (entries == np.arange(256, dtype=np.uint8)[:, None]).all():
                mode = rawmode = "P"
                pal = palette(entries)
    elif version == 5 and bits == 8 and planes == 3:
        mode, rawmode = "RGB", "RGB;L"
    else:
        raise ValueError(f"{name}: unknown PCX mode (version {version}, {bits} bits, "
                         f"{planes} planes)")
    w, h = x1 - x0, y1 - y0
    sized(w, h, mode)
    stride = (w * bits + 7) // 8
    if provided != stride:
        stride += stride % 2
    if provided != stride:
        raise ValueError(f"{name}: PCX bytes per line {provided} where Pillow decodes rows of "
                         f"{stride}: Pillow misreads it (ROADMAP A.12)")
    if stride != (w * bits + 7) // 8 and (bits == 1 and planes > 1 or
                                          rawmode == "RGB;L" and w in (1, 3)):
        raise ValueError(f"{name}: planes of a padded PCX stride that Pillow's unpacker reads "
                         "from the wrong offsets: Pillow misreads it (ROADMAP A.12)")
    row = planes * stride
    rows = rle_rows("pcx_rle", data[offset:], row * h, row, h, name=name).reshape(h, row)
    if row % w and row > w:                       # PcxDecode.c packs the planes together
        bands = row // w
        step = row // bands
        for i in range(1, bands):
            rows[:, i * w:(i + 1) * w] = rows[:, i * step:i * step + w].copy()
    return np.ascontiguousarray(unpack(rows, rawmode, w)), mode, pal


def decode_dcx(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, palette) of a DCX file's first page, as Pillow opens it."""
    offsets = []
    for i in range(1024):
        (off,) = unpack_from("<I", data, 4 + 4 * i)
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise NotThisFormat("a DCX file of no pages")
    return decode_pcx(data, name, offsets[0])
