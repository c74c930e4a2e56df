"""Photoshop (PSD) files as Pillow 12.1's `PsdImagePlugin` opens them: the
merged (composite) image, the header and sections in numpy, PackBits in
`native/lzw.cpp` (`packbits_rows_decode`).

`decode_psd(data)` gives `(pixels, mode, palette)` as
`np.asarray(Image.open(f))`: bitmap ("1", rows of bits as Pillow's "1"
raw mode reads them), greyscale, duotone and multichannel ("L", the first
channel), indexed ("P" over the 768-byte colour mode data, planar),
RGB ("RGB", or "RGBA" with exactly four channels), CMYK ("CMYK", the
samples inverted as stored) and Lab ("LAB", the L, a and b planes as
stored), at 8 bits (1 for bitmaps).  A Lab file ("LAB" to Pillow) raises
naming ROADMAP A.12: Pillow flips the top bit of its a and b planes, which
Photoshop stores with 128 for zero (TIFF's are signed), so its pixels are
not the file's.  The colour mode data, image
resources and layer section are skipped as Pillow walks them; channels
beyond the mode's are not read.  Raw data is planar; PackBits rows are
decoded one after another from each channel's start (the byte counts
place the channels), a packet cut at a row's end.  16- and 32-bit files
are not PSD files to Pillow; data that ends early raises `ValueError`.
"""
from __future__ import annotations

import numpy as np

from .lzw import rle_rows
from .raster import NotThisFormat, Stream, planar_palette, sized, unpack, unpack_from

MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1), (2, 8): ("P", 1),
         (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4), (7, 8): ("L", 1), (8, 8): ("L", 1),
         (9, 8): ("LAB", 3)}


def accept(prefix: bytes) -> bool:
    return prefix[:4] == b"8BPS"


def _u32(f: Stream) -> int:
    return unpack_from(">I", f.read(4))[0]


def decode_psd(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, palette) of a PSD file's composite image, as Pillow
    opens it."""
    f = Stream(data)
    s = f.read(26)
    if not accept(s) or unpack_from(">H", s, 4)[0] != 1:
        raise NotThisFormat("not a PSD file")
    nchan, h, w, bits, psd_mode = unpack_from(">HIIHH", s, 12)
    if (psd_mode, bits) not in MODES:
        raise NotThisFormat(f"PSD colour mode {psd_mode} at {bits} bits")
    mode, channels = MODES[(psd_mode, bits)]
    if channels > nchan:
        raise ValueError(f"{name}: not enough channels in the PSD file")
    if mode == "RGB" and nchan == 4:
        mode, channels = "RGBA", 4
    pal = None
    size = _u32(f)
    if size:
        cmap = f.read(size)
        if mode == "P" and size == 768:
            pal = planar_palette(cmap)
    if mode == "P" and pal is None:                # no palette: Pillow converts through zeros
        pal = np.zeros((256, 3), np.uint8)
    size = _u32(f)                                   # image resources
    if size:
        end = f.tell() + size
        while f.tell() < end:
            f.read(4)
            unpack_from(">H", f.read(2))
            n = f.read(1)
            if not n:
                raise NotThisFormat("truncated PSD image resource")
            rname = f.read(n[0])
            if not len(rname) & 1:
                f.read(1)
            rdata = f.read(_u32(f))
            if len(rdata) & 1:
                f.read(1)
    size = _u32(f)                                   # layer and mask information
    if size:
        end = f.tell() + size
        _u32(f)
        f.seek(end)
    (compression,) = unpack_from(">H", f.read(2))
    at = f.tell()
    if compression not in (0, 1):
        sized(w, h, mode)
        raise ValueError(f"{name}: cannot load this image (PSD compression {compression})")
    if compression == 0:
        starts = [at + c * w * h for c in range(channels)]
    else:
        counts = f.read(channels * h * 2)
        if len(counts) < channels * h * 2:
            raise NotThisFormat("truncated PSD byte counts")
        per = np.frombuffer(counts, ">u2").astype(np.int64).reshape(channels, h).sum(1)
        starts = (f.tell() + np.concatenate([[0], np.cumsum(per)[:-1]])).tolist()
    sized(w, h, mode)
    if mode == "LAB":
        raise ValueError(f"{name}: a Lab PSD, whose a and b planes (stored with 128 for zero) "
                         "Pillow reads with their top bit flipped, as it reads TIFF's signed "
                         "ones: Pillow misreads it (ROADMAP A.12)")
    row = (w + 7) // 8 if mode == "1" else w
    planes = []
    for start in starts:
        if compression == 0:
            if start > len(data) or len(data) - start < row * h:
                raise ValueError(f"{name}: image file is truncated (PSD data ends early)")
            planes.append(np.frombuffer(data, np.uint8, row * h, start).reshape(h, row))
        else:
            planes.append(rle_rows("packbits_rows", data[start:], row * h, row, h,
                                   name=name).reshape(h, row))
    if mode == "1":
        return unpack(planes[0], "1", w), mode, None
    px = [255 - p if mode == "CMYK" else p for p in planes]
    if len(px) == 1:
        return np.ascontiguousarray(px[0]), mode, pal
    return np.ascontiguousarray(np.stack(px, -1)), mode, pal
