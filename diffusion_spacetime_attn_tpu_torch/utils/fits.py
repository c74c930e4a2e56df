"""FITS images as Pillow 12.1's `FitsImagePlugin` opens them, in numpy.

`decode_fits(data)` walks the 80-byte header cards as Pillow does (SIMPLE =
T first; END ends a header unit, padded to 2880 bytes; a following
XTENSION unit's cards are read into the same table while no image was
found) and gives `(pixels, "L", None)` for BITPIX 8: NAXIS1 x NAXIS2 bytes
(a one-axis image as one column), rows bottom-up, BSCALE and BZERO not
applied, as Pillow gives them.

Pillow reads the other sample types with its little-endian raw modes
although FITS stores them big-endian, so BITPIX 16 ("I;16": 3 reads as
768), 32 ("I"), −32 and −64 ("F", the latter as 4-byte floats) come back
byte-swapped or cut: the port raises naming ROADMAP A.12.  So does a data
unit shorter than 80 bytes (Pillow places the data 80 bytes before the end
of the first card it reads after the header, which is then inside the
header's padding) and the GZIP_1 tile-compressed binary table, which
Pillow reads as one gzip stream of 4-byte samples.
"""
from __future__ import annotations

import math

import numpy as np

from .raster import NotThisFormat, Stream, rows_from, sized


def accept(prefix: bytes) -> bool:
    return prefix[:6] == b"SIMPLE"


def _int(headers: dict, key: bytes, name: str) -> int:
    if key not in headers:
        raise NotThisFormat(f"no {key.decode()} card")
    try:
        return int(headers[key])
    except ValueError as e:
        raise ValueError(f"{name}: bad FITS value {key.decode()} = {headers[key]!r}") from e


def _parse(headers: dict, name: str):
    """FitsImageFile._parse_headers -> (found, width, height, bitpix, gzip)."""
    gz = (headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T"
          and headers.get(b"ZCMPTYPE", None) is not None
          and headers[b"ZCMPTYPE"] == b"'GZIP_1  '")
    if headers.get(b"XTENSION") == b"'BINTABLE'" and headers.get(b"ZIMAGE") == b"T" \
            and b"ZCMPTYPE" not in headers:
        raise NotThisFormat("no ZCMPTYPE card")
    prefix = b"Z" if gz else b""
    if gz:
        naxis = _int(headers, b"NAXIS", name)
        if naxis:
            _int(headers, b"NAXIS1", name)
            if naxis > 1:
                _int(headers, b"NAXIS2", name)
        _int(headers, b"BITPIX", name)
    naxis = _int(headers, prefix + b"NAXIS", name)
    if naxis == 0:
        return None
    if naxis == 1:
        w, h = 1, _int(headers, prefix + b"NAXIS1", name)
    else:
        w, h = _int(headers, prefix + b"NAXIS1", name), _int(headers, prefix + b"NAXIS2", name)
    bitpix = _int(headers, prefix + b"BITPIX", name)
    return w, h, bitpix, gz


def decode_fits(data: bytes, name: str = "<bytes>"):
    """(pixels, mode, None) of a FITS file's image, as Pillow opens it."""
    f = Stream(data)
    headers, in_header, found = {}, False, None
    while True:
        card = f.read(80)
        if not card:
            raise ValueError(f"{name}: truncated FITS file")
        keyword = card[:8].strip()
        if keyword in (b"SIMPLE", b"XTENSION"):
            in_header = True
        elif headers and not in_header:
            break
        elif keyword == b"END":
            f.seek(math.ceil(f.tell() / 2880) * 2880)
            if found is None:
                found = _parse(headers, name) or None
            in_header = False
            continue
        if found is not None:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not accept(keyword) or value != b"T"):
            raise NotThisFormat("not a FITS file")
        headers[keyword] = value
    if found is None:
        raise ValueError(f"{name}: no image data in the FITS file")
    w, h, bitpix, gz = found
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bitpix, "")
    sized(w, h, mode)
    at = f.tell() - 80
    if gz:
        raise ValueError(f"{name}: a GZIP_1 tile-compressed FITS image, which Pillow reads as "
                         "one gzip stream of 4-byte samples: Pillow misreads it (ROADMAP A.12)")
    if bitpix != 8:
        raise ValueError(f"{name}: FITS BITPIX {bitpix}, which Pillow reads with a "
                         f"little-endian {mode!r} raw mode, byte-swapped: Pillow misreads it "
                         "(ROADMAP A.12)")
    if len(card) < 80:
        raise ValueError(f"{name}: a FITS data unit shorter than 80 bytes, which Pillow reads "
                         "from inside the header's padding: Pillow misreads it (ROADMAP A.12)")
    if len(data) - at < w * h:
        raise ValueError(f"{name}: image file is truncated (FITS data ends early)")
    return np.ascontiguousarray(rows_from(np.frombuffer(data, np.uint8, w * h, at), h, w, -1)), \
        "L", None
