"""Open an image file without an imaging library, as Pillow 12.1 opens and
converts it.

`read_image(data)` finds the format as `Image.open` does (`FORMATS`: the
formats in Pillow's identification order, each with Pillow's prefix test;
a reader whose header checks fail passes the file on to the next format,
as Pillow's `_open` does) and gives a `Picture`: `pixels` equals
`np.asarray(Image.open(f))`, `mode` is its mode ("1", "L", "LA", "P",
"PA", "I;16", "I;16B", "I", "F", "RGB", "RGBA", "CMYK", "LAB") and
`palette` a "P" or "PA" image's [256, 3] palette.  `read_format` gives
the format's name too.  The port reads (`READ`):

* PNG (every bit depth and colour type, Adam7) through `utils/png.py`;
  JPEG (baseline, extended, progressive, arithmetic-coded and lossless;
  greyscale, YCbCr, RGB-coded, CMYK and YCCK) through `utils/jpeg.py`;
  BMP and header-less DIB through `utils/bmp.py`; WebP (lossy, lossless,
  alpha, an animation's first frame) through `utils/webp.py`; GIF (the
  first frame) through `utils/gif.py`; TIFF (the first page; every coding,
  depth and sample format Pillow reads, orientation applied) through
  `utils/tiff.py`;
* the raster formats whose decoders live in Pillow itself: Netpbm
  (`utils/netpbm.py`), Targa (`utils/tga.py`), QOI (`utils/qoi.py`), ICO
  and CUR (`utils/ico.py`), PCX and DCX (`utils/pcx.py`), SGI
  (`utils/sgi.py`), Sun raster (`utils/sun.py`), PSD (`utils/psd.py`),
  XBM (`utils/xbm.py`), XPM (`utils/xpm.py`), FITS (`utils/fits.py`);
  their byte-run loops are `native/lzw.cpp`'s (`utils/lzw.py`);
* the block-compressed textures: DDS (`utils/dds.py`: BC1-BC7, masked
  RGB, "L", "LA", "P" with an RGBA palette, R8G8B8A8), BLP1 and BLP2
  (`utils/blp.py`) and FTEX (`utils/ftex.py`); their blocks are
  `native/bcn.cpp`'s (`utils/bcn.py`).

What Pillow identifies and the port does not read raises `ValueError`
naming the format: AVIF, FLI, GBR, JPEG 2000, ICNS, IM, IMT, IPTC,
MCIDAS, MSP, PCD, PIXAR, SPIDER and XV thumbnails are queued (ROADMAP
A.12); EPS (no Ghostscript), WMF and the BUFR, GRIB, HDF5 and MPEG stubs
are refused by Pillow too.  Where Pillow reads a file other than the
format's specification says (FITS samples byte-swapped, Sun RLE rows
without their padding, PCX rows of the wrong stride, PSD Lab with the
sign bit of a and b flipped, one- and four-digit XBM values, short and
long XPM colours, the TIFF cases of `utils/tiff.py` and the BLP and
signed BC6H cases of `utils/blp.py` and `utils/bcn.py`), the port raises
naming ROADMAP A.12 rather than copy the misreading.  Corrupt and
truncated files raise `ValueError` where Pillow refuses them, and where
Pillow only warns (an icon's PNG of another size than its directory's).

`convert(picture, mode)` is Pillow's `convert("RGB")` / `convert("L")` in
its integer arithmetic: alpha dropped, grey repeated, "1" as 0 / 255, a
palette looked up ("P" and "PA"; indices past a short palette black; a
DDS's RGBA palette without its alpha),
16-bit grey clipped to 255, 32-bit integers ("I") clipped to 0-255, floats
("F") clipped and truncated (−5.5, 127.6 and 300.2 give 0, 127 and 255;
NaN 0), CMYK as (255 − K) − (C·(255 − K))/255 with Pillow's rounded
division, luma (19595·R + 38470·G + 7471·B + 2¹⁵) >> 16 from the RGB.
"LAB" raises `ValueError`: Pillow converts it to RGB through LittleCMS
(ImageCms, Lab D50 to sRGB), which the port does not reproduce (ROADMAP
A.12), and refuses it to "L".  `open_image(path, mode)` reads a file and
converts it.
"""
from __future__ import annotations

import re
import struct
from typing import Callable, NamedTuple, Optional

import numpy as np

from . import blp, dds, fits, ftex, ico, netpbm, pcx, psd, qoi, sgi, sun, tga, xbm, xpm
from .bmp import accept_dib, decode_bmp, decode_dib
from .gif import decode_gif
from .jpeg import decode_jpeg, pillow_header
from .png import decode_picture, to_grey, to_rgb
from .raster import NotThisFormat, cmyk_rgb
from .tiff import decode_tiff
from .webp import decode_webp


class Picture(NamedTuple):
    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None


def _jpeg(data: bytes, name: str):
    pillow_header(data, name)               # Pillow's marker walk: it passes the file on
    img = decode_jpeg(data, name)
    return img, "L" if img.ndim == 2 else {3: "RGB", 4: "CMYK"}[img.shape[-1]], None


def _webp(data: bytes, name: str):
    img = decode_webp(data, name)
    return img, "RGBA" if img.shape[-1] == 4 else "RGB", None


QUEUED = "the port does not read it yet (ROADMAP A.12)"
REFUSED = "Pillow 12.1 refuses it too (ROADMAP A.12: not to be ported)"


class Refused(NamedTuple):
    """A format Pillow identifies that the port does not read: `opens(data)`
    is Pillow's header check (False: Pillow tries the next format)."""
    why: str
    opens: Callable[[bytes], bool] = lambda data: True


def _im_opens(data: bytes) -> bool:
    """ImImagePlugin's header loop: text lines `Key: value` up to a 0x1A."""
    if b"\n" not in data[:100]:
        return False
    pos, tags = 0, 0
    while True:
        c = data[pos:pos + 1]
        pos += 1
        if c == b"\r":
            continue
        if not c or c in (b"\0", b"\x1a"):
            break
        end = data.find(b"\n", pos)
        end = len(data) if end < 0 else end + 1
        line, pos = c + data[pos:end], end
        if len(line) > 100:
            return False
        line = line[:-2] if line.endswith(b"\r\n") else line[:-1] if line.endswith(b"\n") else line
        m = re.match(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$", line)
        if not m:
            return False
        tags += m.group(1) in (b"Comment", b"Date", b"Digitalization equipment",
                               b"File size (no of images)", b"Lut", b"Name", b"Scale (x,y)",
                               b"Image size (x*y)", b"Image type")
    return tags > 0 and b"\x1a" in data[pos - 1:]


def _imt_opens(data: bytes) -> bool:
    """ImtImagePlugin's loop: `width N`, `height N` and `pixel n8` lines."""
    if b"\n" not in data[:100]:
        return False
    w = h = 0
    grey = False
    for line in data.split(b"\n"):
        if not line or line[:1] == b"\x0c":
            break
        if len(line) == 1 or len(line) > 100:
            break
        if line[:1] == b"*":
            continue
        m = re.match(rb"([a-z]*) ([^ \r\n]*)", line)
        if not m:
            break
        k, v = m.groups()
        if k in (b"width", b"height"):
            try:
                w, h = (int(v), h) if k == b"width" else (w, int(v))
            except ValueError:
                return True                  # Pillow raises: the port refuses it as IMT
        grey |= k == b"pixel" and v == b"n8"
    return grey and w > 0 and h > 0


def _iptc_opens(data: bytes) -> bool:
    """IptcImagePlugin's field loop: 0x1C records up to the image record."""
    pos, info = 0, {}
    while True:
        s = data[pos:pos + 5]
        pos += len(s)
        if not s.strip(b"\0"):
            break
        if s[0] != 0x1C or len(s) < 3 or s[1] not in (1, 2, 3, 4, 5, 6, 7, 8, 9, 240):
            return False
        if len(s) < 4:
            return False
        size = s[3]
        if size > 132:
            return True                      # Pillow raises: refused as IPTC
        if size == 128:
            size = 0
        elif size > 128:
            size = int.from_bytes(data[pos:pos + size - 128][-4:].rjust(4, b"\0"), "big")
            pos += s[3] - 128
        elif len(s) < 5:
            return False
        else:
            size = int.from_bytes(s[3:5], "big")
        tag = (s[1], s[2])
        if tag == (8, 10):
            break
        info[tag] = data[pos:pos + size]
        pos += size
    layers = info.get((3, 60))
    return bool(layers) and len(layers) >= 2 and (3, 20) in info and (3, 30) in info


def _spider_opens(data: bytes) -> bool:
    """SpiderImagePlugin: 27 floats, either byte order, a 2-D header."""
    if len(data) < 108:
        return False
    for order in (">", "<"):
        t = (99.0,) + struct.unpack(order + "27f", data[:108])
        try:
            if not all(t[i] == int(t[i]) for i in (1, 2, 5, 12, 13, 22, 23)):
                continue
        except (ValueError, OverflowError):
            continue
        if int(t[5]) not in (1, 3, -11, -12, -21, -22) or \
                int(t[22]) != int(t[13]) * int(t[23]):
            continue
        stack, number = int(t[24]), int(t[27])
        return (int(t[5]) == 1 and int(t[12]) > 0 and int(t[2]) > 0
                and not (stack < 0 or number < 0 or stack > 0 and number > 0))
    return False


def _u32be(data: bytes, at: int) -> int:
    return int.from_bytes(data[at:at + 4], "big")


# Pillow 12.1's identification order (`Image.ID` once every plugin is
# registered: the preinit formats, then the order of PIL._plugins as each
# plugin registers itself): format -> Pillow's `_accept` on the first 16
# bytes (None: no magic, every file is tried) -> the port's reader, which
# raises NotThisFormat where Pillow's `_open` passes the file on, or why
# the port refuses the format.
FORMATS = (
    ("BMP", lambda p: p[:2] == b"BM", decode_bmp),
    ("DIB", accept_dib, decode_dib),
    ("GIF", lambda p: p[:6] in (b"GIF87a", b"GIF89a"), decode_gif),
    ("JPEG", lambda p: p[:2] == b"\xff\xd8", _jpeg),
    ("PPM", netpbm.accept, netpbm.decode_netpbm),
    ("PNG", lambda p: p[:8] == b"\x89PNG\r\n\x1a\n", decode_picture),
    ("AVIF", lambda p: p[4:8] == b"ftyp" and p[8:12] in (b"avif", b"avis", b"mif1", b"msf1"),
     Refused(QUEUED + ", through libavif 1.3.0")),
    ("BLP", lambda p: p[:4] in (b"BLP1", b"BLP2"), blp.decode_blp),
    ("BUFR", lambda p: p[:4] in (b"BUFR", b"ZCZC"), Refused(REFUSED + ", a stub")),
    ("CUR", ico.accept_cur, ico.decode_cur),
    ("PCX", pcx.accept, pcx.decode_pcx),
    ("DCX", pcx.accept_dcx, pcx.decode_dcx),
    ("DDS", dds.accept, dds.decode_dds),
    ("EPS", lambda p: p[:4] == b"%!PS" or p[:4] == b"\xc5\xd0\xd3\xc6",
     Refused(REFUSED + " without Ghostscript")),
    ("FITS", fits.accept, fits.decode_fits),
    ("FLI", lambda p: len(p) >= 16 and p[4:6] in (b"\x11\xaf", b"\x12\xaf")
     and p[14:16] in (b"\0\0", b"\3\0"),
     Refused(QUEUED, lambda d: d[20:22] == b"\0\0" and d[42:80] == bytes(38)
             and d[88:128] == bytes(len(d[88:128])))),
    ("FTEX", lambda p: p[:4] == b"FTEX", ftex.decode_ftex),
    ("GBR", lambda p: len(p) >= 8 and _u32be(p, 0) >= 20 and _u32be(p, 4) in (1, 2),
     Refused(QUEUED, lambda d: len(d) >= 20 and _u32be(d, 8) and _u32be(d, 12)
             and _u32be(d, 16) in (1, 4))),
    ("GRIB", lambda p: len(p) >= 8 and p[:4] == b"GRIB" and p[7] == 1,
     Refused(REFUSED + ", a stub")),
    ("HDF5", lambda p: p[:8] == b"\x89HDF\r\n\x1a\n", Refused(REFUSED + ", a stub")),
    ("JPEG2000", lambda p: p[:4] == b"\xff\x4f\xff\x51"
     or p[:12] == b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a",
     Refused(QUEUED + ", through OpenJPEG 2.5.4")),
    ("ICNS", lambda p: p[:4] == b"icns", Refused(QUEUED)),
    ("ICO", ico.accept, ico.decode_ico),
    ("IM", None, Refused(QUEUED, _im_opens)),
    ("IMT", None, Refused(QUEUED, _imt_opens)),
    ("IPTC", None, Refused(QUEUED, _iptc_opens)),
    ("MCIDAS", lambda p: p[:8] == b"\0\0\0\0\0\0\0\4",
     Refused(QUEUED, lambda d: len(d) >= 256 and _u32be(d, 40) in (1, 2, 4)
             and 0 < _u32be(d, 36) < 2 ** 31 and 0 < _u32be(d, 32) < 2 ** 31)),
    ("MPEG", lambda p: p[:4] == b"\0\0\1\xb3",
     Refused(REFUSED + ", a stub", lambda d: len(d) >= 7 and d[4] | d[5] >> 4 != 0
             and (d[5] & 15) | d[6] != 0)),
    ("TIFF", lambda p: p[:2] in (b"II", b"MM") and p[2:4] in (b"*\x00", b"\x00*", b"+\x00",
                                                            b"\x00+"), decode_tiff),
    ("MSP", lambda p: p[:4] in (b"DanM", b"LinS"),
     Refused(QUEUED, lambda d: len(d) >= 32 and not np.bitwise_xor.reduce(
         np.frombuffer(d[:32], "<u2")))),
    ("PCD", None, Refused(QUEUED, lambda d: d[2048:2052] == b"PCD_" and len(d) >= 2048 + 1539)),
    ("PIXAR", lambda p: p[:4] == b"\200\350\000\000",
     Refused(QUEUED, lambda d: len(d) >= 428 and d[424:428] == b"\x0e\0\x02\0"
             and d[416:418] != b"\0\0" and d[418:420] != b"\0\0")),
    ("PSD", psd.accept, psd.decode_psd),
    ("QOI", qoi.accept, qoi.decode_qoi),
    ("SGI", sgi.accept, sgi.decode_sgi),
    ("SPIDER", None, Refused(QUEUED, _spider_opens)),
    ("SUN", sun.accept, sun.decode_sun),
    ("TGA", None, tga.decode_tga),
    ("WEBP", lambda p: p[:4] == b"RIFF" and p[8:12] == b"WEBP", _webp),
    ("WMF", lambda p: p[:6] == b"\xd7\xcd\xc6\x9a\0\0" or p[:4] == b"\1\0\0\0",
     Refused(REFUSED + " (no WMF handler outside Windows)",
             lambda d: d[40:44] == b" EMF" if d[:4] == b"\1\0\0\0"
             else d[22:26] == b"\1\0\t\0" or d[14:16] == b"\0\0")),
    ("XBM", xbm.accept, xbm.decode_xbm),
    ("XPM", xpm.accept, xpm.decode_xpm),
    ("XVTHUMB", lambda p: p[:6] == b"P7 332", Refused(QUEUED)),
)
READ = tuple(f for f, _, how in FORMATS if not isinstance(how, Refused))


def read_format(data: bytes, name: str = "<bytes>"):
    """(format, Picture): the format Pillow 12.1 opens `data` as (found as
    Pillow finds it, `FORMATS`) and what `read_image` gives."""
    prefix = data[:16]
    for fmt, accept, how in FORMATS:
        if accept is not None and not accept(prefix):
            continue
        if isinstance(how, Refused):
            if how.opens(data):
                raise ValueError(f"{name}: {fmt}, as Pillow 12.1 identifies it: {how.why}")
            continue
        try:
            return fmt, Picture(*how(data, name))
        except NotThisFormat:
            continue
    raise ValueError(f"{name}: not an image file Pillow 12.1 identifies (no format takes it; "
                     "the port reads " + ", ".join(READ) + "; ROADMAP A.12 lists the rest)")


def read_image(data: bytes, name: str = "<bytes>") -> Picture:
    """The pixels and mode `Image.open` gives for a file of any format the
    port reads (`READ`), found as Pillow finds it (`FORMATS`)."""
    return read_format(data, name)[1]


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
        rgb = cmyk_rgb(px)
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
