"""PyTorch port, the image formats Pillow 12.1 decodes by itself that the port
refused (Netpbm, Targa, QOI, ICO / CUR / DIB, PCX / DCX, SGI, Sun raster,
PSD, XBM, XPM, FITS), held against Pillow on the CPU (`utils/image_io.py`
and its readers, `native/lzw.cpp`'s byte-run loops; numpy only, no JAX
program compiled):

* each kind checked three ways: `read_image`'s format, mode, pixels (dtype
  included) and palette against `Image.open`; `convert` to "RGB" and "L"
  against Pillow's; JAX's `training/image_data.load_image` against the
  port's at two sizes and two filters;
* identification as Pillow's: a file under a wrong suffix reads the same,
  each format Pillow identifies but the port does not read raises naming
  it (queued, or refused by Pillow too); the BLP, DDS and FTEX files once
  named so read as Pillow reads them;
* a seeded corpus (random strings, each new format's header with random
  tails, truncations and byte flips of every committed fixture): the port
  and Pillow both refuse, or both give the same format, mode and pixels;
  the port refuses what Pillow reads only where Pillow misreads the file
  (each case asserted below with both behaviours) or only warns;
* Pillow's quirks the port copies (16-bit PGM kept as stored, plain maxval
  1000 scaled to 16 bits, 16-bit PPM cut to 8 bits, `Pf` bottom-up, PF and
  P7 refused), and the byte-run loops in bounds under AddressSanitizer.

    python -m pytest tests/test_torch_raster_formats.py -q      # ~10 s
"""
import io
import os
import struct
import subprocess
import warnings

import numpy as np
import pytest
from PIL import Image

from diffusion_spacetime_attn_tpu.training import image_data as jdata
from diffusion_spacetime_attn_tpu_torch.training import image_data as tdata
from diffusion_spacetime_attn_tpu_torch.utils import image_io
from helpers import port_formats
from helpers import raw_images as raw

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

def image(h, w, c=3, seed=0):
    return port_formats._image(h, w, seed, c)


def save(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


class Disk(io.BytesIO):
    """A file's seek: before the start it fails, as on a file on disk (the
    JAX package opens paths), where BytesIO would stop at 0."""

    def seek(self, offset, whence=0):
        base = (0, self.tell(), len(self.getbuffer()))[whence]
        if base + offset < 0:
            raise OSError(22, "Invalid argument")
        return super().seek(offset, whence)


def pil(data: bytes):
    """(format, image, warned) as Pillow opens and loads `data`; raises
    where Pillow refuses it."""
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        im = Image.open(Disk(data))
        im.load()
    warned = any("expected size" in str(w.message) for w in seen)
    return {"XVThumb": "XVTHUMB"}.get(im.format, im.format), im, warned


def assert_like_pil(data: bytes, label: str = ""):
    """Format, mode, pixels (dtype included), palette and both conversions."""
    fmt, want, _ = pil(data)
    pixels = np.asarray(want)
    got, pic = image_io.read_format(data, label)
    assert (got, pic.mode) == (fmt, want.mode), (label, got, pic.mode, fmt, want.mode)
    assert pic.pixels.dtype == pixels.dtype and pic.pixels.shape == pixels.shape, label
    assert pic.pixels.tobytes() == pixels.tobytes(), label
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(image_io.convert(pic, mode), np.asarray(want.convert(mode)),
                                      err_msg=f"{label} convert {mode}")
    return pic


def kinds() -> dict:
    """{label: file bytes} of one file of every new kind."""
    r = np.random.RandomState(5)
    rgb = Image.fromarray(image(21, 34, seed=1))
    rgba = Image.fromarray(image(21, 34, 4, seed=2))
    grey = Image.fromarray(image(21, 34, 1, seed=3)[..., 0])
    la = Image.fromarray(image(21, 34, 2, seed=4), "LA")
    pal = rgb.quantize(50)
    ppal = np.asarray(pal.getpalette()[:150], np.uint8).reshape(50, 3)
    bits = Image.fromarray(image(21, 34, 1, seed=5)[..., 0] > 128)
    g16 = image(21, 34, 1, seed=6)[..., 0].astype(np.int32) * 250
    cm = r.randint(0, 256, (40, 3)).astype(np.uint8)
    idx = r.randint(10, 50, (21, 34)).astype(np.uint8)
    p16 = r.randint(0, 256, (16, 3)).astype(np.uint8)
    i4 = r.randint(0, 16, (21, 34)).astype(np.uint8)
    mask = np.asarray(bits)
    k = {
        "pbm raw": save(bits, "PPM"), "pgm raw": save(grey, "PPM"), "ppm raw": save(rgb, "PPM"),
        "pgm 16-bit": save(Image.fromarray(g16), "PPM"),
        "ppm 16-bit": b"P6\n34 21\n65535\n" + (np.asarray(rgb).astype(">u2") * 257 + 3).tobytes(),
        "pgm maxval 1000": b"P5\n34 21\n1000\n" + (g16 // 64).astype(">u2").tobytes(),
        "pgm maxval 100 comments": b"P5 #a\n34#b\n 21 100 " + (np.asarray(grey) // 3).tobytes(),
        "pbm plain": raw.netpbm_plain(np.asarray(bits)),
        "pgm plain": raw.netpbm_plain(np.asarray(grey)),
        "pgm plain 1000": raw.netpbm_plain(g16 // 64, 1000),
        "ppm plain": raw.netpbm_plain(np.asarray(rgb), 255, b"by hand"),
        "pf negative scale": raw.pfm_grey((r.randn(21, 34) * 100).astype(np.float32), -1.0),
        "pf positive scale": raw.pfm_grey((r.randn(21, 34) * 100).astype(np.float32), 2.5),
        "tga rgb top-down": raw.tga_file(np.asarray(rgb)[..., ::-1], origin=0x20, depth=24),
        "tga rgb mirrored rle": raw.tga_file(np.asarray(rgb)[..., ::-1], origin=0x30, depth=24,
                                             rle=True),
        "tga 16-bit": raw.tga_file(r.randint(0, 256, (21, 34, 2)).astype(np.uint8), depth=16),
        "tga 16-bit rle": raw.tga_file(r.randint(0, 4, (21, 34, 2)).astype(np.uint8), depth=16,
                                       rle=True),
        "qoi rgb": save(rgb, "QOI"), "qoi rgba": save(rgba, "QOI"),
        "ico png": save(rgba, "ICO", sizes=[(34, 21)]),
        "ico bmp": save(rgba, "ICO", sizes=[(34, 21)], bitmap_format="bmp"),
        "ico 4-bit mask": raw.icon_file([
            (34, 21, 4, 16, raw.dib_bitmap(i4, 4, p16, mask)),
            (16, 16, 8, 0, raw.dib_bitmap(np.zeros((16, 16), np.uint8), 8, p16))]),
        "ico 24-bit": raw.icon_file([(34, 21, 24, 0, raw.dib_bitmap(np.asarray(rgb), 24,
                                                                    mask=mask))]),
        "ico 32-bit": raw.icon_file([(34, 21, 32, 0, raw.dib_bitmap(np.asarray(rgba), 32))]),
        "cur 32-bit": raw.icon_file([(34, 21, 32, 0, raw.dib_bitmap(np.asarray(rgba), 32))],
                                    cursor=True),
        "cur largest": raw.icon_file([
            (16, 16, 8, 0, raw.dib_bitmap(np.zeros((16, 16), np.uint8), 8, p16)),
            (34, 21, 8, 0, raw.dib_bitmap(np.asarray(pal), 8, ppal))], cursor=True),
        "dib rgb": save(rgb, "DIB"), "dib palette": save(pal, "DIB"),
        "dcx": raw.dcx_file([save(pal, "PCX"), save(rgb, "PCX")]),
        "sgi rle rgb": raw.sgi_rle_file(np.asarray(rgb)),
        "sgi rle rgba 16-bit": raw.sgi_rle_file(np.asarray(rgba).astype(np.uint16) * 257 + 1,
                                                bpc=2),
        "sgi rle grey": raw.sgi_rle_file(np.asarray(grey)[..., None], dimension=2),
        "sun 1-bit": raw.sun_file(np.asarray(bits), 1),
        "sun 8-bit": raw.sun_file(np.asarray(grey), 8),
        "sun 8-bit map": raw.sun_file(np.asarray(pal), 8, colormap=ppal),
        "sun 4-bit": raw.sun_file(i4, 4),
        "sun 24-bit": raw.sun_file(np.asarray(rgb), 24),
        "sun 24-bit rgb": raw.sun_file(np.asarray(rgb), 24, ftype=3),
        "sun 32-bit": raw.sun_file(np.asarray(rgba), 32),
        "sun 8-bit rle": raw.sun_file(np.asarray(grey)[:, :32], 8, ftype=2),
        "sun 24-bit rle": raw.sun_file(np.asarray(rgb)[:, :32], 24, ftype=2),
        "psd rgb": raw.psd_file(np.moveaxis(np.asarray(rgb), -1, 0), 3),
        "psd rgb packbits": raw.psd_file(np.moveaxis(np.asarray(rgb), -1, 0), 3, 1),
        "psd rgba packbits": raw.psd_file(np.moveaxis(np.asarray(rgba), -1, 0), 3, 1,
                                          resources=raw.psd_resource(1005, b"abc", b"n")),
        "psd rgb 5 channels": raw.psd_file(np.concatenate(
            [np.moveaxis(np.asarray(rgba), -1, 0), np.asarray(grey)[None]]), 3, 1),
        "psd grey": raw.psd_file(np.asarray(grey)[None], 1),
        "psd duotone": raw.psd_file(np.asarray(grey)[None], 8, 1),
        "psd cmyk packbits": raw.psd_file(np.moveaxis(np.asarray(rgba), -1, 0), 4, 1),
        "psd indexed": raw.psd_file(np.asarray(pal)[None], 2, 1,
                                    palette=np.concatenate([ppal, ppal[::-1]] * 3)[:256]),
        "psd indexed without palette": raw.psd_file(np.asarray(pal)[None], 2),
        "psd bitmap": raw.psd_file(np.packbits(mask[:, :32], axis=1)[None], 0, 1, depth=1),
        "xbm": save(bits, "XBM"),
        "xpm": raw.xpm_file(r.randint(0, 6, (21, 34)), ["#ff0000", "#00ff00", "#0000ff",
                                                        "#123456", "#abcdef", "#000000"]),
        "xpm 300 colours": raw.xpm_file(r.randint(0, 300, (9, 13)),
                                        [f"#{v:06x}" for v in r.randint(0, 1 << 24, 300)],
                                        cpp=2),
        "fits 8-bit": raw.fits_file(np.asarray(grey), 8, ["BZERO   =                    0"]),
        "pyp": b"PyP\n4 2\n255\n" + bytes(range(8)),
    }
    for m, im in (("L", grey), ("LA", la), ("P", pal), ("RGB", rgb), ("RGBA", rgba),
                  ("1", bits)):
        k[f"tga {m}"] = save(im, "TGA")
        if m != "1":
            k[f"tga {m} rle"] = save(im, "TGA", rle=True)
    for d in (16, 24):
        k[f"tga map{d} from 10"] = raw.tga_file(idx, cm, map_depth=d, map_start=10)
        k[f"tga map{d} from 10 rle"] = raw.tga_file(idx, cm, map_depth=d, map_start=10,
                                                    rle=True, image_id=b"hello")
    for m, im in (("1", bits), ("L", grey), ("P", pal), ("RGB", rgb)):
        k[f"pcx {m}"] = save(im, "PCX")
        k[f"pcx {m} even width"] = save(im.crop((0, 0, 32, 21)), "PCX")
    for m, im in (("L", grey), ("RGB", rgb), ("RGBA", rgba)):
        k[f"sgi {m}"] = save(im, "SGI")
        k[f"sgi {m} 16-bit"] = save(im, "SGI", bpc=2)
    return k


KINDS = kinds()


@pytest.mark.parametrize("label", sorted(KINDS))
def test_new_kinds_equal_pil(label, tmp_path):
    """Each kind's format, mode, pixels and palette, its conversions, and
    JAX's loader on it against the port's at two sizes and two filters."""
    data = KINDS[label]
    assert_like_pil(data, label)
    path = tmp_path / "x.img"
    path.write_bytes(data)
    for size in (32, 77):
        for interp in ("bicubic", "bilinear"):
            np.testing.assert_array_equal(tdata.load_image(str(path), size, interp),
                                          np.asarray(jdata.load_image(str(path), size, interp)),
                                          err_msg=f"{label} {size} {interp}")


def _new_fixtures():
    names = port_formats.raster_images()
    return sorted(names)


def test_fixtures_under_a_wrong_suffix_read_the_same(tmp_path):
    """Pillow identifies a file by its bytes: every new fixture, written as
    `.png` and as `.txt`, loads as under its own name, in the port as in
    JAX; the committed RLE Targa is named `.jpg`."""
    assert image_io.read_format((port_formats.FIXTURES / "tga_rle.jpg").read_bytes())[0] == "TGA"
    for name in _new_fixtures():
        data = (port_formats.FIXTURES / name).read_bytes()
        want = tdata.load_image(str(port_formats.FIXTURES / name), 48, "bicubic")
        for suffix in (".png", ".txt"):
            path = tmp_path / f"renamed{suffix}"
            path.write_bytes(data)
            np.testing.assert_array_equal(tdata.load_image(str(path), 48, "bicubic"), want)
            np.testing.assert_array_equal(np.asarray(jdata.load_image(str(path), 48, "bicubic")),
                                          want, err_msg=f"{name} as {suffix}")


def test_indices_past_a_short_palette_convert_to_black():
    """A BMP's palette of 3 entries and an index of 200: Pillow converts it
    to black (0, 0, 0); the port gave Pillow's grey ramp (200, 200, 200)
    until the raster readers' palette rule replaced it."""
    img = Image.fromarray(np.array([[0, 1, 2, 200]], np.uint8)).quantize(3)
    data = bytearray(save(img, "BMP"))
    data[int.from_bytes(data[10:14], "little") + 3] = 200
    assert_like_pil(bytes(data), "bmp short palette")
    assert image_io.convert(image_io.read_image(bytes(data)), "RGB")[0, 3].tolist() == [0, 0, 0]


# --------------------------------------------- formats the port does not read


def _others() -> dict:
    """{format: a file Pillow identifies as it}: what the port refuses."""
    def new(fmt, mode="RGB", size=(16, 16), **kw):
        return save(Image.new(mode, size, (10, 20, 30) if mode == "RGB" else 7), fmt, **kw)

    be = struct.pack
    return {
        "AVIF": new("AVIF"),
        "EPS": new("EPS"), "JPEG2000": new("JPEG2000"), "ICNS": new("ICNS", "RGBA", (32, 32)),
        "IM": new("IM"), "MSP": new("MSP", "1"), "SPIDER": new("SPIDER", "F"),
        "BUFR": b"BUFR" + bytes(60), "GRIB": b"GRIB\0\0\0\1" + bytes(40),
        "HDF5": b"\x89HDF\r\n\x1a\n" + bytes(40), "MPEG": b"\0\0\1\xb3\x01\x00\x10" + bytes(40),
        "FLI": struct.pack("<IHHHHH", 0, 0xAF11, 1, 16, 16, 8) + bytes(128),
        "GBR": be(">IIIII", 28, 2, 4, 4, 1) + b"GIMP" + be(">I", 10) + b"x\0" + bytes(16),
        "IMT": b"width 4\nheight 2\npixel n8\n\x0c" + bytes(8),
        "IPTC": (b"\x1c\x03\x3c\x00\x02\x01\x00\x1c\x03\x14\x00\x02\x00\x04\x1c\x03\x1e\x00\x02"
                 b"\x00\x02\x1c\x03\x78\x00\x01\x01\x1c\x08\x0a\x00\x08" + bytes(8)),
        "MCIDAS": b"\0\0\0\0\0\0\0\4" + bytes(24) + be(">iii", 4, 4, 1) + bytes(300),
        "PCD": bytes(2048) + b"PCD_" + bytes(1600),
        "PIXAR": b"\200\350\000\000" + bytes(412) + struct.pack("<6H", 4, 4, 0, 0, 14, 2)
        + bytes(700),
        "WMF": b"\xd7\xcd\xc6\x9a\0\0" + struct.pack("<hhhhH", 0, 0, 100, 100, 96) + bytes(6)
        + b"\x01\x00\t\x00" + bytes(40),
        "XVTHUMB": b"P7 332\n#XVVERSION:x\n4 2 255\n" + bytes(8),
    }


OTHERS = _others()
PILLOW_REFUSES = ("EPS", "WMF", "BUFR", "GRIB", "HDF5", "MPEG")
# the files this test named as refused until the port read them
NOW_READ = {"BLP": save(Image.new("P", (16, 16), 7), "BLP"),
            "DDS": save(Image.new("RGBA", (16, 16), 7), "DDS"),
            "FTEX": b"FTEX" + struct.pack("<i2i2i2ii", 0, 4, 4, 1, 1, 1, 0, 64) + bytes(64)}


@pytest.mark.parametrize("fmt", sorted(OTHERS))
def test_other_formats_raise_naming_them(fmt):
    """Pillow identifies each file as `fmt`; the port raises naming it:
    queued (ROADMAP A.12), or refused by Pillow too (EPS without
    Ghostscript, WMF, the four stubs), where Pillow's load fails."""
    data = OTHERS[fmt]
    im = Image.open(io.BytesIO(data))
    assert {"XVThumb": "XVTHUMB"}.get(im.format, im.format) == fmt
    why = "Pillow 12.1 refuses it too" if fmt in PILLOW_REFUSES else "does not read it yet"
    with pytest.raises(ValueError, match=f"{fmt}, as Pillow 12.1 identifies it: .*{why}.*A.12"):
        image_io.read_image(data, fmt)
    if fmt in PILLOW_REFUSES:
        with pytest.raises(Exception):
            im.load()


@pytest.mark.parametrize("fmt", sorted(NOW_READ))
def test_formats_once_refused_read_as_pil(fmt):
    """The BLP, DDS and FTEX files `test_other_formats_raise_naming_them`
    held refused: read as Pillow reads them (`utils/{blp,dds,ftex}.py`)."""
    data = NOW_READ[fmt]
    assert Image.open(io.BytesIO(data)).format == fmt
    assert image_io.read_format(data)[0] == fmt
    assert_like_pil(data, fmt)


def test_netpbm_quirks_as_pillow():
    """16-bit binary PGM: "I" as stored (3000 stays 3000); a plain PGM of
    maxval 1000: "I" scaled to 16 bits (100 -> 6554); 16-bit PPM: 8-bit
    RGB; `Pf` with a negative scale: little-endian, bottom-up; PF and P7
    are no Netpbm to Pillow (P7 332 is an XV thumbnail)."""
    pic = image_io.read_image(b"P5 2 1 65535 " + np.array([3000, 7], ">u2").tobytes())
    assert pic.mode == "I" and pic.pixels.tolist() == [[3000, 7]]
    pic = image_io.read_image(b"P2 2 1 1000 100 1000")
    assert pic.mode == "I" and pic.pixels.tolist() == [[6554, 65535]]
    pic = image_io.read_image(b"P6 1 1 65535 " + np.array([65535, 32768, 257], ">u2").tobytes())
    assert pic.mode == "RGB" and pic.pixels.tolist() == [[[255, 128, 1]]]
    pic = image_io.read_image(b"Pf 1 2 -1.0 " + np.array([1.5, -2.0], "<f4").tobytes())
    assert pic.mode == "F" and pic.pixels.tolist() == [[-2.0], [1.5]]
    for data in (b"PF 1 1 -1.0 " + bytes(12), b"P7\nWIDTH 1\nHEIGHT 1\nENDHDR\n\0"):
        with pytest.raises(Exception):
            Image.open(io.BytesIO(data))
        with pytest.raises(ValueError, match="not an image file Pillow 12.1 identifies"):
            image_io.read_image(data)


# ------------------------------------------------ where Pillow misreads


def _misread_cases() -> dict:
    """{label: (file, check of Pillow's image)}: files Pillow reads other
    than their format's specification; each check asserts what Pillow gives
    and that it is not the file's image."""
    grey = image(6, 33, 1, seed=9)[..., 0]
    v = np.array([[3, 500], [-7, 1]], np.int32)

    def same_as(want):
        return lambda im: np.testing.assert_array_equal(np.asarray(im), want)

    def differs(truth):
        def check(im):
            got = np.asarray(im)
            assert got.shape != truth.shape or not np.array_equal(got, truth)
        return check

    def xbm(im):                             # 0x5 read as 0x50: bits 4 and 6 set
        assert np.asarray(im)[0].tolist() == [False] * 4 + [True, False, True, False]

    rows = np.concatenate([image(30, 30, 1, seed=10)[..., 0], np.full((30, 4), 7, np.uint8)], 1)
    pcx = bytearray(save(Image.fromarray(rows[:, :30]), "PCX")[:128])
    pcx[66:68] = struct.pack("<H", 34)                # rows of 34 bytes, as the header says
    pcx += b"".join(bytes([0xC1, v]) if v >= 0xC0 else bytes([v]) for v in rows.reshape(-1))
    lab = np.stack([grey, grey ^ 1, grey ^ 2])
    return {
        "fits 16-bit": (raw.fits_file(v, 16), same_as(v.astype(">i2").view("<u2"))),
        "fits 32-bit": (raw.fits_file(v, 32), same_as(v.astype(">i4").view("<i4"))),
        "fits float": (raw.fits_file(v.astype(np.float32), -32),
                       same_as(v.astype(">f4").view("<f4"))),
        "fits short data unit": (raw.fits_file(v[:1, :1].astype(np.uint8), 8)[:2881],
                                 same_as(np.array([[32]], np.uint8))),
        "sun rle padded rows": (raw.sun_file(grey, 8, ftype=2), differs(grey)),
        "psd lab": (raw.psd_file(lab, 9),
                    same_as(np.moveaxis(lab, 0, -1) ^ np.array([0, 128, 128], np.uint8))),
        "xbm one-digit value": (b"#define a_width 8\n#define a_height 1\n"
                                b"static char a_bits[] = { 0x5 };\n", xbm),
        "xpm #rgb": (b'/* XPM */\nstatic char *x[] = {\n"2 1 1 1",\n"a c #fff",\n"aa"\n};\n',
                     lambda im: np.testing.assert_array_equal(
                         np.asarray(im.convert("RGB")), [[[0, 15, 255]] * 2])),
        "pcx bytes per line": (bytes(pcx), differs(rows[:, :30])),
    }


MISREAD = _misread_cases()


@pytest.mark.parametrize("label", sorted(MISREAD))
def test_pillow_misreads_and_the_port_refuses(label):
    """Both behaviours: Pillow reads the file, and its pixels are not the
    file's (FITS samples byte-swapped, a data unit under 80 bytes read from
    the header's padding, Sun RLE rows without their padding, PSD Lab's a
    and b with the top bit flipped, `0x5` read as 0x50, `#fff` as (0, 15,
    255), PCX rows of the wrong stride); the port raises naming ROADMAP
    A.12."""
    data, check = MISREAD[label]
    _, im, _ = pil(data)
    check(im)
    with pytest.raises(ValueError, match="Pillow misreads.*A.12"):
        image_io.read_image(data, label)


# ------------------------------------------------------------ seeded corpus


def _headers() -> dict:
    """{format: a file's first bytes}: each new format's header."""
    f = {name: (port_formats.FIXTURES / name).read_bytes() for name in _new_fixtures()}
    return {"PPM": f["rgb16.ppm"][:16], "PPM plain": f["plain_rgb.ppm"][:40],
            "TGA": f["map16_topdown.tga"][:18 + 64 * 2], "QOI": f["blocks.qoi"][:14],
            "ICO": f["icon.ico"][:38], "CUR": f["cursor.cur"][:62], "DIB": f["rgb.dib"][:40],
            "PCX": f["palette.pcx"][:128], "DCX": f["pages.dcx"][:140],
            "SGI": f["rle.sgi"][:512 + 8 * 120], "SUN": f["rle_map.ras"][:32 + 288],
            "PSD": f["blocks.psd"][:120], "XBM": f["mask.xbm"][:120],
            "XPM": f["icon.xpm"][:300], "FITS": f["grey8.fits"][:2880]}


def corpus(kind: str):
    """(label, bytes) of one part of the seeded corpus."""
    r = np.random.RandomState({"random": 41, "tails": 42, "cuts": 43}[kind])
    if kind == "random":
        for k in range(3000):
            yield f"random {k}", r.randint(0, 256, r.randint(18, 401)).astype(np.uint8).tobytes()
    elif kind == "tails":
        for fmt, head in _headers().items():
            for k in range(100):
                n = r.randint(0, 600)
                if k % 2:
                    tail = r.choice([0, 1, 2, 0x7F, 0x80, 0x81, 0xC1, 0xFE, 0xFF], n)
                else:
                    tail = r.randint(0, 256, n)
                yield f"{fmt} + tail {k}", head + tail.astype(np.uint8).tobytes()
    else:
        for name in _new_fixtures():
            f = (port_formats.FIXTURES / name).read_bytes()
            for cut in r.choice(np.arange(1, len(f)), min(10, len(f) - 1), replace=False):
                yield f"{name} cut {cut}", f[:cut]
            for k in range(14):
                g = bytearray(f)
                lo = 0 if k % 2 else min(len(f) - 1, 32)
                for at in r.randint(lo, len(f), 1 + k % 3):
                    g[at] = r.randint(256)
                yield f"{name} flip {k}", bytes(g)


@pytest.mark.parametrize("kind", ["random", "tails", "cuts"])
def test_seeded_corpus_agrees_with_pil(kind):
    """On every case: both refuse; or both read it as the same format with
    the same mode and pixels; or Pillow identifies a format the port does
    not read and the port names it; or Pillow misreads (or only warns) and
    the port says so."""
    counts = {"refused": 0, "equal": 0, "named": 0, "misread": 0}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label, data in corpus(kind):
            try:
                fmt, im, warned = pil(data)
                want = np.asarray(im)
            except Exception:
                with pytest.raises(ValueError):
                    image_io.read_image(data, label)
                counts["refused"] += 1
                continue
            if fmt not in image_io.READ:
                with pytest.raises(ValueError, match=f"{fmt}, as Pillow"):
                    image_io.read_image(data, label)
                counts["named"] += 1
                continue
            try:
                got, pic = image_io.read_format(data, label)
            except ValueError as e:
                assert "Pillow misreads" in str(e) or (warned and "Pillow warns" in str(e)), \
                    (label, fmt, e)
                counts["misread"] += 1
                continue
            assert (got, pic.mode) == (fmt, im.mode), (label, got, pic.mode, fmt, im.mode)
            assert pic.pixels.dtype == want.dtype and pic.pixels.tobytes() == want.tobytes(), \
                label
            counts["equal"] += 1
    least = {"random": (0, 3000), "tails": (10, 300), "cuts": (250, 150)}[kind]
    assert counts["equal"] >= least[0] and counts["refused"] >= least[1], counts


# ------------------------------------------------------------ AddressSanitizer

HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
extern "C" {
int packbits_rows_decode(const uint8_t*, size_t, size_t, size_t, uint8_t*, char*, int);
int tga_rle_decode(const uint8_t*, size_t, int, size_t, size_t, uint8_t*, char*, int);
int pcx_rle_decode(const uint8_t*, size_t, size_t, size_t, uint8_t*, char*, int);
int sgi_rle_decode(const uint8_t*, size_t, int, int, int, int, uint8_t*, char*, int);
int sun_rle_decode(const uint8_t*, size_t, size_t, size_t, uint8_t*, char*, int);
int qoi_decode(const uint8_t*, size_t, size_t, int, uint8_t*, char*, int);
}
int main(int argc, char** argv) {
  char err[256];
  for (int i = 1; i < argc; i++) {
    FILE* f = std::fopen(argv[i], "rb");
    std::vector<uint8_t> b;
    for (int c; (c = std::fgetc(f)) != EOF;) b.push_back(uint8_t(c));
    std::fclose(f);
    const size_t n = b.size();
    uint8_t* d = static_cast<uint8_t*>(std::malloc(n + 1));   // exact size: over-reads trap
    std::memcpy(d, b.data(), n);
    const int shapes[][2] = {{1, 1}, {7, 3}, {34, 21}, {64, 9}};
    for (const auto& s : shapes) {
      const int w = s[0], h = s[1];
      for (int depth = 1; depth <= 4; depth++) {
        uint8_t* out = static_cast<uint8_t*>(std::malloc(size_t(w) * depth * h));
        tga_rle_decode(d, n, depth, size_t(w) * depth, h, out, err, 256);
        pcx_rle_decode(d, n, size_t(w) * depth, h, out, err, 256);
        sun_rle_decode(d, n, size_t(w) * depth, h, out, err, 256);
        packbits_rows_decode(d, n, size_t(w) * depth, h, out, err, 256);
        if (depth >= 3) qoi_decode(d, n, size_t(w) * h, depth, out, err, 256);
        std::free(out);
      }
      for (int bpc = 1; bpc <= 2; bpc++)
        for (int bands = 1; bands <= 4; bands++) {
          uint8_t* out = static_cast<uint8_t*>(std::malloc(size_t(w) * h * bands * bpc));
          sgi_rle_decode(d, n, w, h, bands, bpc, out, err, 256);
          std::free(out);
        }
    }
    std::free(d);
  }
  std::puts("done");
}
"""


def test_raster_loops_stay_in_bounds_under_asan(tmp_path):
    """The Targa, PCX, SGI, Sun raster and PSD PackBits loops and the QOI op
    stream built with AddressSanitizer and UBSan read and write only their
    own memory on the fixtures' coded data and seeded truncations and
    flips of it, at several shapes each."""
    from diffusion_spacetime_attn_tpu_torch.utils import lzw

    (tmp_path / "harness.cpp").write_text(HARNESS)
    flags = ["-O0", "-g", "-std=c++17", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=all"]
    exe = tmp_path / "harness"
    build = subprocess.run(["g++", *flags, "-o", str(exe), str(lzw.SOURCE),
                            str(tmp_path / "harness.cpp")], capture_output=True, text=True,
                           timeout=300)
    assert build.returncode == 0, build.stderr[-3000:]
    fx = {name: (port_formats.FIXTURES / name).read_bytes()
          for name in ("map16_topdown.tga", "palette.pcx", "rle.sgi", "rle_map.ras",
                       "cmyk.psd", "icon.ico")}
    streams = [fx["map16_topdown.tga"][18 + 128:], fx["palette.pcx"][128:], fx["rle.sgi"][512:],
               fx["rle_map.ras"][32 + 288:], fx["cmyk.psd"][40:],
               (port_formats.FIXTURES / "blocks.qoi").read_bytes()[14:3000]]
    r = np.random.RandomState(47)
    paths = []
    for j, f in enumerate(streams):
        for k in range(16):
            g = bytearray(f[:r.randint(1, len(f))] if k % 2 else f)
            for at in r.randint(0, len(g), k % 4):
                g[at] = r.randint(256)
            paths.append(tmp_path / f"s{j}_{k}.bin")
            paths[-1].write_bytes(bytes(g))
    res = subprocess.run([str(exe), *map(str, paths)], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert res.returncode == 0 and res.stdout.strip() == "done", res.stderr[-3000:]
