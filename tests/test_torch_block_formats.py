"""PyTorch port, the block-compressed textures Pillow 12.1 reads (DDS with
BC1-BC7, masked RGB, L / LA / P and R8G8B8A8; BLP1 and BLP2; FTEX), held
against Pillow on the CPU (`utils/{bcn,dds,blp,ftex}.py`, `native/bcn.cpp`;
numpy and Pillow only, no JAX program compiled):

* every committed block fixture: format, mode, pixels (dtype included) and
  `convert` to "RGB" and "L" against `Image.open`;
* seeded random blocks of every BCn variant Pillow decodes (BC1-BC7, BC5
  and BC6H signed) against Pillow's "bcn" decoder, and of BLP2's DXT1 /
  DXT3 / DXT5 against its Python decoders, at odd sizes and at 64x64:
  zero differences (random 16-byte strings reach every BC6H and BC7 mode,
  partition, rotation and reserved mode);
* each DDS pixel format, both BLP versions and FTEX, seeded files at 1x1,
  5x3, 63x65 and 64x64 against Pillow;
* seeded cuts and byte flips of every fixture: both refuse, or both read
  the same; the port refuses what Pillow reads only where Pillow misreads
  it, or where libjpeg only warns on a BLP1 JPEG's corrupt data;
* what Pillow misreads, asserted both ways, and what it refuses;
* the phase formats' 512x512 files (made from seeds here and in
  `chip_smoke.py` alike) against their committed Pillow digests, and
  `native/bcn.cpp` under AddressSanitizer and UBSan.

    python -m pytest tests/test_torch_block_formats.py -q      # ~10 s
"""
import hashlib
import io
import json
import os
import struct
import subprocess
import warnings

import numpy as np
import pytest
import torch
from PIL import BlpImagePlugin, Image

import chip_smoke
from diffusion_spacetime_attn_tpu_torch.utils import bcn, image_io
from helpers import port_formats
from helpers import raw_images as raw

torch.set_num_threads(1)
pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")

SIZES = ((1, 1), (5, 3), (63, 65), (64, 64))
BLOCK_FIXTURES = sorted(port_formats.block_images())


class Disk(io.BytesIO):
    """A file's seek: before the start it fails, as on a file on disk."""

    def seek(self, offset, whence=0):
        base = (0, self.tell(), len(self.getbuffer()))[whence]
        if base + offset < 0:
            raise OSError(22, "Invalid argument")
        return super().seek(offset, whence)


def pil(data: bytes):
    im = Image.open(Disk(data))
    im.load()
    return im


def assert_like_pil(data: bytes, label: str = ""):
    """Format, mode, pixels (dtype included) and both conversions."""
    want = pil(data)
    pixels = np.asarray(want)
    got, pic = image_io.read_format(data, label)
    assert (got, pic.mode) == (want.format, want.mode), (label, got, pic.mode, want.mode)
    assert pic.pixels.dtype == pixels.dtype and pic.pixels.shape == pixels.shape, label
    assert pic.pixels.tobytes() == pixels.tobytes(), label
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(image_io.convert(pic, mode), np.asarray(want.convert(mode)),
                                      err_msg=f"{label} convert {mode}")


@pytest.mark.parametrize("name", BLOCK_FIXTURES)
def test_block_fixtures_equal_pil(name):
    """Each committed fixture as Pillow opens and converts it."""
    assert_like_pil((port_formats.FIXTURES / name).read_bytes(), name)


# ------------------------------------------------------------ the decoders

VARIANTS = {"BC1": (1, ""), "BC2": (2, ""), "BC3": (3, ""), "BC4": (4, ""), "BC5": (5, ""),
            "BC5S": (5, "BC5S"), "BC6H": (6, "BC6H"), "BC6HS": (6, "BC6HS"), "BC7": (7, "")}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_random_blocks_equal_pillows_decoder(variant):
    """Seeded random blocks at odd sizes (partial blocks cut off), at 64x64
    and 2048 blocks more, decoded as Pillow's C decoder does; the signed
    BC6H blocks Pillow misreads are decoded as Pillow does (strict=False)."""
    n, fmt = VARIANTS[variant]
    seed = sorted(VARIANTS).index(variant)
    for w, h in SIZES + ((512, 64),):
        data = port_formats.random_blocks(n, w, h, 100 * seed + w)
        want = np.asarray(Image.frombytes(bcn.MODES[n], (w, h), data, "bcn", (n, fmt)))
        got = bcn.decode(data, n, w, h, fmt, strict=False)
        assert got.shape == want.shape and got.tobytes() == want.tobytes(), (variant, w, h)
    with pytest.raises(ValueError, match="truncated"):
        bcn.decode(data[:-1], n, 512, 64, fmt, strict=False)


BLP_DXT = {"DXT1": (1, False), "DXT1 alpha": (1, True), "DXT3": (2, True), "DXT5": (3, True)}


@pytest.mark.parametrize("kind", sorted(BLP_DXT))
def test_blp_dxt_equal_pillows_python_decoders(kind):
    """`bcn.decode(..., blp=True)` against BlpImagePlugin's decode_dxt1 /
    decode_dxt3 / decode_dxt5 (5-6-5 without bit replication; DXT1's alpha
    only with the header's alpha) on rows of seeded random blocks."""
    n, alpha = BLP_DXT[kind]
    w, h = 96, 32
    data = port_formats.random_blocks(n, w, h, 7 + n + 10 * alpha)
    line = w // 4 * bcn.block_bytes(n)
    rows = []
    for y in range(h // 4):
        chunk = data[y * line:(y + 1) * line]
        rows += (BlpImagePlugin.decode_dxt1(chunk, alpha) if n == 1 else
                 (BlpImagePlugin.decode_dxt3, BlpImagePlugin.decode_dxt5)[n - 2](chunk))
    want = np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, -1)
    got = bcn.decode(data, n, w, h, blp=True, alpha=alpha)
    np.testing.assert_array_equal(got, want, err_msg=kind)


# ------------------------------------------------- seeded files per format


def _payload(r, n, w, h):
    return r.randint(0, 256, n).astype(np.uint8).tobytes()


DDS_KINDS = {
    **{f"fourcc {f.decode()}": dict(fourcc=f, n=n) for f, n in
       ((b"DXT1", 1), (b"DXT3", 2), (b"DXT5", 3), (b"BC4U", 4), (b"ATI1", 4), (b"BC5U", 5),
        (b"BC5S", 5), (b"ATI2", 5))},
    **{f"dxgi {d}": dict(dxgi=d, n=n) for d, n in
       ((70, 1), (71, 1), (73, 2), (74, 2), (76, 3), (77, 3), (79, 4), (80, 4), (82, 5),
        (83, 5), (84, 5), (95, 6), (97, 7), (98, 7), (99, 7))},
    "dxgi 28 rgba": dict(dxgi=28, c=4),
    "rgb 565": dict(pfflags=0x40, bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0)),
    "argb 1555": dict(pfflags=0x41, bitcount=16, masks=(0x7C00, 0x3E0, 0x1F, 0x8000)),
    "bgr 24": dict(pfflags=0x40, bitcount=24, masks=(0xFF, 0xFF00, 0xFF0000, 0)),
    "rgb 332 gapped": dict(pfflags=0x40, bitcount=8, masks=(0xE0, 0x14, 0x3, 0)),
    "rgba 40-bit": dict(pfflags=0x41, bitcount=40, masks=(0xFFFFFFFF, 0, 0x10, 0x80000000)),
    "rgb 0-bit": dict(pfflags=0x40, bitcount=0, masks=(1, 2, 4, 0)),
    "luminance 8": dict(pfflags=0x20000, bitcount=8, c=1),
    "luminance alpha 16": dict(pfflags=0x20001, bitcount=16, c=2),
    "palette 8": dict(pfflags=0x20, bitcount=8, c=1, palette=True),
}


@pytest.mark.parametrize("kind", sorted(DDS_KINDS))
def test_dds_kinds_equal_pil(kind):
    """Each DDS pixel format at four sizes (masked RGB also with its data
    cut in half, which Pillow reads as zeros)."""
    k = dict(DDS_KINDS[kind])
    r = np.random.RandomState(sorted(DDS_KINDS).index(kind))
    n, c, pal = k.pop("n", None), k.pop("c", None), k.pop("palette", False)
    for w, h in SIZES:
        if n:
            data = port_formats.random_blocks(n, w, h, r.randint(1 << 30))
        else:
            per = c if c else k["bitcount"] / 8
            data = _payload(r, int(w * h * per), w, h)
        pal_bytes = _payload(r, 1024, 0, 0) if pal else b""
        assert_like_pil(raw.dds_file(w, h, data, palette=pal_bytes, **k), f"{kind} {w}x{h}")
        if "masks" in k:
            assert_like_pil(raw.dds_file(w, h, data[:len(data) // 2], **k), f"{kind} half")


def _jpeg_parts(w, h, mode, seed):
    buf = io.BytesIO()
    Image.fromarray(port_formats._image(h, w, seed)).convert(mode).save(buf, "JPEG", quality=90)
    jpeg = buf.getvalue()
    sos = jpeg.index(b"\xff\xda")
    return jpeg[:sos], jpeg[sos:]


BLP_KINDS = ("blp1 palette 4", "blp1 palette 5", "blp1 jpeg RGB", "blp1 jpeg L",
             "blp1 jpeg CMYK", "blp1 jpeg RGB alpha", "blp2 palette", "blp2 dxt1",
             "blp2 dxt1 alpha", "blp2 dxt3 alpha", "blp2 dxt5 alpha")


@pytest.mark.parametrize("kind", BLP_KINDS)
def test_blp_kinds_equal_pil(kind):
    """Each BLP kind at four sizes (DXT at widths that are multiples of 4)."""
    r = np.random.RandomState(BLP_KINDS.index(kind) + 20)
    pal = _payload(r, 1024, 0, 0)
    sizes = ((4, 1), (8, 3), (64, 65), (64, 64)) if "dxt" in kind else SIZES
    for w, h in sizes:
        if kind.startswith("blp1 palette"):
            data = raw.blp1_file(w, h, 1, 0, [_payload(r, w * h, w, h)], palette=pal,
                                 encoding=int(kind[-1]))
        elif kind.startswith("blp1 jpeg"):
            head, rest = _jpeg_parts(w, h, kind.split()[2], r.randint(100))
            data = raw.blp1_file(w, h, 0, 8 * kind.endswith("alpha"), [rest], jpeg_header=head)
        elif kind == "blp2 palette":
            data = raw.blp2_file(w, h, 1, 0, 0, [_payload(r, w * h, w, h)], pal)
        else:
            n = int(kind[8]) // 2 + 1
            blocks = port_formats.random_blocks(n, w, h, r.randint(1 << 30))
            data = raw.blp2_file(w, h, 2, 8 * kind.endswith("alpha"), {1: 0, 2: 1, 3: 7}[n],
                                 [blocks], pal)
        assert_like_pil(data, f"{kind} {w}x{h}")


@pytest.mark.parametrize("fmt", [0, 1])
def test_ftex_formats_equal_pil(fmt):
    """FTEX format 0 (DXT1) and 1 (raw RGB) at four sizes."""
    r = np.random.RandomState(30 + fmt)
    for w, h in SIZES:
        mip = (port_formats.random_blocks(1, w, h, r.randint(1 << 30)) if fmt == 0
               else _payload(r, w * h * 3, w, h))
        assert_like_pil(raw.ftex_file(w, h, fmt, mip), f"ftex {fmt} {w}x{h}")


# ------------------------------------------------------ cuts and flips


def corpus(name: str):
    """(label, bytes): seeded cuts and byte flips of one fixture, the flips
    in the header or anywhere."""
    f = (port_formats.FIXTURES / name).read_bytes()
    r = np.random.RandomState(BLOCK_FIXTURES.index(name) + 50)
    for cut in r.choice(np.arange(1, len(f)), 8, replace=False):
        yield f"{name} cut {cut}", f[:cut]
    for k in range(24):
        g = bytearray(f)
        hi = min(len(f), 200) if k % 2 else len(f)
        for at in r.randint(4 * (k % 3 > 0), hi, 1 + k % 3):
            g[at] = r.randint(256)
        yield f"{name} flip {k}", bytes(g)


@pytest.mark.parametrize("name", BLOCK_FIXTURES)
def test_cuts_and_flips_agree_with_pil(name):
    """Both refuse (the port with `ValueError`); or both read the same
    format, mode and pixels; or Pillow misreads the file and the port says
    so; or (BLP1 JPEG) libjpeg only warns on corrupt data the port's codec
    refuses, as for any JPEG."""
    counts = {"refused": 0, "equal": 0, "misread": 0, "corrupt jpeg": 0}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label, data in corpus(name):
            try:
                im = pil(data)
                want = np.asarray(im)
            except Exception:
                with pytest.raises(ValueError):
                    image_io.read_image(data, label)
                counts["refused"] += 1
                continue
            try:
                got, pic = image_io.read_format(data, label)
            except ValueError as e:
                if "Pillow misreads" in str(e):
                    counts["misread"] += 1
                    continue
                assert name == "jpeg1.blp" and im.format == "BLP", (label, e)
                counts["corrupt jpeg"] += 1
                continue
            assert (got, pic.mode) == (im.format, im.mode), (label, got, pic.mode, im.mode)
            assert pic.pixels.dtype == want.dtype and pic.pixels.tobytes() == want.tobytes(), \
                label
            counts["equal"] += 1
    assert counts["refused"] >= 1 and counts["equal"] + counts["misread"] >= 4, counts


# ------------------------------------------------ what Pillow misreads


def _bc6_block(fields) -> bytes:
    """A BC6H block from (value, bits) fields, lowest bits first."""
    v, at = 0, 0
    for value, n in fields:
        v |= (value & ((1 << n) - 1)) << at
        at += n
    assert at == 128
    return v.to_bytes(16, "little")


def _misread_cases() -> dict:
    """{label: (file, check of Pillow's image)}: files Pillow reads other
    than their format's specification; each check asserts what Pillow gives
    and that it is not the file's image."""
    rgba = port_formats._image(8, 10, 80, c=4)
    rgb = rgba[..., :3]
    pal = np.zeros((256, 4), np.uint8)
    pal[:, 3] = 255
    pal[:10, :3] = rgb[0, :, ::-1]
    idx = np.tile(np.arange(10, dtype=np.uint8), (8, 1))
    plane = np.full(80, 7, np.uint8)           # an 8-bit alpha plane after the indices
    dxt1 = port_formats.random_blocks(1, 5, 4, 81)
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, "DDS", pixel_format="DXT3")
    dxt3 = buf.getvalue()[128:]
    head, rest = _jpeg_parts(10, 8, "CMYK", 82)
    small_head, small_rest = _jpeg_parts(12, 12, "RGB", 83)
    # mode 00111: one region, 11-bit base -100 and 9-bit deltas -5 on every
    # channel: the specification's endpoints are both negative (0 on every
    # pixel); Pillow leaves -105's 11 bits unsigned, the largest value
    w11, d9 = -100 & 0x7FF, -5 & 0x1FF
    block = _bc6_block([(0b00111, 5)] + [(w11, 10)] * 3 + [(d9, 9), (w11 >> 10, 1)] * 3
                       + [(7, 3)] + [(15, 4)] * 15)
    return {
        "blp1 palette with an alpha plane": (
            raw.blp1_file(10, 8, 1, 8, [idx.tobytes() + plane.tobytes()],
                          palette=pal.tobytes()),
            lambda im: np.testing.assert_array_equal(np.asarray(im)[..., 3], 255)),
        "blp2 palette with an alpha plane": (
            raw.blp2_file(10, 8, 1, 8, 0, [idx.tobytes() + plane.tobytes()], pal.tobytes()),
            lambda im: np.testing.assert_array_equal(np.asarray(im)[..., 3], 255)),
        "blp2 dxt1 of width 5": (
            raw.blp2_file(5, 4, 2, 0, 0, [dxt1], pal.tobytes()),
            lambda im: np.testing.assert_array_equal(
                np.asarray(im), bcn.decode(dxt1, 1, 8, 4, blp=True, alpha=False)
                .reshape(-1, 3)[:20].reshape(4, 5, 3))),
        "blp2 dxt3 without alpha": (
            raw.blp2_file(8, 8, 2, 0, 1, [dxt3], pal.tobytes()),
            lambda im: np.testing.assert_array_equal(
                np.asarray(im), bcn.decode(dxt3, 2, 8, 8, blp=True)
                .reshape(-1)[:192].reshape(8, 8, 3))),
        "blp1 jpeg with alpha, four channels": (
            raw.blp1_file(10, 8, 0, 8, [rest], jpeg_header=head),
            lambda im: np.testing.assert_array_equal(np.asarray(im)[..., 3], 255)),
        "blp1 jpeg larger than its header": (
            raw.blp1_file(8, 8, 0, 0, [small_rest], jpeg_header=small_head),
            lambda im: np.testing.assert_array_equal(
                np.asarray(im), np.asarray(Image.open(io.BytesIO(small_head + small_rest))
                                           .convert("RGB"))[..., ::-1].reshape(-1, 3)[:64]
                .reshape(8, 8, 3))),
        "dds bc6h signed sums": (
            raw.dds_file(4, 4, block, dxgi=96),
            lambda im: np.testing.assert_array_equal(np.asarray(im).reshape(16, 3)[1:], 255)),
    }


MISREAD = _misread_cases()


@pytest.mark.parametrize("label", sorted(MISREAD))
def test_pillow_misreads_and_the_port_refuses(label):
    """Both behaviours: Pillow reads the file, and its pixels are not the
    file's (alpha from the palette where an alpha plane follows the
    indices, DXT rows of 4·⌈w/4⌉ pixels read at a stride of w, RGBA DXT3
    pixels read as RGB, a BGRA JPEG's alpha lost, a larger JPEG's rows read
    at the header's width, a signed BC6H endpoint left positive); the port
    raises naming ROADMAP A.12."""
    data, check = MISREAD[label]
    check(pil(data))
    with pytest.raises(ValueError, match="Pillow misreads.*A.12"):
        image_io.read_image(data, label)


def test_blp1_jpeg_of_four_channels_without_alpha():
    """Pillow reads a BLP1 JPEG's four channels as inverted CMYK, which
    multiplies the colours by the fourth: where it is 255 that is the
    image (read), elsewhere not (refused naming A.12)."""
    rgb = port_formats._image(8, 10, 84)
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("CMYK").save(buf, "JPEG", quality=95)
    jpeg = buf.getvalue()
    sos = jpeg.index(b"\xff\xda")
    data = raw.blp1_file(10, 8, 0, 0, [jpeg[sos:]], jpeg_header=jpeg[:sos])
    assert_like_pil(data, "cmyk, k 0")
    cmyk = np.asarray(Image.open(io.BytesIO(jpeg)))
    assert not cmyk[..., 3].any()
    cmyk = cmyk.copy()
    cmyk[..., 3] = 100
    buf = io.BytesIO()
    Image.fromarray(cmyk, "CMYK").save(buf, "JPEG", quality=95)
    jpeg = buf.getvalue()
    sos = jpeg.index(b"\xff\xda")
    data = raw.blp1_file(10, 8, 0, 0, [jpeg[sos:]], jpeg_header=jpeg[:sos])
    assert np.asarray(pil(data)).max() < 200               # darkened by K
    with pytest.raises(ValueError, match="fourth channel.*Pillow misreads.*A.12"):
        image_io.read_image(data)


def test_jpeg_restart_segment_of_another_length_raises_as_pil():
    """A DRI segment must hold 4 bytes (libjpeg's get_dri); the codec read
    longer ones until a BLP1 JPEG's flipped byte showed it: a DRI of 4
    bytes reads as Pillow reads it, one of 6 raises where Pillow does."""
    buf = io.BytesIO()
    Image.fromarray(port_formats._image(16, 24, 85)).save(buf, "JPEG", quality=80)
    jpeg = buf.getvalue()
    assert_like_pil(jpeg[:2] + b"\xff\xdd\x00\x04\x00\x00" + jpeg[2:], "DRI of 4 bytes")
    bad = jpeg[:2] + b"\xff\xdd\x00\x06\x00\x00\x00\x00" + jpeg[2:]
    with pytest.raises(OSError):
        pil(bad)
    with pytest.raises(ValueError, match="bad DRI length"):
        image_io.read_image(bad)


def test_jpeg_markers_pillow_refuses_pass_the_file_on():
    """`JpegImageFile._open`'s marker walk (`jpeg.pillow_header`) before the
    codec: a file Pillow's walk refuses is passed on to the next format, so
    neither identifies it (the port read the first case before it ran the
    walk)."""
    buf = io.BytesIO()
    Image.fromarray(port_formats._image(16, 24, 86)).save(buf, "JPEG", quality=80)
    jpeg = buf.getvalue()
    dqt, sof = jpeg.index(b"\xff\xdb"), jpeg.index(b"\xff\xc0")
    twelve = bytearray(jpeg)
    twelve[sof + 4] = 12
    for data in (jpeg[:2] + b"\x00" + jpeg[2:], jpeg[:2] + b"\xff\x02" + jpeg[2:],
                 jpeg[:dqt] + b"\xff\xdb\x00\x05\x00\x01\x02" + jpeg[dqt:], bytes(twelve)):
        with pytest.raises(Exception, match="cannot identify"):
            Image.open(io.BytesIO(data))
        with pytest.raises(ValueError, match="not an image file Pillow 12.1 identifies"):
            image_io.read_image(data)


# ---------------------------------------------------- what Pillow refuses


def _refused() -> dict:
    """{label: (file, format the port names or None: Pillow identifies no
    format)}."""
    dxt1 = port_formats.random_blocks(1, 8, 8, 90)
    ok = raw.dds_file(8, 8, dxt1, fourcc=b"DXT1")
    pal = bytes(1024)
    return {
        "dds header size 100": (ok[:4] + struct.pack("<I", 100) + ok[8:], "DDS"),
        "dds header cut": (ok[:100], "DDS"),
        "dds fourcc DXT2": (raw.dds_file(8, 8, dxt1, fourcc=b"DXT2"), "DDS"),
        "dds bc1 unorm srgb": (raw.dds_file(8, 8, dxt1, dxgi=72), "DDS"),
        "dds bc4 snorm": (raw.dds_file(8, 8, dxt1, dxgi=81), "DDS"),
        "dds luminance 16 without alpha": (raw.dds_file(8, 8, bytes(128), pfflags=0x20000,
                                                        bitcount=16), "DDS"),
        "dds no pixel format": (raw.dds_file(8, 8, dxt1, pfflags=0), "DDS"),
        "dds blocks cut": (ok[:-1], "DDS"),
        "dds dx10 header cut": (raw.dds_file(8, 8, b"", dxgi=71)[:130], None),
        "blp1 compression 2": (raw.blp1_file(8, 8, 2, 0, [bytes(64)], palette=pal), "BLP"),
        "blp1 encoding 3": (raw.blp1_file(8, 8, 1, 0, [bytes(64)], palette=pal, encoding=3),
                            "BLP"),
        "blp1 palette cut": (raw.blp1_file(8, 8, 1, 0, [bytes(64)], palette=pal)[:1000], "BLP"),
        "blp1 too few indices": (raw.blp1_file(8, 8, 1, 0, [bytes(63)], palette=pal), "BLP"),
        "blp2 encoding 3": (raw.blp2_file(8, 8, 3, 0, 0, [bytes(256)], pal), "BLP"),
        "blp2 alpha encoding 2": (raw.blp2_file(8, 8, 2, 8, 2, [bytes(64)], pal), "BLP"),
        "blp2 dxt cut": (raw.blp2_file(8, 8, 2, 0, 0, [dxt1[:-1]], pal), "BLP"),
        "blp header cut": (b"BLP2" + bytes(10), None),
        "ftex two formats": (raw.ftex_file(8, 8, 0, dxt1, formats=2), "FTEX"),
        "ftex format 2": (raw.ftex_file(8, 8, 2, dxt1), "FTEX"),
        "ftex data cut": (raw.ftex_file(8, 8, 1, bytes(191)), "FTEX"),
        "ftex header cut": (b"FTEX" + bytes(12), None),
    }


REFUSED = _refused()


@pytest.mark.parametrize("label", sorted(REFUSED))
def test_what_pillow_refuses_raises(label):
    """Pillow fails on each file; the port raises `ValueError` naming the
    format Pillow took it for, or, where Pillow passes the file on and no
    format takes it, saying so."""
    data, fmt = REFUSED[label]
    with pytest.raises(Exception):
        pil(data)
    match = fmt if fmt else "not an image file Pillow 12.1 identifies"
    with pytest.raises(ValueError, match=match):
        image_io.read_image(data, "x")


# ---------------------------------------------- phase formats' 512x512 files


@pytest.mark.parametrize("name", sorted(port_formats.BLOCKS_512))
def test_generated_512_files_match_their_digests(name):
    """`chip_smoke.py` makes the same bytes as the helper; Pillow's digests
    of them are the committed ones, and the port's pixels and RGB give
    them."""
    data = port_formats.block_file_512(name)
    assert chip_smoke.block_file_512(name) == data
    want = json.loads((port_formats.FIXTURES / "digests.json").read_text())["generated"][name]
    assert port_formats.generated_digests()[name] == want
    pic = image_io.read_image(data, name)
    assert hashlib.sha256(data).hexdigest() == want["file"]
    assert pic.mode == want["mode"] and list(pic.pixels.shape) == want["shape"]
    assert hashlib.sha256(pic.pixels.tobytes()).hexdigest() == want["pixels"]
    assert hashlib.sha256(image_io.convert(pic, "RGB").tobytes()).hexdigest() == want["rgb"]


# ------------------------------------------------------------ AddressSanitizer

HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
extern "C" int bcn_decode(const uint8_t*, size_t, int, int, int, int, int, uint8_t*, char*, int);
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
    const int shapes[][2] = {{1, 1}, {5, 3}, {37, 23}, {64, 9}};
    for (const auto& s : shapes)
      for (int bc = 1; bc <= 7; bc++)
        for (int flags = 0; flags < 8; flags++)
          for (int ch = 1; ch <= 4; ch++) {
            uint8_t* out = static_cast<uint8_t*>(std::malloc(size_t(s[0]) * s[1] * ch));
            bcn_decode(d, n, bc, flags, s[0], s[1], ch, out, err, 256);
            std::free(out);
          }
    std::free(d);
  }
  std::puts("done");
}
"""


def test_bcn_stays_in_bounds_under_asan(tmp_path):
    """`native/bcn.cpp` built with AddressSanitizer and UBSan reads and
    writes only its own memory on the fixtures' block data and seeded cuts
    and flips of it, for every variant, flag and channel count."""
    (tmp_path / "harness.cpp").write_text(HARNESS)
    flags = ["-O0", "-g", "-std=c++17", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=all"]
    exe = tmp_path / "harness"
    build = subprocess.run(["g++", *flags, "-o", str(exe), str(bcn.SOURCE),
                            str(tmp_path / "harness.cpp")], capture_output=True, text=True,
                           timeout=300)
    assert build.returncode == 0, build.stderr[-3000:]
    streams = [(port_formats.FIXTURES / name).read_bytes()[148:]
               for name in ("bc6h_uf16.dds", "bc6h_sf16.dds", "bc7.dds", "dxt5.dds")]
    streams.append(_misread_cases()["dds bc6h signed sums"][0][148:])
    r = np.random.RandomState(91)
    paths = []
    for j, f in enumerate(streams):
        for k in range(8):
            g = bytearray(f[:r.randint(1, len(f))] if k % 2 else f)
            for at in r.randint(0, len(g), k % 4):
                g[at] = r.randint(256)
            paths.append(tmp_path / f"s{j}_{k}.bin")
            paths[-1].write_bytes(bytes(g))
    res = subprocess.run([str(exe), *map(str, paths)], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert res.returncode == 0 and res.stdout.strip() == "done", res.stderr[-3000:]
