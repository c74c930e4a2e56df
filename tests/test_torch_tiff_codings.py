"""PyTorch port, the TIFFs Pillow 12.1 (libtiff 4.7.1) opens that the port
refused or misread, held against Pillow on the CPU (`utils/tiff.py`,
`native/ccitt.cpp`, `native/lzw.cpp`; numpy only, no JAX program compiled):

* JPEG-in-TIFF (7): RGB, YCbCr (4:4:4 as Pillow writes it, 4:2:0 and 4:2:2
  strips from `helpers/jpeg_codings.py`), grey in tiles, CMYK; JPEGTables
  put before each strip's stream;
* YCbCr under the other codings, as libtiff's RGBA interface converts it
  (4:4:4 chunky and planar, 4:2:0 and 4:1:1 data units, BT.709
  coefficients and a studio-range ReferenceBlackWhite), and old-style JPEG
  (6) of one whole JPEG stream (4:2:0 and 4:4:4);
* CCITT modified Huffman (2), Group 3 1-D and 2-D, Group 4, white-is-zero
  and fill order 2; ThunderScan (32809);
* LZMA (34925), Zstandard (50000), BigTIFF, fill order 2 at 1 and 8 bits;
* 16-bit RGB and RGBA (alpha associated, unassociated, unused), signed 8-,
  16- and 32-bit, unsigned 32-bit and float samples (predictors 2 and 3),
  CIE L*a*b*, palette + alpha;
* orientation 1-8 in strips and tiles of a non-square image (2-4 were read
  unflipped);

each checked three ways: `read_image`'s mode, pixels (dtype included) and
palette against `np.asarray(Image.open(f))`; `convert` to "RGB" and "L"
against Pillow's (L*a*b* raises where Pillow converts through LittleCMS, and
refuses "L" as Pillow does); and JAX's `training/image_data.load_image`
against the port's at two sizes and two filters.  A seeded sweep of layouts
(Pillow's table of photometric, sample format, fill order, depth and extra
samples, crossed with codings, byte orders, BigTIFF, strips, tiles, planes,
predictors and orientations) gives Pillow's pixels or raises where Pillow
refuses or misreads.  What Pillow refuses raises `ValueError` naming ROADMAP
A.12; seeded truncations and byte flips of every new coding raise or give
Pillow's pixels; the CCITT and ThunderScan decoders stay in bounds under
AddressSanitizer.

    python -m pytest tests/test_torch_tiff_codings.py -q     # ~10 s
"""
import io
import os
import subprocess
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from diffusion_spacetime_attn_tpu.training import image_data as jdata
from diffusion_spacetime_attn_tpu_torch.training import image_data as tdata
from diffusion_spacetime_attn_tpu_torch.utils import image_io
from helpers import jpeg_codings as jc
from helpers import port_formats
from helpers import raw_images as raw

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def image(h, w, c=3, seed=0):
    return port_formats._image(h, w, seed, c)


def pil(data: bytes):
    return Image.open(io.BytesIO(data))


def pil_tiff(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def strips_of(data: bytes) -> bytes:
    """The coded bytes of a one-strip TIFF's strip."""
    t = pil(data).tag_v2
    return data[t[273][0]:t[273][0] + t[279][0]]


def assert_like_pil(data: bytes, label: str = ""):
    """Mode, pixels (dtype included), palette and both conversions."""
    want = pil(data)
    pixels = np.asarray(want)
    pic = image_io.read_image(data, label)
    assert pic.mode == want.mode, (label, pic.mode, want.mode)
    assert pic.pixels.dtype == pixels.dtype and pic.pixels.shape == pixels.shape, label
    assert pic.pixels.tobytes() == pixels.tobytes(), label
    if want.mode in ("P", "PA"):
        pal = np.asarray(want.getpalette()[:768], np.uint8).reshape(-1, 3)
        np.testing.assert_array_equal(pic.palette[:len(pal)], pal, err_msg=label)
    for mode in ("RGB", "L"):
        if want.mode == "LAB":
            with pytest.raises(ValueError, match="A.12" if mode == "RGB" else "LAB|L\\*a\\*b"):
                image_io.convert(pic, mode)
            continue
        np.testing.assert_array_equal(image_io.convert(pic, mode), np.asarray(want.convert(mode)),
                                      err_msg=f"{label} convert {mode}")
    return pic


def _mask(h=45, w=61):
    return port_formats._mask(h, w) ^ (image(h, w, 1, seed=3)[..., 0] > 200)


def _ccitt_rlew(bits: np.ndarray) -> bytes:
    """Modified Huffman rows padded to 16 bits (libtiff's CCITTRLEW): each
    row coded alone by libtiff's MH encoder, then padded."""
    rows = []
    for row in bits:
        data = strips_of(pil_tiff(Image.fromarray(row[None]), compression="tiff_ccitt"))
        rows.append(data + b"\x00" * (len(data) % 2))
    return raw.tiff_file(bits[..., None].astype(np.uint8), 1, 1, chunks=[b"".join(rows)],
                         tags={259: (3, [32771])})


def _thunderscan(levels: np.ndarray, seed: int) -> bytes:
    """4-bit grey as ThunderScan codes: raw pixels, runs of the last pixel
    (never to a row's end), 2- and 3-bit deltas where they reach."""
    r = np.random.RandomState(seed)
    out = bytearray()
    for row in levels:
        last, x, w = 0, 0, len(row)
        while x < w:
            v = int(row[x])
            run = 1
            while x + run < w and row[x + run] == last and run < 63:
                run += 1
            if v == last and 1 < run < w - x and r.rand() < 0.8:
                out.append(run)
                x += run
            elif (v - last) % 16 in (1, 2, 3, 13, 14, 15) and r.rand() < 0.5:
                d = (v - last) % 16
                out.append(0x80 | ({1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}[d] << 3) | 4)
                last, x = v, x + 1
            else:
                out.append(0xC0 | v)
                last, x = v, x + 1
    return raw.tiff_file(levels[..., None], 4, 1, chunks=[bytes(out)], tags={259: (3, [32809])})


def _jpeg_strips(img: np.ndarray, sampling, rows: int) -> bytes:
    chunks = [jc.huffman_file(jc.coefficients(img[y:y + rows], sampling, 85))
              for y in range(0, img.shape[0], rows)]
    return raw.tiff_file(img, 8, 6, chunks=chunks, rows_per_strip=rows,
                         tags={259: (3, [7]), 530: (3, list(sampling[0]))})


def _jpeg(a, **kw):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _ycbcr_units(h: int, w: int, sub, seed: int, tags=None) -> bytes:
    """Seeded YCbCr data units (sh·sv luma samples, then Cb, Cr) of an h x w
    image, Deflate-coded: what libtiff's RGBA interface reads."""
    sh, sv = sub
    n = -(-h // sv) * -(-w // sh) * (sh * sv + 2)
    units = np.random.RandomState(seed).randint(0, 256, n).astype(np.uint8).tobytes()
    return raw.tiff_file(np.zeros((h, w, 3), np.uint8), 8, 6, chunks=[zlib.compress(units)],
                         tags={259: (3, [8]), 530: (3, list(sub)), **(tags or {})})


def kinds() -> dict:
    """{label: file bytes} of one file of every new kind."""
    rgb = Image.fromarray(image(45, 61, seed=1))
    a16 = image(37, 29, 4, seed=2).astype(np.uint16) * 257 + image(37, 29, 4, seed=5)
    assoc = np.concatenate([a16[..., :3].astype(np.int64) * a16[..., 3:] // 65535,
                            a16[..., 3:]], -1).astype(np.uint16)
    r = np.random.RandomState(7)
    grey = image(33, 47, 1, seed=4)
    floats = (r.randn(33, 47, 1) * 300).astype(np.float32)
    mask = _mask()
    pal = {320: (3, [int(v) for v in r.randint(0, 65536, 768)])}
    return {
        "jpeg rgb": pil_tiff(rgb, compression="jpeg", quality=80),
        "jpeg ycbcr": pil_tiff(rgb.convert("YCbCr"), compression="jpeg"),
        "jpeg ycbcr 4:2:0 strips": _jpeg_strips(image(40, 52, seed=6), [(2, 2), (1, 1), (1, 1)],
                                                16),
        "jpeg ycbcr 4:2:2": _jpeg_strips(image(23, 50, seed=8), [(2, 1), (1, 1), (1, 1)], 23),
        "jpeg grey tiles": pil_tiff(rgb.convert("L"), compression="jpeg", tile=(32, 16)),
        "jpeg cmyk": pil_tiff(rgb.convert("CMYK"), compression="jpeg", quality=90),
        "ccitt mh": pil_tiff(Image.fromarray(mask), compression="tiff_ccitt"),
        "ccitt g3": pil_tiff(Image.fromarray(mask), compression="group3"),
        "ccitt g3 2d fill": pil_tiff(Image.fromarray(mask), compression="group3",
                                     tiffinfo={292: 5, 278: 16}),
        "ccitt g4": pil_tiff(Image.fromarray(mask), compression="group4"),
        "ccitt g4 white0 fill2": pil_tiff(Image.fromarray(mask), compression="group4",
                                          tiffinfo={262: 0, 266: 2}),
        "thunderscan": _thunderscan(grey[..., 0] >> 4, 1),
        "lzma": pil_tiff(rgb, compression="lzma"),
        "zstd predictor": raw.tiff_file(image(45, 61, seed=9), 8, 2, compression=50000,
                                        predictor=2, rows_per_strip=10),
        "bigtiff": pil_tiff(rgb, big_tiff=True),
        "bigtiff tiles lzw": raw.tiff_file(image(40, 52, 4, seed=3), 8, 2, compression=5,
                                           tile=(16, 16), extra=(2,), big_tiff=True),
        "fill2 1-bit": raw.tiff_file(mask[..., None].astype(np.uint8), 1, 0, fill_order=2),
        "fill2 8-bit lzw": raw.tiff_file(grey, 8, 1, compression=5, fill_order=2),
        "fill2 rgb deflate": raw.tiff_file(image(20, 30, seed=2), 8, 2, compression=8,
                                           fill_order=2, big_endian=True),
        "rgb16": raw.tiff_file(a16[..., :3], 16, 2, compression=8, predictor=2),
        "rgba16 associated planar": raw.tiff_file(assoc, 16, 2, big_endian=True, compression=5,
                                                  planar=2, extra=(1,)),
        "rgba16 unassociated": raw.tiff_file(a16, 16, 2, extra=(2,)),
        "rgbx16": raw.tiff_file(a16, 16, 2, big_endian=True, extra=(0,)),
        "int8": raw.tiff_file(grey.astype(np.int8) - 100, 8, 1, sample_format=(2,)),
        "int16 mm": raw.tiff_file((grey.astype(np.int16) - 100) * 200, 16, 1, big_endian=True,
                                  sample_format=(2,)),
        "int16 zstd": raw.tiff_file((grey.astype(np.int16) - 100) * 200, 16, 1,
                                    compression=50000, predictor=2, sample_format=(2,)),
        "int32": pil_tiff(Image.fromarray((grey[..., 0].astype(np.int32) - 90) * 9999)),
        "uint32 lzw": raw.tiff_file(grey.astype(np.uint32) * 16777259, 32, 1, compression=5,
                                    predictor=2),
        "float": pil_tiff(Image.fromarray(floats[..., 0])),
        "float predictor 3": raw.tiff_file(floats, 32, 1, compression=8, predictor=3,
                                           sample_format=(3,), rows_per_strip=7),
        "float predictor 2 mm raw": raw.tiff_file(floats, 32, 0, big_endian=True,
                                                  sample_format=(3,), tile=(16, 16)),
        "lab": pil_tiff(rgb.convert("LAB")),
        "pa": raw.tiff_file(np.concatenate([grey, grey[::-1]], -1), 8, 3, extra=(2,),
                            compression=32773, tags=pal),
        "cmyk16": raw.tiff_file(a16, 16, 5, compression=34925),
        "old jpeg 4:2:0": raw.tiff_file(np.zeros((23, 37, 3), np.uint8), 8, 6,
                                        chunks=[_jpeg(image(23, 37, seed=16))],
                                        tags={259: (3, [6]), 512: (3, [1])}),
        "old jpeg 4:4:4": raw.tiff_file(np.zeros((16, 24, 3), np.uint8), 8, 6,
                                        chunks=[_jpeg(image(16, 24, seed=17), subsampling=0)],
                                        tags={259: (3, [6]), 512: (3, [1])}),
        "ycbcr lzw": raw.tiff_file(image(19, 23, seed=10), 8, 6, compression=5,
                                   tags={530: (3, [1, 1])}),
        "ycbcr deflate 4:2:0 bt709": _ycbcr_units(
            21, 30, (2, 2), 11, {529: (5, [2126, 10000, 7152, 10000, 722, 10000]),
                                 532: (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])}),
        "ycbcr deflate 4:1:1": _ycbcr_units(17, 29, (4, 1), 12),
        "ycbcr planar zstd": raw.tiff_file(image(19, 23, seed=13), 8, 6, compression=50000,
                                           planar=2, tile=(16, 16), tags={530: (3, [1, 1])}),
    }


KINDS = kinds()


@pytest.mark.parametrize("label", sorted(KINDS))
def test_new_kinds_equal_pil(label, tmp_path):
    """Each kind's mode, pixels and palette, its conversions, and JAX's
    loader on it against the port's at two sizes and two filters."""
    data = KINDS[label]
    pic = assert_like_pil(data, label)
    path = tmp_path / "x.tif"
    path.write_bytes(data)
    for size in (32, 77):
        for interp in ("bicubic", "bilinear"):
            want = np.asarray(jdata.load_image(str(path), size, interp))
            if pic.mode == "LAB":
                with pytest.raises(ValueError, match="A.12"):
                    tdata.load_image(str(path), size, interp)
                continue
            np.testing.assert_array_equal(tdata.load_image(str(path), size, interp), want,
                                          err_msg=f"{label} {size} {interp}")


def test_new_kinds_carry_their_tags():
    """The files are what their labels say (Pillow's writer honours the
    tags passed to it)."""
    tags = {label: pil(data).tag_v2 for label, data in KINDS.items()}
    assert tags["ccitt g3 2d fill"][292] == 5
    assert tags["ccitt g4 white0 fill2"][262] == 0 and tags["ccitt g4 white0 fill2"][266] == 2
    assert tags["jpeg ycbcr"][262] == 6 and tags["jpeg ycbcr 4:2:0 strips"][530] == (2, 2)
    assert KINDS["bigtiff"][:4] == b"II+\x00"
    assert tags["float predictor 3"][317] == 3 and tags["int32"][339] == (2,)


@pytest.mark.parametrize("tiled", [False, True], ids=["strips", "tiles"])
@pytest.mark.parametrize("orientation", range(1, 9))
def test_orientation_equals_pil(orientation, tiled):
    """Tag 274 applied after decoding, as Pillow's exif_transpose: a 21x34
    image comes out 34x21 at 5-8; at 2-4 the port gave the stored
    (unflipped) samples, which differ from Pillow's."""
    a = image(21, 34, seed=orientation)
    layout = dict(tile=(16, 16)) if tiled else dict(rows_per_strip=5)
    for photo, s, bits in ((2, a, 8), (1, a[..., :1].astype(np.uint16) * 251, 16),
                           (0, (a[..., :1] > 128).astype(np.uint8), 1)):
        data = raw.tiff_file(s, bits, photo, compression=8, tags={274: (3, [orientation])},
                             **layout)
        pic = assert_like_pil(data, f"orientation {orientation} p{photo}")
        stored = np.asarray(pil(raw.tiff_file(s, bits, photo, compression=8, **layout)))
        if orientation > 1:
            assert pic.pixels.shape != stored.shape or not np.array_equal(pic.pixels, stored)


@pytest.mark.parametrize("label,build,pil_opens", [
    ("sgilog", lambda: raw.tiff_file(image(8, 8), 8, 2, chunks=[b"\x00" * 192],
                                     tags={259: (3, [34676])}), False),
    ("sgilog24", lambda: raw.tiff_file(image(8, 8), 8, 2, chunks=[b"\x00" * 192],
                                       tags={259: (3, [34677])}), False),
    ("webp", lambda: raw.tiff_file(image(8, 8), 8, 2, chunks=[b"RIFF" + b"\x00" * 40],
                                   tags={259: (3, [50001])}), False),
    ("jpeg 2000", lambda: raw.tiff_file(image(8, 8), 8, 2, chunks=[b"\x00" * 64],
                                        tags={259: (3, [34712])}), False),
    ("ycbcr raw", lambda: raw.tiff_file(image(8, 8), 8, 6), False),
    ("bigtiff mm", lambda: b"MM\x00+" + pil_tiff(Image.fromarray(image(8, 8)),
                                                  big_tiff=True)[4:], False),
    ("old jpeg in tags", lambda: raw.tiff_file(image(16, 16), 8, 6, chunks=[b"\x00" * 64],
                                               tags={259: (3, [6]), 512: (3, [1])}), None),
    ("ycbcr 4x4", lambda: _ycbcr_units(8, 9, (4, 4), 14), True),
    ("ycbcr 2x4", lambda: _ycbcr_units(8, 8, (2, 4), 15), False),
    ("ccitt rlew", lambda: _ccitt_rlew(_mask()[:20]), True),
    ("float mm deflate", lambda: raw.tiff_file(np.ones((4, 4, 1), np.float32), 32, 1,
                                               big_endian=True, compression=8,
                                               sample_format=(3,)), True)])
def test_refused_tiffs_raise_naming_a12(label, build, pil_opens):
    """What Pillow refuses (SGILog, WebP and JPEG 2000 codings, uncompressed
    chunky YCbCr, big-endian BigTIFF, YCbCr subsampled 2x4, old-style JPEG
    whose data is no JPEG stream) raises naming A.12 and that Pillow
    refuses it; so do three things Pillow reads that the port does not:
    YCbCr subsampled 4x4 (libtiff's path gives zeros or
    shifted blocks at some sizes), CCITT RLEW (libtiff's own round trip
    decodes to "bad code words") and a big-endian compressed float file,
    which Pillow reads byte-swapped."""
    data = build()
    with pytest.raises(ValueError, match="A.12"):
        image_io.read_image(data, label)
    if pil_opens:
        want = np.asarray(pil(data))
        if label == "float mm deflate":              # libtiff's native order, swapped again
            assert want.tobytes() == np.ones((4, 4), ">f4").tobytes()
        return
    with pytest.raises(Exception):
        pil(data).load()
    if pil_opens is False:                           # the port says why (None: its own reason)
        with pytest.raises(ValueError, match="Pillow 12.1 refuses it too"):
            image_io.read_image(data, label)


# ------------------------------------------------------------ seeded sweep

SWEEP_KINDS = [  # photometric, bits, samples, extra samples, sample format
    (0, 1, 1, None, None), (1, 1, 1, None, None), (0, 2, 1, None, None), (1, 4, 1, None, None),
    (0, 8, 1, None, None), (1, 8, 1, None, None), (1, 8, 1, None, (2,)), (0, 8, 1, None, (2,)),
    (1, 12, 1, None, None), (1, 16, 1, None, None), (0, 16, 1, None, None), (1, 16, 1, None, (2,)),
    (1, 32, 1, None, None), (1, 32, 1, None, (2,)), (1, 32, 1, None, (3,)), (0, 32, 1, None, (3,)),
    (1, 64, 1, None, (3,)), (1, 8, 2, (2,), None), (2, 8, 3, None, None), (2, 8, 4, (1,), None),
    (2, 8, 4, None, None), (2, 16, 3, None, None), (2, 16, 4, None, None), (2, 16, 4, (0,), None),
    (2, 16, 4, (1,), None), (2, 16, 4, (2,), None), (2, 8, 5, (2, 0), None),
    (3, 8, 2, (2,), None), (3, 8, 2, (0,), None), (3, 4, 1, None, None), (5, 8, 4, None, None),
    (5, 16, 4, None, None), (8, 8, 3, None, None), (8, 16, 3, None, None), (6, 8, 1, None, None),
    (6, 8, 3, None, None), (2, 8, 3, None, (2, 2, 2))]


def sweep(seed: int, n: int):
    """(label, bytes, stored samples) of `n` seeded layouts."""
    r = np.random.RandomState(seed)
    for _ in range(n):
        photo, bits, spp, extra, fmt = SWEEP_KINDS[r.randint(len(SWEEP_KINDS))]
        comp = int(r.choice([1, 32773, 5, 8, 34925, 50000]))
        be, big = bool(r.rand() < 0.3), bool(r.rand() < 0.2)
        fill = 2 if r.rand() < 0.25 else 1
        planar = 2 if spp > 1 and r.rand() < 0.4 else 1
        layout = [{}, dict(rows_per_strip=3), dict(tile=(16, 16))][r.randint(3)]
        pred = int(r.choice([1, 1, 2, 3]))
        orient = int(r.choice([1, 2, 3, 4, 5, 6, 7, 8]))
        h, w = int(r.randint(1, 20)), int(r.randint(1, 40))
        f = (fmt or (1,))[0]
        if f == 3:
            s = (r.randn(h, w, spp) * 100).astype(f"f{bits // 8}")
        elif f == 2:
            s = r.randint(-(1 << (bits - 1)), 1 << (bits - 1), (h, w, spp)).astype(f"i{bits // 8}")
        else:
            s = r.randint(0, 1 << min(bits, 31), (h, w, spp)).astype(
                np.uint8 if bits <= 8 else np.uint16 if bits <= 16 else np.uint32)
        tags = {274: (3, [orient])}
        if photo == 3:
            tags[320] = (3, [int(v) for v in r.randint(0, 65536, 3 << min(bits, 8))])
        label = (f"p{photo} {bits}-bit x{extra} f{fmt} c{comp} {'MM' if be else 'II'}"
                 f"{' big' if big and not be else ''} fill{fill} planar{planar} {layout} "
                 f"pred{pred} orientation{orient} {w}x{h}")
        data = raw.tiff_file(s, bits, photo, big_endian=be, compression=comp, predictor=pred,
                             planar=planar, extra=extra, tags=tags, fill_order=fill,
                             big_tiff=big and not be, sample_format=fmt, **layout)
        yield label, data


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_layouts_equal_pil_or_raise(seed):
    """Pillow's pixels wherever Pillow reads a layout and the port does;
    `ValueError` wherever Pillow refuses it; the port refuses only what
    its docstring lists (Pillow misreads it, or reads it through libtiff's
    RGBA interface)."""
    agreed = refused = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label, data in sweep(seed, 300):
            try:
                im = pil(data)
                want, mode = np.asarray(im), im.mode
            except Exception:
                with pytest.raises(ValueError):
                    image_io.read_image(data, label)
                continue
            try:
                pic = image_io.read_image(data, label)
            except ValueError as e:
                assert any(k in str(e) for k in ("byte-swapped", "planar", "YCbCr")), (label, e)
                refused += 1
                continue
            assert pic.mode == mode and pic.pixels.dtype == want.dtype, label
            assert pic.pixels.tobytes() == want.tobytes(), label
            agreed += 1
    assert agreed > 100 and refused < agreed // 2, (agreed, refused)


# ------------------------------------------------------------- corrupt files


def corrupt_files():
    """(label, bytes) of seeded truncations and byte flips of a file of each
    new coding."""
    r = np.random.RandomState(31)
    valid = {k: KINDS[k] for k in ("jpeg ycbcr 4:2:0 strips", "jpeg rgb", "ccitt mh",
                                   "ccitt g3 2d fill", "ccitt g4",
                                   "ccitt g4 white0 fill2", "thunderscan", "lzma",
                                   "zstd predictor", "bigtiff tiles lzw", "float predictor 3",
                                   "rgba16 associated planar")}
    out = []
    for kind, f in valid.items():
        for cut in r.choice(np.arange(8, len(f) - 1), 8, replace=False):
            out.append((f"{kind} cut {cut}", f[:cut]))
        for k in range(12):
            g = bytearray(f)
            for at in r.randint(len(f) // 3, len(f), 1 + k % 3):   # mostly the coded data
                g[at] = r.randint(256)
            out.append((f"{kind} flip {k}", bytes(g)))
    return out


def test_corrupt_files_raise_or_equal_pil():
    """Each truncated or flipped file raises `ValueError` wherever Pillow
    refuses it; where Pillow reads it, the port raises `ValueError` or gives
    Pillow's pixels.  Never another exception."""
    agreed = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for label, data in corrupt_files():
            try:
                im = pil(data)
                want, mode = np.asarray(im), im.mode
            except Exception:
                with pytest.raises(ValueError):
                    image_io.read_image(data, label)
                continue
            try:
                pic = image_io.read_image(data, label)
            except ValueError:
                continue
            assert pic.mode == mode, label
            assert pic.pixels.tobytes() == want.tobytes(), label
            agreed += 1
    assert agreed > 20


HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
extern "C" int ccitt_decode(int, int, const uint8_t*, size_t, int, int, uint8_t*, char*, int);
extern "C" int thunder_decode(const uint8_t*, size_t, int, int, uint8_t*, size_t, char*, int);
int main(int argc, char** argv) {
  for (int i = 1; i < argc; i++) {
    FILE* f = std::fopen(argv[i], "rb");
    std::vector<uint8_t> b;
    for (int c; (c = std::fgetc(f)) != EOF;) b.push_back(uint8_t(c));
    std::fclose(f);
    uint8_t* d = static_cast<uint8_t*>(std::malloc(b.size() + 1));  // exact size: over-reads trap
    std::memcpy(d, b.data(), b.size());
    char err[256];
    const int w = 61, h = 45;
    uint8_t* out = static_cast<uint8_t*>(std::malloc(size_t(h) * ((w + 7) / 8)));
    const int codings[][2] = {{2, 0}, {3, 0}, {3, 1}, {3, 5}, {4, 0}};
    for (const auto& c : codings) ccitt_decode(c[0], c[1], d, b.size(), w, h, out, err, 256);
    std::free(out);
    uint8_t* grey = static_cast<uint8_t*>(std::malloc(33 * 24));   // 47 4-bit pixels a row
    thunder_decode(d, b.size(), 47, 33, grey, 33 * 24, err, 256);
    std::free(grey);
    std::free(d);
  }
  std::puts("done");
}
"""


def test_new_decoders_stay_in_bounds_under_asan(tmp_path):
    """The CCITT decoders (every coding on every stream) and the ThunderScan
    decoder built with AddressSanitizer and UBSan read and write only their
    own memory on seeded truncations and flips of CCITT and ThunderScan
    strips."""
    from diffusion_spacetime_attn_tpu_torch.utils import ccitt, lzw

    (tmp_path / "harness.cpp").write_text(HARNESS)
    flags = ["-O0", "-g", "-std=c++17", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=all"]
    sources = [ccitt.SOURCE, lzw.SOURCE, tmp_path / "harness.cpp"]
    objs = [tmp_path / f"{i}.o" for i in range(len(sources))]
    builds = [subprocess.Popen(["g++", *flags, "-c", "-o", str(o), str(s)],
                               stderr=subprocess.PIPE) for o, s in zip(objs, sources)]
    for b in builds:
        assert b.wait(timeout=300) == 0, b.stderr.read().decode()[-3000:]
    exe = tmp_path / "harness"
    subprocess.run(["g++", *flags, "-o", str(exe), *map(str, objs)], check=True,
                   capture_output=True, timeout=300)
    r = np.random.RandomState(37)
    streams = [strips_of(KINDS[k]) for k in ("ccitt mh", "ccitt g3", "ccitt g3 2d fill",
                                             "ccitt g4")]
    t = pil(KINDS["thunderscan"]).tag_v2
    streams.append(KINDS["thunderscan"][t[273][0]:t[273][0] + t[279][0]])
    paths = []
    for j, f in enumerate(streams):
        for k in range(24):
            g = bytearray(f[:r.randint(1, len(f))] if k % 2 else f)
            for at in r.randint(0, len(g), k % 4):
                g[at] = r.randint(256)
            paths.append(tmp_path / f"s{j}_{k}.bin")
            paths[-1].write_bytes(bytes(g))
    res = subprocess.run([str(exe), *map(str, paths)], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert res.returncode == 0 and res.stdout.strip() == "done", res.stderr[-3000:]
