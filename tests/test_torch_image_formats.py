"""PyTorch port, every image file the JAX package opens through Pillow, held
against Pillow 12.1 (libjpeg-turbo 3.1.3, libtiff 4.7, zlib) on the CPU:

* PNG (`utils/png.py`): every bit depth and colour type (grey at 1, 2, 4,
  8 and 16 bits, palettes at 1, 2, 4 and 8 bits with PLTE and tRNS, RGB,
  grey + alpha and RGBA at 8 and 16 bits), Adam7 or not, every filter type
  (`helpers/raw_images.png_file`), and Pillow's own palette files;
* GIF (`utils/gif.py`, `native/lzw.cpp`): global and local colour tables,
  interlaced rows, a transparency index, a frame smaller than the screen or
  reaching past it, no table at all, a grey-ramp table, Pillow's files;
* TIFF (`utils/tiff.py`): II and MM, strips and tiles, chunky and planar,
  compression none, PackBits, LZW and Deflate, predictor 2, photometric
  0 / 1 at 1, 2, 4, 8 and 16 bits, grey + alpha, RGB (extra samples unused,
  associated or not), palettes at 1, 4 and 8 bits, CMYK; the codings left
  out raise naming ROADMAP A.12 and the tag's value;
* JPEG (`native/jpeg.cpp`, `helpers/jpeg_codings.py`): sampling factors 3
  and 4, arithmetic coding (sequential and progressive, restarts, DAC),
  lossless files (predictors 1-7, point transforms), libjpeg-turbo's block
  smoothing of progressive files cut short; 12-bit and hierarchical files
  raise as Pillow refuses them;

each checked three ways: `read_image`'s mode, pixels (dtype included) and
palette, `convert` to "RGB" and "L", and JAX's `training/image_data.
load_image` against the port's at two sizes and two filters.  Seeded
truncations and byte flips of every new format raise `ValueError` or give
Pillow's pixels (and raise wherever Pillow refuses); the LZW decoders and
the new JPEG codings stay in bounds under AddressSanitizer; the evaluation
reads a grey or grey + alpha result PNG as JAX's `convert("RGB")` does.
No JAX program is compiled.
"""
import io
import os
import subprocess

import numpy as np
import pytest
from PIL import Image

from diffusion_spacetime_attn_tpu.eval import protocol as jprotocol
from diffusion_spacetime_attn_tpu.training import image_data as jdata
from diffusion_spacetime_attn_tpu_torch.eval import protocol as tprotocol
from diffusion_spacetime_attn_tpu_torch.training import image_data as tdata
from diffusion_spacetime_attn_tpu_torch.utils import image_io
from diffusion_spacetime_attn_tpu_torch.utils.jpeg import decode_jpeg
from diffusion_spacetime_attn_tpu_torch.utils.png import write_png
from helpers import jpeg_codings as jc
from helpers import port_formats
from helpers import raw_images as raw

pytestmark = pytest.mark.filterwarnings("ignore:Palette images with Transparency")
SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
SIZES = [(13, 7), (1, 1), (33, 17), (3, 9)]


def image(h, w, c=3, seed=0):
    return port_formats._image(h, w, seed, c)


def pil(data: bytes):
    return Image.open(io.BytesIO(data))


def assert_like_pil(data: bytes, label: str = ""):
    """Mode, pixels (dtype included), palette and both conversions."""
    want = pil(data)
    pixels = np.asarray(want)
    pic = image_io.read_image(data, label)
    assert pic.mode == want.mode, label
    assert pic.pixels.dtype == pixels.dtype, label
    np.testing.assert_array_equal(pic.pixels, pixels, err_msg=label)
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(image_io.convert(pic, mode), np.asarray(want.convert(mode)),
                                      err_msg=f"{label} convert {mode}")


# ----------------------------------------------------------------------- PNG


@pytest.mark.parametrize("interlace", [False, True], ids=["plain", "adam7"])
@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2),
                                         (16, 2), (1, 3), (2, 3), (4, 3), (8, 3), (8, 4),
                                         (16, 4), (8, 6), (16, 6)])
def test_png_variants_equal_pil(depth, ctype, interlace):
    """Every bit depth and colour type, every filter type on seeded rows;
    palettes shorter than their indices reach (black past the PLTE)."""
    r = np.random.RandomState(depth * 10 + ctype)
    for k, (w, h) in enumerate(SIZES):
        s = r.randint(0, 1 << depth, (h, w, SAMPLES[ctype]))
        pal = trns = None
        if ctype == 3:
            n = r.randint(1, (1 << depth) + 1)
            pal = r.randint(0, 256, (n, 3))
            trns = bytes(r.randint(0, 256, min(n, 3)).astype(np.uint8))
        assert_like_pil(raw.png_file(s, depth, ctype, interlace, pal, trns, seed=k),
                        f"{depth}-bit type {ctype} {w}x{h}")


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
def test_pillow_palette_pngs_equal_pil(bits):
    img = Image.fromarray(image(29, 41, seed=bits)).quantize(1 << bits)
    buf = io.BytesIO()
    img.save(buf, "PNG", bits=bits, transparency=0)
    assert_like_pil(buf.getvalue(), f"P;{bits}")


def test_decode_png_keeps_its_8_bit_results():
    """`decode_png` still gives the 8-bit files' samples ([H, W, C]) and
    points the other files at `read_image`."""
    a = image(9, 11, 4)
    for ctype, c in ((0, 1), (2, 3), (4, 2), (6, 4)):
        data = raw.png_file(a[..., :c], 8, ctype, seed=c)
        from diffusion_spacetime_attn_tpu_torch.utils.png import decode_png
        np.testing.assert_array_equal(decode_png(data), a[..., :c])
    with pytest.raises(ValueError, match="read_image"):
        decode_png(raw.png_file(a[..., :1].astype(np.uint16) * 200, 16, 0))


# ----------------------------------------------------------------------- GIF


def gif_cases():
    r = np.random.RandomState(5)
    out = {}
    for w, h in [(13, 7), (64, 48), (1, 1), (5, 30)]:
        for ncol in (2, 16, 256):
            idx = r.randint(0, ncol, (h, w)).astype(np.uint8)
            pal = r.randint(0, 256, (ncol, 3))
            ramp = np.repeat(np.arange(ncol)[:, None], 3, 1)
            tag = f"{w}x{h}x{ncol}"
            out[f"global {tag}"] = raw.gif_file((w, h), [dict(indices=idx)], pal)
            out[f"interlaced {tag}"] = raw.gif_file((w, h), [dict(indices=idx, interlace=True)],
                                                    pal)
            out[f"local off-corner transparent {tag}"] = raw.gif_file(
                (w + 7, h + 3), [dict(indices=idx, at=(5, 2), palette=pal, transparency=1,
                                      interlace=True)])
            out[f"no table {tag}"] = raw.gif_file((w, h), [dict(indices=idx)])
            out[f"grey-ramp local {tag}"] = raw.gif_file((w, h), [dict(indices=idx, palette=ramp)],
                                                         pal)
            out[f"past the screen {tag}"] = raw.gif_file((max(1, w - 1), h),
                                                         [dict(indices=idx, at=(1, 0))], pal)
            out[f"two frames {tag}"] = raw.gif_file(
                (w, h), [dict(indices=idx), dict(indices=idx[::-1].copy())], pal)
    a = image(60, 80, seed=6)
    for kw in ({}, dict(interlace=False), dict(transparency=5)):
        buf = io.BytesIO()
        Image.fromarray(a).quantize(64).save(buf, "GIF", **kw)
        out[f"pillow {kw}"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(a[..., 0]).save(buf, "GIF")
    out["pillow L"] = buf.getvalue()
    return out


GIFS = gif_cases()


@pytest.mark.parametrize("kind", ["global", "interlaced", "local off-corner transparent",
                                  "no table", "grey-ramp local", "past the screen",
                                  "two frames", "pillow"])
def test_gif_variants_equal_pil(kind):
    """The first frame as `Image.open` gives it: Pillow's mode ("L" where the
    table is missing or the grey ramp), the screen's size grown to the
    frame, the transparency index (or 0) around it, LZW codes widening to
    12 bits and the table cleared when it fills."""
    cases = {k: v for k, v in GIFS.items() if k.startswith(kind)}
    assert cases
    for label, data in cases.items():
        assert_like_pil(data, label)


def test_gif_lzw_is_fast():
    """A 640x480 frame of random indices (LZW at its worst) decodes in well
    under 50 ms here (`native/lzw.cpp`)."""
    import time

    r = np.random.RandomState(3)
    data = raw.gif_file((640, 480), [dict(indices=r.randint(0, 256, (480, 640)))],
                        r.randint(0, 256, (256, 3)))
    image_io.read_image(data)
    t0 = time.perf_counter()
    for _ in range(5):
        image_io.read_image(data)
    assert (time.perf_counter() - t0) / 5 < 0.05
    assert_like_pil(data, "640x480")


# ---------------------------------------------------------------------- TIFF

TIFF_KINDS = [  # (photometric, bits, samples, extra samples)
    (0, 1, 1, None), (1, 1, 1, None), (0, 4, 1, None), (1, 4, 1, None), (1, 2, 1, None),
    (0, 8, 1, None), (1, 8, 1, None), (1, 16, 1, None), (0, 16, 1, None), (1, 8, 2, (2,)),
    (2, 8, 3, None), (2, 8, 4, (0,)), (2, 8, 4, (1,)), (2, 8, 4, (2,)), (2, 8, 4, None),
    (3, 1, 1, None), (3, 4, 1, None), (3, 8, 1, None), (5, 8, 4, None)]


@pytest.mark.parametrize("big_endian", [False, True], ids=["II", "MM"])
@pytest.mark.parametrize("compression", [1, 32773, 5, 8, 32946])
def test_tiff_variants_equal_pil(compression, big_endian):
    """Every photometric interpretation, depth and extra-sample layout the
    port reads, in strips (one and several) and tiles, chunky and planar,
    with and without predictor 2, against Pillow; where Pillow refuses a
    variant (a big-endian white-is-zero 16-bit file) the port raises, and it
    refuses the planar layouts Pillow reads wrongly or not at all (grey +
    alpha, RGBX, an untagged RGBA in uncompressed tiles)."""
    r = np.random.RandomState(compression + big_endian)
    w, h = 37, 21
    read = 0
    for layout in ({}, dict(rows_per_strip=5), dict(tile=(16, 16))):
        for photo, bits, spp, extra in TIFF_KINDS:
            for planar in ((1, 2) if spp > 1 else (1,)):
                for pred in ((1, 2) if bits in (8, 16) else (1,)):
                    s = r.randint(0, 1 << bits, (h, w, spp))
                    if extra == (1,):
                        a = r.randint(0, 256, (h, w, 1))
                        s = np.concatenate([s[..., :3] * a // 255, a], -1)
                    tags = {320: (3, [int(v) for v in r.randint(0, 65536, 3 << bits)])} \
                        if photo == 3 else {}
                    data = raw.tiff_file(s.astype(np.uint16 if bits == 16 else np.uint8), bits,
                                         photo, big_endian, compression, pred, planar,
                                         extra=extra, tags=tags, **layout)
                    label = f"{layout} p{photo} {bits}-bit x{extra} planar{planar} pred{pred}"
                    try:
                        pil(data).load()
                    except Exception:
                        with pytest.raises(ValueError):
                            image_io.read_image(data, label)
                        continue
                    if planar == 2 and (photo == 1 or extra == (0,) or (
                            photo == 2 and extra is None and spp == 4 and compression == 1
                            and "tile" in layout)):
                        # Pillow's own planar reader sizes the tiles of an RGBA without
                        # ExtraSamples for three samples: the port refuses those too
                        with pytest.raises(ValueError, match="planar.*A.12"):
                            image_io.read_image(data, label)
                        continue
                    assert_like_pil(data, label)
                    read += 1
    assert read > 100


@pytest.mark.parametrize("kw", [dict(compression="tiff_lzw"), dict(compression="packbits"),
                                dict(compression="tiff_adobe_deflate"), dict(compression="raw"),
                                dict(compression="tiff_lzw", mode="1"),
                                dict(compression="raw", mode="CMYK"),
                                dict(compression="tiff_deflate", mode="P"),
                                dict(compression="raw", mode="I;16"),
                                dict(compression="packbits", mode="LA")],
                         ids=lambda kw: "-".join(kw.values()))
def test_pillow_tiffs_equal_pil(kw):
    kw = dict(kw)
    mode = kw.pop("mode", "RGB")
    img = Image.fromarray(image(30, 41, seed=7))
    if mode == "I;16":
        img = Image.fromarray(image(30, 41, 1, seed=7)[..., 0].astype(np.uint16) * 257)
    elif mode == "P":
        img = img.quantize(100)
    else:
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    assert_like_pil(buf.getvalue(), str(kw))


def _tiff_with(tags, **kw):
    return raw.tiff_file(image(8, 8, 1)[..., :1], 8, 1, tags=tags, **kw)


def _raw_tiff(samples, bits, photo, **kw):
    return lambda: raw.tiff_file(samples, bits, photo, **kw)


@pytest.mark.parametrize("label,data,match,pil_reads", [
    ("jpeg", _raw_tiff(image(8, 8, 1).astype(np.uint16), 16, 1, tags={259: (3, [7])}),
     "JPEG-compressed TIFF of 16-bit", False),
    ("ccitt g4", _raw_tiff(image(8, 8, 1), 8, 1, tags={259: (3, [4])}), "CCITT-coded", False),
    ("ccitt g3", _raw_tiff(image(8, 8, 1) >> 4, 4, 1, tags={259: (3, [3])}), "CCITT-coded",
     False),
    ("old jpeg", lambda: _tiff_with({259: (3, [6])}), "compression 6", True),
    ("float", _raw_tiff(image(8, 8, 1).astype(np.float64), 64, 1, sample_format=(3,)),
     "sample format \\[3\\]", False),
    ("ycbcr", lambda: _save_tiff(mode="YCbCr"), "uncompressed TIFF YCbCr", False),
    ("lab", _raw_tiff(image(8, 8).astype(np.uint16), 16, 8), "photometric interpretation 8",
     False),
    ("fill order 2", _raw_tiff(image(8, 8, 1) >> 4, 4, 3, fill_order=2,
                               tags={320: (3, list(range(48)))}), "fill order 2", False),
    ("bigtiff", _raw_tiff(image(8, 8), 8, 2, big_tiff=True), "BigTIFF", False)],
    ids=[f"{label}-<lambda>-{tag}" for label, tag in (   # the ids the cases had before
        ("jpeg", "compression 7"), ("ccitt g4", "compression 4"), ("ccitt g3", "compression 3"),
        ("old jpeg", "compression 6"), ("float", "sample format"),
        ("ycbcr", "photometric interpretation 6"), ("lab", "photometric interpretation 8"),
        ("fill order 2", "fill order 2"), ("bigtiff", "BigTIFF"))])
def test_tiff_codings_left_out_raise_naming_a12(label, data, match, pil_reads):
    """What the port does not read raises `ValueError` naming ROADMAP A.12
    and the tag's value: of each family this test once refused, a variant
    Pillow 12.1 refuses too (JPEG at 16 bits, CCITT at 8 and 4 bits, 64-bit
    floats, uncompressed YCbCr, 16-bit L*a*b*, an uncompressed 4-bit palette
    of fill order 2) and an old-style JPEG of grey samples (the port reads
    old-style JPEG as YCbCr only).  The families' other variants are read
    (`tests/test_torch_tiff_codings.py`)."""
    data = data()
    if label == "bigtiff":                       # big-endian BigTIFF: Pillow cannot open it
        data = b"MM\x00+" + data[4:]
    with pytest.raises(ValueError, match=f"{match}.*A.12"):
        image_io.read_image(data, label)
    if not pil_reads:
        with pytest.raises(Exception):
            pil(data).load()


def _save_tiff(mode="RGB", **kw):
    img = Image.fromarray(image(16, 16, seed=9))
    if mode == "F":
        img = Image.fromarray(image(16, 16, 1, seed=9)[..., 0].astype(np.float32))
    elif mode != "RGB":
        img = img.convert(mode)
    buf = io.BytesIO()
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def test_tiff_first_page_of_several():
    """A multi-page file gives its first page, as `Image.open` does."""
    frames = [Image.fromarray(image(12, 14, seed=s)) for s in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, "TIFF", save_all=True, append_images=frames[1:])
    assert_like_pil(buf.getvalue(), "pages")


# ---------------------------------------------------------------------- JPEG


@pytest.mark.parametrize("sampling", [[(4, 1), (1, 1), (1, 1)], [(1, 4), (1, 1), (1, 1)],
                                      [(4, 2), (1, 1), (1, 1)], [(3, 1), (1, 1), (1, 1)],
                                      [(4, 1), (2, 1), (1, 1)], [(3, 2), (1, 2), (1, 1)],
                                      [(4, 2), (2, 1), (2, 1)]],
                         ids=lambda s: "-".join(f"{h}x{v}" for h, v in s))
def test_jpeg_sampling_factors_equal_pil(sampling):
    """Sampling factors 3 and 4 (libjpeg's box upsampling of those ratios,
    its fancy h2v1 / h2v2 where the ratio is 2), odd sizes; more than ten
    blocks in an MCU raise as Pillow refuses them."""
    blocks = sum(h * v for h, v in sampling)
    for hh, ww in [(45, 61), (8, 8), (17, 100), (2, 3)]:
        data = jc.huffman_file(jc.coefficients(image(hh, ww, seed=hh), sampling, 85))
        if blocks > 10:
            with pytest.raises(ValueError, match="more than 10"):
                decode_jpeg(data)
            with pytest.raises(OSError):
                pil(data).load()
            continue
        assert_like_pil(data, f"{sampling} {hh}x{ww}")


@pytest.mark.parametrize("progressive", [False, True], ids=["sof9", "sof10"])
@pytest.mark.parametrize("subsampling", [0, 2], ids=["444", "420"])
def test_arithmetic_jpegs_equal_pil(progressive, subsampling):
    """Pillow's baseline coefficients re-coded with the T.81 arithmetic coder
    (sequential or progressive with spectral selection and successive
    approximation), with and without restart intervals and DAC
    conditioning: Pillow decodes the re-coded file to the baseline's pixels
    and the port to Pillow's."""
    for hh, ww in [(45, 61), (16, 16), (33, 100)]:
        buf = io.BytesIO()
        Image.fromarray(image(hh, ww, seed=ww)).save(buf, "JPEG", quality=80,
                                                     subsampling=subsampling)
        frame = jc.read_baseline(buf.getvalue())
        base = np.asarray(pil(buf.getvalue()))
        for restart in (0, 3):
            for dac in (None, {0: (1, 3), 1: (0, 0), 16: 2, 17: 9}):
                data = jc.arithmetic_file(frame, progressive, restart, dac)
                np.testing.assert_array_equal(np.asarray(pil(data)), base)
                assert_like_pil(data, f"{hh}x{ww} restart {restart} dac {dac}")
    buf = io.BytesIO()
    Image.fromarray(image(40, 50, seed=2)[..., 0]).save(buf, "JPEG", quality=70)
    assert_like_pil(jc.arithmetic_file(jc.read_baseline(buf.getvalue()), progressive, 2), "grey")


@pytest.mark.parametrize("predictor", range(1, 8))
def test_lossless_jpegs_equal_pil(predictor):
    """Lossless 8-bit files (SOF3): grey and three-component (RGB, as
    libjpeg-turbo takes them without a JFIF marker), point transforms 0 and
    2, restart intervals; a JFIF (YCbCr) lossless file and a 6-bit one raise
    as Pillow refuses them."""
    for pt in (0, 2):
        assert_like_pil(jc.lossless_file(image(23, 31, seed=predictor), predictor, pt), "rgb")
        assert_like_pil(jc.lossless_file(image(23, 31, seed=predictor)[..., 0], predictor, pt),
                        "grey")
    assert_like_pil(jc.lossless_file(image(20, 9, seed=1), predictor, 1, restart_rows=4),
                    "restarts")
    for data in (jc.lossless_file(image(8, 8), predictor, jfif=True),
                 jc.lossless_file(image(8, 8) >> 2, predictor, precision=6)):
        with pytest.raises(ValueError, match="A.12"):
            decode_jpeg(data)
        with pytest.raises(Exception):
            pil(data).load()


@pytest.mark.parametrize("coding", ["huffman", "arithmetic"])
def test_block_smoothing_equals_pil(coding):
    """Progressive files cut after each of their first nine scans: libjpeg-
    turbo smooths the blocks whose first coefficients are incomplete (the
    DC too, where no AC coefficient is known), greyscale and 4:2:0, odd
    sizes."""
    for hh, ww, q, ss in [(64, 80, 85, 2), (45, 61, 75, 2), (33, 100, 40, 1), (100, 17, 95, 0),
                          (9, 9, 80, 2)]:
        if coding == "huffman":
            buf = io.BytesIO()
            Image.fromarray(image(hh, ww, seed=hh + ww)).save(buf, "JPEG", quality=q,
                                                              progressive=True, subsampling=ss)
            data = buf.getvalue()
        else:
            frame = jc.coefficients(image(hh, ww, seed=3), [(2, 2), (1, 1), (1, 1)], q)
            data = jc.arithmetic_file(frame, progressive=True)
        for k in range(1, 10):
            assert_like_pil(jc.cut_scans(data, k), f"{hh}x{ww} cut after {k}")
    buf = io.BytesIO()
    Image.fromarray(image(40, 48, seed=1)[..., 0]).save(buf, "JPEG", progressive=True)
    for k in range(1, 5):
        assert_like_pil(jc.cut_scans(buf.getvalue(), k), f"grey cut after {k}")


def test_12_bit_and_hierarchical_jpegs_still_raise():
    base = jc.huffman_file(jc.coefficients(image(16, 16), [(1, 1)] * 3))
    sof = base.index(b"\xff\xc0")
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    hier = base[:sof + 1] + b"\xc5" + base[sof + 2:]
    for data, match in ((bytes(twelve), "12-bit.*A.12"), (hier, "hierarchical.*A.12")):
        with pytest.raises(ValueError, match=match):
            decode_jpeg(data)
        with pytest.raises(OSError):
            pil(data).load()


# ---------------------------------------------------- the JAX package's loader


@pytest.mark.parametrize("name", sorted(n for n in os.listdir(port_formats.FIXTURES)
                                        if n.endswith(port_formats.IMAGE_SUFFIXES)))
def test_load_image_equals_jax(name):
    """`training/image_data.load_image` (center crop, resize) on every
    committed fixture, at two sizes and two filters, against JAX's (which
    opens the file with Pillow)."""
    path = str(port_formats.FIXTURES / name)
    assert_like_pil((port_formats.FIXTURES / name).read_bytes(), name)
    for size in (32, 77):
        for interp in ("bicubic", "bilinear"):
            np.testing.assert_array_equal(tdata.load_image(path, size, interp),
                                          np.asarray(jdata.load_image(path, size, interp)),
                                          err_msg=f"{name} {size} {interp}")


# ------------------------------------------------------------- corrupt files


def corrupt_files():
    """(label, bytes) of seeded truncations and byte flips of a file of
    each new format and coding."""
    r = np.random.RandomState(23)
    a = image(23, 29, seed=4)
    frame = jc.read_baseline(jc.huffman_file(jc.coefficients(a, [(2, 2), (1, 1), (1, 1)])))
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", progressive=True)
    valid = {
        "png16": raw.png_file(a.astype(np.uint16) * 257, 16, 2, interlace=True, seed=1),
        "png_palette": raw.png_file(a[..., :1] >> 4, 4, 3, palette=r.randint(0, 256, (16, 3))),
        "gif": raw.gif_file((31, 25), [dict(indices=a[..., 0] >> 2, at=(2, 1), interlace=True,
                                            palette=r.randint(0, 256, (64, 3)),
                                            transparency=2)]),
        "tiff_lzw": raw.tiff_file(a, 8, 2, compression=5, predictor=2, rows_per_strip=7),
        "tiff_packbits": raw.tiff_file(a[..., :1] >> 4, 4, 3, big_endian=True, compression=32773,
                                       tile=(16, 16), tags={320: (3, list(range(0, 48 * 1000,
                                                                               1000)))}),
        "tiff_deflate": raw.tiff_file(a.astype(np.uint16)[..., :1] * 99, 16, 1, compression=8),
        "jpeg_arith": jc.arithmetic_file(frame, restart=2),
        "jpeg_arith_prog": jc.arithmetic_file(frame, progressive=True),
        "jpeg_lossless": jc.lossless_file(a, 7, 1),
        "jpeg_411": jc.huffman_file(jc.coefficients(a, [(4, 1), (1, 1), (1, 1)])),
        "jpeg_smoothed": jc.cut_scans(buf.getvalue(), 3),
    }
    out = []
    for kind, f in valid.items():
        for cut in r.choice(np.arange(2, len(f) - 1), 12, replace=False):
            out.append((f"{kind} cut {cut}", f[:cut]))
        for k in range(16):
            g = bytearray(f)
            for at in r.randint(2, len(f), 1 + k % 3):
                g[at] = r.randint(256)
            out.append((f"{kind} flip {k}", bytes(g)))
    return out


def test_corrupt_files_raise_or_equal_pil():
    """Each truncated or flipped file raises `ValueError` wherever Pillow
    refuses it; where Pillow reads it, the port raises `ValueError` or gives
    Pillow's pixels.  Never another exception."""
    agreed = 0
    for label, data in corrupt_files():
        try:
            im = pil(data)
            want = np.asarray(im)
            mode = im.mode
        except Exception:
            with pytest.raises(ValueError):
                image_io.read_image(data, label)
            continue
        try:
            pic = image_io.read_image(data, label)
        except ValueError:
            continue
        assert pic.mode == mode, label
        np.testing.assert_array_equal(pic.pixels, want, err_msg=label)
        agreed += 1
    assert agreed > 20


HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
extern "C" int jpeg_decode(const uint8_t*, size_t, uint8_t**, int*, int*, int*, char*, int);
extern "C" void jpeg_free(void*);
extern "C" int gif_lzw_decode(const uint8_t*, size_t, int, int, int, int, uint8_t*, int, char*,
                              int);
extern "C" int tiff_unpack(int, const uint8_t*, size_t, uint8_t*, size_t, size_t*, char*, int);
int main(int argc, char** argv) {
  for (int i = 1; i < argc; i++) {
    FILE* f = std::fopen(argv[i], "rb");
    std::vector<uint8_t> b;
    for (int c; (c = std::fgetc(f)) != EOF;) b.push_back(uint8_t(c));
    std::fclose(f);
    uint8_t* d = static_cast<uint8_t*>(std::malloc(b.size() + 1));  // exact size: over-reads trap
    std::memcpy(d, b.data(), b.size());
    char err[256];
    size_t len = std::strlen(argv[i]);
    if (len > 4 && std::strcmp(argv[i] + len - 4, ".lzw") == 0) {
      // an LZW stream: as a GIF frame (minimum code size 8) and as TIFF data
      std::vector<uint8_t> canvas(40 * 30);
      gif_lzw_decode(d, b.size(), 8, 37, 29, 1, canvas.data() + 40 + 2, 40, err, sizeof(err));
      // a strip buffer smaller than the stream decodes to: writes must stop at it
      uint8_t* out = static_cast<uint8_t*>(std::malloc(777));
      size_t got;
      tiff_unpack(5, d, b.size(), out, 777, &got, err, sizeof(err));
      tiff_unpack(32773, d, b.size(), out, 777, &got, err, sizeof(err));
      std::free(out);
    } else {
      uint8_t* out = nullptr;
      int w, h, c;
      if (jpeg_decode(d, b.size(), &out, &w, &h, &c, err, sizeof(err)) == 0) jpeg_free(out);
    }
    std::free(d);
  }
  std::puts("done");
}
"""


def test_new_decoders_stay_in_bounds_under_asan(tmp_path):
    """The LZW / PackBits decoders and the JPEG codec built with
    AddressSanitizer and UBSan read and write only their own memory on the
    corrupt JPEGs above and on seeded truncations and flips of LZW streams
    (GIF's and TIFF's), fed to the GIF, TIFF LZW and PackBits decoders."""
    from diffusion_spacetime_attn_tpu_torch.utils import jpeg, lzw

    (tmp_path / "harness.cpp").write_text(HARNESS)
    flags = ["-O0", "-g", "-std=c++17", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=all"]
    sources = [jpeg.SOURCE, lzw.SOURCE, tmp_path / "harness.cpp"]
    objs = [tmp_path / f"{i}.o" for i in range(len(sources))]
    builds = [subprocess.Popen(["g++", *flags, "-c", "-o", str(o), str(s)],
                               stderr=subprocess.PIPE) for o, s in zip(objs, sources)]
    for b in builds:                      # the three compiles run side by side
        assert b.wait(timeout=300) == 0, b.stderr.read().decode()[-3000:]
    exe = tmp_path / "harness"
    subprocess.run(["g++", *flags, "-o", str(exe), *map(str, objs)], check=True,
                   capture_output=True, timeout=300)
    paths = []
    for i, (label, data) in enumerate(corrupt_files()):
        if label.startswith("jpeg"):
            paths.append(tmp_path / f"{i}.jpg")
            paths[-1].write_bytes(data)
    r = np.random.RandomState(29)
    streams = [raw.lzw_gif(image(29, 37, seed=2)[..., 0], 8)[1:], raw.lzw_tiff(bytes(range(256)) * 9),
               raw.packbits(bytes(image(20, 30, seed=3).reshape(-1)))]
    for j, f in enumerate(streams):
        for k in range(30):
            g = bytearray(f[:r.randint(1, len(f))] if k % 2 else f)
            for at in r.randint(0, len(g), 1 + k % 4):
                g[at] = r.randint(256)
            paths.append(tmp_path / f"s{j}_{k}.lzw")
            paths[-1].write_bytes(bytes(g))
    res = subprocess.run([str(exe), *map(str, paths)], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert res.returncode == 0 and res.stdout.strip() == "done", res.stderr[-3000:]


# ------------------------------------------------- the evaluation's grey fault


def test_detect_folder_reads_grey_results_as_jax(tmp_path):
    """A results folder of grey and grey + alpha PNGs (another tool's
    outputs) and a 16-bit and a palette one: the port's `detect_folder`
    hands its detector the [H, W, 3] float arrays JAX's hands its own
    (`Image.open(f).convert("RGB")`); it gave [H, W, 1] and [H, W, 2]."""
    g = image(24, 32, 2, seed=5)
    files = {"final_s1_index_0.png": raw.png_file(g[..., :1], 8, 0),
             "final_s1_index_1.png": raw.png_file(g, 8, 4),
             "final_s1_index_2.png": raw.png_file(g[..., :1].astype(np.uint16) * 300, 16, 0),
             "final_s1_index_3.png": raw.png_file(g[..., :1] >> 4, 4, 3,
                                                  palette=image(16, 1, seed=1)[:, 0])}
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
    write_png(str(tmp_path / "final_s1_index_4.png"), image(24, 32, seed=6))

    def recorder(seen):
        def detector(img, top_per_category=1):
            seen.append(np.asarray(img))
            return []
        return detector

    jseen, tseen = [], []
    names = sorted(files) + ["final_s1_index_4.png"]
    assert jprotocol.detect_folder(str(tmp_path), recorder(jseen), names) == \
        tprotocol.detect_folder(str(tmp_path), recorder(tseen), names)
    assert len(jseen) == len(tseen) == 5
    for name, j, t in zip(names, jseen, tseen):
        assert t.shape == j.shape == (24, 32, 3), (name, t.shape, j.shape)
        assert t.dtype == np.float32
        np.testing.assert_array_equal(t, j.astype(np.float32), err_msg=name)
