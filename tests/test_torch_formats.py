"""PyTorch port, the image formats a JAX user's folders hold, held against
Pillow 12.1 (libjpeg-turbo 3.1, libwebp 1.6) on the CPU, bit for bit:

* JPEG (`native/jpeg.cpp`): progressive files at qualities 50 / 75 / 95,
  subsampling 4:4:4 / 4:2:2 / 4:2:0, greyscale, restart markers,
  `optimize=True`, odd sizes; CMYK and YCCK (Adobe transforms 0 and 2) and
  RGB-coded files (`keep_rgb=True`);
* BMP (`utils/bmp.py`): Pillow-written modes 1 / L / P / RGB / RGBA, and
  hand-written 1-, 4-, 8-bit palettes, 16-bit (5-5-5 and 5-6-5 bitfields),
  24-bit, 32-bit bitfield layouts, RLE8 and RLE4 (with the delta escape),
  OS/2 core, V4 and V5 headers and top-down rows;
* WebP (`native/webp.cpp`): lossy at three qualities and odd sizes,
  lossless, lossy and lossless alpha, the first frame of an animation;
* `utils/image_io.convert`: every mode above to "RGB" and "L" as Pillow's
  `convert`;
* corrupt files: seeded truncations and byte flips of WebPs raise
  `ValueError` exactly where Pillow refuses them and decode to Pillow's
  pixels where it reads them; the JPEG codings Pillow refuses
  (hierarchical, arithmetic lossless, 12-bit) raise, naming ROADMAP A.12,
  and the arithmetic and lossless ones it decodes give its pixels (every
  variant of those, and GIF and TIFF, is in
  `tests/test_torch_image_formats.py`);
* the committed `tests/fixtures/port_formats/` images against their Pillow
  digests (what `chip_smoke.py` holds the card's machine to).

Only numpy and Pillow: no JAX program is compiled, so the file takes
seconds.
"""
import hashlib
import io
import json
import struct

import numpy as np
import pytest
from PIL import Image

from diffusion_spacetime_attn_tpu_torch.utils import image_io
from diffusion_spacetime_attn_tpu_torch.utils.bmp import decode_bmp
from diffusion_spacetime_attn_tpu_torch.utils.jpeg import decode_jpeg
from diffusion_spacetime_attn_tpu_torch.utils.webp import decode_webp
from helpers import port_formats, raw_images

SIZES = [(1, 1), (2, 3), (17, 9), (33, 100), (53, 37), (64, 64), (121, 162)]


def image(h, w, c=3, seed=0):
    """Integer gradients plus noise: structure and texture for the codecs."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (3 + k) + yy * (2 + 2 * k) + 40 * k) % 256 for k in range(c)], -1)
    return np.clip(base + r.randint(-30, 31, (h, w, c)), 0, 255).astype(np.uint8)


def save(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def assert_like_pil(data, name=""):
    """read_image gives np.asarray(Image.open(f)) and its mode; convert gives
    .convert("RGB") and .convert("L")."""
    im = Image.open(io.BytesIO(data))
    want = np.asarray(im)
    pic = image_io.read_image(data, name)
    assert pic.mode == im.mode, (name, pic.mode, im.mode)
    assert pic.pixels.dtype == want.dtype and pic.pixels.shape == want.shape, name
    np.testing.assert_array_equal(pic.pixels, want, err_msg=name)
    for mode in ("RGB", "L"):
        np.testing.assert_array_equal(image_io.convert(pic, mode), np.asarray(im.convert(mode)),
                                      err_msg=f"{name} -> {mode}")


# ---------------------------------------------------------------------- JPEG


@pytest.mark.parametrize("q", [50, 75, 95])
def test_progressive_jpegs_equal_pil(q):
    for h, w in SIZES:
        a = image(h, w, seed=h * w + q)
        for kw in [dict(subsampling=s) for s in (0, 1, 2)] + [
                dict(optimize=True), dict(restart_marker_blocks=2),
                dict(restart_marker_rows=1, subsampling=0)]:
            assert_like_pil(save(Image.fromarray(a), "JPEG", quality=q, progressive=True, **kw),
                            f"{h}x{w} {kw}")
        assert_like_pil(save(Image.fromarray(a[..., 1]), "JPEG", quality=q, progressive=True),
                        f"grey {h}x{w}")


def _adobe_transform(data, value):
    at = data.index(b"Adobe")
    out = bytearray(data)
    out[at + 11] = value                  # the APP14 segment's transform byte
    return bytes(out)


def test_cmyk_ycck_and_rgb_coded_jpegs_equal_pil():
    for h, w in SIZES:
        a = image(h, w, seed=h + w)
        cmyk = save(Image.fromarray(a).convert("CMYK"), "JPEG", quality=85)
        assert_like_pil(cmyk, f"cmyk {h}x{w}")
        # the same scans read as YCCK (Adobe transform 2): libjpeg converts to CMYK
        assert_like_pil(_adobe_transform(cmyk, 2), f"ycck {h}x{w}")
        try:      # Pillow's encoder refuses some of the smallest progressive CMYK images
            prog = save(Image.fromarray(a).convert("CMYK"), "JPEG", quality=70, progressive=True)
        except OSError:
            prog = None
        if prog is not None:
            assert_like_pil(prog, f"progressive cmyk {h}x{w}")
        for kw in (dict(), dict(subsampling=2), dict(progressive=True)):
            try:
                data = save(Image.fromarray(a), "JPEG", quality=90, keep_rgb=True, **kw)
            except OSError:           # refused by Pillow's encoder at the smallest sizes
                continue
            assert b"JFIF" not in data and b"Adobe" in data
            assert_like_pil(data, f"rgb-coded {h}x{w} {kw}")
    assert decode_jpeg(cmyk).shape == (h, w, 4)


def test_jpeg_codings_left_out_raise_naming_a12():
    """Hierarchical (SOF5-7, SOF13-15) and arithmetic-coded lossless (SOF11)
    files and 12-bit samples: Pillow's libjpeg-turbo refuses them and so
    does the port, naming ROADMAP A.12.  The arithmetic-coded (SOF9, SOF10)
    and lossless (SOF3) files it decodes give its pixels."""
    from helpers import jpeg_codings

    base = save(Image.fromarray(image(16, 16)), "JPEG", quality=75)
    sof = base.index(b"\xff\xc0")
    for marker in (0xC5, 0xC6, 0xC7, 0xCB, 0xCD, 0xCE, 0xCF):
        data = base[:sof + 1] + bytes([marker]) + base[sof + 2:]
        with pytest.raises(ValueError, match="A.12"):
            decode_jpeg(data)
        with pytest.raises(OSError):
            Image.open(io.BytesIO(data)).load()
    frame = jpeg_codings.read_baseline(base)
    for data in (jpeg_codings.arithmetic_file(frame), jpeg_codings.arithmetic_file(frame, True),
                 jpeg_codings.lossless_file(image(16, 16), 4)):
        assert_like_pil(data, "arithmetic or lossless")
    twelve = bytearray(base)
    twelve[sof + 4] = 12
    with pytest.raises(ValueError, match="12-bit.*A.12"):
        decode_jpeg(bytes(twelve))
    with pytest.raises(OSError):               # "cannot handle 12-bit layers"
        Image.open(io.BytesIO(bytes(twelve)))


# ----------------------------------------------------------------------- BMP


def _bmp(w, h, bits, pixels, palette=None, hsize=40, comp=0, masks=None, topdown=False,
         colors=0):
    """A hand-written BMP: `pixels` the file's row bytes, padded, in file order."""
    pad = 3 if hsize == 12 else 4
    pal = b"".join(bytes([b, g, r]) + b"\x00" * (pad - 3) for r, g, b in (palette or []))
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", hsize, w, -h if topdown else h, 1, bits, comp,
                           len(pixels), 2835, 2835, colors, 0)
        extra = struct.pack("<" + "I" * len(masks), *masks) if masks and hsize >= 52 else b""
        head += extra + b"\x00" * (hsize - len(head) - len(extra))
        if masks and hsize == 40:
            head += struct.pack("<III", *masks[:3])
    off = 14 + len(head) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + head + pal + pixels


def _rows(a, bits, bottom_up=True):
    h, w = a.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    out = []
    for y in range(h):
        if bits == 1:
            b = np.packbits(a[y].astype(np.uint8)).tobytes()
        elif bits == 4:
            v = np.concatenate([a[y], np.zeros(w % 2, a.dtype)]).astype(np.uint8)
            b = ((v[0::2] << 4) | v[1::2]).astype(np.uint8).tobytes()
        else:
            b = a[y].astype(np.uint8).tobytes()
        out.append(b + b"\x00" * (stride - len(b)))
    return b"".join(out[::-1] if bottom_up else out)


def bmp_cases():
    r = np.random.RandomState(0)
    W, H = 13, 7
    pal = [tuple(int(v) for v in r.randint(0, 256, 3)) for _ in range(16)]
    idx4, idx8, idx1 = r.randint(0, 16, (H, W)), r.randint(0, 16, (H, W)), r.randint(0, 2, (H, W))
    cases = {}
    for hs in (12, 40, 108, 124):
        cases[f"p4 h{hs}"] = _bmp(W, H, 4, _rows(idx4, 4), pal, hsize=hs)
        cases[f"p8 h{hs}"] = _bmp(W, H, 8, _rows(idx8, 8), pal, hsize=hs,
                                  colors=0 if hs == 12 else 16)
        cases[f"p1 h{hs}"] = _bmp(W, H, 1, _rows(idx1, 1), pal[:2], hsize=hs)
        cases[f"bw1 h{hs}"] = _bmp(W, H, 1, _rows(idx1, 1), [(0, 0, 0), (255, 255, 255)], hsize=hs)
        rgb = r.randint(0, 256, (H, W, 3))
        cases[f"rgb24 h{hs}"] = _bmp(W, H, 24, _rows(rgb[..., ::-1].reshape(H, -1), 8), hsize=hs)
    raw16 = r.randint(0, 65536, (H, W)).astype(np.uint16).view(np.uint8).reshape(H, -1)
    cases["rgb16 555"] = _bmp(W, H, 16, _rows(raw16, 8))
    cases["rgb16 565"] = _bmp(W, H, 16, _rows(raw16, 8), comp=3, masks=(0xF800, 0x7E0, 0x1F))
    cases["rgb16 565 v4"] = _bmp(W, H, 16, _rows(raw16, 8), hsize=108, comp=3,
                                 masks=(0xF800, 0x7E0, 0x1F, 0))
    cases["rgb16 top-down"] = _bmp(W, H, 16, _rows(raw16, 8, bottom_up=False), topdown=True)
    px32 = r.randint(0, 256, (H, W * 4))
    for m in [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
              (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
              (0, 0, 0, 0)]:
        cases[f"bitfields32 {m}"] = _bmp(W, H, 32, _rows(px32, 8), hsize=124, comp=3, masks=m)
    cases["rgb32"] = _bmp(W, H, 32, _rows(px32, 8))
    cases["rgb32 top-down v4"] = _bmp(W, H, 32, _rows(px32, 8, bottom_up=False), topdown=True,
                                      hsize=108)
    runs = np.repeat(r.randint(0, 16, (H, 4)), 4, axis=1)[:, :W]
    rle8 = bytearray()
    for y in range(H - 1, -1, -1):
        x = 0
        while x < W:
            n = 1
            while x + n < W and runs[y, x + n] == runs[y, x]:
                n += 1
            if n == 1 and W - x >= 3:         # an absolute run of three, padded to a word
                rle8 += bytes([0, 3]) + bytes(runs[y, x:x + 3].tolist()) + b"\x00"
                n = 3
            else:
                rle8 += bytes([n, runs[y, x]])
            x += n
        rle8 += b"\x00\x00"
    cases["rle8"] = _bmp(W, H, 8, bytes(rle8 + b"\x00\x01"), pal, comp=1, colors=16)
    # Pillow's delta escape reads its offsets from the two bytes after its own two
    cases["rle8 delta"] = _bmp(W, H, 8, bytes([13, 5, 0, 2, 9, 9, 2, 1, 11, 7, 0, 0] +
                                              [13, 4, 0, 0] * 4 + [0, 1]), pal, comp=1, colors=16)
    rle4 = bytearray()
    for y in range(H - 1, -1, -1):
        row, x = idx4[y], 0
        while x < W:
            n = min(6, W - x)
            if n >= 3 and x % 3 == 0:
                vals = list(row[x:x + n]) + [0]
                packed = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
                rle4 += bytes([0, n]) + packed + b"\x00" * (len(packed) % 2)
                x += n
            else:
                rle4 += bytes([2, (row[x] << 4) | row[min(x + 1, W - 1)]])
                x += 2
        rle4 += b"\x00\x00"
    cases["rle4"] = _bmp(W, H, 4, bytes(rle4 + b"\x00\x01"), pal, comp=2, colors=16)
    cases["grey8"] = _bmp(W, H, 8, _rows(idx8 * 10, 8), [(i, i, i) for i in range(256)])
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        a = image(23, 29, 4 if mode == "RGBA" else 3, seed=len(mode))
        im = Image.fromarray(a)
        cases[f"pil {mode}"] = save(im if mode == "RGBA" else im.convert(mode), "BMP")
    return cases


@pytest.mark.parametrize("name", sorted(bmp_cases()))
def test_bmps_equal_pil(name):
    assert_like_pil(bmp_cases()[name], name)


def test_bmps_pil_refuses_raise():
    good = bmp_cases()["rgb24 h40"]
    for data in (good[:60], good[:2] + b"\x00" * 12 + struct.pack("<I", 20) + good[18:],
                 good.replace(struct.pack("<HH", 1, 24), struct.pack("<HH", 1, 7), 1)):
        with pytest.raises(Exception):
            Image.open(io.BytesIO(data)).load()
        with pytest.raises(ValueError):
            decode_bmp(data)


# ---------------------------------------------------------------------- WebP


def webp_cases():
    cases = {}
    for h, w in SIZES:
        for q in (20, 75, 100):
            cases[f"lossy q{q} {h}x{w}"] = save(Image.fromarray(image(h, w, seed=q + w)), "WEBP",
                                               quality=q)
        cases[f"lossless {h}x{w}"] = save(Image.fromarray(image(h, w, seed=w)), "WEBP",
                                          lossless=True)
        cases[f"alpha {h}x{w}"] = save(Image.fromarray(image(h, w, 4, seed=h)), "WEBP",
                                       quality=70, alpha_quality=50, method=6)
        cases[f"lossless alpha {h}x{w}"] = save(Image.fromarray(image(h, w, 4, seed=h + 1)),
                                                "WEBP", lossless=True)
    flat = np.zeros((48, 64, 4), np.uint8)
    flat[8:30, 10:50] = [200, 30, 90, 255]
    flat[30:, :, 3] = 128
    cases["palette lossless"] = save(Image.fromarray(flat[..., :3]).quantize(5).convert("RGB"),
                                     "WEBP", lossless=True)
    cases["flat alpha lossy"] = save(Image.fromarray(flat), "WEBP", quality=90)
    frames = [Image.fromarray(image(50, 70, 4, seed=s)) for s in range(3)]
    for kw in (dict(lossless=True), dict(quality=60)):
        cases[f"animated {kw}"] = save(frames[0], "WEBP", save_all=True, append_images=frames[1:],
                                       duration=40, **kw)
        rgb = [f.convert("RGB") for f in frames]
        cases[f"animated rgb {kw}"] = save(rgb[0], "WEBP", save_all=True,
                                           append_images=rgb[1:], duration=40, **kw)
    return cases


def test_webps_equal_pil():
    cases = webp_cases()
    for name, data in cases.items():
        assert_like_pil(data, name)
    assert Image.open(io.BytesIO(cases["animated {'quality': 60}"])).n_frames == 3


def test_corrupt_webps_raise_where_pil_refuses():
    """Seeded truncations and byte flips of lossy, lossless and alpha files:
    the port raises ValueError wherever Pillow refuses and gives Pillow's
    pixels wherever it reads."""
    r = np.random.RandomState(3)
    cases = webp_cases()
    refused = 0
    for name in ("lossy q75 53x37", "lossless 53x37", "alpha 53x37", "lossless alpha 53x37"):
        f = cases[name]
        variants = [f[:c] for c in r.choice(np.arange(1, len(f)), 30, replace=False)]
        for k in range(40):
            g = bytearray(f)
            for at in r.randint(12, len(f), 1 + k % 3):
                g[at] = r.randint(256)
            variants.append(bytes(g))
        for data in variants:
            try:
                want = np.asarray(Image.open(io.BytesIO(data)))
            except Exception:
                with pytest.raises(ValueError):
                    decode_webp(data)
                refused += 1
                continue
            np.testing.assert_array_equal(decode_webp(data), want, err_msg=name)
    assert refused > 100


def test_other_formats_raise_naming_a12():
    """GIF and TIFF, which raised until the port read them, give Pillow's
    pixels (`tests/test_torch_image_formats.py` and
    `tests/test_torch_tiff_codings.py` hold every variant); junk and an
    old-style JPEG TIFF (compression 6) still raise, naming ROADMAP A.12."""
    gif = save(Image.fromarray(image(8, 8)).convert("P"), "GIF")
    tif = save(Image.fromarray(image(8, 8)), "TIFF")
    for data in (gif, tif):
        pic = image_io.read_image(data)
        want = Image.open(io.BytesIO(data))
        assert pic.mode == want.mode
        np.testing.assert_array_equal(pic.pixels, np.asarray(want))
    old_jpeg_tif = raw_images.tiff_file(image(16, 16), 8, 2, tags={259: (3, [6])})
    for data, kind in ((old_jpeg_tif, "compression 6"), (b"\x00\x01junk", "not an image")):
        with pytest.raises(ValueError, match=f"{kind}.*A.12"):
            image_io.read_image(data)


def test_committed_fixture_images_match_pil_digests():
    """What phase formats checks on the card's machine: each fixture image's
    pixels and RGB conversion against Pillow's SHA-256 in digests.json."""
    want = json.loads((port_formats.FIXTURES / "digests.json").read_text())["images"]
    assert set(port_formats.TRAIN) <= set(want)
    for name, d in want.items():
        data = (port_formats.FIXTURES / name).read_bytes()
        pic = image_io.read_image(data, name)
        assert pic.mode == d["mode"] and list(pic.pixels.shape) == d["shape"], name
        assert hashlib.sha256(pic.pixels.tobytes()).hexdigest() == d["pixels"], name
        rgb = image_io.convert(pic, "RGB")
        assert hashlib.sha256(rgb.tobytes()).hexdigest() == d["rgb"], name
        assert_like_pil(data, name)
