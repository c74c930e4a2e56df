"""PyTorch port, PIL-free image I/O held against PIL (installed here, the
oracle) and the JAX package on the CPU:

  * `utils/resample.resize` equal to `Image.resize` byte for byte (NEAREST,
    BILINEAR, BICUBIC, LANCZOS and the default filter; RGB and L; up and
    down; odd sizes);
  * the JPEG encoder's bytes equal to PIL's `save(..., "JPEG", quality=q)`
    at q in {30, 50, 75, 95} (RGB and greyscale, odd sizes), the decoder's
    pixels equal to PIL's on PIL's files (4:2:0, 4:2:2, 4:4:4, greyscale,
    restart intervals) and on the port's own;
    GIFs read, a JPEG-in-TIFF and a 12-bit JPEG raise; corrupt files (truncations,
    byte flips, lying segments) raise `ValueError` where PIL refuses them
    and stay in bounds under AddressSanitizer; the digests `chip_smoke.py`
    holds the card's codec and resize to are PIL's;
  * `training/image_data` (`load_image`, `ImagePathsDataset.batches`,
    `lsun_split`, `imagenet_tree`) equal to JAX's arrays and order on a
    folder of PNG and JPEG files;
  * `training/degradation` (`degradation_bsrgan_light`, `superres_example`)
    within 1e-6 of JAX's over 8 seeds and sf in {2, 4}, every branch taken
    (pre-halving, each noise kind, the JPEG round trip, each resize filter).
"""
import hashlib
import io
import os
import random
import subprocess

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from diffusion_spacetime_attn_tpu.training import degradation as jdeg
from diffusion_spacetime_attn_tpu.training import image_data as jdata
from diffusion_spacetime_attn_tpu_torch.training import degradation as tdeg
from diffusion_spacetime_attn_tpu_torch.training import image_data as tdata
from diffusion_spacetime_attn_tpu_torch.utils.image_io import open_image
from diffusion_spacetime_attn_tpu_torch.utils.jpeg import decode_jpeg, encode_jpeg
from diffusion_spacetime_attn_tpu_torch.utils.png import write_png
from diffusion_spacetime_attn_tpu_torch.utils.resample import resize
from helpers import raw_images

PIL_FILTERS = {"nearest": Image.NEAREST, "bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
               "lanczos": Image.LANCZOS}
SIZES = [((53, 37), (512, 512)), ((480, 640), (224, 224)), ((100, 100), (33, 77)),
         ((7, 300), (301, 5)), ((64, 64), (64, 32)), ((1, 1), (5, 3))]


def image(h, w, c=3, seed=0):
    """A seeded image with smooth structure and noise (what a camera gives
    a codec): [h, w, 3] or [h, w] uint8."""
    r = np.random.RandomState(seed)
    coarse = r.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3), dtype=np.uint8)
    base = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR)).astype(int)
    img = np.clip(base + r.randint(-15, 16, base.shape), 0, 255).astype(np.uint8)
    return img if c == 3 else img[..., 1]


@pytest.mark.parametrize("name", ["nearest", "bilinear", "bicubic", "lanczos", None])
@pytest.mark.parametrize("grey", [False, True])
def test_resize_equals_pil(name, grey):
    r = np.random.RandomState(1)
    for (h, w), (ow, oh) in SIZES:
        a = r.randint(0, 256, (h, w) if grey else (h, w, 3), dtype=np.uint8)
        if name is None:                         # Image.resize's default filter: BICUBIC
            want, got = Image.fromarray(a).resize((ow, oh)), resize(a, (ow, oh))
        else:
            want = Image.fromarray(a).resize((ow, oh), PIL_FILTERS[name])
            got = resize(a, (ow, oh), name)
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=f"{name} {h}x{w}->{ow}x{oh}")


def pil_jpeg(a, q=75, **kw):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG", quality=q, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("q", [30, 50, 75, 95])
def test_jpeg_encoder_bytes_equal_pil(q):
    for (h, w) in [(53, 37), (17, 9), (33, 100), (120, 96), (1, 1)]:
        for c in (3, 1):
            a = image(h, w, c, seed=h + q)
            assert encode_jpeg(a, q) == pil_jpeg(a, q), (h, w, c)


def test_jpeg_decoder_pixels_equal_pil():
    files = []
    for (h, w) in [(53, 37), (480, 640), (17, 9), (2, 3), (33, 100)]:
        a, g = image(h, w, seed=w), image(h, w, 1, seed=h)
        files += [pil_jpeg(a, 80, subsampling=ss) for ss in (0, 1, 2)]
        files += [pil_jpeg(g, 60), pil_jpeg(a, 70, restart_marker_blocks=3),
                  pil_jpeg(g, 70, restart_marker_rows=1), encode_jpeg(a, 90), encode_jpeg(g, 40)]
    for data in files:
        np.testing.assert_array_equal(decode_jpeg(data), np.asarray(Image.open(io.BytesIO(data))))


def test_unsupported_files_raise(tmp_path):
    """Progressive and CMYK JPEGs and GIFs, which raised until the port read
    them, now give PIL's pixels (tests/test_torch_formats.py and
    tests/test_torch_image_formats.py hold every variant); junk, an
    old-style JPEG TIFF (compression 6; JPEG-compressed TIFFs are read
    since, `tests/test_torch_tiff_codings.py`), a 12-bit JPEG and a
    truncated WebP still raise, the TIFF naming ROADMAP A.12, the 12-bit
    JPEG as no format Pillow identifies (Pillow's marker walk refuses the
    frame and passes the file on; `decode_jpeg` names A.12)."""
    a = image(32, 32)
    data = pil_jpeg(a, 75, progressive=True)
    np.testing.assert_array_equal(decode_jpeg(data), np.asarray(Image.open(io.BytesIO(data))))
    buf = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(buf, "JPEG")
    np.testing.assert_array_equal(decode_jpeg(buf.getvalue()),
                                  np.asarray(Image.open(io.BytesIO(buf.getvalue()))))
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(b"\x00\x01junk")
    buf = io.BytesIO()
    Image.fromarray(a).convert("P").save(buf, "GIF")
    (tmp_path / "x.gif").write_bytes(buf.getvalue())
    np.testing.assert_array_equal(open_image(str(tmp_path / "x.gif")),
                                  np.asarray(Image.open(tmp_path / "x.gif").convert("RGB")))
    (tmp_path / "x.tif").write_bytes(raw_images.tiff_file(a, 8, 2, tags={259: (3, [6])}))
    with pytest.raises(ValueError, match="compression 6.*A.12"):
        open_image(str(tmp_path / "x.tif"))
    twelve = bytearray(pil_jpeg(a, 75))
    sof = twelve.index(b"\xff\xc0")
    twelve[sof + 4] = 12
    (tmp_path / "x.jpg").write_bytes(bytes(twelve))
    with pytest.raises(ValueError, match="not an image file Pillow 12.1 identifies"):
        open_image(str(tmp_path / "x.jpg"))         # Pillow: "cannot handle 12-bit layers"
    with pytest.raises(Exception):
        Image.open(tmp_path / "x.jpg")
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "WEBP", quality=80)
    (tmp_path / "x.webp").write_bytes(buf.getvalue()[:100])
    with pytest.raises(ValueError, match="truncated"):
        open_image(str(tmp_path / "x.webp"))
    with pytest.raises(Exception):
        Image.open(str(tmp_path / "x.webp")).load()


def corrupt_jpegs():
    """(label, bytes, pil_raises) for corrupt files (pil_raises None where
    the scan data is garbled and either may happen): seeded truncations and
    byte flips of valid files (baseline and progressive), and hand-made
    segments that lie about their
    contents (an over-subscribed Huffman table, short SOF / DQT / DHT / DRI
    / SOS segments, a scan naming 255 components)."""
    r = np.random.RandomState(7)
    valid = [pil_jpeg(image(53, 37, seed=3), 75), pil_jpeg(image(40, 24, seed=5), 70,
                                                             restart_marker_blocks=3),
             pil_jpeg(image(33, 100, 1, seed=4), 60), encode_jpeg(image(24, 40, seed=6), 50),
             pil_jpeg(image(37, 29, seed=8), 80, progressive=True),
             pil_jpeg(image(30, 41, seed=9), 65, progressive=True, restart_marker_blocks=2)]
    out = []
    for f in valid:
        for cut in r.choice(np.arange(2, len(f) - 1), 40, replace=False):
            out.append((f"cut {cut}/{len(f)}", f[:cut], True))
        for k in range(40):
            g = bytearray(f)
            for at in r.randint(2, len(f), 1 + k % 3):
                g[at] = r.randint(256)
            out.append((f"flip {k}", bytes(g), None))
    soi, rest = valid[0][:2], valid[0][2:]
    sos = valid[0].index(b"\xff\xda")
    seg = lambda m, body: bytes([0xFF, m]) + (len(body) + 2).to_bytes(2, "big") + body
    # the scan's AC table 0 redefined with bits[1] = 2, bits[2] = 4: six
    # codes that do not fit lengths 1-2
    oversub = seg(0xC4, bytes([0x10, 2, 4] + [0] * 14 + list(range(6))))
    out += [("oversubscribed DHT", valid[0][:sos] + oversub + valid[0][sos:], True),
            ("unused oversubscribed DHT", soi + oversub.replace(b"\x10", b"\x13", 1) + rest, False),
            ("APP0 of length 1", soi + b"\xff\xe0\x00\x01" + rest, False),
            ("short SOF", soi + seg(0xC0, bytes([8, 0, 16, 0, 16, 3])) + rest, True),
            ("short DQT", soi + seg(0xDB, bytes([0x00] + [1] * 10)) + rest, True),
            ("short 16-bit DQT", soi + seg(0xDB, bytes([0x10] + [1] * 64)) + rest, True),
            ("short DHT", soi + seg(0xC4, bytes([0x00, 0, 5] + [0] * 14 + [1, 2])) + rest, True),
            ("short DRI", soi + seg(0xDD, b"") + rest, True),
            ("DQT of length 1", soi + b"\xff\xdb\x00\x01" + rest, True)]
    f = bytearray(valid[0])
    f[sos + 4] = 255
    out.append(("SOS of 255 components", bytes(f), True))
    return out


def test_corrupt_jpegs_raise_value_error():
    """Where PIL refuses a truncated or malformed file, the port raises
    `ValueError`; where PIL reads a malformed header, the port gives its
    pixels; garbled scan data raises or decodes to the header's size, as
    libjpeg decodes corrupt scan data.  A cut that leaves only the EOI
    marker out also raises (PIL raises there too unless the file has
    restart intervals)."""
    for label, data, pil_raises in corrupt_jpegs():
        if label == "oversubscribed DHT":
            with pytest.raises(ValueError, match="over-subscribed"):
                decode_jpeg(data)
        if pil_raises is False:
            np.testing.assert_array_equal(decode_jpeg(data),
                                          np.asarray(Image.open(io.BytesIO(data))), err_msg=label)
            continue
        if pil_raises:
            with pytest.raises(Exception):
                Image.open(io.BytesIO(data)).load()
            with pytest.raises(ValueError):
                decode_jpeg(data)
            continue
        try:
            got = decode_jpeg(data)
        except ValueError:
            continue
        try:
            want = Image.open(io.BytesIO(data))
            assert got.shape[:2] == (want.height, want.width), label
        except OSError:
            pass


HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>
extern "C" int jpeg_decode(const uint8_t*, size_t, uint8_t**, int*, int*, int*, char*, int);
extern "C" void jpeg_free(void*);
extern "C" int webp_decode(const uint8_t*, size_t, uint8_t**, int*, int*, int*, char*, int);
extern "C" void webp_free(void*);
extern "C" int zstd_decode_alloc(const uint8_t*, size_t, uint8_t**, size_t*, char*, int);
extern "C" int zstd_decode_into(const uint8_t*, size_t, uint8_t*, size_t, size_t*, char*, int);
extern "C" void zstd_free(void*);
int main(int argc, char** argv) {
  for (int i = 1; i < argc; i++) {
    FILE* f = std::fopen(argv[i], "rb");
    std::vector<uint8_t> b;
    for (int c; (c = std::fgetc(f)) != EOF;) b.push_back(uint8_t(c));
    std::fclose(f);
    uint8_t* d = static_cast<uint8_t*>(std::malloc(b.size()));  // exact size: over-reads trap
    std::memcpy(d, b.data(), b.size());
    uint8_t* out = nullptr;
    int w, h, c;
    size_t n;
    char err[256];
    const char* name = argv[i];
    size_t len = std::strlen(name);
    if (len > 4 && std::strcmp(name + len - 4, ".zst") == 0) {
      if (zstd_decode_alloc(d, b.size(), &out, &n, err, sizeof(err)) == 0) zstd_free(out);
      std::vector<uint8_t> small(64 * 1024);   // a caller's buffer the frame may not fit
      zstd_decode_into(d, b.size(), small.data(), small.size(), &n, err, sizeof(err));
    } else if (len > 5 && std::strcmp(name + len - 5, ".webp") == 0) {
      if (webp_decode(d, b.size(), &out, &w, &h, &c, err, sizeof(err)) == 0) webp_free(out);
    } else if (jpeg_decode(d, b.size(), &out, &w, &h, &c, err, sizeof(err)) == 0) {
      jpeg_free(out);
    }
    std::free(d);
  }
  std::puts("done");
}
"""


def corrupt_webps_and_frames():
    """Seeded truncations and byte flips of lossy, lossless and alpha WebPs
    and of zstd frames (random, text-like and float data at levels 1 and
    19, one and several blocks, with the checksum): (suffix, bytes)."""
    import zstandard

    r = np.random.RandomState(11)
    out = []
    files = []
    for kw, c in ((dict(quality=75), 3), (dict(lossless=True), 3), (dict(quality=70), 4),
                  (dict(lossless=True), 4)):
        buf = io.BytesIO()
        a = image(37, 53, seed=c)
        Image.fromarray(np.dstack([a, a[..., :1]]) if c == 4 else a).save(buf, "WEBP", **kw)
        files.append((".webp", buf.getvalue()))
    for lvl in (1, 19):
        for data in (r.randint(0, 256, 3000).astype(np.uint8).tobytes(),
                     bytes(r.choice(list(b"abcde  xyz"), 200_000).astype(np.uint8)),
                     np.round(r.randn(50_000), 2).astype(np.float32).tobytes()):
            files.append((".zst", zstandard.ZstdCompressor(level=lvl,
                                                           write_checksum=True).compress(data)))
    for suffix, f in files:
        for cut in r.choice(np.arange(1, len(f)), 12, replace=False):
            out.append((suffix, f[:cut]))
        for k in range(20):
            g = bytearray(f)
            for at in r.randint(0, len(f), 1 + k % 3):
                g[at] = r.randint(256)
            out.append((suffix, bytes(g)))
    return out


def test_corrupt_jpegs_stay_in_bounds_under_asan(tmp_path):
    """The JPEG, WebP and zstd decoders built with AddressSanitizer and UBSan
    read and write only their own memory on every corrupt file above and on
    seeded truncations and flips of WebPs and zstd frames."""
    from diffusion_spacetime_attn_tpu_torch.utils import jpeg, webp, zstd
    (tmp_path / "harness.cpp").write_text(HARNESS)
    exe = tmp_path / "harness"
    flags = ["-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=all"]
    sources = [jpeg.SOURCE, webp.SOURCE, zstd.SOURCE, tmp_path / "harness.cpp"]
    objs = [tmp_path / f"{i}.o" for i in range(len(sources))]
    builds = [subprocess.Popen(["g++", *flags, "-c", "-o", str(o), str(src)],
                               stderr=subprocess.PIPE) for o, src in zip(objs, sources)]
    for b in builds:                      # the four compiles run side by side
        assert b.wait(timeout=300) == 0, b.stderr.read().decode()[-3000:]
    subprocess.run(["g++", *flags, "-o", str(exe), *map(str, objs)], check=True,
                   capture_output=True, timeout=300)
    paths = []
    for i, (_, data, _) in enumerate(corrupt_jpegs()):
        paths.append(tmp_path / f"{i}.jpg")
        paths[-1].write_bytes(data)
    for i, (suffix, data) in enumerate(corrupt_webps_and_frames()):
        paths.append(tmp_path / f"x{i}{suffix}")
        paths[-1].write_bytes(data)
    r = subprocess.run([str(exe), *map(str, paths)], capture_output=True, text=True, timeout=300,
                       env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert r.returncode == 0 and r.stdout.strip() == "done", r.stderr[-3000:]


def test_chip_smoke_digests_are_pils():
    """The constants the card's run holds its codec and resize to are the
    SHA-256 of PIL's bytes here (and of the port's)."""
    img = chip_smoke.codec_image()
    assert img.shape == (480, 640, 3) and img.dtype == np.uint8
    pil = pil_jpeg(img, chip_smoke.CODEC_QUALITY)
    assert hashlib.sha256(pil).hexdigest() == chip_smoke.JPEG_SHA256
    assert hashlib.sha256(encode_jpeg(img, chip_smoke.CODEC_QUALITY)).hexdigest() == \
        chip_smoke.JPEG_SHA256
    dec = np.asarray(Image.open(io.BytesIO(pil)))
    assert hashlib.sha256(dec.tobytes()).hexdigest() == chip_smoke.DECODE_SHA256
    want = np.asarray(Image.fromarray(img).resize((512, 512)))
    assert hashlib.sha256(want.tobytes()).hexdigest() == chip_smoke.RESIZE_SHA256
    assert hashlib.sha256(resize(img, (512, 512)).tobytes()).hexdigest() == chip_smoke.RESIZE_SHA256


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """PNG and JPEG files (RGB, grey, odd sizes), an LSUN-style split file
    and an ImageNet-style synset tree."""
    root = tmp_path_factory.mktemp("imgs")
    names = []
    for i, (h, w) in enumerate([(40, 52), (37, 37), (64, 30), (45, 61), (33, 48), (50, 50)]):
        a = image(h, w, seed=100 + i)
        if i % 2:
            name = f"im{i}.jpg"
            (root / name).write_bytes(pil_jpeg(a if i != 3 else a[..., 0], 85))
        else:
            name = f"im{i}.png"
            write_png(str(root / name), a)
        names.append(name)
    (root / "split.txt").write_text("\n".join(names) + "\n")
    for s, syn in enumerate(("n02", "n01")):
        (root / "tree" / syn).mkdir(parents=True)
        for j in range(3):
            (root / "tree" / syn / f"{j}.JPEG").write_bytes(pil_jpeg(image(30 + j, 41, seed=s * 9 + j)))
        (root / "tree" / syn / "notes.txt").write_text("x")
    return root


def test_image_data_equals_jax(folder):
    for name in sorted(os.listdir(folder)):
        if name.startswith("im"):
            for size, interp in ((32, "bicubic"), (24, "bilinear"), (None, "bicubic")):
                np.testing.assert_array_equal(
                    tdata.load_image(str(folder / name), size, interp),
                    jdata.load_image(str(folder / name), size, interp))
    t = tdata.lsun_split(str(folder / "split.txt"), str(folder), size=32)
    j = jdata.lsun_split(str(folder / "split.txt"), str(folder), size=32)
    assert t.paths == j.paths
    got, want = list(t.batches(4, seed=3, epochs=3)), list(j.batches(4, seed=3, epochs=3))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gl is None and wl is None
    t = tdata.imagenet_tree(str(folder / "tree"), size=16)
    j = jdata.imagenet_tree(str(folder / "tree"), size=16)
    assert t.paths == j.paths and t.labels == j.labels == [0, 0, 0, 1, 1, 1]
    for (gi, gl), (wi, wl) in zip(t.batches(2, seed=0, epochs=2), j.batches(2, seed=0, epochs=2)):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    assert t.__getitem__(1, random.Random(5))["class_label"] == 0


def test_degradation_matches_jax(monkeypatch):
    """8 seeds x sf in {2, 4} on the same images: LR and HR within 1e-6 of
    JAX's (in practice equal), the superres records too; the run takes the
    pre-halving, every noise kind, the JPEG round trip and every filter."""
    seen = set()
    real_noise, real_resize = tdeg.add_gaussian_noise, tdeg.resize

    def noise(img, rng, *a, **k):
        state = rng.getstate()
        rng.randint(2, 25)
        p = rng.random()
        rng.setstate(state)
        seen.add("noise_channel" if p > 0.6 else "noise_grey" if p > 0.4 else "noise_colour")
        return real_noise(img, rng, *a, **k)

    def resize_(img, size, method="bicubic"):
        seen.add(method)
        return real_resize(img, size, method)

    def jpeg(img, q):
        seen.add("jpeg")
        return encode_jpeg(img, q)

    monkeypatch.setattr(tdeg, "add_gaussian_noise", noise)
    monkeypatch.setattr(tdeg, "resize", resize_)
    monkeypatch.setattr(tdeg, "encode_jpeg", lambda img, quality: jpeg(img, quality))
    r = np.random.RandomState(0)
    for sf in (2, 4):
        for seed in range(8):
            img = r.rand(64, 48, 3).astype(np.float32)
            pre = random.Random(seed).random() < 0.25
            if sf == 4 and pre:
                seen.add("prehalve")
            for got, want in zip(tdeg.degradation_bsrgan_light(img, sf=sf, seed=seed),
                                 jdeg.degradation_bsrgan_light(img, sf=sf, seed=seed)):
                assert got.shape == want.shape and got.dtype == np.float32
                np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
            g = tdeg.superres_example(img, size=32, sf=sf, seed=seed)
            w = jdeg.superres_example(img, size=32, sf=sf, seed=seed)
            for k in ("image", "LR_image"):
                np.testing.assert_allclose(g[k], w[k], atol=1e-6, rtol=0)
    g = tdeg.superres_example(image(40, 30), size=16, sf=2, degradation="bicubic")
    w = jdeg.superres_example(image(40, 30), size=16, sf=2, degradation="bicubic")
    np.testing.assert_allclose(g["LR_image"], w["LR_image"], atol=1e-6)
    assert seen >= {"prehalve", "noise_channel", "noise_grey", "noise_colour", "jpeg",
                    "bilinear", "bicubic", "lanczos"}, seen
