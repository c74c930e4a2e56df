"""The fixtures of `tests/fixtures/port_formats/`, made from seeds with JAX,
orbax and Pillow, and the SHA-256 digests `chip_smoke.py` (phase formats)
holds the port's readers to on a machine that has none of the three.

    python tests/helpers/port_formats.py          # rewrites the fixtures

* `ldm/step_2/`: a JAX `LDMTrainer.save` of an unconditional UNet at
  `UNET` (one level of 32 channels, no attention outside the middle
  block; 182,820 parameters): params, EMA, AdamW's two moments, logvar and
  step.  Random float32 barely compresses (16 bytes a parameter for the
  four copies), so the values are seeded normal draws rounded to halves
  (about 1.3 bytes each after orbax's zstd) and each moment leaf repeats one
  seeded run of values: the state takes about half a megabyte;
* one file of each image format and coding the port reads besides 8-bit
  PNG and baseline JPEG: written by Pillow, a progressive, a CMYK and an
  RGB-coded JPEG, 8-bit palette and 24-bit BMPs, lossy, lossless and alpha
  WebPs, a GIF, LZW, PackBits 1-bit and CMYK TIFFs, a 4-bit palette PNG;
  written by `helpers/raw_images.py` (what Pillow does not write) an Adam7
  palette PNG, 2- and 16-bit grey and 16-bit grey + alpha PNGs, a GIF frame
  with a local table off the screen's corner, planar tiled Deflate,
  16-bit LZW, 4-bit PackBits palette and white-is-zero TIFFs; and by
  `helpers/jpeg_codings.py` arithmetic-coded sequential and progressive,
  lossless, 4:1:1 and block-smoothed JPEGs; and the TIFF kinds of
  `tiff_images` (orientation 2-8, fax-coded masks, JPEG-in-TIFF, LZMA,
  Zstandard, BigTIFF, fill order 2, 16-bit RGB(A), signed, 32-bit and float
  samples, palette + alpha, ThunderScan) and a subsampled lossless JPEG;
  and the kinds of `raster_images` (Netpbm, Targa, QOI, ICO, CUR, DIB,
  PCX, DCX, SGI, Sun raster, PSD, XBM, XPM, FITS; Pillow writes some, the
  rest `helpers/raw_images.py`), among them an RLE Targa named `.jpg`.
  The `TRAIN` files stand in for port-written JPEGs in phase train_data;
  `INIT` and `MASK` are phase image_in's --init and --mask.

`digests.json` holds {"state": {path: sha256 of the restored array's
bytes}, "images": {file: {"file", "mode", "pixels", "rgb", "shape"}}}:
the file's bytes, `Image.open(f).mode`, the SHA-256 of
`np.asarray(Image.open(f))` and of `.convert("RGB")`.
`tests/test_torch_orbax.py` rebuilds everything and holds it to the
committed digests.  Orbax writes a fresh uuid and commit time into every
save, so the state's files differ from build to build; its digests do not.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import sys
import zlib
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures" / "port_formats"
STATE = "ldm/step_2"
UNET = dict(model_channels=32, channel_mult=(1,), num_res_blocks=1, attention_resolutions=(),
            num_heads=1, dtype="float32")
LATENT = 8
TRAIN = ("progressive.jpg", "rgb24.bmp", "lossy.webp", "frame.gif", "lzw.tif", "rgb16.ppm",
         "dxt5_texture.jpg", "tga_rle.jpg")
IMAGE_SUFFIXES = (".jpg", ".bmp", ".webp", ".png", ".gif", ".tif", ".pbm", ".pgm", ".ppm",
                  ".pfm", ".tga", ".qoi", ".ico", ".cur", ".dib", ".pcx", ".dcx", ".sgi", ".ras",
                  ".psd", ".xbm", ".xpm", ".fits", ".dds", ".blp", ".ftc", ".ftu")
# the 512x512 files of phase formats' decode times (Targa RLE, QOI, PSD PackBits)
BLOCKS = ("tga_rle.jpg", "blocks.qoi", "blocks.psd")
# phase image_in's --init and --mask (img2img and inpaint)
INIT, MASK = "adam7_palette.png", "mask.tif"


def _image(h, w, seed, c=3):
    """Integer gradients plus RandomState noise (the same bytes on every numpy)."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (3 + k) + yy * (2 + 2 * k) + 40 * k) % 256 for k in range(c)], -1)
    return np.clip(base + r.randint(-12, 13, (h, w, c)), 0, 255).astype(np.uint8)


def _mask(h: int, w: int) -> np.ndarray:
    """A 1-bit inpainting mask: white (kept) left of a wavy edge."""
    yy, xx = np.mgrid[0:h, 0:w]
    return xx < w // 2 + (yy * 7 // h) % 3 * 2


def raw_images() -> dict:
    """{name: bytes} of the PNG, GIF and TIFF variants Pillow does not write
    (`helpers/raw_images.py`; Pillow reads each)."""
    from PIL import Image

    from helpers import raw_images as raw

    quant = Image.fromarray(_image(120, 160, 4)).quantize(128)
    pal = np.asarray(quant.getpalette()[:3 * 128], np.uint8).reshape(128, 3)
    r = np.random.RandomState(19)
    grey = _image(60, 80, 5, c=2)
    lidx = np.asarray(Image.fromarray(_image(60, 80, 6)).quantize(32))
    lpal = np.asarray(Image.fromarray(_image(60, 80, 6)).quantize(32).getpalette()[:96]).reshape(32, 3)
    return {
        "adam7_palette.png": raw.png_file(np.asarray(quant)[..., None], 8, 3, interlace=True,
                                          palette=pal, trns=bytes([0, 128]), seed=1),
        "grey16.png": raw.png_file((grey[..., :1].astype(np.uint16) * 257
                                    + r.randint(0, 256, (60, 80, 1))), 16, 0, seed=2),
        "grey2_adam7.png": raw.png_file(grey[..., :1] >> 6, 2, 0, interlace=True, seed=3),
        "la16.png": raw.png_file(grey.astype(np.uint16) * 257, 16, 4, seed=4),
        "local_interlaced.gif": raw.gif_file(
            (96, 72), [dict(indices=lidx, at=(7, 5), palette=lpal, interlace=True,
                            transparency=3)], global_palette=pal[:64]),
        "tiles_planar.tif": raw.tiff_file(_image(48, 64, 7, c=4), 8, 2, big_endian=True,
                                          compression=8, predictor=2, planar=2, tile=(32, 16),
                                          extra=(2,)),
        "grey16_lzw.tif": raw.tiff_file(grey[..., :1].astype(np.uint16) * 251, 16, 1,
                                        big_endian=True, compression=5, predictor=2,
                                        rows_per_strip=16),
        "palette4_packbits.tif": raw.tiff_file(
            (grey[..., :1] >> 4), 4, 3, compression=32773, rows_per_strip=7,
            tags={320: (3, [int(v) for v in r.randint(0, 65536, 48)])}),
        "white0_4bit.tif": raw.tiff_file(grey[..., :1] >> 4, 4, 0, tile=(16, 16)),
    }


def jpeg_images() -> dict:
    """{name: bytes} of the JPEG codings no library here writes
    (`helpers/jpeg_codings.py`; Pillow decodes each)."""
    from PIL import Image

    from helpers import jpeg_codings as jc

    buf = io.BytesIO()
    Image.fromarray(_image(60, 80, 10)).save(buf, "JPEG", quality=85)
    frame = jc.read_baseline(buf.getvalue())
    buf = io.BytesIO()
    Image.fromarray(_image(64, 80, 11)).save(buf, "JPEG", quality=85, progressive=True)
    return {
        "arithmetic.jpg": jc.arithmetic_file(frame, restart=4, dac={0: (1, 3), 16: 2}),
        "arithmetic_progressive.jpg": jc.arithmetic_file(frame, progressive=True),
        "lossless.jpg": jc.lossless_file(_image(48, 64, 12), predictor=6, pt=1),
        "sampling_411.jpg": jc.huffman_file(jc.coefficients(_image(60, 80, 13),
                                                            [(4, 1), (1, 1), (1, 1)])),
        "smoothed.jpg": jc.cut_scans(buf.getvalue(), 3),
    }


def tiff_images() -> dict:
    """{name: bytes} of the TIFF kinds Pillow reads beyond those above
    (Pillow writes the JPEG, CCITT, LZMA and BigTIFF ones; the rest by
    `helpers/raw_images.py`, the 4:2:0 strips and the subsampled lossless
    JPEG by `helpers/jpeg_codings.py`): orientation 2-8, fax-coded masks,
    JPEG-in-TIFF, Zstandard, fill order 2, 16-bit RGB(A), signed, 32-bit and
    float samples, palette + alpha, ThunderScan, YCbCr data units and
    old-style JPEG (libtiff's RGBA interface)."""
    from PIL import Image

    from helpers import jpeg_codings as jc
    from helpers import raw_images as raw

    def save(img, **kw):
        buf = io.BytesIO()
        img.save(buf, "TIFF", **kw)
        return buf.getvalue()

    r = np.random.RandomState(23)
    small = _image(20, 30, 14)
    mask = Image.fromarray(_mask(120, 160))
    rgb = Image.fromarray(_image(36, 48, 15))
    grey = _image(24, 40, 16, c=1)
    a16 = _image(24, 32, 17, c=4).astype(np.uint16) * 257 + _image(24, 32, 18, c=4)
    assoc = np.concatenate([a16[..., :3].astype(np.int64) * a16[..., 3:] // 65535, a16[..., 3:]],
                           -1).astype(np.uint16)
    floats = (r.randn(24, 40, 1) * 300).astype(np.float32)
    levels = (grey[..., 0] >> 4).astype(np.uint8)
    thunder = bytearray()
    for row in levels:                                  # raw codes and 3-bit deltas
        last = 0
        for v in row:
            d = (int(v) - last) % 16
            thunder.append(0x80 | ({1: 1, 2: 2, 3: 3, 13: 5, 14: 6, 15: 7}[d] << 3) | 4
                           if d in (1, 2, 3, 13, 14, 15) else 0xC0 | int(v))
            last = int(v)
    units = np.random.RandomState(24).randint(0, 256, 12 * 16 * 6).astype(np.uint8)  # 4:2:0 units
    buf = io.BytesIO()
    rgb.save(buf, "JPEG", quality=85)
    jpeg = buf.getvalue()
    strips = [jc.huffman_file(jc.coefficients(_image(40, 48, 19)[y:y + 16],
                                              [(2, 2), (1, 1), (1, 1)], 85))
              for y in range(0, 40, 16)]
    out = {f"orient{o}.tif": raw.tiff_file(small, 8, 2, compression=8, rows_per_strip=8,
                                            tags={274: (3, [o])}) for o in range(2, 9)}
    out.update({
        "fax_g4.tif": save(mask, compression="group4"),
        "fax_g3_2d_fill2.tif": save(mask, compression="group3",
                                    tiffinfo={292: 5, 266: 2, 262: 0}),
        "fax_mh.tif": save(mask, compression="tiff_ccitt"),
        "jpeg_ycbcr.tif": save(rgb.convert("YCbCr"), compression="jpeg", quality=85),
        "jpeg_420_strips.tif": raw.tiff_file(_image(40, 48, 19), 8, 6, chunks=strips,
                                             rows_per_strip=16,
                                             tags={259: (3, [7]), 530: (3, [2, 2])}),
        "lzma.tif": save(rgb, compression="lzma"),
        "zstd_predictor.tif": raw.tiff_file(_image(36, 48, 20), 8, 2, compression=50000,
                                            predictor=2),
        "bigtiff.tif": save(rgb, big_tiff=True),
        "fill2_lzw.tif": raw.tiff_file(grey, 8, 1, compression=5, fill_order=2),
        "rgb16.tif": raw.tiff_file(a16[..., :3], 16, 2, compression=8, predictor=2),
        "rgba16_planar.tif": raw.tiff_file(assoc, 16, 2, big_endian=True, compression=5,
                                           planar=2, extra=(1,)),
        "int16.tif": raw.tiff_file((grey.astype(np.int16) - 100) * 200, 16, 1,
                                   sample_format=(2,)),
        "int32.tif": save(Image.fromarray((grey[..., 0].astype(np.int32) - 90) * 9999)),
        "float_pred3.tif": raw.tiff_file(floats, 32, 1, compression=8, predictor=3,
                                         sample_format=(3,)),
        "signed8.tif": raw.tiff_file(grey.astype(np.int8) - 100, 8, 1, sample_format=(2,)),
        "pa.tif": raw.tiff_file(np.concatenate([grey, grey[::-1]], -1), 8, 3, extra=(2,),
                                compression=32773,
                                tags={320: (3, [int(v) for v in r.randint(0, 65536, 768)])}),
        "thunderscan.tif": raw.tiff_file(levels[..., None], 4, 1, chunks=[bytes(thunder)],
                                         tags={259: (3, [32809])}),
        "lossless_420.jpg": jc.lossless_file(_image(30, 40, 21), 4, 0,
                                             sampling=[(2, 2), (1, 1), (1, 1)]),
        "ycbcr_420_deflate.tif": raw.tiff_file(
            np.zeros((24, 32, 3), np.uint8), 8, 6, chunks=[zlib.compress(units.tobytes())],
            tags={259: (3, [8]), 530: (3, [2, 2])}),
        "old_jpeg.tif": raw.tiff_file(np.zeros((36, 48, 3), np.uint8), 8, 6, chunks=[jpeg],
                                      tags={259: (3, [6]), 512: (3, [1])}),
    })
    return out


def _blocks(h: int, w: int, seed: int, c: int = 3, bw: int = 32, bh: int = 8) -> np.ndarray:
    """Seeded colours constant over bw x bh blocks: runs that RLE, QOI and
    PackBits shorten, so a 512x512 file stays small."""
    r = np.random.RandomState(seed)
    cols = r.randint(0, 256, (-(-h // bh), -(-w // bw), c)).astype(np.uint8)
    return np.ascontiguousarray(np.repeat(np.repeat(cols, bh, 0), bw, 1)[:h, :w])


def raster_images() -> dict:
    """{name: bytes} of the raster formats Pillow decodes by itself: Pillow
    writes the P4 / P5 / P6 Netpbm, Targa, QOI, ICO, DIB, PCX, SGI and XBM
    files, `helpers/raw_images.py` the plain Netpbm, `Pf`, colour-mapped and
    RLE Targa, CUR, DCX, RLE SGI, Sun, PSD, XPM and FITS ones."""
    from PIL import Image

    from helpers import raw_images as raw

    def save(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()

    r = np.random.RandomState(29)
    grey = _image(40, 56, 30, c=1)[..., 0]
    rgb = _image(40, 56, 31)
    rgba = _image(32, 32, 32, c=4)
    bits = grey > 128
    quant = Image.fromarray(_image(40, 56, 33)).quantize(96)
    qpal = np.asarray(quant.getpalette()[:3 * 96], np.uint8).reshape(96, 3)
    big = _blocks(512, 512, 34)
    pal16 = r.randint(0, 256, (16, 3)).astype(np.uint8)
    idx4 = _image(16, 16, 35, c=1)[..., 0] >> 4
    cmap = r.randint(0, 256, (64, 3)).astype(np.uint8)
    return {
        "bitmap.pbm": save(Image.fromarray(bits), "PPM"),
        "plain_bitmap.pbm": raw.netpbm_plain(bits[:20, :30]),
        "plain_grey1000.pgm": raw.netpbm_plain(grey[:20, :30].astype(np.int32) * 1000 // 255,
                                               1000, b"maxval 1000: mode I"),
        "grey16.pgm": save(Image.fromarray(grey.astype(np.int32) * 251 + 7), "PPM"),
        "plain_rgb.ppm": raw.netpbm_plain(rgb[:16, :24], 255, b"plain"),
        "rgb16.ppm": b"P6\n96 72\n65535\n" + (_image(72, 96, 36).astype(">u2") * 257
                                             + r.randint(0, 256, (72, 96, 3))).astype(">u2")
        .tobytes(),
        "float.pfm": raw.pfm_grey((r.randn(24, 40) * 50).astype(np.float32), -1.0),
        "tga_rle.jpg": raw.tga_file(big[..., ::-1], rle=True, depth=24, origin=0x20,
                                    image_id=b"512x512 RLE"),
        "map16_topdown.tga": raw.tga_file((grey >> 2) + 16, cmap, map_depth=16, map_start=16,
                                          origin=0x20, rle=True),
        "la.tga": save(Image.fromarray(_image(40, 56, 37, c=2), "LA"), "TGA"),
        "rgba_flipped.tga": raw.tga_file(rgba[..., [2, 1, 0, 3]], depth=32, origin=0x10),
        "blocks.qoi": save(Image.fromarray(np.concatenate(
            [big, _blocks(512, 512, 38, 1, 64, 16)], -1)), "QOI"),
        "icon.ico": raw.icon_file([
            (16, 16, 4, 16, raw.dib_bitmap(idx4, 4, pal16, idx4 > 12)),
            (32, 32, 32, 0, save(Image.fromarray(rgba), "PNG"))]),
        "icon_bmp.ico": raw.icon_file([(56, 40, 8, 0, raw.dib_bitmap(
            np.asarray(quant), 8, qpal, bits))]),
        "cursor.cur": raw.icon_file([(32, 32, 32, 0, raw.dib_bitmap(rgba, 32))], cursor=True),
        "rgb.dib": save(Image.fromarray(rgb), "DIB"),
        "palette.pcx": save(quant, "PCX"),
        "rgb_odd.pcx": save(Image.fromarray(_image(31, 47, 39)), "PCX"),
        "mask.pcx": save(Image.fromarray(bits), "PCX"),
        "pages.dcx": raw.dcx_file([save(quant, "PCX"), save(Image.fromarray(bits), "PCX")]),
        "rle.sgi": raw.sgi_rle_file(_blocks(40, 56, 40, 3, 4, 2)),
        "grey16.sgi": save(Image.fromarray(grey), "SGI", bpc=2),
        "rle_map.ras": raw.sun_file(np.asarray(quant)[:, :56], 8, ftype=2, colormap=qpal),
        "rgb.ras": raw.sun_file(rgb[..., ::-1], 24),
        "blocks.psd": raw.psd_file(np.moveaxis(big, -1, 0), 3, 1,
                                   resources=raw.psd_resource(1005, b"\0" * 16, b"res")),
        "cmyk.psd": raw.psd_file(np.moveaxis(_image(20, 30, 41, c=4), -1, 0), 4),
        "mask.xbm": save(Image.fromarray(bits), "XBM"),
        "icon.xpm": raw.xpm_file(np.asarray(quant)[:24, :40] % 40,
                                 ["#%02x%02x%02x" % tuple(c) for c in qpal[:40]], cpp=2),
        "grey8.fits": raw.fits_file(grey, 8),
    }


def _bc6_untransformed(blocks: np.ndarray) -> np.ndarray:
    """Random BC6H blocks set to the two modes without a delta transform
    (11110, two regions of 6 bits; 00011, one of 10 bits), in which Pillow
    reads signed endpoints as the specification does."""
    out = blocks.copy()
    out[:, 0] = (out[:, 0] & 0xE0) | np.where(np.arange(len(out)) % 2, 0x1E, 0x03)
    return out


def random_blocks(n: int, w: int, h: int, seed: int) -> bytes:
    """Seeded random blocks covering w x h pixels of BCn `n`: for BC2-BC7
    every 16 bytes (BC1, BC4: 8) are a block, so random data reaches every
    mode, partition, rotation and index of BC6H and BC7."""
    size = 8 if n in (1, 4) else 16
    r = np.random.RandomState(seed)
    return r.randint(0, 256, ((w + 3) // 4) * ((h + 3) // 4) * size).astype(np.uint8).tobytes()


# phase formats' 512x512 block-compressed decode times: files made from a
# seed here and in chip_smoke.py alike; only their digests are committed
BLOCKS_512 = {"bc1_512.dds": (1, None, 51), "bc6h_512.dds": (6, 95, 52),
              "bc7_512.dds": (7, 98, 53)}


def block_file_512(name: str) -> bytes:
    """One BLOCKS_512 file: a DDS header (FOURCC DXT1, or DX10 with the
    DXGI format) and seeded random blocks."""
    from helpers import raw_images as raw

    n, dxgi, seed = BLOCKS_512[name]
    blocks = random_blocks(n, 512, 512, seed)
    if dxgi is None:
        return raw.dds_file(512, 512, blocks, fourcc=b"DXT1")
    return raw.dds_file(512, 512, blocks, dxgi=dxgi)


def block_images() -> dict:
    """{name: bytes} of the block-compressed texture formats: Pillow writes
    the DXT1 / DXT3 / DXT5 / BC2 / BC3 / BC5 DDS files (its BCn encoder),
    the L, LA and 32-bit masked DDS, and the BLP palette files (RGB
    palettes); `helpers/raw_images.py` the rest around seeded random blocks
    (BC4, BC5 signed, BC6H unsigned and signed, BC7), Pillow's DXT blocks
    (BLP2 DXT1 / DXT3 / DXT5, FTEX format 0) or a Pillow JPEG (BLP1)."""
    from PIL import Image

    from helpers import raw_images as raw

    def save(img, fmt, **kw):
        buf = io.BytesIO()
        img.save(buf, fmt, **kw)
        return buf.getvalue()

    def payload(dds: bytes) -> bytes:
        return dds[148:] if dds[84:88] == b"DX10" else dds[128:]

    r = np.random.RandomState(61)
    rgba = Image.fromarray(_image(36, 52, 62, c=4))
    odd = Image.fromarray(_image(29, 37, 63, c=4))
    rgb = Image.fromarray(_image(40, 56, 64))
    quant = rgb.quantize(80)
    bgra = np.zeros((256, 4), np.uint8)
    bgra[:80, :3] = np.asarray(quant.getpalette("RGB")[:240], np.uint8).reshape(80, 3)[:, ::-1]
    bgra[:, 3] = r.randint(0, 256, 256)
    dxt = {k: payload(save(rgba, "DDS", pixel_format=k)) for k in ("DXT1", "DXT3", "DXT5")}
    jpeg = save(rgb, "JPEG", quality=85)
    sos = jpeg.index(b"\xff\xda")
    blocks6 = np.frombuffer(random_blocks(6, 44, 36, 65), np.uint8).reshape(-1, 16)
    masked = _image(30, 42, 66, c=2)
    rgb565 = ((masked[..., 0].astype(np.uint16) << 8) | masked[..., 1]).astype("<u2")
    return {
        "dxt1.dds": save(rgba, "DDS", pixel_format="DXT1"),
        "dxt3_odd.dds": save(odd, "DDS", pixel_format="DXT3"),
        "dxt5.dds": save(rgba, "DDS", pixel_format="DXT5"),
        "bc2_dx10.dds": save(odd, "DDS", pixel_format="BC2"),
        "bc3_dx10.dds": save(rgba, "DDS", pixel_format="BC3"),
        "bc5u.dds": save(rgba.convert("RGB"), "DDS", pixel_format="BC5"),
        "bc4.dds": raw.dds_file(45, 27, random_blocks(4, 45, 27, 67), fourcc=b"ATI1"),
        "bc5s.dds": raw.dds_file(33, 20, random_blocks(5, 33, 20, 68), fourcc=b"BC5S"),
        "bc6h_uf16.dds": raw.dds_file(44, 36, random_blocks(6, 44, 36, 69), dxgi=95),
        "bc6h_sf16.dds": raw.dds_file(44, 36, _bc6_untransformed(blocks6).tobytes(), dxgi=96),
        "bc7.dds": raw.dds_file(64, 64, random_blocks(7, 64, 64, 70), dxgi=98),
        "bc7_srgb_odd.dds": raw.dds_file(37, 23, random_blocks(7, 37, 23, 71), dxgi=99),
        "rgb565.dds": raw.dds_file(42, 30, rgb565.tobytes(), pfflags=0x40, bitcount=16,
                                   masks=(0xF800, 0x07E0, 0x001F, 0)),
        "argb32.dds": save(rgba, "DDS"),
        "l8.dds": save(rgb.convert("L"), "DDS"),
        "la16.dds": save(rgba.convert("LA"), "DDS"),
        "palette.dds": raw.dds_file(56, 40, np.asarray(quant).tobytes(), pfflags=0x20,
                                    bitcount=8, palette=bgra[:, [2, 1, 0, 3]].tobytes()),
        "r8g8b8a8.dds": raw.dds_file(31, 17, _image(17, 31, 72, c=4).tobytes(), dxgi=28),
        "palette1.blp": save(quant, "BLP", blp_version="BLP1"),
        "jpeg1.blp": raw.blp1_file(56, 40, 0, 0, [jpeg[sos:]], jpeg_header=jpeg[:sos]),
        "palette2.blp": save(quant, "BLP"),
        "dxt1_alpha2.blp": raw.blp2_file(52, 36, 2, 1, 0, [dxt["DXT1"]], bgra.tobytes()),
        "dxt3_2.blp": raw.blp2_file(52, 36, 2, 4, 1, [dxt["DXT3"]], bgra.tobytes()),
        "dxt5_2.blp": raw.blp2_file(52, 36, 2, 8, 7, [dxt["DXT5"]], bgra.tobytes()),
        "dxt1.ftc": raw.ftex_file(52, 36, 0, dxt["DXT1"]),
        "rgb.ftu": raw.ftex_file(56, 40, 1, np.asarray(rgb).tobytes()),
        "dxt5_texture.jpg": save(Image.fromarray(_image(96, 128, 73, c=4)), "DDS",
                                 pixel_format="DXT5"),
    }


def write_images(out: Path) -> None:
    from PIL import Image

    big = Image.fromarray(_image(192, 256, 1))
    small = Image.fromarray(_image(47, 63, 2))
    alpha = Image.fromarray(_image(47, 63, 3, c=4))
    mid = Image.fromarray(_image(120, 160, 8))
    saves = {
        "progressive.jpg": (big, dict(format="JPEG", quality=85, progressive=True)),
        "rgb24.bmp": (big, dict(format="BMP")),
        "lossy.webp": (big, dict(format="WEBP", quality=80)),
        "cmyk.jpg": (small.convert("CMYK"), dict(format="JPEG", quality=90)),
        "rgb_coded.jpg": (small, dict(format="JPEG", quality=90, keep_rgb=True)),
        "palette.bmp": (small.quantize(64), dict(format="BMP")),
        "lossless.webp": (small, dict(format="WEBP", lossless=True)),
        "alpha.webp": (alpha, dict(format="WEBP", quality=70)),
        "frame.gif": (mid.quantize(256), dict(format="GIF")),
        "lzw.tif": (Image.fromarray(_image(72, 96, 9)), dict(format="TIFF",
                                                              compression="tiff_lzw")),
        "mask.tif": (Image.fromarray(_mask(120, 160)), dict(format="TIFF",
                                                            compression="packbits")),
        "cmyk.tif": (small.convert("CMYK"), dict(format="TIFF")),
        "palette4.png": (small.quantize(16), dict(format="PNG", bits=4)),
    }
    for name, (img, kw) in saves.items():
        buf = io.BytesIO()
        img.save(buf, **kw)
        (out / name).write_bytes(buf.getvalue())
    for name, data in {**raw_images(), **jpeg_images(), **tiff_images(),
                       **raster_images(), **block_images()}.items():
        (out / name).write_bytes(data)


def image_digests(out: Path) -> dict:
    from PIL import Image

    d = {}
    for name in sorted(os.listdir(out)):
        if name.endswith(IMAGE_SUFFIXES):
            im = Image.open(out / name)
            px = np.asarray(im)
            d[name] = {"file": hashlib.sha256((out / name).read_bytes()).hexdigest(),
                       "mode": im.mode, "shape": list(px.shape),
                       "pixels": hashlib.sha256(px.tobytes()).hexdigest(),
                       "rgb": hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()).hexdigest()}
    return d


def generated_digests() -> dict:
    """{name: {"file", "mode", "pixels", "rgb", "shape"}} of the BLOCKS_512
    files, as `image_digests` gives them for a committed file."""
    from PIL import Image

    d = {}
    for name in BLOCKS_512:
        data = block_file_512(name)
        im = Image.open(io.BytesIO(data))
        px = np.asarray(im)
        d[name] = {"file": hashlib.sha256(data).hexdigest(), "mode": im.mode,
                   "shape": list(px.shape), "pixels": hashlib.sha256(px.tobytes()).hexdigest(),
                   "rgb": hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()).hexdigest()}
    return d


def _leaves(tree, at=()):
    if hasattr(tree, "_asdict"):                 # optax's named tuples restore as dicts
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], at + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, at + (str(i),))
    elif tree is not None:
        yield "/".join(at), tree


def _bits(v) -> np.ndarray:
    """A leaf's bytes: bfloat16 (numpy's or torch's) as its 16-bit words."""
    if type(v).__module__.startswith("torch"):
        import torch

        return (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).contiguous().numpy()
    a = np.ascontiguousarray(np.asarray(v))
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


def tree_digests(tree) -> dict:
    """{path: sha256 of the leaf's bytes} over a restored (or saved) tree."""
    return {path: hashlib.sha256(_bits(v).tobytes()).hexdigest() for path, v in _leaves(tree)}


def write_state(out: Path) -> dict:
    """The LDMTrainer state at step 2 -> its digests."""
    import jax
    import jax.numpy as jnp

    from diffusion_spacetime_attn_tpu.config import LDMTrainConfig, ScheduleConfig, UNetConfig
    from diffusion_spacetime_attn_tpu.models.unet import UNet
    from diffusion_spacetime_attn_tpu.ops.schedule import make_schedule
    from diffusion_spacetime_attn_tpu.training import ldm_trainer

    unet = UNet(UNetConfig(**UNET), radius=0.2)
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, LATENT, LATENT, 4)), jnp.zeros((1,), jnp.int32),
                            None)["params"]
    r = np.random.RandomState(17)

    def draw(scale, positive=False, period=None):
        """Normal draws rounded to halves times `scale`; with `period`, one
        seeded run of that many values repeated over each leaf."""
        def leaf(s):
            v = r.randn(*((period,) if period else s.shape))
            v = np.round((np.abs(v) if positive else v) * 2) / 2 * scale
            return np.resize(v, s.shape).astype(np.float32)
        return jax.tree_util.tree_map(leaf, shapes)

    params, ema = draw(0.125), draw(0.125)
    mu, nu = draw(2 ** -10, period=97), draw(2 ** -20, positive=True, period=89)
    cfg, sched = LDMTrainConfig(), ScheduleConfig()
    state = ldm_trainer.init_state(cfg, sched, params, 1e-4)
    adam = state.opt_state[0]
    state = state._replace(
        params=params, ema_params=ema, step=jnp.asarray(2, jnp.int32),
        opt_state=(adam._replace(count=jnp.asarray(2, jnp.int32), mu=mu, nu=nu),)
        + tuple(state.opt_state[1:]))
    trainer = ldm_trainer.LDMTrainer(cfg, sched, make_schedule(sched, 50), None,
                                     ckpt_dir=str(out / "ldm"))
    trainer.save(state, 2)
    (out / "ldm" / "config.json").write_text(json.dumps({"unet": UNET, "latent": LATENT}))
    return tree_digests(jax.tree_util.tree_map(np.asarray, state._asdict()))


def build(out: Path) -> dict:
    """Write every fixture into `out` (emptied first) -> the digests."""
    out = Path(out)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    write_images(out)
    return {"state": write_state(out), "images": image_digests(out),
            "generated": generated_digests()}


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))    # `helpers` as the tests see it
    import jax

    jax.config.update("jax_platforms", "cpu")
    target = Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURES
    digests = build(target)
    (target / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(f.stat().st_size for f in target.rglob("*") if f.is_file())
    print(f"wrote {target}: {total} bytes")
