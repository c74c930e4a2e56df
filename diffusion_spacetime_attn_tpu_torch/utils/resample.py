"""PIL's `Image.resize` on uint8 RGB and greyscale images, exactly.

`resize(img, (width, height), filter)` follows Pillow's two-pass separable
convolution (`libImaging/Resample.c`): for each output pixel the filter's
support is widened by the scale when downscaling, the weights are computed
in double and normalized, then converted to 22-bit fixed point
(`PRECISION_BITS = 32 - 8 - 2`, rounded half away from zero); the
horizontal pass runs first and clips to uint8, then the vertical pass, each
only where its axis changes size.  Filters: "nearest" (Pillow's affine
nearest-neighbour scaling), "bilinear", "bicubic" (a = -0.5) and "lanczos"
(a = 3).  `Image.resize`'s default filter is BICUBIC, and so is this one's;
there is no `reducing_gap`.  Each pass is one sparse product (scipy) of the
fixed-point weights, summed exactly in float64; `tests/test_torch_image_io.py`
holds it to PIL byte for byte.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
from scipy import sparse

PRECISION_BITS = 32 - 8 - 2
FILTERS = ("nearest", "bilinear", "bicubic", "lanczos")
ALIASES = {"linear": "bilinear", "cubic": "bicubic"}


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _sinc(x: np.ndarray) -> np.ndarray:
    with np.errstate(invalid="ignore", divide="ignore"):
        px = x * math.pi
        return np.where(x == 0.0, 1.0, np.sin(px) / px)


def _lanczos(x: np.ndarray) -> np.ndarray:
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3), 0.0)


_KERNELS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0), "lanczos": (_lanczos, 3.0)}


def _coeffs(in_size: int, out_size: int, name: str) -> Tuple[np.ndarray, np.ndarray]:
    """`precompute_coeffs` + `normalize_coeffs_8bpc`: (xmin [out], fixed-point
    weights [out, ksize] int64, zero past each pixel's own count)."""
    fn, support = _KERNELS[name]
    scale = filterscale = in_size / out_size
    if filterscale < 1.0:
        filterscale = 1.0
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)     # C's (int) truncation
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)
    w = fn((x[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for j in range(ksize):          # Pillow's `ww += w`, in order (np.sum pairs terms)
        ww = ww + w[:, j]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww != 0.0, ww, 1.0)[:, None], w)
    one = float(1 << PRECISION_BITS)
    fixed = np.where(w < 0, (-0.5 + w * one), (0.5 + w * one))
    return xmin, np.trunc(fixed).astype(np.int64)


def _pass(img: np.ndarray, out_size: int, axis: int, name: str) -> np.ndarray:
    """One 8-bit pass along `axis` (0 rows, 1 columns) of [H, W, C] uint8:
    a sparse [out, in] product of the fixed-point weights in float64, whose
    integer sums (below 2^53) are exact in any order."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size, name)
    rows, cols = np.nonzero(k)
    m = sparse.csr_matrix((k[rows, cols].astype(np.float64), (rows, xmin[rows] + cols)),
                          shape=(out_size, in_size))
    src = np.moveaxis(img, axis, 0)
    acc = m @ src.reshape(in_size, -1).astype(np.float64) + float(1 << (PRECISION_BITS - 1))
    out = np.clip(np.floor(acc / float(1 << PRECISION_BITS)), 0, 255).astype(np.uint8)
    return np.moveaxis(out.reshape((out_size,) + src.shape[1:]), 0, axis)


def _nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`ImagingScaleAffine` of Pillow's NEAREST resize: the source index of
    output x is int(a·0.5 + a·x) accumulated in double, a = in / out."""
    def index(in_size, out_size):
        a = in_size / out_size
        pos = np.add.accumulate(np.concatenate([[a * 0.5], np.full(out_size - 1, a)]))
        return np.clip(pos.astype(np.int64), 0, in_size - 1)
    return img[index(img.shape[0], height)][:, index(img.shape[1], width)]


def resize(img: np.ndarray, size: Tuple[int, int], resample: str = "bicubic") -> np.ndarray:
    """PIL's `Image.fromarray(img).resize(size, resample)` as an array: `img`
    uint8 [H, W] (mode L) or [H, W, 3] (RGB); `size` is (width, height), as
    PIL takes it."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize takes uint8 [H, W] or [H, W, C], got {img.dtype} {img.shape}")
    name = ALIASES.get(str(resample).lower(), str(resample).lower())
    if name not in FILTERS:
        raise ValueError(f"resample filter {resample!r}: one of {FILTERS}")
    width, height = int(size[0]), int(size[1])
    if width <= 0 or height <= 0:
        raise ValueError(f"resize to {size}")
    if (img.shape[1], img.shape[0]) == (width, height):
        return img.copy()
    if name == "nearest":
        return np.ascontiguousarray(_nearest(img, width, height))
    grey = img.ndim == 2
    out = img[..., None] if grey else img
    if width != out.shape[1]:
        out = _pass(out, width, 1, name)
    if height != out.shape[0]:
        out = _pass(out, height, 0, name)
    return np.ascontiguousarray(out[..., 0] if grey else out)
