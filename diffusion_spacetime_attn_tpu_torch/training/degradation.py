"""Blind-superresolution image degradation (BSRGAN-light), on the host;
port of the JAX package's `training/degradation.py` (reference
`ldm/modules/image_degradation/bsrgan_light.py` as `ldm/data/imagenet.py`
`ImageNetSR` consumes it).

The same stages, probabilities and draws in the same order from the same
`random.Random` and `np.random.RandomState`: random-order {blur, random
downsample, gaussian noise, JPEG round trip} with the final downsample
kept last, and the 25 % pre-halving for sf = 4.  PIL's resizes and JPEG
round trip are the port's PIL-exact `utils/resample.resize` and
`utils/jpeg.py` codec; the blur is scipy's `ndimage.convolve` (mirror), as
in JAX.  Never on the card.
"""
from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

from ..utils.jpeg import decode_jpeg, encode_jpeg
from ..utils.resample import resize


def _gaussian_kernel(size: int, sigma_x: float, sigma_y: Optional[float] = None,
                     theta: float = 0.0) -> np.ndarray:
    """Isotropic / anisotropic 2-D gaussian (reference `fspecial` /
    `anisotropic_Gaussian`)."""
    sigma_y = sigma_x if sigma_y is None else sigma_y
    ax = np.arange(size) - (size - 1) / 2.0
    xx, yy = np.meshgrid(ax, ax)
    c, s = np.cos(theta), np.sin(theta)
    xr = c * xx + s * yy
    yr = -s * xx + c * yy
    k = np.exp(-0.5 * ((xr / sigma_x) ** 2 + (yr / sigma_y) ** 2))
    return k / k.sum()


def add_blur(img: np.ndarray, sf: int, rng: random.Random) -> np.ndarray:
    """`add_blur`: 50 % anisotropic, widths scaled by sf."""
    wd = 2.0 + 0.2 * sf
    if rng.random() < 0.5:
        k = _gaussian_kernel(2 * rng.randint(2, 11) + 3, sigma_x=wd * rng.random(),
                             sigma_y=wd * rng.random(), theta=rng.random() * np.pi)
    else:
        k = _gaussian_kernel(2 * rng.randint(2, 11) + 3, sigma_x=max(wd * rng.random(), 1e-2))
    return ndimage.convolve(img, k[..., None], mode="mirror")


def add_gaussian_noise(img: np.ndarray, rng: random.Random, noise_level1: int = 2,
                       noise_level2: int = 25) -> np.ndarray:
    """`add_Gaussian_noise`: per-channel, grey or correlated-colour noise at
    a random level."""
    level = rng.randint(noise_level1, noise_level2) / 255.0
    p = rng.random()
    nprng = np.random.RandomState(rng.randint(0, 2 ** 31 - 1))
    if p > 0.6:
        img = img + nprng.normal(0, level, img.shape)
    elif p > 0.4:
        img = img + nprng.normal(0, level, img.shape[:2] + (1,))
    else:  # correlated colour noise
        d = np.diag(nprng.rand(3))
        u, _ = np.linalg.qr(nprng.rand(3, 3))
        cov = u.T @ d @ u
        img = img + nprng.multivariate_normal([0, 0, 0], np.abs(level ** 2 * cov), img.shape[:2])
    return np.clip(img, 0.0, 1.0)


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (img * 255.0 + 0.5).clip(0, 255).astype(np.uint8)


def add_jpeg_compression(img: np.ndarray, rng: random.Random, q_min: int = 30,
                         q_max: int = 95) -> np.ndarray:
    """`add_JPEG_noise`: a JPEG round trip at a random quality (PIL's bytes
    and pixels, through the port's codec)."""
    q = rng.randint(q_min, q_max)
    return decode_jpeg(encode_jpeg(_to_uint8(img), quality=q)).astype(np.float64) / 255.0


def _resize(img: np.ndarray, shape: Tuple[int, int], rng: random.Random) -> np.ndarray:
    method = rng.choice(["bilinear", "bicubic", "lanczos"])
    return resize(_to_uint8(img), (shape[1], shape[0]), method).astype(np.float64) / 255.0


def degradation_bsrgan_light(image: np.ndarray, sf: int = 4, seed: Optional[int] = None
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """image [H, W, 3] in [0, 1] (float) or uint8 -> (lq [H/sf, W/sf, 3],
    hq [H, W, 3]), both [0, 1] float32 (`degradation_bsrgan_variant`)."""
    rng = random.Random(seed)
    if image.dtype == np.uint8:
        image = image.astype(np.float64) / 255.0
    image = image.astype(np.float64)
    h1, w1 = image.shape[:2]
    image = image[: h1 - h1 % sf, : w1 - w1 % sf]
    h, w = image.shape[:2]
    hq = image.copy()
    sf_run = sf
    if sf == 4 and rng.random() < 0.25:  # scale2_prob pre-halving
        image = _resize(image, (h // 2, w // 2), rng)
        sf_run = 2

    jpeg_prob = 0.9
    order = rng.sample(range(4), 4)
    order.remove(3)                      # the final downsample stays last
    order.append(3)
    for stage in order:
        if stage == 0:
            image = add_blur(image, sf_run, rng)
        elif stage == 1:
            if rng.random() < 0.8:       # random-scale downsample (downsample2)
                sf1 = rng.uniform(1, 2 * sf_run)
                image = _resize(image, (max(int(image.shape[0] / sf1), h // sf),
                                        max(int(image.shape[1] / sf1), w // sf)), rng)
        elif stage == 2:
            image = add_gaussian_noise(image, rng)
        elif stage == 3:
            image = _resize(image, (h // sf, w // sf), rng)  # downsample3
            if rng.random() < jpeg_prob:
                image = add_jpeg_compression(image, rng)
    image = _resize(image, (h // sf, w // sf), rng)          # enforce the final size
    return image.astype(np.float32), hq.astype(np.float32)


def superres_example(image: np.ndarray, size: int = 256, sf: int = 4,
                     degradation: str = "bsrgan_light", seed: Optional[int] = None) -> dict:
    """One ImageNetSR-style record: center-crop to `size`, degrade, return
    {'image', 'LR_image'} both in [-1, 1] (the reference's 2x - 1)."""
    h, w = image.shape[:2]
    m = min(h, w)
    top, left = (h - m) // 2, (w - m) // 2
    crop = image[top: top + m, left: left + m]
    crop = resize(np.ascontiguousarray(_to_uint8(crop) if crop.dtype != np.uint8 else crop),
                  (size, size), "bicubic").astype(np.float32) / 255.0
    if degradation == "bsrgan_light":
        lq, hq = degradation_bsrgan_light(crop, sf=sf, seed=seed)
    else:  # deterministic bicubic (the reference's cv_* interpolation modes)
        lq = resize((crop * 255).astype(np.uint8), (size // sf, size // sf),
                    "bicubic").astype(np.float32) / 255.0
        hq = crop
    return {"image": hq * 2.0 - 1.0, "LR_image": lq * 2.0 - 1.0}
