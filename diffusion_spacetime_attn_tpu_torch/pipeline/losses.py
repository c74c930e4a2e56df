"""CLIP fidelity losses (the reference's DCLIPLoss, `plms.py:21-61`), port of
the JAX package's `pipeline/losses.py`.

Global path (`forward_2`): nearest-upsample ×7, then 16×16 average-pool
(512·7/16 = 224).  That composite is a linear resize, computed exactly as two
separable [224, 512] matrix products, with no 3584² intermediate.

Local path (`forward_3`): a fixed-size crop around each object's center
(`ops.masks.crop_window`), bilinear-resized to 224 (half-pixel, no
antialias, as torch `interpolate(mode="bilinear", align_corners=False)`),
also as two matrix products.

The reference feeds images in [0, 1] to CLIP without the CLIP mean/std
normalization; `normalize=False` (the default) keeps that.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import CLIPConfig
from ..models.clip import CLIP, clip_normalize, cosine_similarity
from ..models.layers import cast_matmul_weights
from ..ops.masks import crop_window, dynamic_crop
from ..utils.testing import randomize_
from ..utils.weights import load_flat


@functools.lru_cache(maxsize=8)
def _upsample_avgpool_matrix(src: int, up: int, pool: int) -> np.ndarray:
    """W[j, i] = count{m in [pool·j, pool·j + pool) : m // up == i} / pool."""
    dst = src * up // pool
    w = np.zeros((dst, src), np.float32)
    for j in range(dst):
        for m in range(pool * j, pool * j + pool):
            w[j, m // up] += 1.0 / pool
    return w


@functools.lru_cache(maxsize=8)
def _bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """Half-pixel bilinear weights without antialias."""
    w = np.zeros((dst, src), np.float32)
    scale = src / dst
    for j in range(dst):
        x = (j + 0.5) * scale - 0.5
        x0 = int(np.floor(x))
        frac = x - x0
        lo = min(max(x0, 0), src - 1)
        hi = min(max(x0 + 1, 0), src - 1)
        w[j, lo] += 1.0 - frac
        w[j, hi] += frac
    return w


def _resize(images, wh: np.ndarray, ww: np.ndarray):
    """[B, h, w, C] -> [B, wh.rows, ww.rows, C] by two separable products."""
    a = torch.as_tensor(wh, device=images.device, dtype=images.dtype)
    b = torch.as_tensor(ww, device=images.device, dtype=images.dtype)
    out = torch.einsum("js,bshc->bjhc", a, images)
    return torch.einsum("kh,bjhc->bjkc", b, out)


def global_resize(images: torch.Tensor, up: int = 7, pool: int = 16) -> torch.Tensor:
    """[B, S, S, C] -> [B, S·up/pool, S·up/pool, C]: the exact ×up-nearest +
    pool-avgpool composite."""
    w = _upsample_avgpool_matrix(images.shape[1], up, pool)
    return _resize(images, w, w)


def bilinear_resize(images: torch.Tensor, size: int) -> torch.Tensor:
    """[B, h, w, C] -> [B, size, size, C], half-pixel bilinear, no antialias."""
    return _resize(images, _bilinear_matrix(images.shape[1], size),
                   _bilinear_matrix(images.shape[2], size))


class DCLIPLoss:
    """A frozen CLIP model and the two fidelity losses."""

    def __init__(self, clip: CLIP, normalize: bool = False):
        self.clip = clip
        self.normalize = normalize
        self.image_size = clip.cfg.vision.image_size

    @classmethod
    def _build(cls, cfg: CLIPConfig, device, fill, normalize: bool) -> "DCLIPLoss":
        with torch.device(device):
            clip = CLIP(cfg)
        cast_matmul_weights(clip).eval().requires_grad_(False)
        fill(clip)
        return cls(clip, normalize)

    @classmethod
    def create(cls, cfg: CLIPConfig, seed: int = 0, device="cuda", scale: float = 0.02,
               normalize: bool = False) -> "DCLIPLoss":
        """Seeded N(0, scale²) weights generated on `device` (no checkpoint)."""
        return cls._build(cfg, device, lambda m: randomize_(m, seed, scale), normalize)

    @classmethod
    def from_flat(cls, cfg: CLIPConfig, flat, device="cuda",
                  normalize: bool = False) -> "DCLIPLoss":
        """Weights from the flat JAX tree of `models.clip.CLIP` (`vision/...`,
        `text/...`, `visual_projection/kernel`, `text_projection/kernel`)."""
        return cls._build(cfg, device, lambda m: load_flat(m, flat), normalize)

    def _device(self):
        return self.clip.visual_projection.weight.device

    def encode_images(self, images224: torch.Tensor) -> torch.Tensor:
        return self.clip.encode_image(clip_normalize(images224) if self.normalize
                                      else images224)

    def encode_texts(self, token_ids) -> torch.Tensor:
        return self.clip.encode_text(torch.as_tensor(token_ids, device=self._device()))

    def global_loss(self, images: torch.Tensor, text_tokens) -> torch.Tensor:
        """1 − cos(CLIP(resize_7_16(img)), CLIP(text)) per image (reference
        forward_2); images [B, S, S, 3] in [0, 1] -> [B]."""
        return 1.0 - cosine_similarity(self.encode_images(global_resize(images)),
                                       self.encode_texts(text_tokens))

    def local_loss(self, images: torch.Tensor, centers: torch.Tensor, object_tokens,
                   active: torch.Tensor, crop_half: float = 0.2) -> torch.Tensor:
        """Σ_n active_n·(1 − cos) over per-object crops (reference forward_3
        over `plms.py:256-273`); -> [B]."""
        B, N = centers.shape[:2]
        starts, size = crop_window(centers, images.shape[1], crop_half)
        starts = starts.tolist()
        crops = torch.stack([dynamic_crop(images[b], starts[b][n], size)
                             for b in range(B) for n in range(N)])
        crops = bilinear_resize(crops, self.image_size)
        img = self.encode_images(crops).reshape(B, N, -1)
        tokens = torch.as_tensor(object_tokens, device=self._device())
        txt = self.encode_texts(tokens.reshape(B * N, -1)).reshape(B, N, -1)
        return ((1.0 - cosine_similarity(img, txt)) * active).sum(dim=-1)
