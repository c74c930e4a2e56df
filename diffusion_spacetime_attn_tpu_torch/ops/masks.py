"""Circular region masks for spatial attention control
(reference `ldm/modules/attention.py:250-263`).

The mask at (row=j, col=i) is (i/dim - x)² + (j/dim - y)² < r²: columns index
x, rows index y, and the grid is floor-aligned (not pixel centres).
"""
from __future__ import annotations

import torch


def circular_mask(centers: torch.Tensor, dim: int, radius: float) -> torch.Tensor:
    """centers [..., 2] (x, y) in [0, 1] -> float32 masks [..., dim, dim]."""
    axis = torch.arange(dim, dtype=torch.float32, device=centers.device) / dim
    c = centers.to(torch.float32)
    x = c[..., 0][..., None, None]
    y = c[..., 1][..., None, None]
    dist = (axis[None, :] - x) ** 2 + (axis[:, None] - y) ** 2
    return (dist < radius * radius).to(torch.float32)


def flat_circular_mask(centers: torch.Tensor, dim: int, radius: float,
                       active=None) -> torch.Tensor:
    """centers [B, N, 2], active [B, N] or None -> [B, N, dim*dim] float32,
    zeroed for inactive (padding) objects."""
    m = circular_mask(centers, dim, radius)
    m = m.reshape(m.shape[:-2] + (dim * dim,))
    if active is not None:
        m = m * active[..., None].to(m.dtype)
    return m


def crop_window(center: torch.Tensor, image_size: int, crop_half: float):
    """Fixed-size crop window for the per-object CLIP loss (JAX
    `masks.py:57-73`): size int(2·crop_half·image_size), start clamped to
    [0, image_size − size] so the window stays inside the image (the
    reference crops a variable-size clamped box; identical away from
    borders).  center [..., 2] (x, y) in [0, 1] -> (start (y, x) int32
    [..., 2], size)."""
    size = int(2 * crop_half * image_size)
    c = center.to(torch.float32) * image_size
    start = torch.clamp(c - size // 2, 0, image_size - size).to(torch.int32)
    return start.flip(-1), size


def dynamic_crop(image: torch.Tensor, start_yx, size: int) -> torch.Tensor:
    """[H, W, C] -> [size, size, C] at (y, x), with `lax.dynamic_slice`'s
    index rule (a negative start counts from the end, then the start is
    clamped into the image); a slice, so differentiable into the image."""
    H, W = image.shape[0], image.shape[1]
    y, x = (int(v) for v in start_yx)
    y, x = y + H if y < 0 else y, x + W if x < 0 else x
    y, x = min(max(y, 0), H - size), min(max(x, 0), W - size)
    return image[y:y + size, x:x + size]
