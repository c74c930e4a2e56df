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
