"""GMM center head: a 5-component bivariate Gaussian mixture over (x, y)
per token; port of the JAX package's `models/layout/gmm_head.py`.

Reference: `layout_predictor/LayoutTransformer/model/bbox_head.py`: in the
paper's config `PDFDecoder.forward` is `output_Layer(encoder_output)` (a
hidden -> hidden linear) feeding `xy_bivariate` (hidden -> 6·K)
(`bbox_head.py:227-266,46-86`).

Layout of the raw 6·K vector: [π(K) | μx(K) | μy(K) | log σx(K) |
log σy(K) | arctanh ρ(K)] (`bbox_head.py:114-135`).  ρ is tanh-ed and not
clamped inside the likelihood (`loss.py:336-452`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import nn

from ...config import LayoutConfig
from ..layers import Dense
from .roberta import _DTYPES


class GMMParams(NamedTuple):
    pi: torch.Tensor       # [..., K] mixture weights (softmaxed)
    mu_x: torch.Tensor     # [..., K]
    mu_y: torch.Tensor
    sigma_x: torch.Tensor  # [..., K] (exp'd)
    sigma_y: torch.Tensor
    rho: torch.Tensor      # [..., K] (tanh'd, not clamped)


def split_gmm(raw: torch.Tensor, k: int = 5) -> GMMParams:
    """raw [..., 6K] -> GMMParams (reference get_gmm_params semantics)."""
    pi, ux, uy, sx, sy, rho = torch.chunk(raw, 6, dim=-1)
    return GMMParams(pi=torch.softmax(pi, dim=-1), mu_x=ux, mu_y=uy,
                     sigma_x=torch.exp(sx), sigma_y=torch.exp(sy), rho=torch.tanh(rho))


def gmm_log_likelihood(raw: torch.Tensor, xy: torch.Tensor, k: int = 5) -> torch.Tensor:
    """log Σ_k π_k N(xy; μ, σ, ρ) + 1e-5 per token (reference
    `loss.py:357-381`)."""
    p = split_gmm(raw, k)
    x, y = xy[..., 0:1], xy[..., 1:2]
    zx = ((x - p.mu_x) / p.sigma_x) ** 2
    zy = ((y - p.mu_y) / p.sigma_y) ** 2
    zxy = (x - p.mu_x) * (y - p.mu_y) / (p.sigma_x * p.sigma_y)
    z = zx + zy - 2.0 * p.rho * zxy
    a = -z / (2.0 * (1.0 - p.rho ** 2))
    norm = torch.clamp(2.0 * math.pi * p.sigma_x * p.sigma_y * torch.sqrt(1.0 - p.rho ** 2),
                       min=1e-5)
    raw_pdf = torch.sum(p.pi * torch.exp(a) / norm, dim=-1)
    return torch.log(raw_pdf + 1e-5)


def sample_xy(raw: torch.Tensor, generator: Optional[torch.Generator] = None,
              greedy_component: bool = False, k: int = 5) -> torch.Tensor:
    """(x, y) = the mean of one component per token: the argmax of π (its
    first maximum) when `greedy_component` or no generator is given, the
    reference's greedy mode (`bbox_head.py:138-180`, GREEDY=True in the
    paper's config); else a categorical draw from `generator`.  JAX draws
    with `jax.random.categorical`, whose stream this cannot match, so only
    the greedy branch agrees with the JAX package (no caller of the port
    samples)."""
    p = split_gmm(raw, k)
    if greedy_component or generator is None:
        idx = torch.argmax(p.pi, dim=-1)
    else:
        flat = torch.clamp(p.pi, min=1e-12).reshape(-1, p.pi.shape[-1])
        idx = torch.multinomial(flat, 1, generator=generator).reshape(p.pi.shape[:-1])
    ux = torch.gather(p.mu_x, -1, idx[..., None])[..., 0]
    uy = torch.gather(p.mu_y, -1, idx[..., None])[..., 0]
    return torch.stack([ux, uy], dim=-1)


class GMMHead(nn.Module):
    """Linear(hidden -> hidden) -> Linear(hidden -> 6K)."""

    def __init__(self, cfg: LayoutConfig):
        super().__init__()
        dt = _DTYPES[cfg.dtype]
        self.output_layer = Dense(cfg.hidden, cfg.hidden, dtype=dt)
        self.xy_bivariate = Dense(cfg.hidden, cfg.gmm_components * 6, dtype=dt)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.xy_bivariate(self.output_layer(features)).float()
