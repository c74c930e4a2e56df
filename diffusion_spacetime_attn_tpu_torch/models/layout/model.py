"""LayoutPredictor = RoBERTa backbone (+ object embedding) + GMM head; port of
the JAX package's `models/layout/model.py`.

Reference: `Rel2Bbox` (`model/Model.py:1017-1034`): encoder features ->
BBox_Head -> per-token (x, y) and the raw GMM parameters, in one
non-autoregressive forward.
"""
from __future__ import annotations

import hashlib
import math
from typing import Optional, Tuple

import torch
from torch import nn

from ...config import LayoutConfig
from .gmm_head import GMMHead, sample_xy
from .roberta import RobertaBackbone


class LayoutPredictor(nn.Module):
    def __init__(self, cfg: LayoutConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = RobertaBackbone(cfg)
        self.head = GMMHead(cfg)

    def forward(self, token_ids: torch.Tensor,
                object_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> raw GMM parameters [B, L, 6K] float32."""
        return self.head(self.backbone(token_ids, object_pos))

    def predict_xy(self, token_ids: torch.Tensor, object_pos: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   greedy_component: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (xy [B, L, 2], raw [B, L, 6K])."""
        raw = self(token_ids, object_pos)
        return sample_xy(raw, generator, greedy_component, self.cfg.gmm_components), raw


def init_layout_(model: LayoutPredictor, seed: int) -> LayoutPredictor:
    """Seeded weights in the distributions of flax's initializers, which the
    JAX package's `create_layout_predictor` draws (the streams differ):
    Dense kernels N(0, 1/fan_in) (flax: truncated), biases 0, embeddings
    N(0, 1), LayerNorm scale 1 and bias 0, the object embedding N(0, 2)
    (kaiming normal of a [1, hidden] kernel).  One generator per parameter
    on its own device, seeded from the seed and a hash of its name."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = model.get_submodule(name.rsplit(".", 1)[0]) if "." in name else model
            if isinstance(owner, nn.LayerNorm):
                p.fill_(1.0 if leaf == "weight" else 0.0)
                continue
            if leaf == "bias":
                p.zero_()
                continue
            if isinstance(owner, nn.Embedding):
                std = 1.0
            elif leaf == "object_embedding":
                std = math.sqrt(2.0)
            else:                                   # Dense weight [out, in]
                std = 1.0 / math.sqrt(p.shape[1])
            h = int.from_bytes(hashlib.sha1(name.encode()).digest()[:4], "little")
            g = torch.Generator(device=p.device).manual_seed((seed ^ h) & 0x7FFFFFFF)
            p.copy_(torch.randn(p.shape, generator=g, device=p.device) * std)
    return model


def create_layout_predictor(cfg: LayoutConfig, seed: int = 0, device="cuda") -> LayoutPredictor:
    """A LayoutPredictor with seeded random weights (`init_layout_`) on
    `device`, in eval mode without gradients."""
    with torch.device(device):
        model = LayoutPredictor(cfg)
    return init_layout_(model, seed).eval().requires_grad_(False)
