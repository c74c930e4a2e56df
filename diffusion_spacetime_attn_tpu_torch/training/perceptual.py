"""Perceptual (LPIPS) and adversarial (PatchGAN) modules for training the
first-stage autoencoder.  Port of the JAX package's `training/perceptual.py`
(taming-transformers' `lpips.py` and `discriminator.py`, which the reference
imports in `ldm/modules/losses/contperceptual.py`).

  * `LPIPS`: VGG16 to relu5_3, five taps (relu1_2 ... relu5_3), unit
    normalization over channels, learned 1×1 heads, taming's scaling
    constants.  Published weights load through `utils/convert.py`
    `convert_lpips`; random weights give a valid metric for smoke runs
    (LPIPS(x, x) = 0 either way).
  * `NLayerDiscriminator`: 64-channel PatchGAN, stride-2 4×4 convolutions,
    LeakyReLU(0.2) and flax's BatchNorm (`FlaxBatchNorm`).

Images are NHWC, as in the JAX package; convolutions run NCHW inside.
Module and parameter names follow the flax tree, so the weight bridge
(`utils/weights.py`) maps them one to one; the discriminator's running
statistics are buffers `bn{n}.mean` / `bn{n}.var` (flax's `batch_stats`).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# taming lpips.py ScalingLayer constants
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 conv plan: (out_channels, pool_before) per conv; the LPIPS taps
# follow the last ReLU of each block
_VGG_PLAN = [
    (64, False), (64, False),
    (128, True), (128, False),
    (256, True), (256, False), (256, False),
    (512, True), (512, False), (512, False),
    (512, True), (512, False), (512, False),
]
_TAPS = (1, 3, 6, 9, 12)
TAP_CHANNELS = (64, 128, 256, 512, 512)


class VGG16Features(nn.Module):
    """VGG16 up to relu5_3; NCHW in, the five tap activations out."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (ch, _) in enumerate(_VGG_PLAN):
            self.add_module(f"conv_{i}", nn.Conv2d(cin, ch, 3, padding=1))
            cin = ch

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for i, (_, pool) in enumerate(_VGG_PLAN):
            if pool:
                x = F.max_pool2d(x, 2, 2)
            x = F.relu(getattr(self, f"conv_{i}")(x))
            if i in _TAPS:
                taps.append(x)
        return taps


def _unit_normalize(x, eps: float = 1e-10):
    return x / (torch.sqrt(torch.sum(x ** 2, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """Learned perceptual distance.  x, y: [B, H, W, 3] in [-1, 1] ->
    [B, 1, 1, 1] (the spatial singletons broadcast against |x − x̂|)."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Features()
        for i, c in enumerate(TAP_CHANNELS):
            self.add_module(f"lin_{i}", nn.Conv2d(c, 1, 1, bias=False))

    def forward(self, x, y):
        shift = torch.as_tensor(_SHIFT, device=x.device)
        scale = torch.as_tensor(_SCALE, device=x.device)

        def feats(im):
            return self.vgg(((im.float() - shift) / scale).permute(0, 3, 1, 2))

        total = 0.0
        for i, (a, b) in enumerate(zip(feats(x), feats(y))):
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + getattr(self, f"lin_{i}")(d).mean(dim=(2, 3), keepdim=True)
        return total.permute(0, 2, 3, 1)


class FlaxBatchNorm(nn.Module):
    """flax `nn.BatchNorm` over the channels of an NCHW tensor: in train
    mode the batch mean and the biased variance max(0, E[x²] − E[x]²) (flax's
    fast variance) normalize, and the running statistics move as
    0.99·running + 0.01·batch (flax's momentum 0.99 is torch's 0.01; torch's
    running variance would take the unbiased batch variance); otherwise the
    running statistics normalize.  eps 1e-5."""

    def __init__(self, channels: int, momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x, train: bool):
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(self.momentum * self.mean + (1 - self.momentum) * mean)
                self.var.copy_(self.momentum * self.var + (1 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]


class NLayerDiscriminator(nn.Module):
    """PatchGAN: Conv(4, s2) → LeakyReLU, n_layers × Conv-BN-LeakyReLU with
    doubling channels (the last at stride 1), a 1-channel logit conv.
    x: [B, H, W, 3] -> logits [B, h, w, 1]."""

    def __init__(self, ndf: int = 64, n_layers: int = 3, in_ch: int = 3):
        super().__init__()
        self.n_layers = n_layers
        self.conv0 = nn.Conv2d(in_ch, ndf, 4, stride=2, padding=1)
        prev = ndf
        for n in range(1, n_layers + 1):
            mult = min(2 ** n, 8)
            stride = 2 if n < n_layers else 1
            self.add_module(f"conv{n}", nn.Conv2d(prev, ndf * mult, 4, stride=stride,
                                                  padding=1, bias=False))
            self.add_module(f"bn{n}", FlaxBatchNorm(ndf * mult))
            prev = ndf * mult
        self.logits = nn.Conv2d(prev, 1, 4, stride=1, padding=1)

    def forward(self, x, train: bool = True):
        h = F.leaky_relu(self.conv0(x.float().permute(0, 3, 1, 2)), 0.2)
        for n in range(1, self.n_layers + 1):
            h = getattr(self, f"conv{n}")(h)
            h = F.leaky_relu(getattr(self, f"bn{n}")(h, train), 0.2)
        return self.logits(h).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real, logits_fake):
    """taming `vqperceptual.hinge_d_loss`."""
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def vanilla_d_loss(logits_real, logits_fake):
    """taming `vqperceptual.vanilla_d_loss`."""
    return 0.5 * (F.softplus(-logits_real).mean() + F.softplus(logits_fake).mean())


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    """taming `vqperceptual.adopt_weight`: `value` before `threshold` steps."""
    return value if global_step < threshold else weight
