"""AutoencoderKL (f=8, z=4) and the VQ first stage (`VectorQuantizer`,
`VQModel`), port of the JAX package's `models/vae.py`.

CompVis details kept for weight compatibility: GroupNorm eps 1e-6, swish,
the asymmetric (0,1)×(0,1) padding of the stride-2 downsample conv, and the
single-head attention block in the bottleneck (plain PyTorch: the JAX package
computes it outside any kernel).  Public layout NHWC, NCHW inside.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import VAEConfig
from ..utils import prng
from .layers import Conv, GroupNorm32
from .unet import torch_dtype


class VAEResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, dtype=torch.float32):
        super().__init__()
        self.norm1 = GroupNorm32(in_ch, eps=1e-6)
        self.conv1 = Conv(in_ch, out_ch, 3, padding=1, dtype=dtype)
        self.norm2 = GroupNorm32(out_ch, eps=1e-6)
        self.conv2 = Conv(out_ch, out_ch, 3, padding=1, dtype=dtype)
        self.nin_shortcut = Conv(in_ch, out_ch, 1, dtype=dtype) if in_ch != out_ch else None

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class VAEAttnBlock(nn.Module):
    """Single-head spatial self-attention over H·W tokens."""

    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.q = Conv(channels, channels, 1, dtype=dtype)
        self.k = Conv(channels, channels, 1, dtype=dtype)
        self.v = Conv(channels, channels, 1, dtype=dtype)
        self.proj_out = Conv(channels, channels, 1, dtype=dtype)

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.norm(x)

        def tokens(t):  # [B, C, H, W] -> [B, H*W, C]
            return t.permute(0, 2, 3, 1).reshape(B, H * W, C)

        q, k, v = tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h))
        sim = torch.einsum("bqc,bkc->bqk", q.float(), k.float())
        attn = torch.softmax(sim * C ** -0.5, dim=-1).to(v.dtype)
        out = torch.einsum("bqk,bkc->bqc", attn.float(), v.float())
        out = out.reshape(B, H, W, C).permute(0, 3, 1, 2).to(x.dtype)
        return x + self.proj_out(out)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        self.conv_in = Conv(cfg.in_ch, cfg.ch, 3, padding=1, dtype=dt)
        ch_prev, curr_res = cfg.ch, cfg.resolution
        levels = len(cfg.ch_mult)
        for level, mult in enumerate(cfg.ch_mult):
            ch = cfg.ch * mult
            for i in range(cfg.num_res_blocks):
                self.add_module(f"down_{level}_block_{i}", VAEResnetBlock(ch_prev, ch, dt))
                if curr_res in cfg.attn_resolutions:
                    self.add_module(f"down_{level}_attn_{i}", VAEAttnBlock(ch, dt))
                ch_prev = ch
            if level != levels - 1:
                curr_res //= 2
                self.add_module(f"down_{level}_downsample", Conv(ch, ch, 3, stride=2, dtype=dt))
        ch = cfg.ch * cfg.ch_mult[-1]
        self.mid_block_1 = VAEResnetBlock(ch_prev, ch, dt)
        self.mid_attn_1 = VAEAttnBlock(ch, dt)
        self.mid_block_2 = VAEResnetBlock(ch, ch, dt)
        self.norm_out = GroupNorm32(ch, eps=1e-6)
        self.conv_out = Conv(ch, 2 * cfg.z_channels, 3, padding=1, dtype=dt)

    def forward(self, x):
        """x [B, C, H, W] -> moments [B, 2z, H/8, W/8]."""
        cfg = self.cfg
        h = self.conv_in(x)
        levels = len(cfg.ch_mult)
        for level in range(levels):
            for i in range(cfg.num_res_blocks):
                h = getattr(self, f"down_{level}_block_{i}")(h)
                attn = getattr(self, f"down_{level}_attn_{i}", None)
                if attn is not None:
                    h = attn(h)
            if level != levels - 1:
                # CompVis pads (0,1,0,1) before the stride-2 conv
                h = getattr(self, f"down_{level}_downsample")(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = torch_dtype(cfg.dtype)
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv(cfg.z_channels, ch, 3, padding=1, dtype=dt)
        self.mid_block_1 = VAEResnetBlock(ch, ch, dt)
        self.mid_attn_1 = VAEAttnBlock(ch, dt)
        self.mid_block_2 = VAEResnetBlock(ch, ch, dt)
        ch_prev = ch
        curr_res = cfg.resolution // (2 ** (len(cfg.ch_mult) - 1))
        for level in reversed(range(len(cfg.ch_mult))):
            ch = cfg.ch * cfg.ch_mult[level]
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_{level}_block_{i}", VAEResnetBlock(ch_prev, ch, dt))
                if curr_res in cfg.attn_resolutions:
                    self.add_module(f"up_{level}_attn_{i}", VAEAttnBlock(ch, dt))
                ch_prev = ch
            if level != 0:
                curr_res *= 2
                self.add_module(f"up_{level}_upsample", Conv(ch, ch, 3, padding=1, dtype=dt))
        self.norm_out = GroupNorm32(ch_prev, eps=1e-6)
        self.conv_out = Conv(ch_prev, cfg.out_ch, 3, padding=1, dtype=dt)

    def forward(self, z):
        """z [B, z, h, w] -> [B, out_ch, 8h, 8w] float32."""
        cfg = self.cfg
        h = self.mid_block_2(self.mid_attn_1(self.mid_block_1(self.conv_in(z))))
        for level in reversed(range(len(cfg.ch_mult))):
            for i in range(cfg.num_res_blocks + 1):
                h = getattr(self, f"up_{level}_block_{i}")(h)
                attn = getattr(self, f"up_{level}_attn_{i}", None)
                if attn is not None:
                    h = attn(h)
            if level != 0:
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = getattr(self, f"up_{level}_upsample")(h)
        return self.conv_out(F.silu(self.norm_out(h))).to(torch.float32)


class AutoencoderKL(nn.Module):
    """encode -> Gaussian moments; decode.  The SD latent scale factor is
    applied by the pipeline."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = self.dtype = torch_dtype(cfg.dtype)
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv(2 * cfg.z_channels, 2 * cfg.embed_dim, 1, dtype=dt)
        self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, 1, dtype=dt)

    def encode_moments(self, x):
        """[B, H, W, 3] in [-1, 1] -> (mean, logvar) each [B, H/8, W/8, embed_dim]."""
        moments = self.quant_conv(self.encoder(x.to(self.dtype).permute(0, 3, 1, 2)))
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, rng: Optional[np.ndarray] = None):
        """The posterior's mean, or mean + std·z with z = jax.random.normal
        of the key `rng` (`utils/prng.py`; drawn in float32 and rounded to
        the mean's dtype)."""
        mean, logvar = self.encode_moments(x)
        if rng is None:
            return mean
        return mean + torch.exp(0.5 * logvar) * prng.normal_like(rng, mean)

    def decode(self, z):
        """[B, h, w, z] (unscaled) -> [B, H, W, 3] float32 in about [-1, 1]."""
        h = self.post_quant_conv(z.to(self.dtype).permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)


class VectorQuantizer(nn.Module):
    """Nearest-neighbour codebook quantizer (taming `VectorQuantizer2`, the
    reference `VQModel`'s).  forward: z [B, h, w, C] -> (z_q with the
    straight-through gradient, the VQ loss, indices [B, h, w]).  Distances
    ‖z‖² + ‖e‖² − 2 z·e in float32, the first minimum wins; the loss is
    taming's legacy weighting β·mean((sg[z_q] − z)²) + mean((z_q − sg[z])²).
    The codebook is `weight` [n_embed, embed_dim] (flax's `embedding`)."""

    def __init__(self, n_embed: int, embed_dim: int, beta: float = 0.25):
        super().__init__()
        self.n_embed, self.embed_dim, self.beta = n_embed, embed_dim, beta
        self.weight = nn.Parameter(torch.empty(n_embed, embed_dim).uniform_(
            -1.0 / n_embed, 1.0 / n_embed))

    def forward(self, z):
        z = z.float()
        codebook = self.weight.float()
        flat = z.reshape(-1, self.embed_dim)
        d = ((flat ** 2).sum(dim=1, keepdim=True) + (codebook ** 2).sum(dim=1)[None, :]
             - 2.0 * flat @ codebook.T)
        idx = torch.argmin(d, dim=1)
        z_q = codebook[idx].reshape(z.shape)
        loss = (self.beta * torch.mean((z_q.detach() - z) ** 2)
                + torch.mean((z_q - z.detach()) ** 2))
        return z + (z_q - z).detach(), loss, idx.reshape(z.shape[:-1])

    def embed_code(self, code):
        """Indices [B, h, w] -> codebook vectors [B, h, w, C]."""
        return self.weight[code]


class VQModel(nn.Module):
    """The reference `VQModel` (`ldm/models/autoencoder.py:14-283`): the KL
    model's encoder and decoder around a vector-quantized bottleneck.
    `encode` -> (quant, loss, indices); `decode` takes quantized latents;
    `interface_encode` / `interface_decode` are `VQModelInterface`'s (the
    LDM first stage encodes to the pre-quant h and quantizes in decode).
    NHWC in and out."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        dt = self.dtype = torch_dtype(cfg.dtype)
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quantize = VectorQuantizer(cfg.n_embed, cfg.embed_dim)
        self.quant_conv = Conv(2 * cfg.z_channels, cfg.embed_dim, 1, dtype=dt)
        self.post_quant_conv = Conv(cfg.embed_dim, cfg.z_channels, 1, dtype=dt)

    def encode_to_prequant(self, x):
        h = self.quant_conv(self.encoder(x.to(self.dtype).permute(0, 3, 1, 2)))
        return h.permute(0, 2, 3, 1)

    def encode(self, x):
        return self.quantize(self.encode_to_prequant(x))

    def decode(self, quant):
        h = self.post_quant_conv(quant.to(self.dtype).permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)

    def decode_code(self, code):
        return self.decode(self.quantize.embed_code(code))

    def forward(self, x):
        quant, loss, idx = self.encode(x)
        return self.decode(quant), loss, idx

    def interface_encode(self, x):
        return self.encode_to_prequant(x)

    def interface_decode(self, h, force_not_quantize: bool = False):
        if not force_not_quantize:
            h, _, _ = self.quantize(h)
        return self.decode(h)
