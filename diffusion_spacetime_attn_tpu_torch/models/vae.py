"""AutoencoderKL (f=8, z=4), port of the JAX package's `models/vae.py`.

CompVis details kept for weight compatibility: GroupNorm eps 1e-6, swish,
the asymmetric (0,1)×(0,1) padding of the stride-2 downsample conv, and the
single-head attention block in the bottleneck (plain PyTorch: the JAX package
computes it outside any kernel).  Public layout NHWC, NCHW inside.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VAEConfig
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

    def decode(self, z):
        """[B, h, w, z] (unscaled) -> [B, H, W, 3] float32 in about [-1, 1]."""
        h = self.post_quant_conv(z.to(self.dtype).permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)
