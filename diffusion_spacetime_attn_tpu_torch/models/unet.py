"""SD v1 UNet, port of the JAX package's `models/unet.py`.

320 base channels, mult (1,2,4,4), 2 res blocks per level,
SpatialTransformers at downsample factors 1/2/4 (16 of them: 6 down, 1 mid,
9 up), skip connections concatenated on the channel axis.  The public layout
is the JAX one, latents [B, H, W, C]; convolutions run NCHW inside.  The
spatial-control state is an explicit `SpatialControl` argument threaded to
every cross-attention.  `conditional=False` builds the unconditional UNet of
the reference's unconditional LDM configs (JAX: `context=None`), whose
second attention in every block is self-attention; it takes no context, and
a conditional UNet raises without one.

Tensor parallelism reaches the blocks through their modules:
`parallel/sharding.shard_params(unet, mesh)` slices every transformer
block's attention and GEGLU pairs to the rank's share of the mesh's model
axis and marks them, and the UNet's forward is unchanged (the convolutions,
norms and time embedding are replicated, as JAX's rules leave them).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import UNetConfig
from ..ops.attention import SpatialControl
from .layers import (
    Conv,
    Dense,
    Downsample,
    GroupNorm32,
    ResBlock,
    SpatialTransformer,
    Upsample,
    timestep_embedding,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]


class UNet(nn.Module):
    def __init__(self, cfg: UNetConfig, radius: float = 0.2, conditional: bool = True):
        super().__init__()
        self.cfg, self.conditional = cfg, conditional
        dt = self.dtype = torch_dtype(cfg.dtype)
        mc = cfg.model_channels
        emb_dim = mc * 4
        self.time_embed_0 = Dense(mc, emb_dim, dtype=dt)
        self.time_embed_2 = Dense(emb_dim, emb_dim, dtype=dt)

        scores_dtype = (None if cfg.attn_scores_dtype == "float32"
                        else torch_dtype(cfg.attn_scores_dtype))

        def transformer(ch):
            heads = ch // cfg.num_head_channels if cfg.num_head_channels else cfg.num_heads
            return SpatialTransformer(
                ch, heads, cfg.context_dim if conditional else None,
                depth=cfg.transformer_depth, radius=radius, dtype=dt, flash=cfg.use_flash,
                mha=cfg.use_mha, fused_control=cfg.use_fused_control, fused_ff=cfg.use_fused_ff,
                q_chunk=cfg.attn_q_chunk, scores_dtype=scores_dtype)

        self.in_conv = Conv(cfg.in_channels, mc, 3, padding=1, dtype=dt)
        skips = [mc]
        ch_prev, ds, idx = mc, 1, 0
        levels = len(cfg.channel_mult)
        for level, mult in enumerate(cfg.channel_mult):
            ch = mc * mult
            for _ in range(cfg.num_res_blocks):
                self.add_module(f"down_res_{idx}", ResBlock(ch_prev, ch, emb_dim, dt))
                if ds in cfg.attention_resolutions:
                    self.add_module(f"down_attn_{idx}", transformer(ch))
                skips.append(ch)
                ch_prev, idx = ch, idx + 1
            if level != levels - 1:
                self.add_module(f"down_sample_{level}", Downsample(ch, dt))
                skips.append(ch)
                ds *= 2

        ch = mc * cfg.channel_mult[-1]
        self.mid_res_0 = ResBlock(ch_prev, ch, emb_dim, dt)
        self.mid_attn = transformer(ch)
        self.mid_res_1 = ResBlock(ch, ch, emb_dim, dt)
        ch_prev, idx = ch, 0
        for level, mult in reversed(list(enumerate(cfg.channel_mult))):
            ch = mc * mult
            for i in range(cfg.num_res_blocks + 1):
                self.add_module(f"up_res_{idx}",
                                ResBlock(ch_prev + skips.pop(), ch, emb_dim, dt))
                if ds in cfg.attention_resolutions:
                    self.add_module(f"up_attn_{idx}", transformer(ch))
                if level > 0 and i == cfg.num_res_blocks:
                    self.add_module(f"up_sample_{level}", Upsample(ch, dt))
                    ds //= 2
                ch_prev, idx = ch, idx + 1
        self.out_norm = GroupNorm32(mc)
        self.out_conv = Conv(mc, cfg.out_channels, 3, padding=1, dtype=dt)

    def zero_init_modules(self):
        """Names of the convolutions the JAX UNet zero-initializes: every
        ResBlock's out_conv, every SpatialTransformer's proj_out and the
        final out_conv (`models/layers.py:254,285`, `unet.py:134` there)."""
        names = ["out_conv"]
        for name, m in self.named_modules():
            if isinstance(m, ResBlock):
                names.append(f"{name}.out_conv")
            elif isinstance(m, SpatialTransformer):
                names.append(f"{name}.proj_out")
        return names

    def forward(self, x: torch.Tensor, timesteps: torch.Tensor,
                context: Optional[torch.Tensor] = None,
                control: Optional[SpatialControl] = None) -> torch.Tensor:
        """x [B, H, W, C] latents (B = 2·prompts under CFG), timesteps [B],
        context [B, L, D] (None for the unconditional UNet) -> eps
        [B, H, W, C] float32."""
        cfg, dt = self.cfg, self.dtype
        if self.conditional != (context is not None):
            raise ValueError(f"a {'' if self.conditional else 'un'}conditional UNet "
                             f"{'needs a context' if self.conditional else 'takes no context'}")
        h = x.to(dt).permute(0, 3, 1, 2)
        if context is not None:
            context = context.to(dt)
        emb = timestep_embedding(timesteps, cfg.model_channels).to(dt)
        emb = self.time_embed_2(F.silu(self.time_embed_0(emb)))

        def sub(name):
            return getattr(self, name, None)

        h = self.in_conv(h)
        hs = [h]
        idx, levels = 0, len(cfg.channel_mult)
        for level in range(levels):
            for _ in range(cfg.num_res_blocks):
                h = sub(f"down_res_{idx}")(h, emb)
                if sub(f"down_attn_{idx}") is not None:
                    h = sub(f"down_attn_{idx}")(h, context, control)
                hs.append(h)
                idx += 1
            if level != levels - 1:
                h = sub(f"down_sample_{level}")(h)
                hs.append(h)

        h = self.mid_res_0(h, emb)
        h = self.mid_attn(h, context, control)
        h = self.mid_res_1(h, emb)

        idx = 0
        for level in reversed(range(levels)):
            for i in range(cfg.num_res_blocks + 1):
                h = torch.cat([h, hs.pop()], dim=1)
                h = sub(f"up_res_{idx}")(h, emb)
                if sub(f"up_attn_{idx}") is not None:
                    h = sub(f"up_attn_{idx}")(h, context, control)
                if sub(f"up_sample_{level}") is not None and i == cfg.num_res_blocks:
                    h = sub(f"up_sample_{level}")(h)
                idx += 1

        h = self.out_conv(F.silu(self.out_norm(h)))
        return h.permute(0, 2, 3, 1).to(torch.float32)
