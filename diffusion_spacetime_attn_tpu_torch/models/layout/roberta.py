"""RoBERTa-base encoder with the layout predictor's object-position embedding;
port of the JAX package's `models/layout/roberta.py`.

Reference: `layout_predictor/LayoutTransformer/model/Model.py:533-628`
(fairseq RobertaEncoder) and the `object_embedding` parameter added to the
token embeddings at object positions (`Model.py:72-74,222-227`).

Standard RoBERTa-base: learned positions offset past the pad index
(position = pad_id + cumsum(mask)·mask), embedding LayerNorm, post-LN
layers (residual -> LayerNorm, each LayerNorm in float32, eps 1e-5),
exact-erf GELU.  Attention is a plain matmul and softmax, as the JAX
module's einsums are: masked scores are filled with -1e9 in float32 before
the softmax.  Modules carry the flax names (`token_embedding`, `layer_0`,
`attn.q`, `attn_ln`, `fc1`, ...), so `utils/weights.py` maps a flax tree
one to one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...config import LayoutConfig
from ..layers import Dense, LayerNorm32

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class RobertaSelfAttention(nn.Module):
    def __init__(self, hidden: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.q = Dense(hidden, hidden, dtype=dtype)
        self.k = Dense(hidden, hidden, dtype=dtype)
        self.v = Dense(hidden, hidden, dtype=dtype)
        self.out = Dense(hidden, hidden, dtype=dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        dh = self.hidden // self.heads

        def split(t):
            return t.reshape(B, L, self.heads, dh).transpose(1, 2)   # [B, H, L, dh]

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        sim = torch.matmul(q, k.transpose(-1, -2)).float() * (dh ** -0.5)
        sim = sim.masked_fill(~pad_mask[:, None, None, :], -1e9)
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).float().transpose(1, 2).reshape(B, L, self.hidden)
        return self.out(out.to(x.dtype))


class RobertaLayer(nn.Module):
    """Post-LN transformer layer (fairseq normalize_before=False)."""

    def __init__(self, hidden: int, heads: int, ffn_dim: int, dtype=torch.float32):
        super().__init__()
        self.attn = RobertaSelfAttention(hidden, heads, dtype)
        self.attn_ln = LayerNorm32(hidden, eps=1e-5)
        self.fc1 = Dense(hidden, ffn_dim, dtype=dtype)
        self.fc2 = Dense(ffn_dim, hidden, dtype=dtype)
        self.final_ln = LayerNorm32(hidden, eps=1e-5)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        x = self.attn_ln(x + self.attn(x, pad_mask))
        h = self.fc2(F.gelu(self.fc1(x), approximate="none"))
        return self.final_ln(x + h)


class RobertaBackbone(nn.Module):
    def __init__(self, cfg: LayoutConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = _DTYPES[cfg.dtype]
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden)
        self.position_embedding = nn.Embedding(cfg.max_positions, cfg.hidden)
        self.emb_ln = LayerNorm32(cfg.hidden, eps=1e-5)
        self.object_embedding = nn.Parameter(torch.zeros(1, cfg.hidden))
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", RobertaLayer(cfg.hidden, cfg.heads, cfg.ffn_dim,
                                                       self.dtype))

    def forward(self, token_ids: torch.Tensor,
                object_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        """token_ids [B, L] (pad = cfg.pad_token_id), object_pos [B, L] bool
        or float -> features [B, L, hidden] float32."""
        cfg, dt = self.cfg, self.dtype
        pad = cfg.pad_token_id
        mask = token_ids != pad                                          # [B, L]
        positions = pad + torch.cumsum(mask.to(torch.int64), dim=-1) * mask
        x = (self.token_embedding(token_ids).to(dt)
             + self.position_embedding(positions).to(dt))
        x = self.emb_ln(x)
        if object_pos is not None:
            x = x + self.object_embedding[None].to(dt) * object_pos[..., None].to(dt)
        # zero padded positions (reference `Model.py:231-233`)
        x = x * mask[..., None].to(x.dtype)
        for i in range(cfg.layers):
            x = getattr(self, f"layer_{i}")(x, mask)
        return x.float()
