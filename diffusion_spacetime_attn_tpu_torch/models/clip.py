"""CLIP text tower (the SD conditioning encoder), port of the JAX package's
`models/clip.py:CLIPTextTower`.

OpenAI-CLIP numerics: quick-GELU, LayerNorm eps 1e-5 in float32, causal
mask, EOT pooling at the argmax of the token ids, float32 outputs.  The
attention here is plain PyTorch, as in the JAX package (no kernel).
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import CLIPTextConfig
from .layers import Dense, LayerNorm32
from .unet import torch_dtype


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(width, width * 4, dtype=dtype)
        self.fc2 = Dense(width * 4, width, dtype=dtype)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.q_proj = Dense(width, width, dtype=dtype)
        self.k_proj = Dense(width, width, dtype=dtype)
        self.v_proj = Dense(width, width, dtype=dtype)
        self.out_proj = Dense(width, width, dtype=dtype)
        self.width, self.heads = width, heads

    def forward(self, x, mask=None):
        B, L, _ = x.shape
        dh = self.width // self.heads
        q = self.q_proj(x).reshape(B, L, self.heads, dh)
        k = self.k_proj(x).reshape(B, L, self.heads, dh)
        v = self.v_proj(x).reshape(B, L, self.heads, dh)
        sim = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
        if mask is not None:
            sim = sim + mask
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
        return self.out_proj(out.reshape(B, L, self.width).to(x.dtype))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.ln1 = LayerNorm32(width)
        self.attn = CLIPAttention(width, heads, dtype)
        self.ln2 = LayerNorm32(width)
        self.mlp = CLIPMLP(width, dtype)

    def forward(self, x, mask=None):
        x = x + self.attn(self.ln1(x), mask)
        return x + self.mlp(self.ln2(x))


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        dt = self.dtype = torch_dtype(cfg.dtype)
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.position_embedding = nn.Parameter(torch.zeros(cfg.max_len, cfg.width))
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", CLIPEncoderLayer(cfg.width, cfg.heads, dt))
        self.ln_final = LayerNorm32(cfg.width)

    def forward(self, token_ids: torch.Tensor):
        """token_ids [B, L] -> (last_hidden [B, L, W], pooled [B, W]), float32."""
        B, L = token_ids.shape
        x = (self.token_embedding(token_ids.long()).to(self.dtype)
             + self.position_embedding[None, :L].to(self.dtype))
        causal = torch.full((L, L), float("-inf"), device=x.device).triu(1)[None, None]
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x, causal)
        x = self.ln_final(x)
        eot = token_ids.long().argmax(dim=-1)
        pooled = x[torch.arange(B, device=x.device), eot]
        return x.to(torch.float32), pooled.to(torch.float32)
