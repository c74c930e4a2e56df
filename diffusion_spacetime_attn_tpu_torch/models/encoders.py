"""Stock conditional-LDM encoders beyond the CLIP text tower; port of the JAX
package's `models/encoders.py` (reference `ldm/modules/encoders/modules.py`):

  * `ClassEmbedder` (:21-33): class id -> [B, 1, D] embedding, the
    cross-attention context of class-conditional LDMs (e.g. cin256);
  * `TransformerEmbedder` (:36-49) / `BERTEmbedder` (:80-103): token ids ->
    [B, L, D] hidden states of x-transformers' `TransformerWrapper` (token +
    learned positional embeddings, pre-LN attention / MLP blocks, final
    norm).  Tokenization stays a host-side callable.

Numerics are flax's modules': LayerNorm eps 1e-6 in float32, multi-head
attention with the query scaled by dh^-½ and a float32 softmax, the MLP's
GELU in its tanh form (`nn.gelu`'s default).  Module names follow the flax
tree; the weight bridge (`utils/weights.py`) maps flax's per-head attention
kernels ([dim, heads, dh] and [heads, dh, dim]) onto the Linear layers here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import LayerNorm32


class ClassEmbedder(nn.Module):
    """An embedding lookup returned as [B, 1, D]."""

    def __init__(self, n_classes: int, embed_dim: int = 512):
        super().__init__()
        self.embedding = nn.Embedding(n_classes, embed_dim)

    def forward(self, class_ids: torch.Tensor) -> torch.Tensor:
        return self.embedding(class_ids.long())[:, None, :]


class _Attention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention(qkv_features=dim,
    out_features=dim)` over one sequence (self-attention, no mask)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query, self.key, self.value = (nn.Linear(dim, dim) for _ in range(3))
        self.out = nn.Linear(dim, dim)

    def forward(self, x):
        B, L, D = x.shape
        hd = D // self.heads

        def split(t):
            return t.reshape(B, L, self.heads, hd)

        q = split(self.query(x)) / hd ** 0.5
        k, v = split(self.key(x)), split(self.value(x))
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()), dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()).reshape(B, L, D)
        return self.out(o.to(x.dtype))


class _PreLNEncoder(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int = 8):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"ln1_{i}", LayerNorm32(dim, eps=1e-6))
            self.add_module(f"attn_{i}", _Attention(dim, heads))
            self.add_module(f"ln2_{i}", LayerNorm32(dim, eps=1e-6))
            self.add_module(f"ff1_{i}", nn.Linear(dim, dim * 4))
            self.add_module(f"ff2_{i}", nn.Linear(dim * 4, dim))
        self.ln_out = LayerNorm32(dim, eps=1e-6)

    def forward(self, x):
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"ln1_{i}")(x))
            h = F.gelu(getattr(self, f"ff1_{i}")(getattr(self, f"ln2_{i}")(x)), approximate="tanh")
            x = x + getattr(self, f"ff2_{i}")(h)
        return self.ln_out(x)


class TransformerEmbedder(nn.Module):
    """Token + absolute positional embeddings through `n_layer` pre-LN
    blocks -> [B, L, D] hidden states."""

    def __init__(self, vocab_size: int, max_seq_len: int = 77, n_embed: int = 512,
                 n_layer: int = 12, heads: int = 8):
        super().__init__()
        self.token_emb = nn.Embedding(vocab_size, n_embed)
        self.pos_emb = nn.Parameter(torch.zeros(max_seq_len, n_embed))
        self.encoder = _PreLNEncoder(n_embed, n_layer, heads)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        L = tokens.shape[1]
        return self.encoder(self.token_emb(tokens.long()) + self.pos_emb[None, :L])


class BERTEmbedder(nn.Module):
    """The same wrapper at BERT's defaults (vocabulary 30522, length 77)."""

    def __init__(self, n_embed: int = 1280, n_layer: int = 32, vocab_size: int = 30522,
                 max_seq_len: int = 77, heads: int = 8):
        super().__init__()
        self.transformer = TransformerEmbedder(vocab_size, max_seq_len, n_embed, n_layer, heads)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.transformer(tokens)
