"""CLIP text and vision transformers, port of the JAX package's
`models/clip.py`.

Two uses, as in the reference:
  * `CLIPTextTower` (ViT-L/14 defaults) is the SD conditioning encoder;
  * `CLIP` (ViT-B/32 defaults) is the dual-tower model behind the DCLIP
    fidelity loss (`pipeline/losses.py`).

OpenAI-CLIP numerics: quick-GELU, LayerNorm eps 1e-5 in float32, causal
mask on the text tower, EOT pooling at the argmax of the token ids,
bias-free patch embedding and projection heads, float32 outputs.  The
attention here is plain PyTorch, as in the JAX package (no kernel).

Tensor parallelism (JAX `clip.py:67,74` pins the heads on 'model'):
`parallel/sharding.shard_params` slices `q/k/v_proj` and `fc1` to this
rank's heads and hidden features and `out_proj` / `fc2` to the matching
input columns, and sets `model_split`; the layer then takes its input
through `copy_to_model` and sums its row-parallel product over the model
ranks before the bias (`parallel/tensor.py`).
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import CLIPConfig, CLIPTextConfig, CLIPVisionConfig
from ..parallel.tensor import copy_to_model
from .layers import Conv, Dense, LayerNorm32, row_parallel
from .unet import torch_dtype


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPMLP(nn.Module):
    def __init__(self, width: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(width, width * 4, dtype=dtype)
        self.fc2 = Dense(width * 4, width, dtype=dtype)
        self.model_split = None

    def forward(self, x):
        split = self.model_split
        if split is None:
            return self.fc2(quick_gelu(self.fc1(x)))
        return row_parallel(self.fc2, quick_gelu(self.fc1(copy_to_model(x, split))), split)


class CLIPAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.q_proj = Dense(width, width, dtype=dtype)
        self.k_proj = Dense(width, width, dtype=dtype)
        self.v_proj = Dense(width, width, dtype=dtype)
        self.out_proj = Dense(width, width, dtype=dtype)
        self.width, self.heads = width, heads
        self.model_split = None

    def forward(self, x, mask=None):
        B, L, _ = x.shape
        dh = self.width // self.heads
        split = self.model_split
        heads = self.heads if split is None else self.heads // split.size
        if split is not None:
            x = copy_to_model(x, split)
        q = self.q_proj(x).reshape(B, L, heads, dh)
        k = self.k_proj(x).reshape(B, L, heads, dh)
        v = self.v_proj(x).reshape(B, L, heads, dh)
        sim = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
        if mask is not None:
            sim = sim + mask
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", attn.float(), v.float())
        out = out.reshape(B, L, heads * dh).to(x.dtype)
        return self.out_proj(out) if split is None else row_parallel(self.out_proj, out, split)


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


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        dt = self.dtype = torch_dtype(cfg.dtype)
        n = (cfg.image_size // cfg.patch_size) ** 2
        self.patch_embedding = Conv(3, cfg.width, cfg.patch_size, stride=cfg.patch_size,
                                    dtype=dt, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.position_embedding = nn.Parameter(torch.zeros(n + 1, cfg.width))
        self.ln_pre = LayerNorm32(cfg.width)
        for i in range(cfg.layers):
            self.add_module(f"layer_{i}", CLIPEncoderLayer(cfg.width, cfg.heads, dt))
        self.ln_post = LayerNorm32(cfg.width)

    def forward(self, pixels: torch.Tensor):
        """pixels [B, H, W, 3] -> pooled pre-projection features [B, W], float32.
        VALID patches (the conv has no padding), class token first."""
        B, W = pixels.shape[0], self.cfg.width
        patches = self.patch_embedding(pixels.to(self.dtype).permute(0, 3, 1, 2))
        patches = patches.permute(0, 2, 3, 1).reshape(B, -1, W)
        cls = self.class_embedding.to(self.dtype).expand(B, 1, W)
        x = torch.cat([cls, patches], dim=1) + self.position_embedding[None].to(self.dtype)
        x = self.ln_pre(x)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer_{i}")(x)
        return self.ln_post(x[:, 0]).to(torch.float32)


class CLIP(nn.Module):
    """Dual-tower CLIP with bias-free projection heads (ViT-B/32 defaults)."""

    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = CLIPVisionTower(cfg.vision)
        self.text = CLIPTextTower(cfg.text)
        self.visual_projection = Dense(cfg.vision.width, cfg.projection_dim, bias=False)
        self.text_projection = Dense(cfg.text.width, cfg.projection_dim, bias=False)

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.visual_projection(self.vision(pixels))

    def encode_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        """EOT-pooled text features, projected."""
        return self.text_projection(self.text(token_ids)[1])

    def forward(self, pixels, token_ids):
        return self.encode_image(pixels), self.encode_text(token_ids)


# CLIP image preprocessing constants (OpenAI)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def clip_normalize(images: torch.Tensor) -> torch.Tensor:
    """images in [0, 1], [..., H, W, 3] -> CLIP-normalized."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=images.device)
    return (images - mean) / std


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=eps)
    b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=eps)
    return (a * b).sum(dim=-1)
