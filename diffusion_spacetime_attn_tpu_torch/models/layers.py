"""Shared building blocks, port of the JAX package's `models/layers.py`.

Numerics rules kept from the JAX package: normalizations and softmax in
float32, matmuls and convolutions in the configured compute dtype.
Parameters are created in float32; `cast_matmul_weights` converts the
weights of every `Dense` / `Conv` to its compute dtype once, which is what
the JAX modules do at each use.  Modules carry the JAX module names, so the
weight bridge (`utils/weights.py`) maps parameter paths one to one.

Convolutions run NCHW inside; the token flatten order of the transformer is
H·W row-major, as in the JAX package, so the circular masks line up.

Tensor parallelism (the mesh's model axis; JAX's `constrain` pins, which
keep the heads on 'model'): `parallel/sharding.shard_params` slices the
attention's q/k/v and output projections to this rank's heads and GEGLU's
`proj_in` / `proj_out` to its hidden features, and sets the module's
`model_split`.  `CrossAttention` and `GEGLUFeedForward` then compute their
share: `copy_to_model` on each input they take whole (the normed
activations, the text and local contexts, `coef`), the kernels on the
rank's heads or features, `reduce_from_model` after the row-parallel
product, and the output bias (GEGLU's b2 and residual too) once, after it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import SpatialControl, attention, spacetime_cross_attention
from ..ops.cuda_geglu import geglu_ff
from ..parallel.tensor import copy_to_model, reduce_from_model


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding, cos first."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class Dense(nn.Linear):
    """Linear layer computing in `compute_dtype` (flax `nn.Dense(dtype=...)`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Conv2d):
    """NCHW convolution computing in `compute_dtype`."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype: torch.dtype = torch.float32, bias: bool = True):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=padding, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride, self.padding)


def row_parallel(lin: Dense, x, split):
    """`lin(x)` where lin holds this rank's input features of the model
    axis (`split`): the partial products summed over the ranks, then the
    bias once."""
    dt = lin.compute_dtype
    y = reduce_from_model(F.linear(x.to(dt), lin.weight.to(dt)), split)
    return y + lin.bias.to(dt)


def cast_matmul_weights(model: nn.Module) -> nn.Module:
    """Convert every Dense / Conv weight and bias to its compute dtype in
    place (norm parameters and embeddings stay float32)."""
    for m in model.modules():
        if isinstance(m, (Dense, Conv)):
            for p in m.parameters(recurse=False):
                p.data = p.data.to(m.compute_dtype)
    return model


class GroupNorm32(nn.GroupNorm):
    """GroupNorm(32) computed in float32, cast back to the input dtype."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__(32, channels, eps=eps)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class LayerNorm32(nn.LayerNorm):
    """LayerNorm computed in float32, cast back to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP: proj to 2×(4·dim), gate with exact-erf gelu, project back.
    fused=True routes through the CUDA GEGLU kernel's wrapper.  Under
    `model_split` (`proj_in` holding this rank's [h_m | g_m]) the kernel
    gets a zero b2 and no residual: one launch per call, its partial output
    summed over the model ranks, then b2 and the residual added on every
    rank."""

    def __init__(self, dim: int, mult: int = 4, dtype=torch.float32,
                 fused: bool = False):
        super().__init__()
        inner = dim * mult
        self.proj_in = Dense(dim, inner * 2, dtype=dtype)
        self.proj_out = Dense(inner, dim, dtype=dtype)
        self.dtype, self.fused = dtype, fused
        self.model_split = None

    def forward(self, x, residual=None):
        dt = self.dtype
        w1, b1 = self.proj_in.weight.to(dt), self.proj_in.bias.to(dt)
        w2, b2 = self.proj_out.weight.to(dt), self.proj_out.bias.to(dt)
        split = self.model_split
        if split is not None:
            x = copy_to_model(x, split).to(dt)
            if self.fused:
                part = geglu_ff(x, w1, b1, w2, torch.zeros_like(b2), None)
            else:
                h, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
                part = F.linear(h * F.gelu(gate), w2)
            out = reduce_from_model(part, split) + b2
            return out if residual is None else out + residual.to(dt)
        if self.fused:
            res = None if residual is None else residual.to(dt)
            return geglu_ff(x.to(dt), w1, b1, w2, b2, res)
        h, gate = F.linear(x.to(dt), w1, b1).chunk(2, dim=-1)
        out = F.linear(h * F.gelu(gate), w2, b2)
        return out if residual is None else out + residual


class CrossAttention(nn.Module):
    """QKV projections + attention; no bias on q/k/v, bias on out."""

    def __init__(self, query_dim: int, context_dim: Optional[int] = None,
                 heads: int = 8, dtype=torch.float32, flash: bool = False,
                 mha: bool = False, fused_control: bool = False, q_chunk: int = 0,
                 scores_dtype=None):
        super().__init__()
        inner = query_dim
        cdim = query_dim if context_dim is None else context_dim
        self.to_q = Dense(query_dim, inner, bias=False, dtype=dtype)
        self.to_k = Dense(cdim, inner, bias=False, dtype=dtype)
        self.to_v = Dense(cdim, inner, bias=False, dtype=dtype)
        self.to_out = Dense(inner, query_dim, dtype=dtype)
        self.heads, self.flash, self.mha = heads, flash, mha
        self.fused_control = fused_control
        self.q_chunk, self.scores_dtype = q_chunk, scores_dtype
        self.model_split = None

    def _local_heads(self) -> int:
        split = self.model_split
        return self.heads if split is None else self.heads // split.size

    def _whole(self, t):
        """An input every model rank holds whole: its cotangent is summed
        over the model ranks."""
        split = self.model_split
        return t if split is None or t is None else copy_to_model(t, split)

    def _out(self, o):
        split = self.model_split
        return self.to_out(o) if split is None else row_parallel(self.to_out, o, split)

    def forward(self, x, context=None):
        x = self._whole(x)
        context = x if context is None else self._whole(context)
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        return self._out(attention(q, k, v, self._local_heads(), flash=self.flash,
                                   mha=self.mha, q_chunk=self.q_chunk,
                                   scores_dtype=self.scores_dtype))

    def controlled(self, x, context, control: Optional[SpatialControl], radius: float):
        """Cross-attention with the spatial blend on the cond rows."""
        x, context = self._whole(x), self._whole(context)
        if control is not None and self.model_split is not None:
            control = control._replace(local_contexts=self._whole(control.local_contexts),
                                       coef=self._whole(control.coef))
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        local_kv = None
        if control is not None:
            local_kv = (self.to_k(control.local_contexts),
                        self.to_v(control.local_contexts))
        out = spacetime_cross_attention(q, (k, v), local_kv, control, self._local_heads(),
                                        radius, fused=self.fused_control)
        return self._out(out)


class BasicTransformerBlock(nn.Module):
    """Self-attn -> controlled cross-attn -> GEGLU FF, pre-LN residuals.

    `context_dim=None` builds the unconditional block (the reference's
    unconditional LDM configs): `attn2` is a second self-attention with
    dim -> dim projections, routed flash ▸ mha ▸ q_chunk ▸ plain by the same
    flags and knobs as `attn1` (JAX `models/layers.py:193-214`); the knobs
    reach self-attention only.  A block built one way raises when called the
    other way."""

    def __init__(self, dim: int, heads: int, context_dim: Optional[int], radius: float = 0.2,
                 dtype=torch.float32, flash: bool = False, mha: bool = False,
                 fused_control: bool = False, fused_ff: bool = False, q_chunk: int = 0,
                 scores_dtype=None):
        super().__init__()
        self.conditional = context_dim is not None
        self_attn = dict(heads=heads, dtype=dtype, flash=flash, mha=mha, q_chunk=q_chunk,
                         scores_dtype=scores_dtype)
        self.attn1 = CrossAttention(dim, **self_attn)
        if self.conditional:
            self.attn2 = CrossAttention(dim, context_dim=context_dim, heads=heads,
                                        dtype=dtype, fused_control=fused_control)
        else:
            self.attn2 = CrossAttention(dim, **self_attn)
        self.norm1, self.norm2, self.norm3 = (LayerNorm32(dim) for _ in range(3))
        self.ff = GEGLUFeedForward(dim, dtype=dtype, fused=fused_ff)
        self.radius = radius

    def forward(self, x, context=None, control: Optional[SpatialControl] = None):
        if self.conditional != (context is not None):
            raise ValueError("a conditional block needs a context and an unconditional "
                             "one takes none")
        x = self.attn1(self.norm1(x)) + x
        if self.conditional:
            x = self.attn2.controlled(self.norm2(x), context, control, self.radius) + x
        else:
            x = self.attn2(self.norm2(x)) + x
        return self.ff(self.norm3(x), residual=x)


class SpatialTransformer(nn.Module):
    """GroupNorm -> 1×1 proj_in -> transformer blocks over H·W tokens ->
    1×1 proj_out, residual.  x: [B, C, H, W]; `context_dim=None`: the
    unconditional blocks."""

    def __init__(self, channels: int, heads: int, context_dim: Optional[int], depth: int = 1,
                 radius: float = 0.2, dtype=torch.float32, flash: bool = False,
                 mha: bool = False, fused_control: bool = False, fused_ff: bool = False,
                 q_chunk: int = 0, scores_dtype=None):
        super().__init__()
        self.norm = GroupNorm32(channels, eps=1e-6)
        self.proj_in = Conv(channels, channels, 1, dtype=dtype)
        self.depth = depth
        for d in range(depth):
            self.add_module(f"block_{d}", BasicTransformerBlock(
                channels, heads, context_dim, radius=radius, dtype=dtype, flash=flash,
                mha=mha, fused_control=fused_control, fused_ff=fused_ff, q_chunk=q_chunk,
                scores_dtype=scores_dtype))
        self.proj_out = Conv(channels, channels, 1, dtype=dtype)

    def forward(self, x, context=None, control=None):
        B, C, H, W = x.shape
        h = self.proj_in(self.norm(x))
        h = h.permute(0, 2, 3, 1).reshape(B, H * W, C)
        for d in range(self.depth):
            h = getattr(self, f"block_{d}")(h, context, control)
        h = h.reshape(B, H, W, C).permute(0, 3, 1, 2)
        return x + self.proj_out(h)


class ResBlock(nn.Module):
    """UNet residual block with timestep-embedding injection."""

    def __init__(self, in_ch: int, out_ch: int, emb_dim: int, dtype=torch.float32):
        super().__init__()
        self.in_norm = GroupNorm32(in_ch)
        self.in_conv = Conv(in_ch, out_ch, 3, padding=1, dtype=dtype)
        self.emb_proj = Dense(emb_dim, out_ch, dtype=dtype)
        self.out_norm = GroupNorm32(out_ch)
        self.out_conv = Conv(out_ch, out_ch, 3, padding=1, dtype=dtype)
        self.skip = Conv(in_ch, out_ch, 1, dtype=dtype) if in_ch != out_ch else None

    def forward(self, x, emb):
        h = self.in_conv(F.silu(self.in_norm(x)))
        h = h + self.emb_proj(F.silu(emb))[:, :, None, None]
        h = self.out_conv(F.silu(self.out_norm(h)))
        if self.skip is not None:
            x = self.skip(x)
        return x + h


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        # torch Conv2d(stride=2, padding=1): pads (1,1) like the JAX module
        self.conv = Conv(channels, channels, 3, stride=2, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32):
        super().__init__()
        self.conv = Conv(channels, channels, 3, padding=1, dtype=dtype)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))
