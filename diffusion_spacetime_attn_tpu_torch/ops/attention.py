"""Attention ops: plain MHA and the spatial-control blended cross-attention.

Port of the JAX package's `ops/attention.py`.  Semantics per prompt, CFG
pair (u, c), N objects, blend weights coef:

    g_u   = attn(q_u, ctx_uncond)
    g_c   = attn(q_c, ctx_cond)
    loc_i = attn(q_c, ctx_local_i)                  (i = 1..N)
    out_u = g_u
    out_c = g_c + Σ_i mask_i ⊙ coef_i · (loc_i − g_u)

applied before the output projection (exact: the per-pixel mask broadcasts
over channels, and the projection bias cancels in loc_i − g_u).

Numerics follow the JAX package: products of the working dtype accumulate in
float32 (the operands are widened, which is exact for bf16), the softmax is
float32, probabilities are rounded to V's dtype before the PV product, and
outputs are cast to q's dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .cuda_flash import flash_attention, flash_ok
from .masks import flat_circular_mask


class SpatialControl(NamedTuple):
    """Per-prompt control state threaded through the UNet."""

    local_contexts: torch.Tensor  # [B, N, L, D] text embeddings of "a photo of <obj>"
    centers: torch.Tensor         # [B, N, 2] (x, y) in [0, 1]
    coef: torch.Tensor            # [B, N] blend weights for this step
    active: torch.Tensor          # [B, N] 1.0 = real object, 0.0 = padding


def attention(q, k, v, num_heads: int, *, out_dtype=None, flash: bool = False,
              mha: bool = False):
    """Softmax attention.  q: [B, Lq, H*Dh], k/v: [B, Lk, H*Dh].

    flash=True routes the shapes that pass `flash_ok` through the CUDA flash
    kernels' wrapper (`ops/cuda_flash.py`, forward and backward).  mha=True
    routes self-attention (Lq == Lk) through the CUDA MHA kernel's wrapper
    (`ops/cuda_mha.py`); flash wins where both apply, as in the JAX package.
    Both wrappers take plain PyTorch versions for CPU tensors.
    """
    B, Lq, inner = q.shape
    Lk = k.shape[-2]
    if flash and flash_ok(Lq, Lk, inner // num_heads):
        return flash_attention(q, k, v, num_heads, out_dtype=out_dtype)
    if mha and Lq == Lk:
        from .cuda_mha import mha_attention

        return mha_attention(q, k, v, num_heads, out_dtype=out_dtype)
    dh = inner // num_heads
    scale = dh ** -0.5
    qh = q.reshape(B, Lq, num_heads, dh).float()
    kh = k.reshape(B, Lk, num_heads, dh).float()
    vh = v.reshape(B, Lk, num_heads, dh)
    sim = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    attn = torch.softmax(sim * scale, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", attn.to(vh.dtype).float(), vh.float())
    return out.reshape(B, Lq, inner).to(out_dtype or q.dtype)


def multi_context_attention(q, k, v, num_heads: int):
    """One query set against S stacked contexts, one softmax per context.
    q: [B, Lq, H*Dh]; k/v: [B, S, Lk, H*Dh] -> [B, S, Lq, H*Dh]."""
    B, Lq, inner = q.shape
    S, Lk = k.shape[1], k.shape[2]
    dh = inner // num_heads
    scale = dh ** -0.5
    qh = q.reshape(B, Lq, num_heads, dh).float()
    kh = k.reshape(B, S, Lk, num_heads, dh).float()
    vh = v.reshape(B, S, Lk, num_heads, dh)
    sim = torch.einsum("bqhd,bskhd->bshqk", qh, kh)
    attn = torch.softmax(sim * scale, dim=-1)
    out = torch.einsum("bshqk,bskhd->bsqhd", attn.to(vh.dtype).float(), vh.float())
    return out.reshape(B, S, Lq, inner).to(q.dtype)


def spacetime_cross_attention(
    q: torch.Tensor,              # [2B, Lq, inner]; rows [0:B] uncond, [B:2B] cond
    context_kv,                   # (k, v) each [2B, L, inner]
    local_kv,                     # (k, v) each [B, N, L, inner] or None
    control: Optional[SpatialControl],
    num_heads: int,
    radius: float,
    fused: bool = False,
):
    """Blended global+local cross-attention (pre-projection).  Returns
    [2B, Lq, inner].  control=None is plain cross-attention.  fused=True
    routes the cond half through the CUDA spacetime kernel's wrapper
    (`ops/cuda_spacetime.py`); g_u stays the plain attention of the uncond
    rows, as in the JAX package."""
    k, v = context_kv
    B = q.shape[0] // 2
    dim = int(round(q.shape[1] ** 0.5))

    if control is not None and fused:
        from .cuda_spacetime import fused_spacetime_attention

        g_u = attention(q[:B], k[:B], v[:B], num_heads)
        lk, lv = local_kv
        m = flat_circular_mask(control.centers, dim, radius, control.active)
        out_c = fused_spacetime_attention(
            q[B:], g_u, k[B:], v[B:], lk, lv, m, control.coef, num_heads)
        return torch.cat([g_u, out_c], dim=0)

    g = attention(q, k, v, num_heads)
    if control is None:
        return g
    lk, lv = local_kv
    loc = multi_context_attention(q[B:], lk, lv, num_heads)  # [B, N, Lq, inner]
    m = flat_circular_mask(control.centers, dim, radius, control.active)
    w = m * control.coef[..., None]                           # [B, N, Lq]
    g_u, g_c = g[:B], g[B:]
    blend = (torch.einsum("bnq,bnqi->bqi", w.to(loc.dtype), loc)
             - w.sum(dim=1)[..., None].to(g_u.dtype) * g_u)
    return torch.cat([g_u, g_c + blend], dim=0)
