"""Blended spacetime cross-attention (cond half) on the CUDA kernel
`csrc/spacetime_fwd.cu`.

Replaces the JAX package's Pallas TPU kernel `ops/pallas_spacetime.py:_kernel`
(launched by `_forward`, public `fused_spacetime_attention`), with the same
argument order and layouts.  On the H100 the op is bound by memory: the
kernel reads q and g_u once, keeps the N per-object attention results in
registers and shared memory (the plain version writes a [B, N, Lq, inner]
tensor), and writes the blended rows once.  Contexts are at most 80 keys
(CLIP's 77); keys past the context length are masked to −inf.

`fused_spacetime_attention` takes the plain version for CPU tensors only;
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import cuda_lib

DH_MAX = 160
LK_MAX = 80


def spacetime_plain(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads: int):
    """The plain PyTorch version (the math of `_xla_reference`,
    `pallas_spacetime.py:140-149`)."""
    from .attention import attention, multi_context_attention

    g_c = attention(q_c, kc, vc, num_heads)
    loc = multi_context_attention(q_c, lk, lv, num_heads)      # [B, N, Lq, inner]
    w = masks * coef[..., None]                                 # [B, N, Lq]
    blend = torch.einsum("bnq,bnqi->bqi", w.to(loc.dtype), loc)
    return g_c + blend - w.sum(dim=1)[..., None].to(g_u.dtype) * g_u


def spacetime_cost(B: int, N: int, Lq: int, Lk: int, inner: int, itemsize: int):
    """(FLOPs, bytes) of one call: QK and PV products for N+1 contexts; q,
    g_u, out, the K/V of every context, f32 masks and coef moved once."""
    flops = 4 * B * (N + 1) * Lq * Lk * inner
    nbytes = (itemsize * (3 * B * Lq * inner + 2 * B * (N + 1) * Lk * inner)
              + 4 * (B * N * Lq + B * N))
    return flops, nbytes


def fused_spacetime_attention(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads: int):
    """q_c/g_u: [B, Lq, inner]; kc/vc: [B, Lk, inner]; lk/lv: [B, N, Lk,
    inner]; masks: [B, N, Lq]; coef: [B, N] -> blended cond rows [B, Lq,
    inner] in q_c's dtype."""
    if q_c.device.type == "cpu":
        return spacetime_plain(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads)
    if q_c.device.type != "cuda":
        raise ValueError(f"fused_spacetime_attention: unsupported device {q_c.device}")
    B, Lq, inner = q_c.shape
    N, Lk = lk.shape[1], lk.shape[2]
    want = {"g_u": (g_u, (B, Lq, inner)), "kc": (kc, (B, Lk, inner)),
            "vc": (vc, (B, Lk, inner)), "lk": (lk, (B, N, Lk, inner)),
            "lv": (lv, (B, N, Lk, inner)), "masks": (masks, (B, N, Lq)),
            "coef": (coef, (B, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"fused_spacetime_attention: {name} {tuple(t.shape)} != {shape}")
    for t in (g_u, kc, vc, lk, lv):
        if t.dtype != q_c.dtype:
            raise TypeError("fused_spacetime_attention: q_c, g_u, K and V must share one dtype")
    if inner % num_heads or inner // num_heads > DH_MAX or Lk > LK_MAX:
        raise ValueError(f"fused_spacetime_attention: unsupported inner={inner} "
                         f"heads={num_heads} Lk={Lk}")
    # the TPU kernel reads masks in q's dtype; both kernels read coef in f32
    m = masks.to(q_c.dtype).float().contiguous()
    c = coef.float().contiguous()
    cuda_lib.require_cuda("fused_spacetime_attention", q_c, g_u, kc, vc, lk, lv, m, c)
    dh = inner // num_heads
    out = torch.empty_like(q_c)
    rc = cuda_lib.library().dsta_spacetime_fwd(
        cuda_lib.dtype_code(q_c), q_c.data_ptr(), g_u.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), lk.data_ptr(), lv.data_ptr(), m.data_ptr(), c.data_ptr(),
        out.data_ptr(), B, N, Lq, Lk, num_heads, dh, dh ** -0.5,
        cuda_lib.stream_ptr(q_c))
    cuda_lib.check(rc, "dsta_spacetime_fwd")
    fused_spacetime_attention.launches += 1
    return out


fused_spacetime_attention.launches = 0
