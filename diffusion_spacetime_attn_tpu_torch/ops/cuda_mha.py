"""Self-attention forward on the CUDA kernel `csrc/mha_fwd.cu`.

Replaces the JAX package's Pallas TPU kernel `ops/pallas_mha.py:_mha_kernel`
(public `mha_attention`).  On the H100 the op is bound by operations at SD
level 0 and 1 (4·L²·dh FLOPs per head) and by memory at the short level-2
and mid sequences.  The TPU kernel held a whole score row per query in
VMEM; an SM cannot, so the CUDA kernel runs an online softmax over 64-key
tiles and keeps every score on chip: bfloat16 on the tensor cores
(`mma.sync`), float32 on the CUDA cores.  The JAX envelope `mha_ok`
was measured on a TPU and is not carried over: every call on a CUDA tensor
goes through the kernel.

`mha_attention` is a `torch.autograd.Function`.  Its forward takes the plain
version (`ops.attention.attention`) for CPU tensors only; for a CUDA tensor
it launches the kernel or raises.  Its backward is plain PyTorch on every
device, with the numerics of the JAX package's `_mha_bh_bwd`
(`pallas_mha.py:151-165`), which JAX too computes outside any kernel; it
works on a few (batch, head) slices at a time so that its f32 [L, L]
intermediates stay small.
"""
from __future__ import annotations

import torch

from . import cuda_lib

DH_MAX = 160


def mha_attention_plain(q, k, v, num_heads: int, *, out_dtype=None):
    """The plain PyTorch version: f32 scores and softmax, p rounded to V's
    dtype, f32 accumulation, output in q's dtype."""
    from .attention import attention

    return attention(q, k, v, num_heads, out_dtype=out_dtype)


def mha_cost(B: int, Lq: int, Lk: int, inner: int, itemsize: int):
    """(FLOPs, bytes) of one call: two products of 2·Lq·Lk·dh per head;
    q, k, v read once and out written once."""
    flops = 4 * B * Lq * Lk * inner
    nbytes = itemsize * (2 * B * Lq * inner + 2 * B * Lk * inner)
    return flops, nbytes


# f32 bytes of one [slices, Lq, Lk] intermediate of the plain backward (and
# of the plain flash versions, `cuda_flash.py`)
BWD_CHUNK_BYTES = 1 << 28


def mha_bwd_plain(q, k, v, g, num_heads: int):
    """(dq, dk, dv) of softmax attention for the output cotangent g, with the
    numerics of `_mha_bh_bwd`: p recomputed in f32, rounded to V's dtype for
    dv; ds rounded to q's dtype; f32 products; each cotangent in its
    input's dtype."""
    B, Lq, inner = q.shape
    Lk = k.shape[1]
    dh = inner // num_heads
    scale = dh ** -0.5

    def fold(t, L):  # [B, L, H*dh] -> [B*H, L, dh]
        return t.reshape(B, L, num_heads, dh).transpose(1, 2).reshape(B * num_heads, L, dh)

    qf, kf, vf, gf = fold(q, Lq), fold(k, Lk), fold(v, Lk), fold(g, Lq)
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (qf, kf, vf))
    step = max(1, BWD_CHUNK_BYTES // (4 * Lq * Lk))
    for i in range(0, B * num_heads, step):
        sl = slice(i, i + step)
        qs, ks, vs, gs = qf[sl].float(), kf[sl].float(), vf[sl].float(), gf[sl].float()
        p = torch.softmax((qs @ ks.transpose(1, 2)) * scale, dim=-1)
        dv[sl] = (p.to(v.dtype).float().transpose(1, 2) @ gs).to(v.dtype)
        dp = gs @ vs.transpose(1, 2)
        ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True)) * scale).to(q.dtype).float()
        dq[sl] = (ds @ ks).to(q.dtype)
        dk[sl] = (ds.transpose(1, 2) @ qs).to(k.dtype)

    def unfold(t, L):
        return t.reshape(B, num_heads, L, dh).transpose(1, 2).reshape(B, L, inner)

    return unfold(dq, Lq), unfold(dk, Lk), unfold(dv, Lk)


def _forward(q, k, v, num_heads):
    """The forward kernel on CUDA tensors; counts a launch of `mha_attention`."""
    cuda_lib.require_cuda("mha_attention", q, k, v)
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"mha_attention: bad shapes {q.shape} {k.shape} {v.shape}")
    B, Lq, inner = q.shape
    if k.shape[0] != B or k.shape[2] != inner or inner % num_heads:
        raise ValueError(f"mha_attention: bad shapes {q.shape} {k.shape} heads={num_heads}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("mha_attention: q, k, v must share one dtype")
    dh = inner // num_heads
    if dh > DH_MAX:
        raise ValueError(f"mha_attention: head width {dh} > {DH_MAX}")
    out = torch.empty_like(q)
    rc = cuda_lib.library().dsta_mha_fwd(
        cuda_lib.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Lq, k.shape[1], num_heads, dh, dh ** -0.5,
        cuda_lib.stream_ptr(q))
    cuda_lib.check(rc, "dsta_mha_fwd")
    mha_attention.launches += 1
    return out


class _MhaFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        if q.device.type == "cpu":
            out = mha_attention_plain(q, k, v, num_heads)
        elif q.device.type == "cuda":
            out = _forward(q, k, v, num_heads)
        else:
            raise ValueError(f"mha_attention: unsupported device {q.device}")
        ctx.save_for_backward(q, k, v)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        need = ctx.needs_input_grad
        if not any(need[:3]):
            return None, None, None, None
        with torch.profiler.record_function("mha_bwd_plain"):   # read by chip_smoke.py
            dq, dk, dv = mha_bwd_plain(q, k, v, g.contiguous(), ctx.num_heads)
        return (dq if need[0] else None, dk if need[1] else None, dv if need[2] else None, None)


def mha_attention(q, k, v, num_heads: int, *, out_dtype=None):
    """q: [B, Lq, H*dh]; k/v: [B, Lk, H*dh] -> [B, Lq, H*dh] in q's dtype
    (then out_dtype).  Full non-causal softmax per query row.
    Differentiable in q, k and v."""
    out = _MhaFn.apply(q, k, v, num_heads)
    return out if out_dtype is None else out.to(out_dtype)


mha_attention.launches = 0
