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

`mha_attention` takes the plain version (`ops.attention.attention`) for CPU
tensors only; for a CUDA tensor it launches the kernel or raises.
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


def mha_attention(q, k, v, num_heads: int, *, out_dtype=None):
    """q: [B, Lq, H*dh]; k/v: [B, Lk, H*dh] -> [B, Lq, H*dh] in q's dtype
    (then out_dtype).  Full non-causal softmax per query row."""
    if q.device.type == "cpu":
        return mha_attention_plain(q, k, v, num_heads, out_dtype=out_dtype)
    if q.device.type != "cuda":
        raise ValueError(f"mha_attention: unsupported device {q.device}")
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
    return out if out_dtype is None else out.to(out_dtype)


mha_attention.launches = 0
