"""Fused GEGLU feed-forward on the CUDA kernel `csrc/geglu_fwd.cu`.

Replaces the JAX package's Pallas TPU kernel `ops/pallas_geglu.py:_ff_kernel`
(public `geglu_ff`).  The weights are taken as the port's modules store them
(`nn.Linear` layout: w1 [2·inner, dim], w2 [dim, inner]); the weight bridge
transposes the JAX [in, out] kernels once at load time.  On the H100 the op
is bound by operations at SD levels 0-2 and by its 26 MB of weights at the
mid block.  The kernel keeps the gated [M, inner] intermediate in shared
memory and writes each inner chunk's partial second product to its own f32
slice of a scratch ([chunks, M, dim], allocated here); a second kernel sums
the slices in chunk order, so the result does not change from run to run.
bfloat16 runs on the tensor cores and takes widths that are multiples of 8
and 16-byte aligned tensors only.  The JAX envelope `ff_win` was measured on
a TPU and is not carried over.

`geglu_ff` takes the plain version for CPU tensors only; for a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cuda_lib


def gelu_erf(x):
    return 0.5 * x * (1.0 + torch.erf(x * 2.0 ** -0.5))


def geglu_plain(x, w1, b1, w2, b2, residual=None):
    """The plain PyTorch version (the math of `_xla_ref`,
    `pallas_geglu.py:349-362`): f32 products and gate, u rounded to x's
    dtype, output in x's dtype."""
    inner = w2.shape[1]
    xf = x.float()
    h = F.linear(xf, w1[:inner].float(), b1[:inner].float())
    g = F.linear(xf, w1[inner:].float(), b1[inner:].float())
    u = (h * gelu_erf(g)).to(x.dtype)
    out = F.linear(u.float(), w2.float(), b2.float())
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def geglu_cost(M: int, dim: int, inner: int, itemsize: int, residual: bool = True):
    """(FLOPs, bytes) of one call: 6·M·dim·inner FLOPs; x, the residual,
    the weights and biases read once and out written once."""
    flops = 6 * M * dim * inner
    acts = (3 if residual else 2) * M * dim
    nbytes = itemsize * (acts + 3 * dim * inner + 2 * inner + dim)
    return flops, nbytes


def geglu_ff(x, w1, b1, w2, b2, residual=None):
    """x: [..., dim]; w1: [2·inner, dim]; b1: [2·inner]; w2: [dim, inner];
    b2: [dim]; residual like x or None -> [..., dim] in x's dtype."""
    if x.device.type == "cpu":
        return geglu_plain(x, w1, b1, w2, b2, residual)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_ff: unsupported device {x.device}")
    shape = x.shape
    dim = shape[-1]
    inner = w2.shape[1]
    if (tuple(w1.shape) != (2 * inner, dim) or tuple(b1.shape) != (2 * inner,)
            or tuple(w2.shape) != (dim, inner) or tuple(b2.shape) != (dim,)):
        raise ValueError(f"geglu_ff: bad weight shapes {tuple(w1.shape)} {tuple(b1.shape)} "
                         f"{tuple(w2.shape)} {tuple(b2.shape)} for dim={dim}")
    if residual is not None and residual.shape != shape:
        raise ValueError(f"geglu_ff: residual {tuple(residual.shape)} != {tuple(shape)}")
    tensors = [x, w1, b1, w2, b2] + ([residual] if residual is not None else [])
    for t in tensors:
        if t.dtype != x.dtype:
            raise TypeError("geglu_ff: x, weights, biases and residual must share one dtype")
    cuda_lib.require_cuda("geglu_ff", *tensors)
    code = cuda_lib.dtype_code(x)
    if x.dtype == torch.bfloat16 and (
            dim % 8 or inner % 8 or any(t.data_ptr() % 16 for t in (x, w1, w2))):
        raise ValueError(f"geglu_ff: bfloat16 takes dim and inner multiples of 8 and 16-byte "
                         f"aligned x, w1, w2 (dim={dim}, inner={inner})")
    M = x.numel() // dim
    lib = cuda_lib.library()
    scratch = torch.empty((lib.dsta_geglu_chunks(code, M, inner), M, dim), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    rc = lib.dsta_geglu_fwd(
        code, x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(),
        None if residual is None else residual.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), M, dim, inner, cuda_lib.stream_ptr(x))
    cuda_lib.check(rc, "dsta_geglu_fwd")
    geglu_ff.launches += 1
    return out


geglu_ff.launches = 0
