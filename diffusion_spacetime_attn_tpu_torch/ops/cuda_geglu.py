"""Fused GEGLU feed-forward on the CUDA kernels `csrc/geglu_fwd.cu` (forward)
and `csrc/geglu_bwd.cu` (dx).

Replaces the JAX package's Pallas TPU kernels `ops/pallas_geglu.py:_ff_kernel`
and `_ff_bwd_kernel` (public `geglu_ff`).  The weights are taken as the port's
modules store them (`nn.Linear` layout: w1 [2·inner, dim], w2 [dim, inner]);
the weight bridge transposes the JAX [in, out] kernels once at load time.  On
the H100 the op is bound by operations at SD levels 0-2 and by its 26 MB of
weights at the mid block.  Every call on a CUDA tensor goes through a kernel,
in the design `geglu_design` picks from the dtype before launch (no fallback
after a failed launch):

- "wgmma" (bf16; dim and inner multiples of 8, 16-byte aligned operands;
  every SD v1-4 site): two persistent wgmma GEMMs fed by TMA rings per call.
  The forward writes the gated u [M, inner] as bf16 (it is rounded there in
  every version) and multiplies it by W2; the dx writes [dh | dg]
  [M, 2·inner] as bf16 and multiplies it by W1.  The wrapper allocates that
  intermediate; no f32 scratch.  Other bf16 inputs raise.
- "simt" (float32): on the CUDA cores, each (row tile, inner chunk) block
  writes its partial second product to its own f32 slice of a scratch
  ([chunks, M, dim], allocated here), and a second kernel sums the slices
  in chunk order.

No design uses atomics, so the result does not change from run to run.
`geglu_ff.launches_by_design` and `geglu_dx.launches_by_design` count
launches per design.  The JAX envelope `ff_win` was measured on a TPU and is
not carried over.

`geglu_ff` is a `torch.autograd.Function`: on a CPU tensor it runs the
plain versions (`geglu_plain`, `geglu_dx_plain`), on a CUDA tensor it
launches the kernels or raises.  dx is the kernel `geglu_dx` (which counts
its own launches); the residual's cotangent is dy itself; dW and db are plain
products, computed only when asked for (the chain's weights are frozen, as
XLA prunes them in `pallas_geglu.py:365-394`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import cuda_lib

DESIGNS = ("wgmma", "simt")


def geglu_design(dtype, dim: int, inner: int, aligned: bool = True) -> str:
    """The kernel design that takes a GEGLU forward or dx: "wgmma" for bf16
    at widths that are multiples of 8 with 16-byte aligned operands (what TMA
    can describe), "simt" for float32.  Other bf16 inputs raise ValueError:
    no kernel takes them."""
    if dtype != torch.bfloat16:
        return "simt"
    if dim % 8 or inner % 8 or not aligned:
        raise ValueError(f"bfloat16 GEGLU takes dim and inner multiples of 8 and 16-byte "
                         f"aligned tensors (dim={dim}, inner={inner}, aligned={aligned})")
    return "wgmma"


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


def _h_g(x, w1, b1, inner):
    """Recomputed f32 h and g (`_xla_dx`, `pallas_geglu.py:294-310`)."""
    xf = x.float()
    h = F.linear(xf, w1[:inner].float(), b1[:inner].float())
    g = F.linear(xf, w1[inner:].float(), b1[inner:].float())
    return h, g


def _dh_dg(h, g, du):
    """du·gelu(g) and du·h·gelu′(g) in f32, with native erf."""
    c = 0.5 * (1.0 + torch.erf(g * 2.0 ** -0.5))
    phi = torch.exp(-0.5 * g * g) * (2.0 * math.pi) ** -0.5
    return du * (g * c), du * (h * (c + g * phi))


def geglu_dx_plain(x, w1, b1, w2, dy):
    """The plain dx (the math of `_xla_dx`, `pallas_geglu.py:294-310`): f32
    products, dh and dg rounded to x's dtype, dx in x's dtype."""
    inner = w2.shape[1]
    h, g = _h_g(x, w1, b1, inner)
    dh, dg = _dh_dg(h, g, dy.float() @ w2.float())
    dh, dg = dh.to(x.dtype).float(), dg.to(x.dtype).float()
    return (dh @ w1[:inner].float() + dg @ w1[inner:].float()).to(x.dtype)


def geglu_cost(M: int, dim: int, inner: int, itemsize: int, residual: bool = True):
    """(FLOPs, bytes) of one call: 6·M·dim·inner FLOPs; x, the residual,
    the weights and biases read once and out written once."""
    flops = 6 * M * dim * inner
    acts = (3 if residual else 2) * M * dim
    nbytes = itemsize * (acts + 3 * dim * inner + 2 * inner + dim)
    return flops, nbytes


def geglu_dx_cost(M: int, dim: int, inner: int, itemsize: int):
    """(FLOPs, bytes) of one dx call: 10·M·dim·inner FLOPs (h, g, du, and
    the two products into dx; `pallas_geglu.py:342`); x, dy, W1, b1 and W2
    read once and dx written once."""
    flops = 10 * M * dim * inner
    nbytes = itemsize * (3 * M * dim + 3 * dim * inner + 2 * inner)
    return flops, nbytes


def _check(name, x, w1, b1, w2, tensors, operands):
    """Raise unless the kernels take these inputs (`operands`: those TMA
    reads); returns (M, dim, inner, design)."""
    dim = x.shape[-1]
    inner = w2.shape[1]
    if (tuple(w1.shape) != (2 * inner, dim) or tuple(b1.shape) != (2 * inner,)
            or w2.shape[0] != dim):
        raise ValueError(f"{name}: bad weight shapes {tuple(w1.shape)} {tuple(b1.shape)} "
                         f"{tuple(w2.shape)} for dim={dim}")
    for t in tensors:
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: x, weights, biases, residual and dy must share one dtype")
    cuda_lib.require_cuda(name, *tensors)
    try:
        design = geglu_design(x.dtype, dim, inner, all(t.data_ptr() % 16 == 0 for t in operands))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return x.numel() // dim, dim, inner, design


def out_tile_width(M: int, dim: int) -> int:
    """The output columns per tile (160 or 64) of the wgmma design's
    products into [M, dim] on the current card, as the kernels pick it."""
    return cuda_lib.library().dsta_geglu_out_width(M, dim)


def _scratch(design, M, dim, inner, cols, device):
    """The wgmma design's bf16 intermediate [M, cols], or the simt design's
    f32 slices [chunks, M, dim]."""
    if design == "wgmma":
        return torch.empty((M, cols), dtype=torch.bfloat16, device=device)
    chunks = cuda_lib.library().dsta_geglu_chunks(0, M, inner)
    return torch.empty((chunks, M, dim), dtype=torch.float32, device=device)


def _forward(x, w1, b1, w2, b2, residual):
    """The forward kernel on CUDA tensors; counts a launch of `geglu_ff`."""
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"geglu_ff: residual {tuple(residual.shape)} != {tuple(x.shape)}")
    if tuple(b2.shape) != (x.shape[-1],):
        raise ValueError(f"geglu_ff: b2 {tuple(b2.shape)} for dim={x.shape[-1]}")
    tensors = [x, w1, b1, w2, b2] + ([residual] if residual is not None else [])
    M, dim, inner, design = _check("geglu_ff", x, w1, b1, w2, tensors, (x, w1, w2))
    scratch = _scratch(design, M, dim, inner, inner, x.device)
    out = torch.empty_like(x)
    rc = cuda_lib.library().dsta_geglu_fwd(
        cuda_lib.dtype_code(x), x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        b2.data_ptr(), None if residual is None else residual.data_ptr(),
        scratch.data_ptr(), out.data_ptr(), M, dim, inner, cuda_lib.stream_ptr(x))
    cuda_lib.check(rc, "dsta_geglu_fwd")
    geglu_ff.launches += 1
    geglu_ff.launches_by_design[design] += 1
    return out


def geglu_dx(x, w1, b1, w2, dy):
    """dx of the GEGLU MLP for the output cotangent dy: x, dy [..., dim] ->
    [..., dim] in x's dtype.  CPU tensors take `geglu_dx_plain`; CUDA
    tensors launch `csrc/geglu_bwd.cu` (counted) or raise."""
    if x.device.type == "cpu":
        return geglu_dx_plain(x, w1, b1, w2, dy)
    if x.device.type != "cuda":
        raise ValueError(f"geglu_dx: unsupported device {x.device}")
    if dy.shape != x.shape:
        raise ValueError(f"geglu_dx: dy {tuple(dy.shape)} != x {tuple(x.shape)}")
    M, dim, inner, design = _check("geglu_dx", x, w1, b1, w2, [x, w1, b1, w2, dy],
                                   (x, w1, w2, dy))
    scratch = _scratch(design, M, dim, inner, 2 * inner, x.device)
    dx = torch.empty_like(x)
    rc = cuda_lib.library().dsta_geglu_dx(
        cuda_lib.dtype_code(x), x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
        dy.data_ptr(), scratch.data_ptr(), dx.data_ptr(), M, dim, inner,
        cuda_lib.stream_ptr(x))
    cuda_lib.check(rc, "dsta_geglu_dx")
    geglu_dx.launches += 1
    geglu_dx.launches_by_design[design] += 1
    return dx


geglu_dx.launches = 0
geglu_dx.launches_by_design = dict.fromkeys(DESIGNS, 0)


class _GegluFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, residual):
        if x.device.type == "cpu":
            out = geglu_plain(x, w1, b1, w2, b2, residual)
        elif x.device.type == "cuda":
            out = _forward(x, w1, b1, w2, b2, residual)
        else:
            raise ValueError(f"geglu_ff: unsupported device {x.device}")
        # the residual enters linearly: its cotangent is dy, so it is not saved
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w1, b1, w2, b2 = ctx.saved_tensors
        need = ctx.needs_input_grad
        dy = dy.contiguous()
        dx = geglu_dx(x, w1, b1, w2, dy) if need[0] else None
        dw1 = db1 = dw2 = db2 = None
        if any(need[1:5]):  # plain products (`pallas_geglu.py:365-394`)
            inner = w2.shape[1]
            x2, gf = x.reshape(-1, x.shape[-1]), dy.reshape(-1, dy.shape[-1]).float()
            h, g = _h_g(x2, w1, b1, inner)
            dh, dg = _dh_dg(h, g, gf @ w2.float())
            u = (h * gelu_erf(g)).to(x.dtype)
            xf = x2.float()
            dw1 = torch.cat([dh.to(x.dtype).float().T @ xf,
                             dg.to(x.dtype).float().T @ xf]).to(w1.dtype)
            db1 = torch.cat([dh.sum(0), dg.sum(0)]).to(b1.dtype)
            dw2 = (gf.T @ u.float()).to(w2.dtype)
            db2 = gf.sum(0).to(b2.dtype)
        dres = dy if need[5] else None
        return dx, dw1, db1, dw2, db2, dres


def geglu_ff(x, w1, b1, w2, b2, residual=None):
    """x: [..., dim]; w1: [2·inner, dim]; b1: [2·inner]; w2: [dim, inner];
    b2: [dim]; residual like x or None -> [..., dim] in x's dtype.
    Differentiable in every tensor argument."""
    return _GegluFn.apply(x, w1, b1, w2, b2, residual)


geglu_ff.launches = 0
geglu_ff.launches_by_design = dict.fromkeys(DESIGNS, 0)
