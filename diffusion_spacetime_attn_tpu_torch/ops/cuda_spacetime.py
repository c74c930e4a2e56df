"""Blended spacetime cross-attention (cond half) on the CUDA kernels
`csrc/spacetime_fwd.cu` and `csrc/spacetime_bwd.cu`.

Replaces the JAX package's Pallas TPU kernels `ops/pallas_spacetime.py:_kernel`
(launched by `_forward`) and `_bwd_kernel` (launched by `_backward`), public
`fused_spacetime_attention`, with the same argument order and layouts.  On
the H100 both are bound by memory, and the bf16 forward at SD level 0 by its
exps: the forward reads q and g_u once, keeps the N per-object attention
results on chip (the plain version writes a [B, N, Lq, inner] tensor) and
writes the blended rows once; the backward recomputes each softmax per query
tile and writes dq and the per-head blend products t, and dK/dV only when
they are asked for.  Contexts are at most 80 keys (CLIP's 77); keys past the
context length are masked to −inf.  The masks are cast once, to q's dtype,
which is how the kernels (and the TPU kernels) read them.

Every call on a CUDA tensor goes through a kernel, in the design
`spacetime_design` picks from the dtype and shape before launch (no fallback
after a failed launch): "wgmma" (bf16; head width a multiple of 8 up to 160,
contexts of at most 80 keys, 16-byte aligned operands: every SD v1-4 site),
the forward and the dq pass on the tensor cores, fed by TMA rings, the
forward's blended probabilities rounded to bf16 and the dq pass's ds split
into two bf16 parts as the A operand of the second product; or "simt"
(float32, CUDA cores).  Other bf16 inputs raise.  The
dK/dV pass, which the optimization's chain never asks for, runs on the CUDA
cores in both dtypes.  `fused_spacetime_attention.launches_by_design` and
`spacetime_bwd.launches_by_design` count launches per design.

`fused_spacetime_attention` is a `torch.autograd.Function`.  On a CPU tensor
it runs the plain versions (`spacetime_plain`, `spacetime_bwd_plain`); on a
CUDA tensor it launches the kernels or raises.  `fused_spacetime_attention`
counts its forward launches and `spacetime_bwd` its backward launches.
"""
from __future__ import annotations

import torch

from . import cuda_lib

DH_MAX = 160
LK_MAX = 80
DESIGNS = ("wgmma", "simt")


def spacetime_design(dtype, dh: int, Lk: int, aligned: bool = True) -> str:
    """The kernel design that takes a spacetime forward or backward: "wgmma"
    for bf16 at head widths that are multiples of 8 up to `DH_MAX`, contexts
    of at most `LK_MAX` keys and 16-byte aligned operands (what TMA can
    describe), "simt" for float32.  Other bf16 inputs raise ValueError: no
    kernel takes them."""
    if dtype != torch.bfloat16:
        return "simt"
    if dh % 8 or dh > DH_MAX or Lk > LK_MAX or not aligned:
        raise ValueError(f"bfloat16 spacetime attention takes head widths that are multiples "
                         f"of 8 up to {DH_MAX}, contexts of at most {LK_MAX} keys and 16-byte "
                         f"aligned tensors (dh={dh}, Lk={Lk}, aligned={aligned})")
    return "wgmma"


def spacetime_plain(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads: int):
    """The plain PyTorch version (the math of `_xla_reference`,
    `pallas_spacetime.py:140-149`)."""
    from .attention import attention, multi_context_attention

    g_c = attention(q_c, kc, vc, num_heads)
    loc = multi_context_attention(q_c, lk, lv, num_heads)      # [B, N, Lq, inner]
    w = masks * coef[..., None]                                 # [B, N, Lq]
    blend = torch.einsum("bnq,bnqi->bqi", w.to(loc.dtype), loc)
    return g_c + blend - w.sum(dim=1)[..., None].to(g_u.dtype) * g_u


def _blend_cotangents(t, masks, coef, g, g_u, need_masks: bool = True):
    """dg_u, dmasks, dcoef from the per-head blend products t [B, H, N, Lq]
    (`pallas_spacetime.py:307-314`); dmasks is None without need_masks."""
    t_sum = t.sum(dim=1)                                        # [B, N, Lq]
    w = masks.float() * coef[..., None].float()
    dg_u = (-w.sum(dim=1)[..., None] * g.float()).to(g_u.dtype)
    dmasks = (coef[..., None].float() * t_sum).to(masks.dtype) if need_masks else None
    dcoef = (masks.float() * t_sum).sum(dim=-1).to(coef.dtype)
    return dg_u, dmasks, dcoef


def _plain_raw(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads, g):
    """f32 (dq, t, dkc, dvc, dlk, dlv) with the math of `_bwd_kernel`
    (`pallas_spacetime.py:152-233`): one softmax per context, recomputed."""
    B, Lq, inner = q_c.shape
    N, Lk = lk.shape[1], lk.shape[2]
    dh = inner // num_heads
    scale = dh ** -0.5

    def heads(x):  # [..., L, inner] -> [..., H, L, dh], f32
        return x.float().reshape(*x.shape[:-1], num_heads, dh).transpose(-2, -3)

    q, gb, gu = heads(q_c), heads(g), heads(g_u)               # [B, H, Lq, dh]
    # contexts stacked: 0 global, 1..N objects -> [B, N+1, H, Lk, dh]
    k = torch.cat([heads(kc)[:, None], heads(lk)], dim=1)
    v = torch.cat([heads(vc)[:, None], heads(lv)], dim=1)
    ones = torch.ones((B, 1, Lq), dtype=torch.float32, device=masks.device)
    w = torch.cat([ones, masks.float()], dim=1)
    w = w * torch.cat([ones[:, :, 0], coef.float()], dim=1)[..., None]
    p = torch.softmax(torch.einsum("bhqd,bchkd->bchqk", q, k) * scale, dim=-1)
    dout = w[:, :, None, :, None] * gb[:, None]                  # [B, N+1, H, Lq, dh]
    dv = torch.einsum("bchqk,bchqd->bchkd", p, dout)
    dp = torch.einsum("bchqd,bchkd->bchqk", dout, v)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bchqk,bchkd->bhqd", ds, k) * scale
    dk = torch.einsum("bchqk,bhqd->bchkd", ds, q) * scale
    loc = torch.einsum("bchqk,bchkd->bchqd", p[:, 1:], v[:, 1:])
    t = ((loc - gu[:, None]) * gb[:, None]).sum(dim=-1).transpose(1, 2)  # [B, H, N, Lq]

    def unheads(x):  # [..., H, L, dh] -> [..., L, inner]
        return x.transpose(-2, -3).reshape(*x.shape[:-3], x.shape[-2], inner)

    return unheads(dq), t, unheads(dk[:, 0]), unheads(dv[:, 0]), unheads(dk[:, 1:]), \
        unheads(dv[:, 1:])


def spacetime_bwd_plain(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads: int, g):
    """The plain backward: the 8 cotangents of `_backward`
    (`pallas_spacetime.py:236-314`) in its order and dtypes,
    (dq_c, dg_u, dkc, dvc, dlk, dlv, dmasks, dcoef)."""
    dq, t, dkc, dvc, dlk, dlv = _plain_raw(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads, g)
    dg_u, dmasks, dcoef = _blend_cotangents(t, masks, coef, g, g_u)
    return (dq.to(q_c.dtype), dg_u, dkc.to(kc.dtype), dvc.to(vc.dtype), dlk.to(lk.dtype),
            dlv.to(lv.dtype), dmasks, dcoef)


def spacetime_cost(B: int, N: int, Lq: int, Lk: int, inner: int, itemsize: int):
    """(FLOPs, bytes) of one forward call: QK and PV products for N+1
    contexts; q, g_u, out, the K/V of every context, the masks (in q's
    dtype) and f32 coef moved once."""
    flops = 4 * B * (N + 1) * Lq * Lk * inner
    nbytes = (itemsize * (3 * B * Lq * inner + 2 * B * (N + 1) * Lk * inner + B * N * Lq)
              + 4 * B * N)
    return flops, nbytes


def spacetime_exps(B: int, N: int, Lq: int, Lk: int, heads: int) -> int:
    """Exponentials of one forward call, and of one backward call's dq pass:
    one per score, N+1 contexts of Lk keys per (prompt, head, query)."""
    return B * heads * Lq * (N + 1) * Lk


def spacetime_bwd_cost(B: int, N: int, Lq: int, Lk: int, inner: int, heads: int,
                       itemsize: int, need_kv: bool = True):
    """(FLOPs, bytes) of one backward call.  The dq pass does three products
    per context (q·Kᵀ, ḡ·Vᵀ, ds·K), the dK/dV pass two more (dsᵀ·q, pᵀ·ḡ;
    the softmax and ḡ·Vᵀ it recomputes are not counted).  Bytes: q, g_u, ḡ,
    the K/V of every context, the masks (in q's dtype) and f32 coef read
    once; f32 dq and t [B, heads, N, Lq] written once, and f32 dK/dV of
    every context with need_kv."""
    flops = 2 * (5 if need_kv else 3) * B * (N + 1) * Lq * Lk * inner
    nbytes = (itemsize * (3 * B * Lq * inner + 2 * B * (N + 1) * Lk * inner + B * N * Lq)
              + 4 * B * N + 4 * (B * Lq * inner + B * heads * N * Lq))
    if need_kv:
        nbytes += 4 * 2 * B * (N + 1) * Lk * inner
    return flops, nbytes


def _check(name, q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads, g=None):
    """Raise unless the kernels take these inputs; returns (B, N, Lq, Lk, inner)."""
    B, Lq, inner = q_c.shape
    N, Lk = lk.shape[1], lk.shape[2]
    want = {"g_u": (g_u, (B, Lq, inner)), "kc": (kc, (B, Lk, inner)),
            "vc": (vc, (B, Lk, inner)), "lk": (lk, (B, N, Lk, inner)),
            "lv": (lv, (B, N, Lk, inner)), "masks": (masks, (B, N, Lq)),
            "coef": (coef, (B, N))}
    if g is not None:
        want["g"] = (g, (B, Lq, inner))
    for key, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} {tuple(t.shape)} != {shape}")
    for t in (g_u, kc, vc, lk, lv) + (() if g is None else (g,)):
        if t.dtype != q_c.dtype:
            raise TypeError(f"{name}: q_c, g_u, K, V and the cotangent must share one dtype")
    if inner % num_heads or inner // num_heads > DH_MAX or Lk > LK_MAX:
        raise ValueError(f"{name}: unsupported inner={inner} heads={num_heads} Lk={Lk}")
    return B, N, Lq, Lk, inner


def _masks_coef(q_c, masks, coef):
    # the kernels (as the TPU kernels) read masks in q's dtype, coef in f32;
    # a cast or copy only where the input is not that already
    return masks.to(q_c.dtype).contiguous(), coef.float().contiguous()


def _design(name, q_c, num_heads, Lk, operands):
    """The design of a launch (`operands`: the tensors a kernel reads or
    writes in q's dtype); raises what `spacetime_design` raises."""
    try:
        return spacetime_design(q_c.dtype, q_c.shape[-1] // num_heads, Lk,
                                all(t.data_ptr() % 16 == 0 for t in operands))
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None


def _forward(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads):
    """The forward kernel on CUDA tensors; counts a launch."""
    B, N, Lq, Lk, inner = _check("fused_spacetime_attention", q_c, g_u, kc, vc, lk, lv,
                                 masks, coef, num_heads)
    m, c = _masks_coef(q_c, masks, coef)
    cuda_lib.require_cuda("fused_spacetime_attention", q_c, g_u, kc, vc, lk, lv, m, c)
    dh = inner // num_heads
    out = torch.empty_like(q_c)
    design = _design("fused_spacetime_attention", q_c, num_heads, Lk,
                     (q_c, g_u, kc, vc, lk, lv, out))
    rc = cuda_lib.library().dsta_spacetime_fwd(
        cuda_lib.dtype_code(q_c), q_c.data_ptr(), g_u.data_ptr(), kc.data_ptr(),
        vc.data_ptr(), lk.data_ptr(), lv.data_ptr(), m.data_ptr(), c.data_ptr(),
        out.data_ptr(), B, N, Lq, Lk, num_heads, dh, dh ** -0.5,
        cuda_lib.stream_ptr(q_c))
    cuda_lib.check(rc, "dsta_spacetime_fwd")
    fused_spacetime_attention.launches += 1
    fused_spacetime_attention.launches_by_design[design] += 1
    return out


def spacetime_bwd_raw(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads: int, g,
                      need_kv: bool = True):
    """The backward kernel's own f32 outputs (dq, t, dkc, dvc, dlk, dlv) on
    CUDA tensors (the last four None without need_kv); counts a launch of
    `spacetime_bwd`."""
    B, N, Lq, Lk, inner = _check("spacetime_bwd", q_c, g_u, kc, vc, lk, lv, masks, coef,
                                 num_heads, g)
    m, c = _masks_coef(q_c, masks, coef)
    cuda_lib.require_cuda("spacetime_bwd", q_c, g_u, kc, vc, lk, lv, m, c, g)
    dh = inner // num_heads
    design = _design("spacetime_bwd", q_c, num_heads, Lk, (q_c, g_u, kc, vc, lk, lv, g))
    f32 = dict(dtype=torch.float32, device=q_c.device)
    dq = torch.empty((B, Lq, inner), **f32)
    t = torch.empty((B, num_heads, N, Lq), **f32)
    kv = (torch.empty((B, Lk, inner), **f32), torch.empty((B, Lk, inner), **f32),
          torch.empty((B, N, Lk, inner), **f32), torch.empty((B, N, Lk, inner), **f32)) \
        if need_kv else (None,) * 4
    ptrs = [None if x is None else x.data_ptr() for x in kv]
    rc = cuda_lib.library().dsta_spacetime_bwd(
        cuda_lib.dtype_code(q_c), q_c.data_ptr(), g_u.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        lk.data_ptr(), lv.data_ptr(), m.data_ptr(), c.data_ptr(), g.data_ptr(), dq.data_ptr(),
        t.data_ptr(), *ptrs, B, N, Lq, Lk, num_heads, dh, dh ** -0.5,
        cuda_lib.stream_ptr(q_c))
    cuda_lib.check(rc, "dsta_spacetime_bwd")
    spacetime_bwd.launches += 1
    spacetime_bwd.launches_by_design[design] += 1
    return (dq, t) + kv


def spacetime_bwd(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads: int, g,
                  need_kv: bool = True, need_masks: bool = True):
    """Cotangents (dq_c, dg_u, dkc, dvc, dlk, dlv, dmasks, dcoef) of the
    blend for the output cotangent g, in `_backward`'s order and dtypes.
    Without need_kv, dkc..dlv are None and the kernel's dK/dV pass does not
    run; without need_masks, dmasks is None.  CPU tensors take
    `spacetime_bwd_plain`; CUDA tensors the kernel."""
    if q_c.device.type == "cpu":
        cots = spacetime_bwd_plain(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads, g)
        cots = cots if need_kv else cots[:2] + (None,) * 4 + cots[6:]
        return cots if need_masks else cots[:6] + (None, cots[7])
    if q_c.device.type != "cuda":
        raise ValueError(f"spacetime_bwd: unsupported device {q_c.device}")
    dq, t, dkc, dvc, dlk, dlv = spacetime_bwd_raw(q_c, g_u, kc, vc, lk, lv, masks, coef,
                                                  num_heads, g, need_kv)
    dg_u, dmasks, dcoef = _blend_cotangents(t, masks, coef, g, g_u, need_masks)
    kv = (dkc.to(kc.dtype), dvc.to(vc.dtype), dlk.to(lk.dtype), dlv.to(lv.dtype)) \
        if need_kv else (None,) * 4
    return (dq.to(q_c.dtype), dg_u) + kv + (dmasks, dcoef)


spacetime_bwd.launches = 0
spacetime_bwd.launches_by_design = dict.fromkeys(DESIGNS, 0)


class _SpacetimeFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads):
        if q_c.device.type == "cpu":
            out = spacetime_plain(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads)
        elif q_c.device.type == "cuda":
            out = _forward(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads)
        else:
            raise ValueError(f"fused_spacetime_attention: unsupported device {q_c.device}")
        ctx.save_for_backward(q_c, g_u, kc, vc, lk, lv, masks, coef)
        ctx.num_heads = num_heads
        return out

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad
        cots = spacetime_bwd(*ctx.saved_tensors, ctx.num_heads, g.contiguous(),
                             need_kv=any(need[2:6]), need_masks=need[6])
        return tuple(c if n else None for c, n in zip(cots, need[:8])) + (None,)


def fused_spacetime_attention(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads: int):
    """q_c/g_u: [B, Lq, inner]; kc/vc: [B, Lk, inner]; lk/lv: [B, N, Lk,
    inner]; masks: [B, N, Lq]; coef: [B, N] -> blended cond rows [B, Lq,
    inner] in q_c's dtype.  Differentiable in every tensor argument."""
    return _SpacetimeFn.apply(q_c, g_u, kc, vc, lk, lv, masks, coef, num_heads)


fused_spacetime_attention.launches = 0
fused_spacetime_attention.launches_by_design = dict.fromkeys(DESIGNS, 0)
