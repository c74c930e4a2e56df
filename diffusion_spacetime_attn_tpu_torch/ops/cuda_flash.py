"""Flash self-attention, forward and backward, on the CUDA kernels
`csrc/flash_fwd.cu` and `csrc/flash_bwd.cu`.

Counterpart of the JAX package's `flash_attention` (`ops/attention.py:194-214`),
which runs jax's splash attention (`_splash_kernel`, `:63-92`): its forward
body `flash_attention_kernel` and its backward bodies
`_flash_attention_dq_kernel` and `_flash_attention_dkv_kernel` are the TPU
kernels these replace.  Numerics are splash's: q is scaled by dh^-½ and
rounded to K's dtype before the kernels (`attention.py:205,210`); scores,
softmax and the row log-sum-exp (the residual the backward recomputes p from)
are f32; the backward rounds p to the cotangent's dtype for dV and ds to K's
dtype for dq and dK.  On the H100 both kernels are bound by operations at the
sites JAX sends here; neither writes an [L, L] tensor.

`flash_attention` is a `torch.autograd.Function`.  On a CPU tensor it runs
the plain versions (`flash_attention_plain`, `flash_bwd_plain`); on a CUDA
tensor it launches the kernels or raises.  `flash_attention.launches` counts
forward launches and `flash_bwd.launches` backward launches.  di = rowsum(o ⊙
ḡ) is computed here before the backward kernel, as splash computes it outside
its kernels (`_splash_attention_bwd`).
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .cuda_mha import BWD_CHUNK_BYTES

DH_MAX = 128


def flash_ok(Lq: int, Lk: int, dh: int) -> bool:
    """The JAX package's routing rule for flash (`ops/attention.py:56-60`):
    long self-attention sequences, head width ≤ 128.  It decides which sites
    take this path, as in JAX; it is not a measured speed envelope of the
    H100 kernels."""
    return Lq == Lk and Lq >= 1024 and dh <= 128 and Lq % 512 == 0


def query_scale(q, num_heads: int) -> float:
    """dh^-½ rounded to q's dtype, as JAX rounds the Python scalar it
    multiplies a bf16 array by."""
    return float(torch.tensor((q.shape[-1] // num_heads) ** -0.5, dtype=q.dtype))


def scaled_query(q, k, num_heads: int):
    """q·dh^-½ in q's dtype, then rounded to K's dtype (`attention.py:205,210`)."""
    return (q * query_scale(q, num_heads)).to(k.dtype)


def _fold(t, num_heads):  # [B, L, H*dh] -> [B*H, L, dh]
    B, L, inner = t.shape
    return t.reshape(B, L, num_heads, inner // num_heads).transpose(1, 2).reshape(
        B * num_heads, L, inner // num_heads)


def _unfold(t, B):  # [B*H, L, dh] -> [B, L, H*dh]
    BH, L, dh = t.shape
    return t.reshape(B, BH // B, L, dh).transpose(1, 2).reshape(B, L, BH // B * dh)


def _slices(BH, Lq, Lk):
    step = max(1, BWD_CHUNK_BYTES // (4 * Lq * Lk))
    return [slice(i, i + step) for i in range(0, BH, step)]


def row_dot(o, g, num_heads: int):
    """di = Σ_d o·g per (batch·head, row) in f32, [B*H, L]."""
    return (_fold(o, num_heads).float() * _fold(g, num_heads).float()).sum(dim=-1).contiguous()


def flash_attention_plain(q, k, v, num_heads: int):
    """Splash's forward in PyTorch: (o in q's dtype, lse [B*H, Lq] f32).
    f32 scores and softmax of the scaled query; the PV product in f32 on f32
    p (splash `:819-820`, unlike `pallas_mha.py:90`)."""
    B, Lq, _ = q.shape
    qf, kf, vf = (_fold(t, num_heads) for t in (scaled_query(q, k, num_heads), k, v))
    o = torch.empty(qf.shape, dtype=k.dtype, device=q.device)
    lse = torch.empty(qf.shape[:2], dtype=torch.float32, device=q.device)
    for sl in _slices(qf.shape[0], Lq, k.shape[1]):
        s = qf[sl].float() @ kf[sl].float().transpose(1, 2)
        lse[sl] = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[sl, :, None])
        o[sl] = (p @ vf[sl].float()).to(o.dtype)
    return _unfold(o, B).to(q.dtype), lse


def flash_bwd_plain(q, k, v, o, lse, g, num_heads: int):
    """Splash's backward in PyTorch: (dq, dk, dv), each in its input's dtype.
    di = Σ o·g in f32; p = exp(s − lse); dp = g·Vᵀ; ds = p·(dp − di)
    rounded to K's dtype before the dq and dk products (splash `:1381-1397`);
    p rounded to g's dtype for dv; dq rounded to K's dtype, then the
    pre-scale's chain rule in q's dtype."""
    B, Lq, _ = q.shape
    qs = scaled_query(q, k, num_heads)
    qf, kf, vf, gf = (_fold(t, num_heads) for t in (qs, k, v, g))
    di = row_dot(o, g, num_heads)
    dq = torch.empty(qf.shape, dtype=k.dtype, device=q.device)
    dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (kf, vf))
    for sl in _slices(qf.shape[0], Lq, k.shape[1]):
        qsl, ksl, gsl = qf[sl].float(), kf[sl].float(), gf[sl].float()
        p = torch.exp(qsl @ ksl.transpose(1, 2) - lse[sl, :, None])
        dv[sl] = (p.to(g.dtype).float().transpose(1, 2) @ gsl).to(v.dtype)
        dp = gsl @ vf[sl].float().transpose(1, 2)
        ds = (p * (dp - di[sl, :, None])).to(k.dtype).float()
        dq[sl] = (ds @ ksl).to(k.dtype)
        dk[sl] = (ds.transpose(1, 2) @ qsl).to(k.dtype)
    return _unfold(dq, B).to(q.dtype) * query_scale(q, num_heads), _unfold(dk, B), _unfold(dv, B)


def flash_cost(B: int, Lq: int, Lk: int, inner: int, heads: int, itemsize: int):
    """(FLOPs, bytes) of one forward call: two products, 4·Lq·Lk·dh FLOPs
    per (batch, head); q, k, v read once, o and the f32 lse written once."""
    flops = 4 * B * Lq * Lk * inner
    nbytes = itemsize * (2 * B * Lq * inner + 2 * B * Lk * inner) + 4 * B * heads * Lq
    return flops, nbytes


def flash_bwd_cost(B: int, Lq: int, Lk: int, inner: int, heads: int, itemsize: int):
    """(FLOPs, bytes) of one backward call: five products (s, dp, dq, dk,
    dv), 10·Lq·Lk·dh FLOPs per (batch, head), however often the kernel
    recomputes s and dp; q, k, v, o, g and the f32 lse read once, dq, dk,
    dv written once."""
    flops = 10 * B * Lq * Lk * inner
    nbytes = (itemsize * (3 * B * Lq * inner + 2 * B * Lk * inner)
              + 4 * B * heads * Lq + itemsize * (B * Lq * inner + 2 * B * Lk * inner))
    return flops, nbytes


def _check(name, q, k, v, num_heads, *more):
    """Raise unless the kernels take these CUDA tensors; returns (B, Lq, Lk, dh)."""
    cuda_lib.require_cuda(name, q, k, v, *more)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"{name}: bad shapes {tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, Lq, inner = q.shape
    if k.shape[0] != B or k.shape[2] != inner or inner % num_heads:
        raise ValueError(f"{name}: bad shapes {tuple(q.shape)} {tuple(k.shape)} "
                         f"heads={num_heads}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k, v must share one dtype")
    dh = inner // num_heads
    if dh > DH_MAX:
        raise ValueError(f"{name}: head width {dh} > {DH_MAX}")
    return B, Lq, k.shape[1], dh


def flash_fwd(q, k, v, num_heads: int):
    """(o, lse): the plain forward for CPU tensors, the forward kernel for
    CUDA tensors (counts a launch of `flash_attention`)."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, num_heads)
    B, Lq, Lk, dh = _check("flash_attention", q, k, v, num_heads)
    qs = scaled_query(q, k, num_heads)
    out = torch.empty_like(qs)
    lse = torch.empty((B * num_heads, Lq), dtype=torch.float32, device=q.device)
    rc = cuda_lib.library().dsta_flash_fwd(
        cuda_lib.dtype_code(qs), qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Lq, Lk, num_heads, dh, cuda_lib.stream_ptr(q))
    cuda_lib.check(rc, "dsta_flash_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_bwd_raw(qs, k, v, g, lse, di, num_heads: int, scale: float):
    """The backward kernel on CUDA tensors from the scaled query qs and di;
    returns (dq, dk, dv) in the inputs' dtype and counts a launch of
    `flash_bwd`."""
    B, Lq, Lk, dh = _check("flash_bwd", qs, k, v, num_heads, g, lse, di)
    if g.shape != qs.shape or g.dtype != qs.dtype:
        raise ValueError("flash_bwd: the cotangent must match q")
    if lse.shape != (B * num_heads, Lq) or di.shape != lse.shape or \
            lse.dtype != torch.float32 or di.dtype != torch.float32:
        raise ValueError("flash_bwd: lse and di must be float32 [B*H, Lq]")
    dq, dk, dv = torch.empty_like(qs), torch.empty_like(k), torch.empty_like(v)
    rc = cuda_lib.library().dsta_flash_bwd(
        cuda_lib.dtype_code(qs), qs.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, Lq, Lk, num_heads, dh, scale, cuda_lib.stream_ptr(qs))
    cuda_lib.check(rc, "dsta_flash_bwd")
    flash_bwd.launches += 1
    return dq, dk, dv


def flash_bwd(q, k, v, o, lse, g, num_heads: int):
    """(dq, dk, dv) of flash attention for the output cotangent g, from the
    forward's output o and log-sum-exp lse.  CPU tensors take
    `flash_bwd_plain`; CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, g, num_heads)
    return flash_bwd_raw(scaled_query(q, k, num_heads), k, v, g, lse, row_dot(o, g, num_heads),
                         num_heads, query_scale(q, num_heads))


flash_bwd.launches = 0


class _FlashFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads):
        if q.device.type not in ("cpu", "cuda"):
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        o, lse = flash_fwd(q, k, v, num_heads)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads = num_heads
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        # always all three: the chain's keys and values come from the latents
        dq, dk, dv = flash_bwd(q, k, v, o, lse, g.contiguous(), ctx.num_heads)
        return dq, dk, dv, None


def flash_attention(q, k, v, num_heads: int, *, out_dtype=None):
    """q: [B, Lq, H*dh]; k/v: [B, Lk, H*dh] -> [B, Lq, H*dh] in q's dtype
    (then out_dtype), with splash's numerics.  Differentiable in q, k, v."""
    out = _FlashFn.apply(q, k, v, num_heads)
    return out if out_dtype is None else out.to(out_dtype)


flash_attention.launches = 0
