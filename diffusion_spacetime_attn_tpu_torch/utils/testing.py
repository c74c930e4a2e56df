"""Seeded random weights, and the kernel-vs-plain comparison, for tests and
benchmarks.

SD-style models zero-initialize their output convs, so a fresh init is
degenerate (identically-zero output); without a checkpoint, every parameter
is replaced by N(0, scale²) noise, as the JAX package's `randomize_params`
does.  One generator per state-dict key, seeded from the seed and a hash of
the key, on the parameter's own device (no host-side generation of GBs).
"""
from __future__ import annotations

import hashlib

import torch
from torch import nn


def randomize_(module: nn.Module, seed: int, scale: float = 0.02) -> nn.Module:
    """Fill every parameter of `module` in place with seeded N(0, scale²)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            h = int.from_bytes(hashlib.sha1(name.encode()).digest()[:4], "little")
            g = torch.Generator(device=p.device)
            g.manual_seed((seed ^ h) & 0x7FFFFFFF)
            noise = torch.randn(p.shape, generator=g, device=p.device, dtype=torch.float32)
            p.copy_(noise * scale)
    return module


# Kernel-vs-plain tolerances: an output passes when every element has
# |got - want| <= atol + rtol·|want| and ||got - want|| / ||want|| <= rel_norm.
#   float32: the kernel and the plain version differ in summation order only.
#   bfloat16, mha and geglu: both round at the same points (p, or the gated u,
#     before the second product; the output once), so they differ by about
#     one bf16 ulp of the output (2^-7 relative at most; rtol allows two).
#     The absolute floor scales with the output: atol = 2 % of rms(want),
#     for elements near zero.
#   bfloat16, spacetime: the plain version rounds every blend term (loc_n,
#     w·loc_n, g_c + blend, (Σ w)·g_u) while the kernel rounds once, so an
#     output near zero carries a few ulps of terms of magnitude up to ~10.
#   bfloat16, spacetime_bwd: both backwards compute in float32 and round each
#     cotangent once, like mha (the f32 dmasks and dcoef take the f32 rule).
#     The GEGLU dx uses "geglu": both round dh and dg at the same point.
BF16_ATOL_RMS = {"mha": 0.02, "geglu": 0.02, "spacetime_bwd": 0.02}
BF16_ABS = {"spacetime": (5e-2, 2e-2)}
BF16_RTOL, BF16_REL_NORM = 2.0 ** -6, 1e-2
F32_TOL = 1e-4


def compare(got: torch.Tensor, want: torch.Tensor, kind: str) -> dict:
    """Hold a kernel's output against its plain version (`kind`: "mha",
    "geglu", "spacetime" or "spacetime_bwd").  Returns the errors, the limits and "ok"."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rel_norm = float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp_min(1e-30))
    if want.dtype == torch.float32:
        atol = rtol = limit = F32_TOL
    elif kind in BF16_ABS:
        (atol, rtol), limit = BF16_ABS[kind], BF16_REL_NORM
    else:
        atol = BF16_ATOL_RMS[kind] * float(w.square().mean().sqrt())
        rtol, limit = BF16_RTOL, BF16_REL_NORM
    excess = float((err - atol - rtol * w.abs()).max())
    ok = (got.shape == want.shape and got.dtype == want.dtype
          and bool(torch.isfinite(g).all()) and excess <= 0 and rel_norm <= limit)
    return {"ok": ok, "max_abs_err": float(err.max()), "rel_norm": rel_norm, "atol": atol,
            "rtol": rtol, "rel_norm_limit": limit}
