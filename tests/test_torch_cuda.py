"""The port's CUDA kernels against their plain PyTorch versions.

Tests marked `gpu` need a CUDA card: each decides inside its fixture whether
one is present and skips otherwise.  The card's machine has no JAX, so run
them there without the repository's conftest (which imports JAX):

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

The unmarked tests run anywhere: they check the C interface statically
(there is no nvcc on a CPU-only machine).

Tolerances are those of `utils.testing.compare`, which states the reason for
each: float32 1e-4 per element (summation order only); bfloat16 per element
within atol + 2^-6·|plain| (atol 2 % of the plain output's rms for attention,
GEGLU, its dx and the spacetime backward; 5e-2 for the spacetime blend) and
within 1e-2 in relative norm.  The autograd Functions' gradients are held
against autograd of the plain forwards in float32 (bf16 autograd of a plain
forward rounds at other points than either backward).
"""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from diffusion_spacetime_attn_tpu_torch.ops import (
    cuda_flash,
    cuda_geglu,
    cuda_lib,
    cuda_mha,
    cuda_spacetime,
)
from diffusion_spacetime_attn_tpu_torch.ops.masks import flat_circular_mask
from diffusion_spacetime_attn_tpu_torch.utils.testing import compare

DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, dev, dtype, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _check(got, want, kind):
    torch.cuda.synchronize()
    cmp = compare(got, want, kind)
    assert cmp["ok"], cmp


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Lq,Lk,H,dh", [
    (2, 256, 256, 8, 40), (1, 128, 128, 4, 80), (2, 64, 64, 8, 160),
    (1, 100, 100, 2, 16),        # ragged query and key tiles
    (2, 70, 130, 2, 24),         # Lq != Lk
    (1, 50, 50, 3, 20),          # head width not a multiple of 8 (element loads)
    (2, 1088, 1088, 8, 40),      # ragged last tile of 128 queries and of 128 keys
    (2, 1088, 1088, 8, 80),
    (1, 200, 330, 2, 64),        # the wgmma loop at dh 64 and 128, Lq != Lk
    (1, 330, 200, 2, 128),
    # dh 160 (SD level 2 and mid): 64-query blocks where they fit the card
    # in one wave, else 128; 64-key ring stages
    (2, 256, 256, 8, 160), (4, 256, 256, 8, 160), (4, 64, 64, 8, 160),
    (2, 200, 200, 8, 160),       # ragged query and key tiles
    (2, 36, 36, 8, 160),         # one short key tile
    (1, 144, 144, 8, 160),       # 64-query blocks, a ragged third
    (4, 1060, 1060, 8, 160),     # 128-query blocks, the last one's second warpgroup rowless
    (1, 70, 130, 2, 160),        # Lq != Lk
    # the 768² RDM (head width 32) at 3 prompts: levels 0 and 2 and the mid
    # block, whose 144 and 36 tokens leave row tails; at 1 prompt the mid
    # block's grid takes 64-query blocks
    (6, 2304, 2304, 14, 32), (6, 144, 144, 42, 32), (6, 36, 36, 56, 32),
    (2, 36, 36, 56, 32), (2, 64, 64, 4, 32), (1, 100, 300, 2, 32),
])
def test_mha_kernel_matches_plain(cuda, dtype, B, Lq, Lk, H, dh):
    g = torch.Generator(device=cuda).manual_seed(dh + Lq)
    q = _randn(g, cuda, dtype, B, Lq, H * dh)
    k, v = (_randn(g, cuda, dtype, B, Lk, H * dh) for _ in range(2))
    design = cuda_mha.attention_design("mha", dtype, dh)
    if dtype == torch.bfloat16 and dh in (32, 160):    # the RDM's and SD level 2's widths
        assert design == "wgmma"
    before = cuda_mha.mha_attention.launches_by_design[design]
    _check(cuda_mha.mha_attention(q, k, v, H), cuda_mha.mha_attention_plain(q, k, v, H), "mha")
    assert cuda_mha.mha_attention.launches_by_design[design] == before + 1


# (B, N, Lq, Lk, inner, H) of the spacetime kernels' card tests
SPACETIME_SHAPES = [
    (2, 4, 4096, 77, 320, 8), (2, 4, 1024, 77, 640, 8),     # SD sites at 2 prompts:
    (2, 4, 256, 77, 1280, 8), (2, 4, 64, 77, 1280, 8),      # dh 40, 80, 160, 160
    (1, 4, 1024, 77, 640, 8), (2, 2, 256, 77, 1280, 8),
    (1, 3, 100, 12, 32, 2),      # ragged query tile, short context, dh 16
    (2, 1, 64, 80, 64, 4),       # the longest context the kernel takes
    (1, 0, 100, 77, 320, 8),     # no objects: the global context alone
    (1, 1, 100, 1, 512, 8),      # one key, dh 64
    (2, 4, 100, 64, 640, 8),     # Lk 64, dh 80
    (1, 4, 100, 80, 1280, 8),    # Lk 80, dh 160
    (1, 2, 100, 77, 512, 8),     # dh 64 at CLIP's 77 keys
    (1, 4, 4100, 77, 320, 8),    # 128-query blocks (a grid of > 2 waves), ragged last block
    (2, 4, 2112, 77, 1280, 8),   # 128-query blocks at dh 160: a 2-stage ring for 5 contexts
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,N,Lq,Lk,inner,H", SPACETIME_SHAPES)
def test_spacetime_kernel_matches_plain(cuda, dtype, B, N, Lq, Lk, inner, H):
    """Each design (bf16 wgmma, f32 simt) against the plain version at the SD
    sites and ragged shapes; the launch counted under its design; a repeat
    gives the same bits."""
    g = torch.Generator(device=cuda).manual_seed(Lq + N)
    args = _spacetime_args(g, cuda, dtype, B, N, Lq, Lk, inner) + (H,)
    design = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = dict(cuda_spacetime.fused_spacetime_attention.launches_by_design)
    got = cuda_spacetime.fused_spacetime_attention(*args)
    assert cuda_spacetime.fused_spacetime_attention.launches_by_design == {
        **before, design: before[design] + 1}
    _check(got, cuda_spacetime.spacetime_plain(*args), "spacetime")
    assert torch.equal(got, cuda_spacetime.fused_spacetime_attention(*args))


# (M, dim), inner = 4·dim
GEGLU_SHAPES = [
    (16384, 320), (4096, 640), (1024, 1280), (256, 1280),   # SD sites at 2 prompts (M = 4·L)
    (512, 320), (256, 640), (128, 1280), (100, 32), (7, 48),
    (16384, 48),                 # a 128-wide inner tile that runs past inner = 192
    (1000, 40),                  # M not a multiple of 64; inner 160 not a multiple of 64
    (300, 72),                   # dim and inner (288) not multiples of 64
    (64, 36),                    # width not a multiple of 8: float32 only
    # the 768² RDM at 3 prompts: levels 0 and 2 take 160-column output
    # tiles with a tail (448 = 2·160 + 128, 1344 = 8·160 + 64); the mid
    # block takes 64-column tiles (1792 = 28·64)
    (13824, 448), (864, 1344), (216, 1792),
]


def _geglu_weights(g, dev, dtype, M, dim):
    inner = 4 * dim
    return (_randn(g, dev, dtype, M, dim), _randn(g, dev, dtype, 2 * inner, dim, scale=dim ** -0.5),
            _randn(g, dev, dtype, 2 * inner, scale=0.1),
            _randn(g, dev, dtype, dim, inner, scale=inner ** -0.5))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("M,dim", GEGLU_SHAPES)
def test_geglu_kernel_matches_plain(cuda, dtype, residual, M, dim):
    """Each design (bf16 wgmma, f32 simt) against the plain version at the SD
    site shapes and ragged ones."""
    g = torch.Generator(device=cuda).manual_seed(M + dim)
    x, w1, b1, w2 = _geglu_weights(g, cuda, dtype, M, dim)
    b2 = _randn(g, cuda, dtype, dim, scale=0.1)
    res = _randn(g, cuda, dtype, M, dim) if residual else None
    if dtype == torch.bfloat16 and dim % 8:
        # the tensor-core kernels take widths that are multiples of 8 only
        with pytest.raises(ValueError):
            cuda_geglu.geglu_ff(x, w1, b1, w2, b2, res)
        return
    design = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = dict(cuda_geglu.geglu_ff.launches_by_design)
    got = cuda_geglu.geglu_ff(x, w1, b1, w2, b2, res)
    assert cuda_geglu.geglu_ff.launches_by_design == {**before, design: before[design] + 1}
    _check(got, cuda_geglu.geglu_plain(x, w1, b1, w2, b2, res), "geglu")
    # no atomics: a repeat gives the same bits
    assert torch.equal(got, cuda_geglu.geglu_ff(x, w1, b1, w2, b2, res))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Lq,Lk,H,dh", [
    (2, 4096, 4096, 8, 40),      # SD level 0, one prompt (2 CFG rows)
    (2, 1024, 1024, 8, 80),      # SD level 1
    (1, 100, 130, 2, 24),        # ragged query and key tiles, Lq != Lk
    (1, 64, 64, 3, 20),          # head width not a multiple of 8 (element loads)
    (1, 128, 128, 2, 128),       # the widest head flash_ok routes
    (2, 1088, 1088, 8, 40),      # ragged last tile of 128 queries / keys (wgmma in bf16)
    (2, 1088, 1088, 8, 80),
    (1, 200, 330, 2, 64),        # the wgmma kernels at dh 64 and 128, Lq != Lk
    (1, 330, 200, 2, 128),
])
def test_flash_kernels_match_plain(cuda, dtype, B, Lq, Lk, H, dh):
    """Forward (o, lse) and backward (dq, dk, dv) kernels against the plain
    versions; each launch counted under its design; a repeat gives the same
    bits."""
    g = torch.Generator(device=cuda).manual_seed(Lq + dh)
    q, gbar = (_randn(g, cuda, dtype, B, Lq, H * dh) for _ in range(2))
    k, v = (_randn(g, cuda, dtype, B, Lk, H * dh) for _ in range(2))
    v = (v.float() + 1.0).to(dtype)      # mean 1: o and di = rowsum(o ⊙ ḡ) are not ~0
    design = cuda_mha.attention_design("flash", dtype, dh)
    fwd, bwd = cuda_flash.flash_attention.launches, cuda_flash.flash_bwd.launches
    fwd_d = cuda_flash.flash_attention.launches_by_design[design]
    bwd_d = cuda_flash.flash_bwd.launches_by_design[design]
    o, lse = cuda_flash.flash_fwd(q, k, v, H)
    assert cuda_flash.flash_attention.launches == fwd + 1
    assert cuda_flash.flash_attention.launches_by_design[design] == fwd_d + 1
    o_p, lse_p = cuda_flash.flash_attention_plain(q, k, v, H)
    _check(o, o_p, "flash")
    _check(lse, lse_p, "flash")                      # float32: 1e-4
    grads = cuda_flash.flash_bwd(q, k, v, o_p, lse_p, gbar, H)
    assert cuda_flash.flash_bwd.launches == bwd + 1
    assert cuda_flash.flash_bwd.launches_by_design[design] == bwd_d + 1
    for got, want in zip(grads, cuda_flash.flash_bwd_plain(q, k, v, o_p, lse_p, gbar, H)):
        _check(got, want, "flash")
    again = (cuda_flash.flash_fwd(q, k, v, H)
             + cuda_flash.flash_bwd(q, k, v, o_p, lse_p, gbar, H))
    for a, b in zip((o, lse) + grads, again):        # no atomics
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("B,L,dh,H", [
    (2, 4096, 40, 8), (2, 1024, 80, 8),
    (4, 256, 160, 8),            # SD level 2, MHA only (64-query blocks)
    (6, 2304, 32, 14),           # RDM level 0, MHA only (128-query blocks, two per SM)
])
def test_wgmma_kernels_repeat_bit_for_bit(cuda, B, L, dh, H):
    """20 launches of each wgmma kernel on the same inputs give the same
    bits: a ring stage read before its copy landed, or released before its
    last product, shows up as bits that differ between launches.  Flash
    runs the wgmma kernels at dh 40 and 80 only."""
    g = torch.Generator(device=cuda).manual_seed(L + dh + 5)
    q, k, gbar = (_randn(g, cuda, torch.bfloat16, B, L, H * dh) for _ in range(3))
    v = _randn(g, cuda, torch.bfloat16, B, L, H * dh) + 1
    assert cuda_mha.attention_design("mha", q.dtype, dh) == "wgmma"
    mha = cuda_mha.mha_attention(q, k, v, H)
    flash = cuda_mha.attention_design("flash", q.dtype, dh) == "wgmma"
    if flash:
        o, lse = cuda_flash.flash_fwd(q, k, v, H)
        grads = cuda_flash.flash_bwd(q, k, v, o, lse, gbar, H)
    for _ in range(20):
        assert torch.equal(mha, cuda_mha.mha_attention(q, k, v, H))
        if flash:
            assert all(torch.equal(a, b)
                       for a, b in zip((o, lse), cuda_flash.flash_fwd(q, k, v, H)))
            again = cuda_flash.flash_bwd(q, k, v, o, lse, gbar, H)
            assert all(torch.equal(a, b) for a, b in zip(grads, again))


BWD_NAMES = ("dq_c", "dg_u", "dkc", "dvc", "dlk", "dlv", "dmasks", "dcoef")


def _spacetime_args(g, dev, dtype, B, N, Lq, Lk, inner):
    q_c, g_u = (_randn(g, dev, dtype, B, Lq, inner) for _ in range(2))
    kc, vc = (_randn(g, dev, dtype, B, Lk, inner) for _ in range(2))
    lk, lv = (_randn(g, dev, dtype, B, N, Lk, inner) for _ in range(2))
    dim = int(round(Lq ** 0.5))
    masks = flat_circular_mask(torch.rand((B, N, 2), generator=g, device=dev), dim, 0.3)
    masks = torch.nn.functional.pad(masks, (0, Lq - dim * dim))
    coef = torch.rand((B, N), generator=g, device=dev) * 2
    return q_c, g_u, kc, vc, lk, lv, masks, coef


@pytest.mark.gpu
@pytest.mark.parametrize("need_kv", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,N,Lq,Lk,inner,H", SPACETIME_SHAPES)
def test_spacetime_bwd_kernel_matches_plain(cuda, need_kv, dtype, B, N, Lq, Lk, inner, H):
    g = torch.Generator(device=cuda).manual_seed(Lq + N + 7)
    args = _spacetime_args(g, cuda, dtype, B, N, Lq, Lk, inner)
    gbar = _randn(g, cuda, dtype, B, Lq, inner)
    design = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = cuda_spacetime.spacetime_bwd.launches
    by_design = dict(cuda_spacetime.spacetime_bwd.launches_by_design)
    got = cuda_spacetime.spacetime_bwd(*args, H, gbar, need_kv=need_kv)
    assert cuda_spacetime.spacetime_bwd.launches == before + 1
    assert cuda_spacetime.spacetime_bwd.launches_by_design == {
        **by_design, design: by_design[design] + 1}
    want = cuda_spacetime.spacetime_bwd_plain(*args, H, gbar)
    for name, a, b in zip(BWD_NAMES, got, want):
        if a is None:
            assert not need_kv and name in ("dkc", "dvc", "dlk", "dlv")
            continue
        if b.numel() == 0:     # no objects: the per-object cotangents are empty
            assert a.shape == b.shape and a.dtype == b.dtype
            continue
        torch.cuda.synchronize()
        cmp = compare(a, b, "spacetime_bwd")
        assert cmp["ok"], (name, cmp)
    again = cuda_spacetime.spacetime_bwd(*args, H, gbar, need_kv=need_kv)
    for a, b in zip(got, again):   # no atomics: the same bits on a repeat
        assert a is None or torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,dim", GEGLU_SHAPES)
def test_geglu_dx_kernel_matches_plain(cuda, dtype, M, dim):
    g = torch.Generator(device=cuda).manual_seed(M + dim + 1)
    x, w1, b1, w2 = _geglu_weights(g, cuda, dtype, M, dim)
    dy = _randn(g, cuda, dtype, M, dim)
    if dtype == torch.bfloat16 and dim % 8:
        with pytest.raises(ValueError):
            cuda_geglu.geglu_dx(x, w1, b1, w2, dy)
        return
    design = "wgmma" if dtype == torch.bfloat16 else "simt"
    before = cuda_geglu.geglu_dx.launches
    by_design = dict(cuda_geglu.geglu_dx.launches_by_design)
    got = cuda_geglu.geglu_dx(x, w1, b1, w2, dy)
    assert cuda_geglu.geglu_dx.launches == before + 1
    assert cuda_geglu.geglu_dx.launches_by_design == {**by_design, design: by_design[design] + 1}
    _check(got, cuda_geglu.geglu_dx_plain(x, w1, b1, w2, dy), "geglu")
    assert torch.equal(got, cuda_geglu.geglu_dx(x, w1, b1, w2, dy))


@pytest.mark.gpu
@pytest.mark.parametrize("L,dim", [(4096, 320), (1024, 640), (256, 1280), (64, 1280)])
def test_geglu_wgmma_kernels_repeat_bit_for_bit(cuda, L, dim):
    """20 launches of the wgmma GEGLU forward and dx at each SD site (2
    prompts: M = 4·L) give the same bits: a ring stage read before its copy
    landed, or released before its last product, shows up as bits that
    differ between launches."""
    g = torch.Generator(device=cuda).manual_seed(L + dim + 9)
    x, w1, b1, w2 = _geglu_weights(g, cuda, torch.bfloat16, 4 * L, dim)
    b2, dy = _randn(g, cuda, torch.bfloat16, dim, scale=0.1), _randn(g, cuda, torch.bfloat16, 4 * L, dim)
    fwd, dx_before = dict(cuda_geglu.geglu_ff.launches_by_design), dict(cuda_geglu.geglu_dx.launches_by_design)
    out = cuda_geglu.geglu_ff(x, w1, b1, w2, b2, x)
    dx = cuda_geglu.geglu_dx(x, w1, b1, w2, dy)
    for _ in range(20):
        assert torch.equal(out, cuda_geglu.geglu_ff(x, w1, b1, w2, b2, x))
        assert torch.equal(dx, cuda_geglu.geglu_dx(x, w1, b1, w2, dy))
    assert cuda_geglu.geglu_ff.launches_by_design == {**fwd, "wgmma": fwd["wgmma"] + 21}
    assert cuda_geglu.geglu_dx.launches_by_design == {**dx_before, "wgmma": dx_before["wgmma"] + 21}


@pytest.mark.gpu
@pytest.mark.parametrize("Lq,inner", [(4096, 320), (1024, 640), (256, 1280), (64, 1280)])
def test_spacetime_wgmma_kernels_repeat_bit_for_bit(cuda, Lq, inner):
    """20 launches of the wgmma spacetime forward and dq pass at each SD site
    (2 prompts, 4 objects) give the same bits: a ring stage read before its
    copy landed or released before its last product, or warpgroup 1's
    hand-off read before it was written, shows up as bits that differ."""
    g = torch.Generator(device=cuda).manual_seed(Lq + inner + 9)
    args = _spacetime_args(g, cuda, torch.bfloat16, 2, 4, Lq, 77, inner)
    gbar = _randn(g, cuda, torch.bfloat16, 2, Lq, inner)
    fwd = dict(cuda_spacetime.fused_spacetime_attention.launches_by_design)
    bwd = dict(cuda_spacetime.spacetime_bwd.launches_by_design)
    out = cuda_spacetime.fused_spacetime_attention(*args, 8)
    dq, t = cuda_spacetime.spacetime_bwd_raw(*args, 8, gbar, need_kv=False)[:2]
    for _ in range(20):
        assert torch.equal(out, cuda_spacetime.fused_spacetime_attention(*args, 8))
        again = cuda_spacetime.spacetime_bwd_raw(*args, 8, gbar, need_kv=False)
        assert torch.equal(dq, again[0]) and torch.equal(t, again[1])
    assert cuda_spacetime.fused_spacetime_attention.launches_by_design == {
        **fwd, "wgmma": fwd["wgmma"] + 21}
    assert cuda_spacetime.spacetime_bwd.launches_by_design == {**bwd, "wgmma": bwd["wgmma"] + 21}


def _grads(fn, args, seed=3):
    """Gradients of sum(fn(*args) * w) with respect to every float tensor."""
    leaves = [a.detach().clone().requires_grad_(True) if torch.is_tensor(a) else a
              for a in args]
    out = fn(*leaves)
    w = torch.randn(out.shape, generator=torch.Generator(device=out.device).manual_seed(seed),
                    device=out.device).to(out.dtype)
    (out * w).sum().backward()
    return [a.grad for a in leaves if torch.is_tensor(a)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["spacetime", "geglu", "mha", "flash"])
def test_autograd_functions_match_plain_autograd(cuda, kind):
    """float32 on the card: the gradient through each kernel wrapper (kernel
    forward, kernel or plain backward) equals autograd of its plain forward
    within 1e-4 + 1e-4·|plain|, and the backward kernel is launched."""
    g = torch.Generator(device=cuda).manual_seed(11)
    dt = torch.float32
    if kind == "spacetime":
        args = _spacetime_args(g, cuda, dt, 2, 3, 256, 77, 320)
        kern = lambda *a: cuda_spacetime.fused_spacetime_attention(*a, 8)  # noqa: E731
        plain = lambda *a: cuda_spacetime.spacetime_plain(*a, 8)  # noqa: E731
        counter = cuda_spacetime.spacetime_bwd
    elif kind == "geglu":
        dim, inner = 64, 256
        args = (_randn(g, cuda, dt, 2, 50, dim), _randn(g, cuda, dt, 2 * inner, dim, scale=0.1),
                _randn(g, cuda, dt, 2 * inner, scale=0.1), _randn(g, cuda, dt, dim, inner,
                                                                    scale=0.05),
                _randn(g, cuda, dt, dim, scale=0.1), _randn(g, cuda, dt, 2, 50, dim))
        kern, plain, counter = cuda_geglu.geglu_ff, cuda_geglu.geglu_plain, cuda_geglu.geglu_dx
    elif kind == "mha":
        args = tuple(_randn(g, cuda, dt, 2, 128, 64) for _ in range(3))
        kern = lambda *a: cuda_mha.mha_attention(*a, 2)  # noqa: E731
        plain = lambda *a: cuda_mha.mha_attention_plain(*a, 2)  # noqa: E731
        counter = None
    else:
        args = tuple(_randn(g, cuda, dt, 2, 1024, 64) for _ in range(3))
        kern = lambda *a: cuda_flash.flash_attention(*a, 2)  # noqa: E731
        plain = lambda *a: cuda_mha.mha_attention_plain(*a, 2)  # noqa: E731
        counter = cuda_flash.flash_bwd
    before = None if counter is None else counter.launches
    got, want = _grads(kern, args), _grads(plain, args)
    if counter is not None:
        assert counter.launches == before + 1
    for a, b in zip(got, want):
        _check(a, b, kind)


@pytest.mark.gpu
def test_kernel_outputs_carry_a_gradient(cuda):
    """The fault the wrappers had before they became autograd Functions: a
    kernel output on a CUDA tensor that requires grad had no grad_fn, and
    the gradient was dropped without an error."""
    x = torch.randn(2, 64, 64, device=cuda, requires_grad=True)
    w1 = torch.randn(512, 64, device=cuda) * 0.1
    b1, w2, b2 = torch.zeros(512, device=cuda), torch.randn(64, 256, device=cuda) * 0.1, \
        torch.zeros(64, device=cuda)
    for out in (cuda_mha.mha_attention(x, x, x, 2), cuda_geglu.geglu_ff(x, w1, b1, w2, b2, x),
                cuda_flash.flash_attention(x, x, x, 2)):
        assert out.grad_fn is not None
        (grad,) = torch.autograd.grad(out.sum(), x)
        assert float(grad.abs().sum()) > 0
    # the flash backward returns dq, dk and dv, with the same bits on a repeat
    xb = x.detach().bfloat16().requires_grad_(True)
    kb, vb = (torch.randn(2, 64, 64, device=cuda).bfloat16().requires_grad_(True)
              for _ in range(2))
    gbar = torch.randn(2, 64, 64, device=cuda).bfloat16()
    first = torch.autograd.grad(cuda_flash.flash_attention(xb, kb, vb, 2), (xb, kb, vb), gbar)
    second = torch.autograd.grad(cuda_flash.flash_attention(xb, kb, vb, 2), (xb, kb, vb), gbar)
    for a, b in zip(first, second):
        assert float(a.float().abs().sum()) > 0 and torch.equal(a, b)


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_bad_input(cuda):
    q = torch.randn(1, 64, 64, device=cuda)
    before = cuda_mha.mha_attention.launches
    cuda_mha.mha_attention(q, q, q, 2)
    assert cuda_mha.mha_attention.launches == before + 1
    with pytest.raises(TypeError):
        cuda_mha.mha_attention(q.half(), q.half(), q.half(), 2)
    with pytest.raises(ValueError):
        cuda_mha.mha_attention(q.transpose(1, 2), q, q, 2)
    wide = torch.zeros(1, 8, 400, device=cuda)   # head width 200 > 160
    with pytest.raises(ValueError):
        cuda_mha.mha_attention(wide, wide, wide, 2)
    assert cuda_mha.mha_attention.launches == before + 1
    flash_before = cuda_flash.flash_attention.launches
    with pytest.raises(ValueError):              # head width 160 > 128
        cuda_flash.flash_attention(wide[..., :320], wide[..., :320], wide[..., :320], 2)
    with pytest.raises(TypeError):
        cuda_flash.flash_attention(q, q.bfloat16(), q.bfloat16(), 2)
    assert cuda_flash.flash_attention.launches == flash_before
    # bfloat16 GEGLU on the tensor cores (TMA) needs 16-byte aligned operands
    dim, inner = 64, 256
    x = torch.zeros(4 * dim + 1, dtype=torch.bfloat16, device=cuda)[1:].view(4, dim)
    w1 = torch.zeros(2 * inner, dim, dtype=torch.bfloat16, device=cuda)
    w2 = torch.zeros(dim, inner, dtype=torch.bfloat16, device=cuda)
    b1, b2 = w1[:, 0].contiguous(), w2[:, 0].contiguous()
    ff_before = cuda_geglu.geglu_ff.launches, dict(cuda_geglu.geglu_ff.launches_by_design)
    with pytest.raises(ValueError):
        cuda_geglu.geglu_ff(x, w1, b1, w2, b2)
    with pytest.raises(ValueError):
        cuda_geglu.geglu_ff(x.clone(), w1, b1[:-8], w2, b2)
    assert (cuda_geglu.geglu_ff.launches, cuda_geglu.geglu_ff.launches_by_design) == ff_before
    # bfloat16 spacetime attention (TMA) needs head widths that are multiples
    # of 8 and 16-byte aligned operands; nothing is launched otherwise
    g = torch.Generator(device=cuda).manual_seed(2)
    st = _spacetime_args(g, cuda, torch.bfloat16, 1, 2, 64, 77, 64)
    st_before = (cuda_spacetime.fused_spacetime_attention.launches,
                 dict(cuda_spacetime.fused_spacetime_attention.launches_by_design))
    odd = torch.zeros(64 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(1, 64, 64)
    with pytest.raises(ValueError):
        cuda_spacetime.fused_spacetime_attention(odd, *st[1:], 4)
    with pytest.raises(ValueError):              # dh 20
        cuda_spacetime.fused_spacetime_attention(*(t[..., :60].contiguous() for t in st[:6]),
                                                 *st[6:], 3)
    with pytest.raises(ValueError):
        cuda_spacetime.spacetime_bwd(odd, *st[1:], 4, odd.clone())
    assert (cuda_spacetime.fused_spacetime_attention.launches,
            cuda_spacetime.fused_spacetime_attention.launches_by_design) == st_before


@pytest.mark.gpu
def test_unet_kernels_on_matches_off(cuda):
    """A small UNet in float32 with the three kernel flags on and off."""
    from diffusion_spacetime_attn_tpu_torch.config import UNetConfig
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.ops.attention import SpatialControl
    from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_

    small = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1, 2), num_heads=2, context_dim=32)
    with torch.device(cuda):
        on = UNet(UNetConfig(use_mha=True, use_fused_ff=True, use_fused_control=True, **small))
        off = UNet(UNetConfig(**small))
    randomize_(on, seed=3, scale=0.2)
    off.load_state_dict(on.state_dict())
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 16, 16, 4), generator=g, device=cuda)
    t = torch.full((4,), 501, dtype=torch.int32, device=cuda)
    ctx = torch.randn((4, 12, 32), generator=g, device=cuda)
    ctl = SpatialControl(torch.randn((2, 2, 12, 32), generator=g, device=cuda),
                         torch.rand((2, 2, 2), generator=g, device=cuda),
                         torch.full((2, 2), 1.5, device=cuda), torch.ones((2, 2), device=cuda))
    counts = [w.launches for w in (cuda_mha.mha_attention, cuda_geglu.geglu_ff,
                                   cuda_spacetime.fused_spacetime_attention)]
    with torch.inference_mode():
        a, b = on(x, t, ctx, ctl), off(x, t, ctx, ctl)
    after = [w.launches for w in (cuda_mha.mha_attention, cuda_geglu.geglu_ff,
                                  cuda_spacetime.fused_spacetime_attention)]
    assert [y - x_ for x_, y in zip(counts, after)] == [7, 7, 7]  # 7 transformer sites
    _check(a, b, "unet")  # float32: 1e-4 per element


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,dim", [(16384, 320), (4096, 640), (1024, 1280), (256, 1280)])
def test_geglu_weight_gradients_at_sd_training_sites(cuda, dtype, M, dim):
    """The GEGLU autograd Function at the SD v1-4 training sites (batch 4,
    M = 4·L): dx (the dx kernel), dW1, db1, dW2, db2 (plain products, as JAX
    takes them outside its Pallas body) and the residual's cotangent against
    autograd of the plain forward on the same inputs, with the kernel
    forward; tolerances of `compare` ("geglu": float32 1e-4 + 1e-4·|plain|;
    bf16 2 % of rms + 2^-6·|plain| and 1e-2 in relative norm)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x, w1, b1, w2 = _geglu_weights(g, cuda, dtype, M, dim)
    args = (x, w1, b1, w2, _randn(g, cuda, dtype, dim, scale=0.1), _randn(g, cuda, dtype, M, dim))
    before = (cuda_geglu.geglu_ff.launches, cuda_geglu.geglu_dx.launches)
    got = _grads(cuda_geglu.geglu_ff, args)
    want = _grads(cuda_geglu.geglu_plain, [a.float() for a in args])
    assert (cuda_geglu.geglu_ff.launches, cuda_geglu.geglu_dx.launches) == \
        (before[0] + 1, before[1] + 1)
    for name, a, b in zip(("dx", "dW1", "db1", "dW2", "db2", "dres"), got, want):
        assert a.dtype == dtype, name
        cmp = compare(a, b.to(dtype), "geglu")
        assert cmp["ok"], (name, cmp)


@pytest.mark.gpu
def test_flash_gradients_inside_a_training_step(cuda):
    """One LDM training step (float32, AdamW) of a small UNet whose level-0
    self-attention sees 1024 tokens, so it takes the flash kernels forward
    and backward, and whose feed-forward takes the GEGLU kernels, against
    the same step with the flags off: the loss, every parameter's gradient
    (the attention projections carry flash's dq, dK and dV) within 1e-4
    relative in norm, the updated weights within 1e-4 + 1e-4·|plain|, and
    one flash backward and one GEGLU dx launch per site.

    The weights are held where the step is well conditioned, as the CPU
    training tests hold them.  AdamW's first step moves an element by
    lr·g/(|g| + 1e-8): below |g| ~ 1e-6 that is linear in g with gain
    lr/1e-8, so gradients that agree to 1e-4 in norm give steps 1e-4 apart
    (one element of time_embed_2's weight, |g| ~ 1e-9 against its
    gradient's norm of 0.3, moved 2.7e-4 apart on the card).  Neither
    path's gradients repeat bit for bit from run to run on the card, so
    which element crosses the bound changes from run to run.  An element
    whose plain gradient exceeds 1e-6 and twice the gradients' whole
    difference keeps its sign on both paths, and its steps differ by at most
    2·lr·1e-8/|g| ≤ 2e-5."""
    from diffusion_spacetime_attn_tpu_torch.config import LDMTrainConfig, ScheduleConfig, UNetConfig
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
    from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
    from diffusion_spacetime_attn_tpu_torch.training import ldm_trainer as tldm
    from diffusion_spacetime_attn_tpu_torch.utils import prng
    from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_

    small = dict(model_channels=64, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1, 2), num_heads=2, context_dim=32)
    with torch.device(cuda):
        on = UNet(UNetConfig(use_flash=True, use_fused_ff=True, **small))
        off = UNet(UNetConfig(**small))
    randomize_(on, seed=4, scale=0.2)
    off.load_state_dict(on.state_dict())
    g = torch.Generator(device=cuda).manual_seed(1)
    x0 = torch.randn((2, 32, 32, 4), generator=g, device=cuda)
    ctx = torch.randn((2, 12, 32), generator=g, device=cuda)
    cfg, sched_cfg = LDMTrainConfig(batch_size=2, use_ema=False), ScheduleConfig()
    sched = make_schedule(sched_cfg, 50, device=cuda)
    lvlb = torch.from_numpy(tldm.lvlb_weights(sched_cfg)).to(cuda)
    out = {}
    for name, model in (("on", on), ("off", off)):
        state = tldm.init_state(cfg, sched_cfg, model, 1e-3)
        counts = (cuda_flash.flash_bwd.launches, cuda_geglu.geglu_dx.launches)
        loss, _ = tldm.p_losses(cfg, sched, lvlb, model, state.logvar, x0, ctx, prng.PRNGKey(2))
        loss.backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        state.opt_state.update()
        out[name] = (loss.detach(), grads, model.state_dict(),
                     (cuda_flash.flash_bwd.launches - counts[0],
                      cuda_geglu.geglu_dx.launches - counts[1]))
    (l_on, g_on, p_on, n_on), (l_off, g_off, p_off, n_off) = out["on"], out["off"]
    assert n_on == (3, 7) and n_off == (0, 0)   # 3 blocks at level 0 of 7
    assert abs(float(l_on - l_off)) <= 1e-5 * abs(float(l_off))
    held = 0
    for k in g_off:
        err = torch.linalg.vector_norm(g_on[k] - g_off[k])
        assert float(err) <= 1e-4 * float(torch.linalg.vector_norm(g_off[k])) + 1e-12, k
        sure = g_off[k].abs() > torch.clamp(2 * err, min=1e-6)
        if sure.any():
            _check(p_on[k][sure], p_off[k][sure], "geglu")
        held += int(sure.sum())
    total = sum(g.numel() for g in g_off.values())
    assert held >= 0.75 * total, (held, total)


# ------------------------------------------------------------ no card needed


def _bf16(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen) * scale).to(torch.bfloat16)


def _bf16_cases(kind):
    """(plain bfloat16 output, the same math in float32 rounded once, and
    outputs with planted faults) at small shapes on the CPU."""
    gen = torch.Generator().manual_seed(0)
    f32 = lambda ts: [t.float() for t in ts]  # noqa: E731
    if kind == "mha":
        q, k, v = (_bf16(gen, 2, 256, 320) for _ in range(3))
        plain = lambda q_, k_, v_: cuda_mha.mha_attention_plain(q_, k_, v_, 8)  # noqa: E731
        faults = {"skip_key_tile": plain(q, k[:, :192].contiguous(), v[:, :192].contiguous()),
                  "scale_x1.05": plain((q.float() * 1.05).bfloat16(), k, v)}
        return plain(q, k, v), plain(*f32((q, k, v))).bfloat16(), faults
    if kind == "geglu":
        M, dim, inner = 256, 64, 256
        args = (_bf16(gen, M, dim), _bf16(gen, 2 * inner, dim, scale=dim ** -0.5),
                _bf16(gen, 2 * inner, scale=0.1), _bf16(gen, dim, inner, scale=inner ** -0.5),
                _bf16(gen, dim, scale=0.1), _bf16(gen, M, dim))
        w2 = args[3].clone()
        w2[:, :64] = 0
        faults = {"skip_inner_tile": cuda_geglu.geglu_plain(*args[:3], w2, *args[4:])}
        return (cuda_geglu.geglu_plain(*args), cuda_geglu.geglu_plain(*f32(args)).bfloat16(),
                faults)
    if kind == "flash":
        # the kernel's forward rounds p to bf16 before the PV product (its
        # running max taken over the whole row here); splash keeps p in f32
        q, k, v = (_bf16(gen, 2, 1024, 320) for _ in range(3))

        def p_rounded(q_, k_, v_):
            qf, kf, vf = (cuda_flash._fold(t, 8).float()
                          for t in (cuda_flash.scaled_query(q_, k_, 8), k_, v_))
            s = qf @ kf.transpose(1, 2)
            p = torch.exp(s - s.amax(dim=-1, keepdim=True))
            o = (p.bfloat16().float() @ vf) / p.sum(dim=-1, keepdim=True)
            return cuda_flash._unfold(o.bfloat16(), 2)

        plain = lambda *a: cuda_flash.flash_attention_plain(*a, 8)[0]  # noqa: E731
        faults = {"skip_key_tile": plain(q, k[:, :-64].contiguous(), v[:, :-64].contiguous())}
        return plain(q, k, v), p_rounded(q, k, v), faults
    B, N, Lq, inner = 1, 4, 256, 320
    ts = [_bf16(gen, B, Lq, inner), _bf16(gen, B, Lq, inner), _bf16(gen, B, 77, inner),
          _bf16(gen, B, 77, inner), _bf16(gen, B, N, 77, inner), _bf16(gen, B, N, 77, inner)]
    masks = flat_circular_mask(torch.rand((B, N, 2), generator=gen), 16, 0.2)
    rest = (masks, torch.full((B, N), 1.25), 8)
    ctx = [t[..., :64, :].contiguous() for t in ts[2:]]
    # object 2's K/V served from object 1's ring stage (a stale context)
    stale = [t.clone() for t in ts[4:]]
    for t in stale:
        t[:, 1] = t[:, 0]
    if kind == "spacetime_bwd":
        # the wgmma dq pass rounds ds to bf16 as the A operand of ds·K
        g = _bf16(gen, B, Lq, inner)
        return (cuda_spacetime.spacetime_bwd_plain(*ts, *rest, g)[0],
                _spacetime_dq_ds_rounded(*ts, *rest, g),
                {"stale_ring_stage_for_object_2":
                 cuda_spacetime.spacetime_bwd_plain(*ts[:4], *stale, *rest, g)[0]})
    faults = {"first_key_tile_only": cuda_spacetime.spacetime_plain(*ts[:2], *ctx, *rest),
              "stale_ring_stage_for_object_2": cuda_spacetime.spacetime_plain(*ts[:4], *stale,
                                                                             *rest)}
    if kind == "spacetime_wgmma":
        # the wgmma forward rounds P′ = (w / rowsum)·p to bf16 before P′·V
        return (cuda_spacetime.spacetime_plain(*ts, *rest), _spacetime_p_rounded(*ts, *rest),
                faults)
    return (cuda_spacetime.spacetime_plain(*ts, *rest),
            cuda_spacetime.spacetime_plain(*f32(ts), *rest).bfloat16(), faults)


def _spacetime_heads(x, heads):
    """[..., L, inner] -> [..., H, L, dh] in float32."""
    return x.float().reshape(*x.shape[:-1], heads, -1).transpose(-2, -3)


def _spacetime_probs(q, k, heads):
    """Softmax of every context [B, N+1, H, Lq, Lk] in float32 (k: [B, N+1,
    Lk, inner])."""
    qh, kh = _spacetime_heads(q, heads), _spacetime_heads(k, heads)
    s = torch.einsum("bhqd,bchkd->bchqk", qh, kh) * qh.shape[-1] ** -0.5
    return torch.softmax(s, dim=-1)


def _spacetime_p_rounded(q_c, g_u, kc, vc, lk, lv, masks, coef, heads):
    """The wgmma forward's arithmetic: f32 scores and softmax, the blend
    weight folded into p, P′ rounded to bf16, f32 accumulation, the output
    rounded once."""
    k, v = torch.cat([kc[:, None], lk], 1), torch.cat([vc[:, None], lv], 1)
    w = torch.cat([torch.ones_like(masks[:, :1]), masks * coef[..., None]], 1)  # [B, N+1, Lq]
    p = _spacetime_probs(q_c, k, heads) * w[:, :, None, :, None]
    acc = torch.einsum("bchqk,bchkd->bhqd", p.bfloat16().float(), _spacetime_heads(v, heads))
    out = acc - w[:, 1:].sum(1)[:, None, :, None] * _spacetime_heads(g_u, heads)
    return out.transpose(1, 2).reshape(q_c.shape).bfloat16()


def _spacetime_dq_ds_rounded(q_c, g_u, kc, vc, lk, lv, masks, coef, heads, g):
    """The wgmma dq pass's arithmetic: f32 p, e and rowsum(p ⊙ e), scale·ds
    rounded to bf16, f32 accumulation of ds·K, dq rounded once."""
    k, v = torch.cat([kc[:, None], lk], 1), torch.cat([vc[:, None], lv], 1)
    w = torch.cat([torch.ones_like(masks[:, :1]), masks * coef[..., None]], 1)
    p = _spacetime_probs(q_c, k, heads)
    gh = _spacetime_heads(g, heads)
    e = torch.einsum("bhqd,bchkd->bchqk", gh, _spacetime_heads(v, heads))
    r = (p * e).sum(-1, keepdim=True)
    ds = w[:, :, None, :, None] * p * (e - r) * gh.shape[-1] ** -0.5
    dq = torch.einsum("bchqk,bchkd->bhqd", ds.bfloat16().float(), _spacetime_heads(k, heads))
    return dq.transpose(1, 2).reshape(q_c.shape).bfloat16()


@pytest.mark.parametrize("kind", ["mha", "geglu", "spacetime", "flash", "spacetime_wgmma",
                                  "spacetime_bwd"])
def test_bf16_comparison_passes_one_rounding_and_rejects_planted_faults(kind):
    """The kernels compute in float32 and round once (the flash forward also
    rounds p, the wgmma spacetime forward P′ and its dq pass ds); `compare`
    must take that rounding difference and reject a dropped key or inner
    tile, a wrong softmax scale or a stale context (the card's smoke test
    repeats this at SD shapes)."""
    want, rounded_once, faults = _bf16_cases(kind)
    cmp_kind = {"spacetime_wgmma": "spacetime"}.get(kind, kind)
    cmp = compare(rounded_once, want, cmp_kind)
    assert cmp["ok"], cmp
    assert cmp["rel_norm"] < cmp["rel_norm_limit"] / 2, cmp    # a margin of 2x at least
    for name, out in faults.items():
        assert not compare(out, want, cmp_kind)["ok"], name


@pytest.mark.parametrize("case,kernel,dtype,H,inner,want", [
    ("SD level 0", "flash", torch.bfloat16, 8, 320, "wgmma"),     # dh 40
    ("SD level 0, serving", "mha", torch.bfloat16, 8, 320, "wgmma"),
    ("SD level 1", "flash", torch.bfloat16, 8, 640, "wgmma"),     # dh 80
    ("SD level 1, serving", "mha", torch.bfloat16, 8, 640, "wgmma"),
    ("dh 64", "flash", torch.bfloat16, 2, 128, "wgmma"),
    ("dh 128", "mha", torch.bfloat16, 2, 256, "wgmma"),
    ("SD level 2 and mid", "mha", torch.bfloat16, 8, 1280, "wgmma"),    # dh 160
    ("RDM, every level", "mha", torch.bfloat16, 14, 448, "wgmma"),      # dh 32
    ("dh 160, flash", "flash", torch.bfloat16, 8, 1280, "mma_sync"),   # flash_ok never takes it
    ("dh 32, flash", "flash", torch.bfloat16, 14, 448, "mma_sync"),
    ("stride not a multiple of 16 bytes", "mha", torch.bfloat16, 3, 60, "mma_sync"),  # dh 20
    ("dh 48", "mha", torch.bfloat16, 2, 96, "mma_sync"),
    ("dh 16", "mha", torch.bfloat16, 2, 32, "mma_sync"),
    ("float32", "mha", torch.float32, 8, 320, "simt"),
    ("float32, dh 32", "mha", torch.float32, 14, 448, "simt"),
    ("float32, flash", "flash", torch.float32, 8, 640, "simt"),
])
def test_attention_design_by_shape(case, kernel, dtype, H, inner, want):
    """The wrappers pick the kernel design from the shape before launch:
    every SD v1-4 main-path site of flash (levels 0 and 1) and of the MHA
    forward (every level) and every RDM site of the MHA forward takes the
    wgmma kernels in bf16; float32, head widths TMA cannot describe and
    widths the wgmma kernels are not built for take the synchronous ones."""
    assert cuda_mha.attention_design(kernel, dtype, inner // H) == want, case
    if want == "wgmma":   # an unaligned base pointer cannot be a TMA tensor
        assert cuda_mha.attention_design(kernel, dtype, inner // H, aligned=False) == "mma_sync"


@pytest.mark.parametrize("counter", ["flash_attention", "flash_bwd", "mha_attention"])
def test_design_counters_start_at_zero_and_cpu_calls_count_nothing(counter):
    wrapper = {"flash_attention": cuda_flash.flash_attention, "flash_bwd": cuda_flash.flash_bwd,
               "mha_attention": cuda_mha.mha_attention}[counter]
    assert set(wrapper.launches_by_design) == set(cuda_mha.DESIGNS)
    before = dict(wrapper.launches_by_design), wrapper.launches
    gen = torch.Generator().manual_seed(1)
    q, k, v, g = (_bf16(gen, 1, 64, 64) for _ in range(4))
    o = cuda_flash.flash_attention(q, k, v, 2)
    cuda_mha.mha_attention(q, k, v, 2)
    cuda_flash.flash_bwd(q, k, v, o, cuda_flash.flash_fwd(q, k, v, 2)[1], g, 2)
    assert (dict(wrapper.launches_by_design), wrapper.launches) == before
    if not torch.cuda.is_available():     # this process launched nothing
        assert set(wrapper.launches_by_design.values()) == {0} and wrapper.launches == 0


@pytest.mark.parametrize("case,dtype,dim,inner,aligned,want", [
    ("SD level 0", torch.bfloat16, 320, 1280, True, "wgmma"),
    ("SD level 1", torch.bfloat16, 640, 2560, True, "wgmma"),
    ("SD level 2 and mid", torch.bfloat16, 1280, 5120, True, "wgmma"),
    ("widths not multiples of 64", torch.bfloat16, 40, 160, True, "wgmma"),
    ("an operand TMA cannot describe", torch.bfloat16, 320, 1280, False, None),
    ("dim not a multiple of 8", torch.bfloat16, 36, 144, True, None),
    ("inner not a multiple of 8", torch.bfloat16, 64, 260, True, None),
    ("float32", torch.float32, 320, 1280, True, "simt"),
    ("float32, unaligned and ragged", torch.float32, 36, 144, False, "simt"),
])
def test_geglu_design_by_shape(case, dtype, dim, inner, aligned, want):
    """Every SD v1-4 GEGLU site (dim 320, 640, 1280; inner 4·dim) takes the
    wgmma kernels in bf16; float32 takes the CUDA cores; no kernel takes
    other bf16 inputs (None: raises)."""
    if want is None:
        with pytest.raises(ValueError):
            cuda_geglu.geglu_design(dtype, dim, inner, aligned)
    else:
        assert cuda_geglu.geglu_design(dtype, dim, inner, aligned) == want, case


@pytest.mark.parametrize("counter", ["geglu_ff", "geglu_dx"])
def test_geglu_design_counters_start_at_zero_and_cpu_calls_count_nothing(counter):
    wrapper = getattr(cuda_geglu, counter)
    assert set(wrapper.launches_by_design) == set(cuda_geglu.DESIGNS)
    before = dict(wrapper.launches_by_design), wrapper.launches
    gen = torch.Generator().manual_seed(4)
    x, dy = _bf16(gen, 8, 64), _bf16(gen, 8, 64)
    w1, b1 = _bf16(gen, 512, 64, scale=0.1), _bf16(gen, 512, scale=0.1)
    w2, b2 = _bf16(gen, 64, 256, scale=0.1), _bf16(gen, 64, scale=0.1)
    cuda_geglu.geglu_ff(x, w1, b1, w2, b2, x)
    cuda_geglu.geglu_dx(x, w1, b1, w2, dy)
    assert (dict(wrapper.launches_by_design), wrapper.launches) == before
    if not torch.cuda.is_available():     # this process launched nothing
        assert set(wrapper.launches_by_design.values()) == {0} and wrapper.launches == 0


@pytest.mark.parametrize("case,dtype,dh,Lk,aligned,want", [
    ("SD level 0", torch.bfloat16, 40, 77, True, "wgmma"),
    ("SD level 1", torch.bfloat16, 80, 77, True, "wgmma"),
    ("SD level 2 and mid", torch.bfloat16, 160, 77, True, "wgmma"),
    ("dh 64, the longest context", torch.bfloat16, 64, 80, True, "wgmma"),
    ("dh 8, one key", torch.bfloat16, 8, 1, True, "wgmma"),
    ("dh not a multiple of 8", torch.bfloat16, 20, 77, True, None),
    ("dh past 160", torch.bfloat16, 168, 77, True, None),
    ("a context of 81 keys", torch.bfloat16, 40, 81, True, None),
    ("an operand TMA cannot describe", torch.bfloat16, 40, 77, False, None),
    ("float32", torch.float32, 40, 77, True, "simt"),
    ("float32, unaligned and ragged", torch.float32, 20, 12, False, "simt"),
])
def test_spacetime_design_by_shape(case, dtype, dh, Lk, aligned, want):
    """Every SD v1-4 spacetime site (dh 40, 80, 160; 77 keys) takes the
    wgmma kernels in bf16; float32 takes the CUDA cores; no kernel takes
    other bf16 inputs (None: raises)."""
    if want is None:
        with pytest.raises(ValueError):
            cuda_spacetime.spacetime_design(dtype, dh, Lk, aligned)
    else:
        assert cuda_spacetime.spacetime_design(dtype, dh, Lk, aligned) == want, case


@pytest.mark.parametrize("counter", ["fused_spacetime_attention", "spacetime_bwd"])
def test_spacetime_design_counters_start_at_zero_and_cpu_calls_count_nothing(counter):
    wrapper = getattr(cuda_spacetime, counter)
    assert set(wrapper.launches_by_design) == set(cuda_spacetime.DESIGNS)
    before = dict(wrapper.launches_by_design), wrapper.launches
    gen = torch.Generator().manual_seed(5)
    args = [_bf16(gen, 1, 16, 64), _bf16(gen, 1, 16, 64), _bf16(gen, 1, 12, 64),
            _bf16(gen, 1, 12, 64), _bf16(gen, 1, 2, 12, 64), _bf16(gen, 1, 2, 12, 64),
            torch.rand((1, 2, 16), generator=gen), torch.rand((1, 2), generator=gen)]
    cuda_spacetime.fused_spacetime_attention(*args, 2)
    cuda_spacetime.spacetime_bwd(*args, 2, _bf16(gen, 1, 16, 64), need_kv=False)
    assert (dict(wrapper.launches_by_design), wrapper.launches) == before
    if not torch.cuda.is_available():     # this process launched nothing
        assert set(wrapper.launches_by_design.values()) == {0} and wrapper.launches == 0


def test_spacetime_backward_skips_dmasks_unless_asked():
    """The autograd backward computes dmasks only when the masks need a
    gradient (the main path's masks never do)."""
    gen = torch.Generator().manual_seed(6)
    args = [torch.randn(s, generator=gen) for s in
            ((1, 16, 64), (1, 16, 64), (1, 12, 64), (1, 12, 64), (1, 2, 12, 64), (1, 2, 12, 64))]
    masks, coef = torch.rand((1, 2, 16), generator=gen), torch.rand((1, 2), generator=gen)
    g = torch.randn((1, 16, 64), generator=gen)
    full = cuda_spacetime.spacetime_bwd(*args, masks, coef, 2, g, need_kv=False)
    short = cuda_spacetime.spacetime_bwd(*args, masks, coef, 2, g, need_kv=False,
                                         need_masks=False)
    assert full[6] is not None and short[6] is None
    assert all(torch.equal(a, b) for a, b in zip(full[:2] + full[7:], short[:2] + short[7:]))
    for want_masks in (False, True):
        m = masks.clone().requires_grad_(want_masks)
        c = coef.clone().requires_grad_(True)
        out = cuda_spacetime.fused_spacetime_attention(*args, m, c, 2)
        (out * g).sum().backward()
        assert (m.grad is not None) == want_masks and c.grad is not None
        if want_masks:
            assert torch.allclose(m.grad, full[6], atol=1e-6)
        assert torch.allclose(c.grad, full[7], atol=1e-6)


def test_c_entry_points_match_ctypes_signatures():
    """Every `extern "C"` entry in csrc has a ctypes signature with as many
    arguments, and every signature names an entry (no nvcc here to check)."""
    found = {}
    for src in sorted(cuda_lib.CSRC.glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    assert found == {k: len(v) for k, v in cuda_lib.SIGNATURES.items()}


def test_importing_the_kernels_builds_nothing():
    code = ("import diffusion_spacetime_attn_tpu_torch.models.unet\n"
            "from diffusion_spacetime_attn_tpu_torch.ops import cuda_lib\n"
            "print('lib' in cuda_lib._state)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=Path(__file__).resolve().parent.parent)
    assert out.stdout.strip() == "False"
    assert {p.name for p in cuda_lib.CSRC.glob("*.cu")} == {
        "mha_fwd.cu", "spacetime_fwd.cu", "spacetime_bwd.cu", "geglu_fwd.cu", "geglu_bwd.cu",
        "flash_fwd.cu", "flash_bwd.cu"}
    assert {p.name for p in cuda_lib.CSRC.glob("*.cuh")} == {
        "common.cuh", "attn_fwd.cuh", "hopper.cuh"}
    assert Path(cuda_lib.BUILD_DIR).name == "_build"
