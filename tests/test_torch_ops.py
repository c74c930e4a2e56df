"""PyTorch port, ops layer: schedule, masks, attention and the plain versions
of the three CUDA kernels, each held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both sides.  f32
tolerances: the schedule and masks must match bit for bit (same float64 host
math, same float32 ops); attention paths agree to ~1e-5 (same math, sums
taken in another order by XLA and by PyTorch); the GEGLU comparison allows
for the JAX kernel's erf polynomial (6e-7 off, `pallas_geglu.py:102-103`).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.config import ScheduleConfig as JScheduleConfig
from diffusion_spacetime_attn_tpu.ops.pallas_geglu import geglu_ff as j_geglu_ff
from diffusion_spacetime_attn_tpu.ops.pallas_mha import mha_attention as j_mha_attention
from diffusion_spacetime_attn_tpu.ops.pallas_spacetime import (
    fused_spacetime_attention_interpret as j_spacetime_interpret,
)
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.ops import attention as tatt
from diffusion_spacetime_attn_tpu_torch.ops import masks as tmasks
from diffusion_spacetime_attn_tpu_torch.ops import schedule as tsched
from diffusion_spacetime_attn_tpu_torch.ops.cuda_geglu import geglu_cost, geglu_ff, geglu_plain
from diffusion_spacetime_attn_tpu_torch.ops.cuda_mha import mha_attention, mha_cost
from diffusion_spacetime_attn_tpu_torch.ops.cuda_spacetime import (
    fused_spacetime_attention,
    spacetime_cost,
)

# the JAX package's ops/__init__ re-exports functions named like its modules
jatt = importlib.import_module("diffusion_spacetime_attn_tpu.ops.attention")
jmasks = importlib.import_module("diffusion_spacetime_attn_tpu.ops.masks")
jsched = importlib.import_module("diffusion_spacetime_attn_tpu.ops.schedule")

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _j(a):
    return jnp.asarray(np.asarray(a, np.float32))


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach().numpy() if hasattr(got, "detach") else got),
                               np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------- schedule


@pytest.mark.parametrize("steps", [50, 6, 20])
def test_schedule_bit_equal(steps):
    js = jsched.make_schedule(JScheduleConfig(), steps)
    ts = tsched.make_schedule(tcfg.ScheduleConfig(), steps)
    assert int(ts.timesteps[0]) == 1000 // steps * (steps - 1) + 1
    for name in ("timesteps", "timesteps_next", "alphas", "alphas_prev",
                 "sqrt_one_minus_alphas", "sigmas", "alphas_cumprod", "betas"):
        a = np.asarray(getattr(js, name))
        b = getattr(ts, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# ---------------------------------------------------------------- masks


@pytest.mark.parametrize("dim", [8, 16, 64])
def test_masks_bit_equal(dim):
    r = np.random.RandomState(dim)
    centers = r.rand(2, 3, 2).astype(np.float32)
    active = np.array([[1, 1, 0], [1, 0, 1]], np.float32)
    np.testing.assert_array_equal(
        np.asarray(jmasks.circular_mask(_j(centers), dim, 0.2)),
        tmasks.circular_mask(_t(centers), dim, 0.2).numpy())
    np.testing.assert_array_equal(
        np.asarray(jmasks.flat_circular_mask(_j(centers), dim, 0.2, _j(active))),
        tmasks.flat_circular_mask(_t(centers), dim, 0.2, _t(active)).numpy())


# ---------------------------------------------------------------- attention


def _qkv(B, Lq, Lk, inner, seed):
    r = np.random.RandomState(seed)
    return (r.randn(B, Lq, inner).astype(np.float32),
            r.randn(B, Lk, inner).astype(np.float32),
            r.randn(B, Lk, inner).astype(np.float32))


@pytest.mark.parametrize("Lq,Lk,inner,heads", [(64, 64, 64, 4), (100, 77, 80, 2)])
def test_plain_attention_matches_jax(Lq, Lk, inner, heads):
    q, k, v = _qkv(2, Lq, Lk, inner, seed=Lq)
    want = jatt.attention(_j(q), _j(k), _j(v), heads)
    _close(tatt.attention(_t(q), _t(k), _t(v), heads), want)


def test_multi_context_attention_matches_jax():
    r = np.random.RandomState(3)
    q = r.randn(2, 64, 32).astype(np.float32)
    k = r.randn(2, 3, 7, 32).astype(np.float32)
    v = r.randn(2, 3, 7, 32).astype(np.float32)
    want = jatt.multi_context_attention(_j(q), _j(k), _j(v), 2)
    _close(tatt.multi_context_attention(_t(q), _t(k), _t(v), 2), want)


def _control_inputs(coef_value=None, seed=5):
    B, N, Lq, L, inner = 2, 3, 64, 7, 32
    r = np.random.RandomState(seed)
    q = r.randn(2 * B, Lq, inner).astype(np.float32)
    k = r.randn(2 * B, L, inner).astype(np.float32)
    v = r.randn(2 * B, L, inner).astype(np.float32)
    lk = r.randn(B, N, L, inner).astype(np.float32)
    lv = r.randn(B, N, L, inner).astype(np.float32)
    ctx = r.randn(B, N, L, 16).astype(np.float32)
    centers = r.rand(B, N, 2).astype(np.float32)
    coef = (r.rand(B, N) * 2).astype(np.float32) if coef_value is None else \
        np.full((B, N), coef_value, np.float32)
    active = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    return q, k, v, lk, lv, (ctx, centers, coef, active)


@pytest.mark.parametrize("mode", ["control", "no_control", "zero_coef"])
@pytest.mark.parametrize("fused", [False, True])
def test_spacetime_cross_attention_matches_jax(mode, fused):
    """With control, without it, and with coef=0 (which must equal the
    vanilla path); fused=True goes through the kernel wrapper, which takes
    its plain version on CPU tensors (the JAX side takes its XLA path)."""
    q, k, v, lk, lv, ctl = _control_inputs(0.0 if mode == "zero_coef" else None)
    jc = tc = None
    jl = tl = None
    if mode != "no_control":
        jc = jatt.SpatialControl(*map(_j, ctl))
        tc = tatt.SpatialControl(*map(_t, ctl))
        jl, tl = (_j(lk), _j(lv)), (_t(lk), _t(lv))
    want = jatt.spacetime_cross_attention(_j(q), (_j(k), _j(v)), jl, jc, 2, 0.2)
    got = tatt.spacetime_cross_attention(_t(q), (_t(k), _t(v)), tl, tc, 2, 0.2, fused=fused)
    _close(got, want)
    if mode == "zero_coef":
        plain = tatt.attention(_t(q), _t(k), _t(v), 2)
        _close(got, plain.numpy(), atol=1e-6, rtol=1e-6)


# ------------------------------------------- kernel plain versions vs Pallas


def _spacetime_inputs(B=1, N=3, Lq=512, Lk=77, inner=64, seed=0):
    """The shapes and distribution of tests/test_pallas_spacetime.py."""
    rng = np.random.RandomState(seed)
    f = lambda *s: (rng.randn(*s) * 0.3).astype(np.float32)
    q_c, g_u = f(B, Lq, inner), f(B, Lq, inner)
    kc, vc = f(B, Lk, inner), f(B, Lk, inner)
    lk, lv = f(B, N, Lk, inner), f(B, N, Lk, inner)
    masks = (rng.rand(B, N, Lq) < 0.3).astype(np.float32)
    coef = (rng.rand(B, N) * 2).astype(np.float32)
    return q_c, g_u, kc, vc, lk, lv, masks, coef


@pytest.mark.parametrize("kw,heads", [
    (dict(), 4),
    (dict(B=2, N=2, Lq=1024, inner=80, seed=1), 8),
])
def test_spacetime_plain_matches_pallas_interpret(kw, heads):
    args = _spacetime_inputs(**kw)
    want = j_spacetime_interpret(*map(_j, args), heads)
    got = fused_spacetime_attention(*map(_t, args), heads)
    _close(got, want, atol=2e-5, rtol=2e-5)


def _geglu_inputs(M, dim, seed):
    inner = 4 * dim
    r = np.random.RandomState(seed)
    x = r.randn(M, dim).astype(np.float32)
    w1 = (r.randn(dim, 2 * inner) * 0.05).astype(np.float32)   # JAX [in, out]
    b1 = (r.randn(2 * inner) * 0.1).astype(np.float32)
    w2 = (r.randn(inner, dim) * 0.05).astype(np.float32)
    b2 = (r.randn(dim) * 0.1).astype(np.float32)
    res = r.randn(M, dim).astype(np.float32)
    return x, w1, b1, w2, b2, res


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("M,dim", [(64, 320), (128, 640), (32, 1280)])
def test_geglu_plain_matches_pallas_interpret(M, dim, residual):
    x, w1, b1, w2, b2, res = _geglu_inputs(M, dim, seed=dim + residual)
    jres = _j(res) if residual else None
    want = j_geglu_ff(_j(x), _j(w1), _j(b1), _j(w2), _j(b2), jres, interpret=True)
    # the port takes nn.Linear layout: w1 [2·inner, dim], w2 [dim, inner]
    got = geglu_ff(_t(x), _t(w1.T.copy()), _t(b1), _t(w2.T.copy()), _t(b2),
                   _t(res) if residual else None)
    _close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dh,L", [(40, 256), (80, 128), (160, 64)])
def test_mha_plain_matches_pallas_interpret(dh, L):
    B, H = 2, 2
    q, k, v = _qkv(B, L, L, H * dh, seed=dh)
    want = j_mha_attention(_j(q), _j(k), _j(v), H, interpret=True)
    _close(mha_attention(_t(q), _t(k), _t(v), H), want)


# ------------------------------------------- wrappers on CPU tensors


def test_wrappers_take_plain_path_on_cpu_without_counting():
    before = (mha_attention.launches, geglu_ff.launches, fused_spacetime_attention.launches)
    q, k, v = map(_t, _qkv(1, 32, 32, 32, seed=9))
    _close(mha_attention(q, k, v, 2), tatt.attention(q, k, v, 2).numpy(), atol=0, rtol=0)
    x, w1, b1, w2, b2, res = map(_t, _geglu_inputs(8, 32, seed=2))
    w1, w2 = w1.T.contiguous(), w2.T.contiguous()
    _close(geglu_ff(x, w1, b1, w2, b2, res), geglu_plain(x, w1, b1, w2, b2, res).numpy(),
           atol=0, rtol=0)
    args = list(map(_t, _spacetime_inputs(Lq=64, inner=32)))
    fused_spacetime_attention(*args, 2)
    after = (mha_attention.launches, geglu_ff.launches, fused_spacetime_attention.launches)
    assert after == before


def test_plain_versions_keep_working_dtype():
    """bf16 in, bf16 out, as in the JAX kernels (out in x / q dtype)."""
    q, k, v = (t.to(torch.bfloat16) for t in map(_t, _qkv(1, 16, 16, 32, seed=4)))
    assert mha_attention(q, k, v, 2).dtype == torch.bfloat16
    assert mha_attention(q, k, v, 2, out_dtype=torch.float32).dtype == torch.float32
    x, w1, b1, w2, b2, res = (t.to(torch.bfloat16) for t in map(_t, _geglu_inputs(8, 32, 3)))
    assert geglu_ff(x, w1.T.contiguous(), b1, w2.T.contiguous(), b2, res).dtype == torch.bfloat16


# ------------------------------------------- cost model of the main path


@pytest.mark.parametrize("fn,args,flops,nbytes", [
    # one prompt (CFG rows = 2), SD v1-4 level 0 / 1 / 2 / mid
    (mha_cost, (2, 4096, 4096, 320, 2), 42.9e9, 21.0e6),
    (mha_cost, (2, 1024, 1024, 640, 2), 5.37e9, 10.5e6),
    (mha_cost, (2, 256, 256, 1280, 2), 0.671e9, 5.24e6),
    (geglu_cost, (8192, 320, 1280, 2), 20.1e9, 18.2e6),
    (geglu_cost, (128, 1280, 5120, 2), 5.03e9, 40.3e6),
    (spacetime_cost, (1, 4, 4096, 77, 320, 2), 2.02e9, 8.42e6),
    (spacetime_cost, (1, 4, 64, 77, 1280, 2), 0.126e9, 2.464e6),
])
def test_cost_model_matches_main_path_table(fn, args, flops, nbytes):
    f, b = fn(*args)
    assert abs(f - flops) / flops < 5e-3
    assert abs(b - nbytes) / nbytes < 5e-3


# ------------------------------------------- config


@pytest.mark.parametrize("field,value", [
    ("use_flash", True), ("attn_q_chunk", 512),
    ("attn_scores_dtype", "bfloat16"), ("conv_norm_barrier", True),
])
def test_unimplemented_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        tcfg.UNetConfig(**{field: value})


def test_config_defaults_match_jax():
    import dataclasses

    from diffusion_spacetime_attn_tpu import config as jcfg

    for name in ("UNetConfig", "VAEConfig", "CLIPTextConfig", "ScheduleConfig",
                 "SpaceTimeConfig", "PipelineConfig"):
        a = dataclasses.asdict(getattr(jcfg, name)())
        b = dataclasses.asdict(getattr(tcfg, name)())
        assert a == b, name
