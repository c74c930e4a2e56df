"""PyTorch port, ops layer: schedule, masks, attention and the plain versions
of the CUDA kernels (forwards and backwards), each held against the JAX
package on the CPU, and the kernel wrappers' autograd Functions held against
autograd of their plain forwards.

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
from diffusion_spacetime_attn_tpu_torch.ops.cuda_geglu import (
    geglu_cost,
    geglu_dx,
    geglu_dx_cost,
    geglu_dx_plain,
    geglu_ff,
    geglu_plain,
)
from diffusion_spacetime_attn_tpu_torch.ops.cuda_mha import (
    mha_attention,
    mha_attention_plain,
    mha_cost,
)
from diffusion_spacetime_attn_tpu_torch.ops.cuda_spacetime import (
    fused_spacetime_attention,
    spacetime_bwd,
    spacetime_bwd_cost,
    spacetime_bwd_plain,
    spacetime_cost,
    spacetime_plain,
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


# ------------------------------------------- backwards against the JAX kernels


BWD_NAMES = ("dq_c", "dg_u", "dkc", "dvc", "dlk", "dlv", "dmasks", "dcoef")


@pytest.mark.parametrize("kw,heads", [
    (dict(), 4),
    (dict(B=2, N=2, Lq=1024, inner=80, seed=1), 8),
    (dict(B=1, N=3, Lq=64, inner=32, seed=5), 2),
])
def test_spacetime_bwd_plain_matches_pallas_interpret(kw, heads):
    """All 8 cotangents of `_backward` (interpret mode), in order, f32 1e-4."""
    from diffusion_spacetime_attn_tpu.ops import pallas_spacetime as ps

    args = _spacetime_inputs(**kw)
    g = (np.random.RandomState(9).randn(*args[0].shape) * 0.1).astype(np.float32)
    want = ps._backward(*map(_j, args), heads, _j(g), interpret=True)
    got = spacetime_bwd_plain(*map(_t, args), heads, _t(g))
    assert len(got) == len(want) == 8
    for name, a, b in zip(BWD_NAMES, got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        _close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("M,dim", [(64, 320), (128, 640), (32, 1280)])
def test_geglu_dx_plain_matches_pallas_interpret(M, dim):
    from diffusion_spacetime_attn_tpu.ops.pallas_geglu import _ff_dx_local

    x, w1, b1, w2, _, dy = _geglu_inputs(M, dim, seed=dim + 7)
    want = _ff_dx_local(_j(x), _j(w1), _j(b1), _j(w2), _j(dy), interpret=True)
    got = geglu_dx_plain(_t(x), _t(w1.T.copy()), _t(b1), _t(w2.T.copy()), _t(dy))
    _close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dh,L", [(40, 256), (80, 128), (160, 64)])
def test_mha_grad_matches_jax_grad(dh, L):
    """Gradient of mha_attention (kernel forward, `_mha_bh_bwd` backward) vs
    jax.grad of the JAX `mha_attention` in interpret mode."""
    import jax

    B, H = 2, 2
    q, k, v = _qkv(B, L, L, H * dh, seed=dh + 1)
    w = np.random.RandomState(3).randn(B, L, H * dh).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(j_mha_attention(*a, H, interpret=True) * _j(w)),
                    argnums=(0, 1, 2))(_j(q), _j(k), _j(v))
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    (mha_attention(*ts, H) * _t(w)).sum().backward()
    for a, b in zip(ts, want):
        _close(a.grad, b, atol=1e-4, rtol=1e-4)


def _grads(fn, args, seed=4):
    leaves = [a.clone().requires_grad_(True) if torch.is_tensor(a) else a for a in args]
    out = fn(*leaves)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    (out * w).sum().backward()
    return [a.grad for a in leaves if torch.is_tensor(a)]


@pytest.mark.parametrize("kind", ["spacetime", "geglu", "mha"])
def test_autograd_function_grads_match_plain_autograd(kind):
    """Each wrapper is a torch.autograd.Function whose backward (the plain
    backward on the CPU) gives autograd's gradient of the plain forward, in
    every tensor argument."""
    if kind == "spacetime":
        args = list(map(_t, _spacetime_inputs(B=2, N=3, Lq=64, inner=32, seed=2)))
        kern = lambda *a: fused_spacetime_attention(*a, 2)  # noqa: E731
        plain = lambda *a: spacetime_plain(*a, 2)  # noqa: E731
    elif kind == "geglu":
        x, w1, b1, w2, b2, res = map(_t, _geglu_inputs(16, 32, seed=6))
        args = [x.reshape(2, 8, 32), w1.T.contiguous(), b1, w2.T.contiguous(), b2,
                res.reshape(2, 8, 32)]
        kern, plain = geglu_ff, geglu_plain
    else:
        args = list(map(_t, _qkv(2, 24, 24, 32, seed=8)))
        kern = lambda *a: mha_attention(*a, 2)  # noqa: E731
        plain = lambda *a: mha_attention_plain(*a, 2)  # noqa: E731
    got, want = _grads(kern, args), _grads(plain, args)
    assert len(got) == len(want) == len(args)
    for a, b in zip(got, want):
        _close(a, b.numpy(), atol=1e-5, rtol=1e-5)


def test_wrapper_outputs_come_from_their_autograd_functions():
    """The gradient of a wrapper's output goes through its own backward (the
    kernel's on the card).  Before, the CUDA path built its output outside
    autograd, so a requires-grad input got no gradient and no error."""
    q = torch.randn(1, 16, 32, requires_grad=True)
    x = torch.randn(4, 32, requires_grad=True)
    w1, b1 = torch.randn(256, 32) * 0.1, torch.zeros(256)
    w2, b2 = torch.randn(32, 128) * 0.1, torch.zeros(32)
    args = [_t(a) for a in _spacetime_inputs(Lq=64, inner=32, seed=3)]
    args[0].requires_grad_(True)
    outs = {"_MhaFnBackward": mha_attention(q, q, q, 2),
            "_GegluFnBackward": geglu_ff(x, w1, b1, w2, b2, x),
            "_SpacetimeFnBackward": fused_spacetime_attention(*args, 2)}
    for name, out in outs.items():
        assert type(out.grad_fn).__name__ == name


def test_backward_entry_points_take_plain_path_on_cpu_without_counting():
    before = (spacetime_bwd.launches, geglu_dx.launches)
    args = list(map(_t, _spacetime_inputs(Lq=64, inner=32, seed=4)))
    g = torch.randn(args[0].shape)
    full = spacetime_bwd(*args, 2, g)
    short = spacetime_bwd(*args, 2, g, need_kv=False)
    assert short[2:6] == (None,) * 4
    for a, b in zip(full[:2] + full[6:], short[:2] + short[6:]):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    x, w1, b1, w2, _, dy = map(_t, _geglu_inputs(8, 32, seed=5))
    torch.testing.assert_close(geglu_dx(x, w1.T, b1, w2.T, dy),
                               geglu_dx_plain(x, w1.T, b1, w2.T, dy), atol=0, rtol=0)
    assert (spacetime_bwd.launches, geglu_dx.launches) == before


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
    # backwards at the chain's shapes (2 prompts): 10·M·dim·inner FLOPs for dx
    (geglu_dx_cost, (16384, 320, 1280, 2), 67.1e9, 33.9e6),
    (spacetime_bwd_cost, (2, 4, 4096, 77, 320, 8, 2, False), 6.06e9, 28.38e6),
])
def test_cost_model_matches_main_path_table(fn, args, flops, nbytes):
    f, b = fn(*args)
    assert abs(f - flops) / flops < 5e-3
    assert abs(b - nbytes) / nbytes < 5e-3


# ------------------------------------------- config


@pytest.mark.parametrize("field,value", [
    ("attn_q_chunk", 512), ("attn_scores_dtype", "bfloat16"), ("conv_norm_barrier", True),
])
def test_unimplemented_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match=field):
        tcfg.UNetConfig(**{field: value})


def test_use_flash_unet_routes_level0_attn1_through_flash(monkeypatch):
    """UNetConfig(use_flash=True): the level-0 self-attention sites (1024
    tokens) go to flash, the level-1 ones (256 tokens) and every
    cross-attention do not."""
    cfg = tcfg.UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                          attention_resolutions=(1, 2), num_heads=2, context_dim=32,
                          use_flash=True)
    from diffusion_spacetime_attn_tpu_torch.models.unet import UNet

    unet = UNet(cfg)
    assert unet.down_attn_0.block_0.attn1.flash and not unet.down_attn_0.block_0.attn2.flash
    seen = []
    real = tatt.flash_attention

    def spy(q, k, v, num_heads, *, out_dtype=None):
        seen.append(q.shape[1])
        return real(q, k, v, num_heads, out_dtype=out_dtype)

    monkeypatch.setattr(tatt, "flash_attention", spy)
    with torch.no_grad():
        eps = unet(torch.randn(2, 32, 32, 4), torch.full((2,), 501), torch.randn(2, 7, 32))
    assert eps.shape == (2, 32, 32, 4)
    assert seen == [1024] * 3      # down_attn_0, up_attn_2, up_attn_3


def test_config_defaults_match_jax():
    import dataclasses

    from diffusion_spacetime_attn_tpu import config as jcfg

    for name in ("UNetConfig", "VAEConfig", "CLIPTextConfig", "CLIPVisionConfig", "CLIPConfig",
                 "ScheduleConfig", "SpaceTimeConfig", "PipelineConfig"):
        a = dataclasses.asdict(getattr(jcfg, name)())
        b = dataclasses.asdict(getattr(tcfg, name)())
        assert a == b, name
