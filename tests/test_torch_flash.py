"""PyTorch port, `use_flash`: the flash self-attention (`ops/cuda_flash.py`)
held against the JAX package on the CPU.

- The plain forward and backward, and `flash_attention` on CPU tensors,
  against JAX's `flash_attention(..., interpret=True)` (splash attention
  under the Pallas interpreter) and `jax.vjp` of it, f32, 1e-5: the same
  math, sums taken in another order.  `DSTA_SPLASH_SPMD=0`: the conftest's 8
  CPU devices would otherwise pick the SPMD wrapper.
- The router: `attention(..., flash=True)` sends exactly the `flash_ok`
  shapes to `flash_attention`, and flash wins over mha.
- The slice: `generation_loss` and its coef gradient with `use_flash=True`
  against the JAX package's `use_flash=True` pipeline, which on the CPU takes
  its einsum path (`attention.py:238`), so this holds the port's routing and
  backward to the same function.  The smoke config of
  `tests/test_torch_chain.py` with a latent of 32, cut to one level (UNet
  and VAE): the UNet's one transformer (mid) sees 1024 tokens and passes
  `flash_ok`, and the decoded image keeps the loss CLIP's 32-pixel
  geometry.  One PLMS step (two evaluations).  1e-4 relative, as the chain
  test.  The cuts keep the JAX oracle's trace and compile, which dominate
  this file, near 12 s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
from diffusion_spacetime_attn_tpu.ops.attention import flash_attention as j_flash_attention
from diffusion_spacetime_attn_tpu.pipeline import spacetime as jst
from diffusion_spacetime_attn_tpu.pipeline.losses import DCLIPLoss as JDCLIPLoss
from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
from diffusion_spacetime_attn_tpu.testbed.configs import smoke_pipeline_cfg
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.ops import attention as tatt
from diffusion_spacetime_attn_tpu_torch.ops import cuda_flash
from diffusion_spacetime_attn_tpu_torch.pipeline import spacetime as tst
from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion

ATOL = 1e-5
RTOL = 1e-4


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ------------------------------------------------------ kernel vs splash


def test_flash_matches_jax_splash_interpret(monkeypatch):
    monkeypatch.setenv("DSTA_SPLASH_SPMD", "0")
    B, H, L, dh = 1, 2, 1024, 32
    r = np.random.RandomState(0)
    q, k, v, g = (r.randn(B, L, H * dh).astype(np.float32) for _ in range(4))
    out, vjp = jax.vjp(lambda a, b, c: j_flash_attention(a, b, c, H, interpret=True),
                       *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(out)] + [np.asarray(d) for d in vjp(jnp.asarray(g))]

    # the plain versions
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = cuda_flash.flash_attention_plain(tq, tk, tv, H)
    assert lse.shape == (B * H, L) and lse.dtype == torch.float32
    got = [o] + list(cuda_flash.flash_bwd_plain(tq, tk, tv, o, lse, tg, H))
    # the autograd Function on CPU tensors
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    o2 = cuda_flash.flash_attention(*leaves, H)
    o2.backward(tg)
    got2 = [o2] + [t.grad for t in leaves]
    for name, a, b, w in zip(("o", "dq", "dk", "dv"), got, got2, want):
        np.testing.assert_allclose(a.detach().numpy(), w, atol=ATOL, rtol=ATOL, err_msg=name)
        np.testing.assert_array_equal(b.detach().numpy(), a.detach().numpy(), err_msg=name)
    assert o2.grad_fn is not None and float(np.abs(want[1]).max()) > 0


def test_flash_cost_model():
    # SD level 0 at the optimization batch (2 prompts = 4 CFG rows, 8 heads)
    f, b = cuda_flash.flash_cost(4, 4096, 4096, 320, 8, 2)
    assert f == 4 * 4 * 8 * 4096 ** 2 * 40
    assert b == 2 * 4 * 4 * 4096 * 320 + 4 * 4 * 8 * 4096
    f, b = cuda_flash.flash_bwd_cost(4, 4096, 4096, 320, 8, 2)
    assert f == 10 * 4 * 8 * 4096 ** 2 * 40        # five products, however recomputed
    assert b == 2 * 8 * 4 * 4096 * 320 + 4 * 4 * 8 * 4096


# ------------------------------------------------------------- router


@pytest.mark.parametrize("Lq,Lk,inner,heads,routed", [
    (1024, 1024, 320, 8, True),      # SD level 1 width at L = 1024
    (4096, 4096, 320, 8, True),      # SD level 0
    (1536, 1536, 64, 2, True),       # a multiple of 512
    (512, 512, 64, 2, False),        # too short
    (1100, 1100, 64, 2, False),      # not a multiple of 512
    (1024, 77, 64, 2, False),        # cross-attention
    (1024, 1024, 320, 2, False),     # head width 160 > 128
])
def test_router_sends_exactly_the_flash_ok_shapes(monkeypatch, Lq, Lk, inner, heads, routed):
    calls = []

    def spy(q, k, v, num_heads, *, out_dtype=None):
        calls.append((q.shape[1], k.shape[1], q.shape[2] // num_heads))
        return torch.zeros_like(q)

    monkeypatch.setattr(tatt, "flash_attention", spy)
    assert cuda_flash.flash_ok(Lq, Lk, inner // heads) == routed
    q = torch.randn(1, Lq, inner)
    k = v = torch.randn(1, Lk, inner)
    for mha in (False, True):       # flash wins where both apply
        out = tatt.attention(q, k, v, heads, flash=True, mha=mha)
        assert out.shape == q.shape
    assert calls == [(Lq, Lk, inner // heads)] * 2 * routed
    tatt.attention(q, k, v, heads)  # flash off: never routed
    assert len(calls) == 2 * routed


# ---------------------------------------------------------- the slice


def _flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


def _port_cfg(c):
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (_port_cfg(getattr(c, f.name))
                           if dataclasses.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dataclasses.fields(c)})


def test_use_flash_generation_loss_and_coef_grad_match_jax():
    base = smoke_pipeline_cfg(num_steps=1)
    cfg = dataclasses.replace(
        base, unet=dataclasses.replace(base.unet, channel_mult=(1,), attention_resolutions=(),
                                       use_flash=True),
        vae=dataclasses.replace(base.vae, ch_mult=(1,)),
        spacetime=dataclasses.replace(base.spacetime, latent_size=32))
    sd = JSD.create(cfg, jax.random.PRNGKey(0), abstract=True)
    sd = dataclasses.replace(
        sd,
        unet_params=randomize_params(sd.unet_params, jax.random.PRNGKey(1), 0.2),
        vae_params=randomize_params(sd.vae_params, jax.random.PRNGKey(2), 0.2),
        text_params=randomize_params(sd.text_params, jax.random.PRNGKey(3), 0.2))
    lc = cfg.loss_clip
    cmodel = JCLIP(lc)
    cparams = jax.eval_shape(cmodel.init, jax.random.PRNGKey(4), jnp.zeros((1, 14, 14, 3)),
                             jnp.zeros((1, lc.text.max_len), jnp.int32))["params"]
    jloss = JDCLIPLoss(cmodel, randomize_params(cparams, jax.random.PRNGKey(5), 0.2))
    pcfg = _port_cfg(cfg)
    assert pcfg.unet.use_flash
    tsd = StableDiffusion.from_flat(pcfg, _flat(sd.unet_params), _flat(sd.vae_params),
                                    _flat(sd.text_params), device="cpu")
    tloss = DCLIPLoss.from_flat(pcfg.loss_clip, _flat(jloss.params), device="cpu")

    B, N, L, V = 1, 2, cfg.text_encoder.max_len, cfg.text_encoder.vocab_size
    r = np.random.RandomState(0)

    def ids(n, vocab, length):
        a = r.randint(1, vocab - 1, size=(n, length)).astype(np.int32)
        a[:, -1] = vocab - 1
        return a

    emb = np.asarray(sd.encode_text(jnp.asarray(ids(B + B + B * N, V, L))))
    arrays = dict(
        cond=emb[:B], uncond=emb[B:2 * B], local_contexts=emb[2 * B:].reshape(B, N, L, -1),
        centers=np.array([[[0.3, 0.4], [0.7, 0.6]]], np.float32),
        active=np.ones((B, N), np.float32),
        caption_tokens=ids(B, lc.text.vocab_size, lc.text.max_len),
        object_tokens=ids(B * N, lc.text.vocab_size, lc.text.max_len).reshape(B, N, -1),
        x_T=r.randn(B, 32, 32, 4).astype(np.float32))
    jin = jst.SpaceTimeInputs(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tin = tst.SpaceTimeInputs(**{k: torch.tensor(v) for k, v in arrays.items()})
    st = cfg.spacetime
    coef = jst.init_coef(jin.active, st.num_steps, st.init_coef)
    vg = jax.value_and_grad(lambda c: jst.generation_loss(c, sd, jloss, jin, st), has_aux=True)
    (jl, _), jg = jax.jit(vg).lower(coef).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})(coef)

    launches = cuda_flash.flash_attention.launches
    seen = []
    real = tatt.flash_attention

    def spy(*a, **kw):
        seen.append(a[0].shape[1])
        return real(*a, **kw)

    tatt.flash_attention = spy
    try:
        c = torch.tensor(np.asarray(coef)).requires_grad_(True)
        tl, _ = tst.generation_loss(c, tsd, tloss, tin, st)
        tl.backward()
    finally:
        tatt.flash_attention = real
    # one site x 2 evaluations (PLMS step 0), each run again by the
    # checkpoint's recompute; CPU tensors count no launch
    assert seen == [1024] * 4
    assert cuda_flash.flash_attention.launches == launches
    assert abs(tl.item() - float(jl)) <= RTOL * abs(float(jl)), (tl.item(), float(jl))
    assert rel(c.grad.numpy(), np.asarray(jg)) <= RTOL, rel(c.grad.numpy(), np.asarray(jg))
    assert np.abs(np.asarray(jg)).max() > 0
