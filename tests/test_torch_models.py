"""PyTorch port, models layer: the weight bridge and the UNet, VAE and CLIP
text tower forwards, held against the JAX package on the CPU.

Weights are the JAX package's `randomize_params(scale=0.2)` trees (SD zero-
inits its output convs, so a fresh init is degenerate), flattened with "/"
and loaded through the port's bridge.  f32 tolerance ~1e-4: flax GroupNorm
and LayerNorm take the variance as E[x²]−E[x]², torch does not, and the
difference grows through a dozen normalized layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffusion_spacetime_attn_tpu import config as jcfg
from diffusion_spacetime_attn_tpu.models.clip import CLIPTextTower as JText
from diffusion_spacetime_attn_tpu.models.unet import UNet as JUNet
from diffusion_spacetime_attn_tpu.models.vae import AutoencoderKL as JVAE
from diffusion_spacetime_attn_tpu.ops.attention import SpatialControl as JControl
from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
from diffusion_spacetime_attn_tpu.testbed.configs import smoke_pipeline_cfg
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models.clip import CLIPTextTower
from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
from diffusion_spacetime_attn_tpu_torch.models.vae import AutoencoderKL
from diffusion_spacetime_attn_tpu_torch.ops.attention import SpatialControl
from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
from diffusion_spacetime_attn_tpu_torch.utils.weights import bridge, torch_key

ATOL = 1e-4


def port_cfg(c):
    """The port's config dataclass with the same field values as a JAX one."""
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (port_cfg(getattr(c, f.name))
                           if dataclasses.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dataclasses.fields(c)})


def flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


@pytest.fixture(scope="module")
def pair():
    """(JAX bundle, port bundle) on the smoke config with equal weights."""
    cfg = smoke_pipeline_cfg(num_steps=4)
    sd = JSD.create(cfg, jax.random.PRNGKey(0), abstract=True)
    sd = dataclasses.replace(
        sd,
        unet_params=randomize_params(sd.unet_params, jax.random.PRNGKey(1), 0.2),
        vae_params=randomize_params(sd.vae_params, jax.random.PRNGKey(2), 0.2),
        text_params=randomize_params(sd.text_params, jax.random.PRNGKey(3), 0.2))
    tsd = StableDiffusion.from_flat(port_cfg(cfg), flat(sd.unet_params),
                                    flat(sd.vae_params), flat(sd.text_params),
                                    device="cpu")
    return sd, tsd


# ---------------------------------------------------------------- bridge


@pytest.mark.parametrize("which", ["unet", "vae", "text"])
def test_bridge_loads_smoke_trees_exactly(pair, which):
    """No missing or unexpected key, matching shapes, and every value is
    the JAX value in torch layout."""
    sd, tsd = pair
    jparams = {"unet": sd.unet_params, "vae": sd.vae_params, "text": sd.text_params}[which]
    model = {"unet": tsd.unet, "vae": tsd.vae, "text": tsd.text_encoder}[which]
    fl = flat(jparams)
    state = bridge(fl, model)
    assert set(state) == set(model.state_dict())
    for path, arr in fl.items():
        key, value = torch_key(path, arr)
        np.testing.assert_array_equal(model.state_dict()[key].float().numpy(), value)


def test_bridge_rejects_missing_and_unexpected_keys(pair):
    sd, tsd = pair
    fl = flat(sd.text_params)
    fl.pop("ln_final/scale")
    with pytest.raises(KeyError, match="missing"):
        bridge(fl, tsd.text_encoder)
    fl = flat(sd.text_params)
    fl["ln_final/extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        bridge(fl, tsd.text_encoder)


def _shape_map(tree):
    """{torch key: torch-layout shape} of an abstract JAX tree, no memory."""
    out = {}
    for path, s in traverse_util.flatten_dict(tree, sep="/").items():
        view = np.broadcast_to(np.float32(0), s.shape)
        key, value = torch_key(path, view)
        out[key] = tuple(value.shape)
    return out


@pytest.mark.parametrize("which", ["unet", "vae", "text"])
def test_bridge_covers_full_sd_v14_key_set(which):
    """At SD v1-4 size (shapes only: jax.eval_shape and torch's meta
    device) every JAX parameter maps onto exactly one port parameter of the
    same shape."""
    r = jax.random.PRNGKey(0)
    if which == "unet":
        jm, tm = JUNet(jcfg.UNetConfig()), UNet
        args = (jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,), jnp.int32), jnp.zeros((2, 77, 768)))
        tcfg_ = tcfg.UNetConfig()
    elif which == "vae":
        jm, tm = JVAE(jcfg.VAEConfig()), AutoencoderKL
        args = (jnp.zeros((1, 64, 64, 3)),)
        tcfg_ = tcfg.VAEConfig()
    else:
        jm, tm = JText(jcfg.CLIPTextConfig()), CLIPTextTower
        args = (jnp.zeros((1, 77), jnp.int32),)
        tcfg_ = tcfg.CLIPTextConfig()
    tree = jax.eval_shape(jm.init, r, *args)["params"]
    with torch.device("meta"):
        model = tm(tcfg_)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = _shape_map(tree)
    assert set(got) == set(want)
    assert got == want
    if which == "unet":
        assert sum(np.prod(s) for s in want.values()) > 8.5e8


# ---------------------------------------------------------------- forwards


def _unet_inputs(control: bool, seed=0):
    r = np.random.RandomState(seed)
    B, N = 2, 2  # prompts; the UNet batch is the CFG stack 2B
    x = r.randn(2 * B, 8, 8, 4).astype(np.float32)
    t = np.array([981, 981, 501, 501], np.int32)
    ctx = r.randn(2 * B, 12, 32).astype(np.float32)
    ctl = None
    if control:
        ctl = (r.randn(B, N, 12, 32).astype(np.float32),
               np.array([[[0.3, 0.4], [0.7, 0.6]], [[0.5, 0.5], [0.2, 0.8]]], np.float32),
               np.array([[1.5, 2.0], [2.5, 0.0]], np.float32),
               np.array([[1, 1], [1, 0]], np.float32))
    return x, t, ctx, ctl


@pytest.mark.parametrize("control", [False, True])
def test_unet_forward_matches_jax(pair, control):
    sd, tsd = pair
    x, t, ctx, ctl = _unet_inputs(control)
    jctl = None if ctl is None else JControl(*map(jnp.asarray, ctl))
    want = jax.jit(sd.unet.apply)({"params": sd.unet_params}, jnp.asarray(x),
                                  jnp.asarray(t), jnp.asarray(ctx), jctl)
    tctl = None if ctl is None else SpatialControl(*map(torch.from_numpy, ctl))
    with torch.inference_mode():
        got = tsd.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx), tctl)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_unet_kernel_flags_route_through_wrappers_on_cpu(pair):
    """use_mha / use_fused_ff / use_fused_control on: every site goes through
    a kernel wrapper, which on CPU tensors takes its plain version, so the
    output equals the flags-off UNet's (f32, same weights)."""
    sd, tsd = pair
    cfg = dataclasses.replace(tsd.cfg.unet, use_mha=True, use_fused_ff=True,
                              use_fused_control=True)
    fused = UNet(cfg, radius=tsd.cfg.spacetime.radius)
    fused.load_state_dict(tsd.unet.state_dict())
    x, t, ctx, ctl = map(lambda a: a if a is None else a, _unet_inputs(True, seed=3))
    args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
            SpatialControl(*map(torch.from_numpy, ctl)))
    with torch.inference_mode():
        a, b = tsd.unet(*args), fused(*args)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, rtol=1e-5)


def test_vae_decode_matches_jax(pair):
    sd, tsd = pair
    z = np.random.RandomState(4).randn(2, 8, 8, 4).astype(np.float32)
    want = jax.jit(sd.decode_latents)(jnp.asarray(z))
    with torch.inference_mode():
        got = tsd.decode_latents(torch.from_numpy(z))
    assert tuple(got.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)


def test_vae_encode_moments_matches_jax(pair):
    """The encoder half the bridge loads: mean and clipped logvar."""
    from diffusion_spacetime_attn_tpu.models.vae import AutoencoderKL as JAutoencoderKL

    sd, tsd = pair
    img = np.random.RandomState(6).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    want = sd.vae.apply({"params": sd.vae_params}, jnp.asarray(img),
                        method=JAutoencoderKL.encode_moments)
    with torch.inference_mode():
        got = tsd.vae.encode_moments(torch.from_numpy(img))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (2, 8, 8, 4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, rtol=ATOL)


def test_encode_text_matches_jax(pair):
    sd, tsd = pair
    r = np.random.RandomState(5)
    ids = r.randint(1, sd.cfg.text_encoder.vocab_size - 1, size=(3, 12)).astype(np.int32)
    ids[:, -3] = sd.cfg.text_encoder.vocab_size - 1   # EOT = largest id
    want = jax.jit(sd.encode_text)(jnp.asarray(ids))
    with torch.inference_mode():
        got = tsd.encode_text(ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=ATOL)
