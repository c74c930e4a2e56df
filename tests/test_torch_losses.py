"""PyTorch port, losses layer: crop windows, the two resizes, the dual-tower
CLIP (vision tower, encode_image, encode_text) and DCLIPLoss, held against
the JAX package on the CPU, and the CLIP weight bridge.

Inputs are made with numpy from a seed and handed to both sides; CLIP is the
smoke config's loss CLIP (`testbed/configs.py:smoke_pipeline_cfg`) with the
JAX package's `randomize_params(scale=0.2)` weights loaded through the
bridge.  Tolerances: crops bit-equal (same float32 ops); resizes 1e-6 (the
same matrices, sums in another order); CLIP features and losses 1e-4 (flax
LayerNorm takes the variance as E[x²]−E[x]², torch does not).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from diffusion_spacetime_attn_tpu import config as jcfg
from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
from diffusion_spacetime_attn_tpu.models.clip import cosine_similarity as j_cos
from diffusion_spacetime_attn_tpu.pipeline.losses import DCLIPLoss as JDCLIPLoss
from diffusion_spacetime_attn_tpu.pipeline.losses import bilinear_resize as j_bilinear
from diffusion_spacetime_attn_tpu.pipeline.losses import global_resize as j_global
from diffusion_spacetime_attn_tpu.testbed.configs import smoke_pipeline_cfg
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models.clip import CLIP, clip_normalize, cosine_similarity
from diffusion_spacetime_attn_tpu_torch.ops import masks as tmasks
from diffusion_spacetime_attn_tpu_torch.pipeline.losses import (
    DCLIPLoss,
    bilinear_resize,
    global_resize,
)
from diffusion_spacetime_attn_tpu_torch.utils.weights import bridge, torch_key

jmasks = importlib.import_module("diffusion_spacetime_attn_tpu.ops.masks")
ATOL = 1e-4


def port_cfg(c):
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (port_cfg(getattr(c, f.name))
                           if dataclasses.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dataclasses.fields(c)})


def flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


def _close(got, want, atol=ATOL, rtol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------- crops


@pytest.mark.parametrize("S,crop_half", [(32, 0.2), (512, 0.2), (64, 0.1)])
def test_crop_window_and_dynamic_crop_bit_equal(S, crop_half):
    r = np.random.RandomState(S)
    centers = np.concatenate([r.rand(2, 3, 2), [[[0.0, 1.0], [0.99, 0.01], [0.5, 0.5]]] * 2],
                             axis=1).astype(np.float32)              # borders clamp
    js, jsize = jmasks.crop_window(jnp.asarray(centers), S, crop_half)
    ts, tsize = tmasks.crop_window(torch.from_numpy(centers), S, crop_half)
    assert tsize == jsize and ts.dtype == torch.int32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    img = r.rand(S, S, 3).astype(np.float32)
    for start in ts.reshape(-1, 2).tolist() + [[-3, S], [S, -1]]:  # out of range: clamped
        want = jmasks.dynamic_crop(jnp.asarray(img), jnp.asarray(start, jnp.int32), tsize)
        got = tmasks.dynamic_crop(torch.from_numpy(img), start, tsize)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dynamic_crop_is_differentiable_into_the_image():
    img = torch.rand(16, 16, 3, requires_grad=True)
    tmasks.dynamic_crop(img, (2, 5), 6).sum().backward()
    want = torch.zeros(16, 16, 3)
    want[2:8, 5:11] = 1.0
    torch.testing.assert_close(img.grad, want, atol=0, rtol=0)


# ---------------------------------------------------------------- resizes


@pytest.mark.parametrize("S", [32, 512])
def test_global_resize_matches_jax(S):
    x = np.random.RandomState(S).rand(2, S, S, 3).astype(np.float32)
    got = global_resize(torch.from_numpy(x))
    assert got.shape == (2, S * 7 // 16, S * 7 // 16, 3)
    _close(got, j_global(jnp.asarray(x)), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("shape,size", [((3, 12, 12, 3), 14), ((2, 204, 204, 3), 224),
                                        ((1, 10, 17, 3), 8)])
def test_bilinear_resize_matches_jax(shape, size):
    x = np.random.RandomState(size).rand(*shape).astype(np.float32)
    _close(bilinear_resize(torch.from_numpy(x), size), j_bilinear(jnp.asarray(x), size),
           atol=1e-6, rtol=1e-6)


def test_bilinear_resize_is_torch_interpolate_without_antialias():
    x = torch.rand(2, 20, 20, 3)
    want = torch.nn.functional.interpolate(x.permute(0, 3, 1, 2), size=(14, 14),
                                           mode="bilinear", align_corners=False,
                                           antialias=False).permute(0, 2, 3, 1)
    torch.testing.assert_close(bilinear_resize(x, 14), want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- CLIP


@pytest.fixture(scope="module")
def clip_pair():
    """(JAX DCLIPLoss, port DCLIPLoss, cfg) with equal smoke-config weights."""
    cfg = smoke_pipeline_cfg().loss_clip
    model = JCLIP(cfg)
    size, L = cfg.vision.image_size, cfg.text.max_len
    params = jax.eval_shape(model.init, jax.random.PRNGKey(4), jnp.zeros((1, size, size, 3)),
                            jnp.zeros((1, L), jnp.int32))["params"]
    params = randomize_params(params, jax.random.PRNGKey(5), 0.2)
    return (JDCLIPLoss(model, params), DCLIPLoss.from_flat(port_cfg(cfg), flat(params),
                                                           device="cpu"), cfg)


def _tokens(cfg, n, seed):
    r = np.random.RandomState(seed)
    V, L = cfg.text.vocab_size, cfg.text.max_len
    ids = r.randint(1, V - 1, size=(n, L)).astype(np.int32)
    ids[:, -1] = V - 1   # EOT, the highest id
    return ids


def test_clip_bridge_loads_the_dual_tower_tree_exactly(clip_pair):
    jl, tl, _ = clip_pair
    fl = flat(jl.params)
    assert any(k.startswith("vision/") for k in fl) and "visual_projection/kernel" in fl
    state = bridge(fl, tl.clip)
    assert set(state) == set(tl.clip.state_dict())
    for path, arr in fl.items():
        key, value = torch_key(path, arr)
        np.testing.assert_array_equal(tl.clip.state_dict()[key].numpy(), value)
    fl.pop("vision/class_embedding")
    with pytest.raises(KeyError, match="missing"):
        bridge(fl, tl.clip)
    fl = flat(jl.params)
    fl["text_projection/bias"] = np.zeros(16, np.float32)
    with pytest.raises(KeyError, match="unexpected"):
        bridge(fl, tl.clip)


def test_clip_bridge_covers_full_vit_b32_key_set():
    """At ViT-B/32 size (shapes only: jax.eval_shape and torch's meta
    device) every JAX parameter maps onto exactly one port parameter."""
    cfg = jcfg.CLIPConfig()
    tree = jax.eval_shape(JCLIP(cfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                          jnp.zeros((1, 77), jnp.int32))["params"]
    got = {}
    for path, s in traverse_util.flatten_dict(tree, sep="/").items():
        key, value = torch_key(path, np.broadcast_to(np.float32(0), s.shape))
        got[key] = tuple(value.shape)
    with torch.device("meta"):
        model = CLIP(tcfg.CLIPConfig())
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert want["vision.patch_embedding.weight"] == (768, 3, 32, 32)
    assert want["visual_projection.weight"] == (512, 768)
    assert want["text_projection.weight"] == (512, 512)
    assert 1.45e8 < sum(np.prod(s) for s in want.values()) < 1.55e8   # ViT-B/32: 151 M


def test_clip_vision_tower_and_encoders_match_jax(clip_pair):
    jl, tl, cfg = clip_pair
    size = cfg.vision.image_size
    px = np.random.RandomState(1).rand(3, size, size, 3).astype(np.float32)
    ids = _tokens(cfg, 3, seed=2)
    p = {"params": jl.params}
    with torch.no_grad():
        _close(tl.clip.vision(torch.from_numpy(px)),
               jl.clip.apply(p, jnp.asarray(px), method=lambda m, x: m.vision(x)))
        _close(tl.encode_images(torch.from_numpy(px)), jl.encode_images(jnp.asarray(px)))
        _close(tl.encode_texts(ids), jl.encode_texts(jnp.asarray(ids)))


def test_clip_normalize_and_cosine_match_jax():
    from diffusion_spacetime_attn_tpu.models.clip import clip_normalize as j_norm

    r = np.random.RandomState(3)
    x = r.rand(2, 5, 5, 3).astype(np.float32)
    _close(clip_normalize(torch.from_numpy(x)), j_norm(jnp.asarray(x)), atol=1e-6, rtol=1e-6)
    a, b = r.randn(4, 16).astype(np.float32), r.randn(4, 16).astype(np.float32)
    b[0] = 0.0   # the eps clamp
    _close(cosine_similarity(torch.from_numpy(a), torch.from_numpy(b)),
           j_cos(jnp.asarray(a), jnp.asarray(b)), atol=1e-6, rtol=1e-6)


def test_dclip_global_and_local_losses_match_jax(clip_pair):
    """Images at the smoke config's 32 pixels: global_resize to 14, crops of
    12 resized to 14; 2 prompts x 2 objects, one inactive."""
    jl, tl, cfg = clip_pair
    r = np.random.RandomState(4)
    images = r.rand(2, 32, 32, 3).astype(np.float32)
    centers = np.array([[[0.3, 0.4], [0.9, 0.05]], [[0.5, 0.5], [0.2, 0.8]]], np.float32)
    active = np.array([[1, 1], [1, 0]], np.float32)
    cap, obj = _tokens(cfg, 2, seed=5), _tokens(cfg, 4, seed=6).reshape(2, 2, -1)
    with torch.no_grad():
        _close(tl.global_loss(torch.from_numpy(images), cap),
               jl.global_loss(jnp.asarray(images), jnp.asarray(cap)))
        _close(tl.local_loss(torch.from_numpy(images), torch.from_numpy(centers), obj,
                             torch.from_numpy(active)),
               jl.local_loss(jnp.asarray(images), jnp.asarray(centers), jnp.asarray(obj),
                             jnp.asarray(active)))


def test_dclip_losses_are_differentiable_in_the_image(clip_pair):
    """The chain's gradient enters through the images: both losses reach
    them, and an inactive object adds nothing."""
    _, tl, cfg = clip_pair
    img = torch.rand(1, 32, 32, 3, requires_grad=True)
    centers = torch.tensor([[[0.3, 0.4], [0.7, 0.7]]])
    obj = _tokens(cfg, 2, seed=7).reshape(1, 2, -1)
    tl.local_loss(img, centers, obj, torch.tensor([[1.0, 0.0]])).sum().backward()
    g = img.grad[0].abs().sum(-1)
    assert float(g[6:18, 3:15].sum()) > 0          # object 0: y 12.8 - 6, x 9.6 - 6
    g[6:18, 3:15] = 0.0
    assert float(g.abs().max()) == 0.0             # nothing outside its crop
    img.grad = None
    tl.global_loss(img, _tokens(cfg, 1, seed=8)).sum().backward()
    assert float(img.grad.abs().min()) > 0
