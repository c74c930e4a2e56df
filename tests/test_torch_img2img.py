"""PyTorch port, the image-in paths held against the JAX package on the CPU:
the VAE encode (mean and a keyed sample), `VQModel`, the unconditional UNet,
DDPM, DDIM's inpainting mask / x0 / start_step, the nearest mask resize,
`img2img`, `inpaint`, and the `sample_diffusion` core, each on the same
weights (carried across with the weight bridge) and the same JAX keys.

Configs: the testbed's smoke pipeline (`testbed/configs.py`) with N(0, 0.2²)
weights; `sample_diffusion`'s `--tiny` models.  Tolerances, float32:
encode, eps and images 1e-4 (absolute and relative); VQ indices equal,
z_q and the loss 1e-5; sampler chains 1e-5 on a smooth eps function as in
`test_torch_samplers.py`; mask indices equal.  Torch takes one thread.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.config import ScheduleConfig as JScheduleConfig
from diffusion_spacetime_attn_tpu.config import UNetConfig as JUNetConfig
from diffusion_spacetime_attn_tpu.config import VAEConfig as JVAEConfig
from diffusion_spacetime_attn_tpu.models.unet import UNet as JUNet
from diffusion_spacetime_attn_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from diffusion_spacetime_attn_tpu.models.vae import VQModel as JVQModel
from diffusion_spacetime_attn_tpu.ops.schedule import make_schedule as jmake_schedule
from diffusion_spacetime_attn_tpu.pipeline import img2img as jimg2img
from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
from diffusion_spacetime_attn_tpu.samplers.ddim import ddim_sample as jddim
from diffusion_spacetime_attn_tpu.samplers.ddpm import ddpm_sample as jddpm
from diffusion_spacetime_attn_tpu.testbed.configs import smoke_pipeline_cfg
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
from diffusion_spacetime_attn_tpu_torch.models.vae import AutoencoderKL, VQModel
from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
from diffusion_spacetime_attn_tpu_torch.pipeline import img2img as timg2img
from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
from diffusion_spacetime_attn_tpu_torch.samplers.ddim import ddim_sample
from diffusion_spacetime_attn_tpu_torch.samplers.ddpm import ddpm_sample
from diffusion_spacetime_attn_tpu_torch.scripts import img2img as img2img_cli
from diffusion_spacetime_attn_tpu_torch.scripts import sample_diffusion
from diffusion_spacetime_attn_tpu_torch.utils import prng
from diffusion_spacetime_attn_tpu_torch.utils.png import read_png, write_png
from diffusion_spacetime_attn_tpu_torch.utils.weights import load_flat
from test_torch_pipeline import flat, port_cfg

ATOL = 1e-4
CHAIN_ATOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=atol)


def randomized(params, seed):
    return randomize_params(params, jax.random.PRNGKey(seed), 0.2)


@pytest.fixture(scope="module")
def bundles():
    """(JAX StableDiffusion, the port's on the same weights), smoke config,
    4 DDIM steps, guidance 5."""
    cfg = smoke_pipeline_cfg(num_steps=4)
    sd = JSD.create(cfg, jax.random.PRNGKey(0), abstract=True)
    sd = dataclasses.replace(sd, unet_params=randomized(sd.unet_params, 1),
                             vae_params=randomized(sd.vae_params, 2),
                             text_params=randomized(sd.text_params, 3))
    tsd = StableDiffusion.from_flat(port_cfg(cfg), flat(sd.unet_params), flat(sd.vae_params),
                                    flat(sd.text_params), device="cpu")
    r = np.random.RandomState(0)
    V, L = cfg.text_encoder.vocab_size, cfg.text_encoder.max_len
    ids = r.randint(1, V - 1, size=(4, L)).astype(np.int32)
    img = r.uniform(-1, 1, size=(2, 32, 32, 3)).astype(np.float32)
    mask = np.zeros((2, 32, 32, 1), np.float32)
    mask[:, :, :16] = 1.0                   # keep the left half
    mask[1, 20:] = 1.0
    with torch.inference_mode():
        tcond, tuncond = tsd.encode_text(ids[:2]), tsd.encode_text(ids[2:])
    jcond, juncond = sd.encode_text(jnp.asarray(ids[:2])), sd.encode_text(jnp.asarray(ids[2:]))
    return dict(sd=sd, tsd=tsd, img=img, mask=mask, t=(tcond, tuncond), j=(jcond, juncond))


# ---------------------------------------------------------------- encode side


def test_vae_encode_mean_and_keyed_sample_match_jax(bundles):
    sd, tsd, img = bundles["sd"], bundles["tsd"], bundles["img"]
    key = 11
    jmean = jax.jit(lambda x: sd.encode_images(x))(jnp.asarray(img))
    jsamp = jax.jit(lambda x, k: sd.encode_images(x, k))(jnp.asarray(img),
                                                         jax.random.PRNGKey(key))
    with torch.inference_mode():
        mean = tsd.encode_images(torch.from_numpy(img))
        samp = tsd.encode_images(torch.from_numpy(img), prng.PRNGKey(key))
    assert mean.shape == (2, 8, 8, 4)
    close(mean, jmean)
    close(samp, jsamp)
    assert float((samp - mean).abs().max()) > 1e-3      # the sample is not the mean


def test_vq_model_matches_jax():
    """encode -> (z_q, loss, indices), decode, decode_code, forward and the
    VQModelInterface pair; the straight-through gradient reaches the input."""
    cfg = JVAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, n_embed=16, resolution=16)
    model = JVQModel(cfg)
    params = jax.tree.map(jnp.asarray, randomized(jax.eval_shape(
        model.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))["params"], 5))
    tmodel = load_flat(VQModel(port_cfg(cfg)), flat(params)).eval()
    x = np.random.RandomState(3).uniform(-1, 1, size=(2, 16, 16, 3)).astype(np.float32)

    @jax.jit
    def jax_side(x):
        def apply(method, *a):
            return model.apply({"params": params}, *a, method=method)
        q, loss, idx = apply(JVQModel.encode, x)
        h = apply(JVQModel.interface_encode, x)
        return dict(q=q, loss=loss, idx=idx, dec=apply(JVQModel.decode, q),
                    code=apply(JVQModel.decode_code, idx),
                    rec=model.apply({"params": params}, x)[0],
                    h=h, iq=apply(lambda m, a: m.interface_decode(a), h),
                    inq=apply(lambda m, a: m.interface_decode(a, True), h))

    j = jax_side(jnp.asarray(x))
    with torch.no_grad():
        tq, tloss, tidx = tmodel.encode(torch.from_numpy(x))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(j["idx"]))
        assert len(np.unique(np.asarray(j["idx"]))) > 2
        close(tq, j["q"], atol=1e-5)
        assert abs(tloss.item() - float(j["loss"])) <= 1e-5 * max(1.0, abs(float(j["loss"])))
        close(tmodel.decode(tq), j["dec"])
        close(tmodel.decode_code(tidx), j["code"])
        close(tmodel(torch.from_numpy(x))[0], j["rec"])
        h = tmodel.interface_encode(torch.from_numpy(x))
        close(h, j["h"])
        close(tmodel.interface_decode(h), j["iq"])
        close(tmodel.interface_decode(h, force_not_quantize=True), j["inq"])
    xg = torch.from_numpy(x).requires_grad_(True)
    q, loss, _ = tmodel.encode(xg)
    (q.sum() + loss).backward()
    assert xg.grad is not None and float(xg.grad.abs().max()) > 0


# ---------------------------------------------------------------- unconditional UNet


UNCOND_CFG = JUNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                         attention_resolutions=(1, 2), num_heads=2, context_dim=16)


def _unet_params(context):
    unet = JUNet(UNCOND_CFG)
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                            jnp.zeros((1,), jnp.int32), context)["params"]
    return unet, randomized(shapes, 7)


@pytest.fixture(scope="module")
def uncond():
    """(JAX eps of the unconditional UNet at x, t; its params; x; t)."""
    unet, params = _unet_params(None)
    r = np.random.RandomState(1)
    x = r.randn(2, 8, 8, 4).astype(np.float32)
    t = np.array([981, 21], np.int32)
    eps = jax.jit(lambda x, t: unet.apply({"params": params}, x, t, None))(x, t)
    return np.asarray(eps), params, x, t


@pytest.mark.parametrize("flags", [{}, {"use_mha": True, "use_fused_ff": True},
                                   {"use_flash": True}])
def test_unconditional_unet_eps_matches_jax(uncond, flags):
    """attn2 is self-attention with dim -> dim projections and attn1's
    routing flags; on CPU tensors the kernel flags route to the plain
    versions, so eps is the same."""
    want, params, x, t = uncond
    tunet = load_flat(UNet(port_cfg(dataclasses.replace(UNCOND_CFG, **flags)),
                           conditional=False), flat(params)).eval()
    with torch.inference_mode():
        got = tunet(torch.from_numpy(x), torch.from_numpy(t))
    close(got, want)
    blk = tunet.down_attn_0.block_0
    assert tuple(blk.attn2.to_k.weight.shape) == (32, 32)
    assert blk.attn2.mha == blk.attn1.mha and blk.attn2.flash == blk.attn1.flash


def test_unconditional_and_conditional_trees_do_not_cross(uncond):
    """The bridge refuses a conditional tree for an unconditional UNet and
    the other way round (attn2's to_k / to_v shapes differ); each UNet
    raises when called the other way."""
    params = uncond[1]
    _, cond_params = _unet_params(jnp.zeros((1, 7, 16)))
    cfg = port_cfg(UNCOND_CFG)
    with pytest.raises(ValueError, match="shape"):
        load_flat(UNet(cfg, conditional=False), flat(cond_params))
    with pytest.raises(ValueError, match="shape"):
        load_flat(UNet(cfg), flat(params))
    x, t = torch.zeros(1, 8, 8, 4), torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="takes no context"):
        UNet(cfg, conditional=False)(x, t, torch.zeros(1, 7, 16))
    with pytest.raises(ValueError, match="needs a context"):
        UNet(cfg)(x, t)


# ---------------------------------------------------------------- samplers


def jax_eps(w):
    def eps_fn(x, t, i):
        return jnp.tanh(0.8 * x * (1.0 + 0.1 * w[i]) + 0.001 * t) + 0.05 * x
    return eps_fn


def torch_eps(w):
    def eps_fn(x, t, i):
        return torch.tanh(0.8 * x * (1.0 + 0.1 * w[i]) + 0.001 * t) + 0.05 * x
    return eps_fn


@pytest.mark.parametrize("clip_denoised, v_posterior", [(False, 0.0), (True, 0.0), (False, 0.5)])
def test_ddpm_chain_matches_jax(clip_denoised, v_posterior):
    """The full ancestral chain over a 40-step train schedule on split(key, T)."""
    T = 40
    r = np.random.RandomState(2)
    x_T, w = r.randn(2, 8, 8, 4).astype(np.float32), r.rand(T).astype(np.float32)
    want = jddpm(jax_eps(jnp.asarray(w)), jnp.asarray(x_T), JScheduleConfig(num_train_timesteps=T),
                 jax.random.PRNGKey(4), clip_denoised=clip_denoised, v_posterior=v_posterior,
                 remat=False)
    got = ddpm_sample(torch_eps(torch.from_numpy(w)), torch.from_numpy(x_T),
                      tcfg.ScheduleConfig(num_train_timesteps=T), prng.PRNGKey(4),
                      clip_denoised=clip_denoised, v_posterior=v_posterior, remat=False)
    close(got, want, atol=CHAIN_ATOL)


@pytest.mark.parametrize("start_step, with_mask, eta", [(0, True, 0.0), (2, True, 1.0),
                                                        (3, False, 1.0), (2, False, 0.0)])
def test_ddim_mask_x0_start_step_match_jax(start_step, with_mask, eta):
    """Inpainting re-noise from split(key, 2S)[1, i] (PRNGKey(0) without a
    key), σ·z from [0, i], and the loop from start_step with eps_fn getting
    the loop position."""
    S = 6
    r = np.random.RandomState(3)
    x_T, w = r.randn(2, 8, 8, 4).astype(np.float32), r.rand(S).astype(np.float32)
    x0 = r.randn(2, 8, 8, 4).astype(np.float32)
    mask = (r.rand(2, 8, 8, 1) > 0.5).astype(np.float32)
    seen = []
    jkw = dict(mask=jnp.asarray(mask), x0=jnp.asarray(x0)) if with_mask else {}
    tkw = dict(mask=torch.from_numpy(mask), x0=torch.from_numpy(x0)) if with_mask else {}
    jrng, trng = (jax.random.PRNGKey(8), prng.PRNGKey(8)) if eta else (None, None)
    want = jddim(jax_eps(jnp.asarray(w)), jnp.asarray(x_T),
                 jmake_schedule(JScheduleConfig(), S, eta=eta), rng=jrng, remat=False,
                 start_step=start_step, **jkw)
    teps = torch_eps(torch.from_numpy(w))
    got = ddim_sample(lambda x, t, i: seen.append(i) or teps(x, t, i), torch.from_numpy(x_T),
                      make_schedule(tcfg.ScheduleConfig(), S, eta=eta), rng=trng, remat=False,
                      start_step=start_step, **tkw)
    close(got, want, atol=CHAIN_ATOL)
    assert seen == list(range(start_step, S))
    with pytest.raises(ValueError, match="x0 required"):
        ddim_sample(teps, torch.from_numpy(x_T), make_schedule(tcfg.ScheduleConfig(), S),
                    mask=torch.from_numpy(mask))


@pytest.mark.parametrize("src, dst", [((16, 16), (2, 2)), ((512, 512), (64, 64)),
                                      ((32, 32), (8, 8)), ((37, 29), (5, 4)), ((10, 7), (3, 3)),
                                      ((3, 5), (7, 11))])
def test_nearest_mask_resize_matches_jax(src, dst):
    """jax.image.resize(..., "nearest") keeps rows floor((i + 0.5)·in/out):
    8i + 4 at f = 8, where torch's "nearest" keeps 8i."""
    x = np.arange(np.prod(src), dtype=np.float32).reshape(1, *src, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, *dst, 1), "nearest"))
    got = timg2img.resize_nearest(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(got, want)
    if src == (16, 16):
        assert got[0, :, :, 0].tolist() == [[68, 76], [196, 204]]        # rows and columns 4, 12


# ---------------------------------------------------------------- img2img / inpaint


@pytest.mark.parametrize("strength", [0.75, 0.5])
def test_img2img_matches_jax(bundles, strength):
    sd, tsd, img = bundles["sd"], bundles["tsd"], bundles["img"]
    want = jax.jit(lambda x, c, u, k: jimg2img.img2img(sd, x, c, u, k, strength=strength))(
        jnp.asarray(img), *bundles["j"], jax.random.PRNGKey(5))
    got = timg2img.img2img(tsd, torch.from_numpy(img), *bundles["t"], prng.PRNGKey(5),
                           strength=strength)
    assert got.shape == (2, 32, 32, 3)
    close(got, want)


def test_inpaint_matches_jax(bundles):
    sd, tsd, img, mask = bundles["sd"], bundles["tsd"], bundles["img"], bundles["mask"]
    want = jax.jit(lambda x, m, c, u, k: jimg2img.inpaint(sd, x, m, c, u, k))(
        jnp.asarray(img), jnp.asarray(mask), *bundles["j"], jax.random.PRNGKey(6))
    got = timg2img.inpaint(tsd, torch.from_numpy(img), torch.from_numpy(mask), *bundles["t"],
                           prng.PRNGKey(6))
    close(got, want)
    with pytest.raises(ValueError, match="strength"):
        timg2img.img2img(tsd, torch.from_numpy(img), *bundles["t"], prng.PRNGKey(6),
                         strength=0.0)


def test_img2img_cli_writes_the_pipeline_image(bundles, tmp_path):
    """The CLI (--tiny --cpu: seeded weights) reads the PNGs (the mask as
    PIL's luma), runs the pipeline on the key of --seed and writes the
    rounded image; an image that is not --size square is resized as PIL's
    default filter does."""
    init = ((bundles["img"][0] + 1.0) * 127.5).astype(np.uint8)
    write_png(str(tmp_path / "in.png"), init)
    mask = np.repeat((bundles["mask"][0] * 255).astype(np.uint8), 3, axis=-1)
    write_png(str(tmp_path / "mask.png"), mask)
    base = ["--init", str(tmp_path / "in.png"), "--prompt", "a cat", "--size", "32", "--cpu",
            "--tiny", "--steps", "3", "--seed", "3", "--outdir", str(tmp_path)]
    path = img2img_cli.main(base + ["--mask", str(tmp_path / "mask.png")])
    assert os.path.basename(path) == "inpaint_s3.png"
    cfg = img2img_cli.pipeline_config(img2img_cli.parse_args(base))
    tsd = StableDiffusion.create(cfg, seed=0, device="cpu")
    L = cfg.text_encoder.max_len
    tok = img2img_cli.padded(img2img_cli.make_clip_tokenizer(None, max_len=L), L)
    with torch.inference_mode():
        cond, uncond = (tsd.encode_text(np.asarray(tok(t), np.int32)[None]) for t in ("a cat", ""))
    x = torch.from_numpy(init.astype(np.float32)[None] / 127.5 - 1.0)
    m = torch.from_numpy(mask[None, :, :, :1].astype(np.float32) / 255.0)
    want = timg2img.inpaint(tsd, x, m, cond, uncond, prng.PRNGKey(3), guidance_scale=7.5)
    np.testing.assert_array_equal(read_png(path),
                                  (want[0].numpy() * 255.0 + 0.5).astype(np.uint8))
    assert img2img_cli.main(base).endswith("img2img_s3.png")
    big = np.random.RandomState(5).randint(0, 256, (40, 48, 3), dtype=np.uint8)
    write_png(str(tmp_path / "big.png"), big)
    from PIL import Image
    want = np.asarray(Image.fromarray(big).resize((32, 32)))
    np.testing.assert_array_equal(img2img_cli.read_square(str(tmp_path / "big.png"), 32), want)


# ---------------------------------------------------------------- sample_diffusion


@pytest.fixture(scope="module")
def tiny_models():
    """sample_diffusion --tiny's UNet (unconditional) and VAE, float32, with
    N(0, 0.2²) weights in both packages."""
    args = sample_diffusion.parse_args(["--tiny", "--cpu", "--dtype", "float32"])
    ucfg, vcfg, hw, scfg = sample_diffusion.configs(args)
    junet = JUNet(JUNetConfig(**dataclasses.asdict(ucfg)))
    jvae = JAutoencoderKL(JVAEConfig(**dataclasses.asdict(vcfg)))
    up = randomized(jax.eval_shape(junet.init, jax.random.PRNGKey(0), jnp.zeros((1, hw, hw, 4)),
                                   jnp.zeros((1,), jnp.int32), None)["params"], 8)
    vp = randomized(jax.eval_shape(jvae.init, jax.random.PRNGKey(0),
                                   jnp.zeros((1, 32, 32, 3)))["params"], 9)
    tunet, tvae = sample_diffusion.build_models(ucfg, vcfg, "cpu")
    load_flat(tunet, flat(up))
    load_flat(tvae, flat(vp))
    return dict(junet=junet, jvae=jvae, up=up, vp=vp, models=(tunet, tvae), hw=hw,
                scfg=scfg, vcfg=vcfg)


def _jax_run(m, key, B, vanilla, steps=3, eta=1.0):
    """The JAX script's `run` (scripts/sample_diffusion.py), on its key."""
    scfg = JScheduleConfig(**dataclasses.asdict(m["scfg"]))
    k_init, k_chain = jax.random.split(key)
    x_T = jax.random.normal(k_init, (B, m["hw"], m["hw"], 4), jnp.float32)

    def eps_fn(x, t, i):
        return m["junet"].apply({"params": m["up"]}, x, jnp.full((x.shape[0],), t, jnp.int32),
                                None)

    if vanilla:
        z = jddpm(eps_fn, x_T, scfg, k_chain)
    else:
        z = jddim(eps_fn, x_T, jmake_schedule(scfg, steps, eta=eta),
                  rng=k_chain if eta > 0 else None)
    img = m["jvae"].apply({"params": m["vp"]}, z / m["vcfg"].scale_factor,
                          method=JAutoencoderKL.decode)
    return jnp.clip((img + 1.0) / 2.0, 0.0, 1.0)


@pytest.mark.parametrize("vanilla", [False, True])
def test_sample_diffusion_core_matches_jax(tiny_models, vanilla):
    """One batch on the script's key tree: DDIM-3 at eta 1 (the default
    path, split at every step) and the vanilla DDPM chain over the tiny
    32-step train schedule."""
    m = tiny_models
    key = jax.random.split(jax.random.split(jax.random.PRNGKey(42), 3)[2])[1]
    tkey = prng.split(prng.split(prng.PRNGKey(42), 3)[2])[1]
    want = jax.jit(lambda k: _jax_run(m, k, 2, vanilla))(key)
    got = sample_diffusion.sample_batch(*m["models"], tkey, 2, m["hw"], m["scfg"], 3, 1.0,
                                        vanilla)
    close(got, want)


def test_sample_diffusion_cli_writes_jax_files(tiny_models, tmp_path):
    m = tiny_models
    out = sample_diffusion.main(["--tiny", "--cpu", "--dtype", "float32", "-n", "3",
                                 "--batch-size", "2", "-c", "2", "--npz", "-l", str(tmp_path)],
                                models=m["models"])
    names = sorted(os.listdir(tmp_path))
    assert names == ["000000.png", "000001.png", "000002.png", "samples.npz",
                     "sampling_config.json"]
    arr = out["images"]
    assert arr.shape == (3, 32, 32, 3) and np.isfinite(arr).all()
    np.testing.assert_array_equal(read_png(str(tmp_path / "000002.png")),
                                  (arr[2] * 255.0).clip(0, 255).astype(np.uint8))
    npz = np.load(tmp_path / "samples.npz")["arr_0"]
    np.testing.assert_array_equal(npz, (arr * 255.0 + 0.5).clip(0, 255).astype(np.uint8))
    config = json.load(open(tmp_path / "sampling_config.json"))
    assert sorted(config) == sorted(
        ["n_samples", "batch_size", "vanilla", "custom_steps", "eta", "clip_denoised", "logdir",
         "ckpt_dir", "ckpt_step", "vae_ckpt", "seed", "dtype", "npz", "tiny"])
    # the second batch's key: rng, k = split(rng) after r1, r2, rng = split(PRNGKey(42), 3)
    rng = prng.split(prng.PRNGKey(42), 3)[2]
    for _ in range(2):
        rng, k = prng.split(rng)
    second = sample_diffusion.sample_batch(*m["models"], k, 2, m["hw"], m["scfg"], 2, 1.0)
    np.testing.assert_array_equal(arr[2], second[0].numpy())
    with pytest.raises(NotImplementedError, match="A.15"):
        sample_diffusion.main(["--tiny", "--cpu", "--ckpt-dir", str(tmp_path)])
