"""PyTorch port, the dataset runners held against the JAX package on the CPU:
`PromptRunner` in the vanilla, spatial and spacetime modes (its fixture is
shared with `tests/test_torch_batch_runner.py`), and the PNG writer and
reader.

Tiny configs of `tests/test_batch_runner.py` (UNet 32 channels, 16x16
latents, 32x32 images, 2 objects, PLMS-3), JAX's weights (randomized at
scale 0.2 so the blend-weight gradient is far above Adam's eps) loaded
through the bridge, the spacetime mode at 2 epochs.  Both packages draw
x_T as JAX does (`utils/prng.py` in the port).  Tolerances: float images
within 1e-4 + 1e-4·|ref| (the chain tests' tolerance,
`tests/test_torch_chain.py`); the PNGs, written from images truncated to
uint8, within 1 LSB on at most 0.1 % of the values (a 1e-6 difference can
cross a truncation step).
"""
import dataclasses
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from PIL import Image

from diffusion_spacetime_attn_tpu.config import (
    CLIPConfig,
    CLIPTextConfig,
    CLIPVisionConfig,
    LayoutConfig,
    PipelineConfig,
    SpaceTimeConfig,
    UNetConfig,
    VAEConfig,
)
from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
from diffusion_spacetime_attn_tpu.models.layout.model import create_layout_predictor
from diffusion_spacetime_attn_tpu.pipeline.frontend import LayoutInference as JLayoutInference
from diffusion_spacetime_attn_tpu.pipeline.losses import DCLIPLoss as JDCLIPLoss
from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
from diffusion_spacetime_attn_tpu.pipeline.runners import PromptRunner as JPromptRunner
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_clip_tokenizer as jclip_tok
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_roberta_tokenizer as jrob_tok
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models.layout.model import LayoutPredictor
from diffusion_spacetime_attn_tpu_torch.pipeline.frontend import LayoutInference
from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
from diffusion_spacetime_attn_tpu_torch.pipeline.runners import PromptRunner, save_image
from diffusion_spacetime_attn_tpu_torch.utils.png import read_png, write_png
from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import (
    make_clip_tokenizer,
    make_roberta_tokenizer,
)
from diffusion_spacetime_attn_tpu_torch.utils.weights import layout_state_dict

PROMPTS = [
    "a dog to the left of a cat",
    "a car above a bench",
    "no objects here at all",        # layout fails -> skipped
    "the bird sits on a chair",
    "a cup next to a laptop",
]
TOL = 1e-4
MODES = ("vanilla", "spatial", "spacetime")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test processes side by side on few cores,
    where torch's spinning intra-op threads slow each other down many-fold;
    this module's torch work is small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(c):
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (port_cfg(getattr(c, f.name))
                           if dataclasses.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dataclasses.fields(c)})


def flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


@pytest.fixture(scope="module")
def runners(tmp_path_factory):
    """{mode: (JAX PromptRunner, the port's)} over the same weights, each
    writing to its own directory."""
    text = CLIPTextConfig(width=16, layers=2, heads=2, vocab_size=49408, max_len=12)
    cfg = PipelineConfig(
        unet=UNetConfig(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                        attention_resolutions=(1, 2), num_heads=2, context_dim=16),
        vae=VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1),
        text_encoder=text,
        loss_clip=CLIPConfig(vision=CLIPVisionConfig(image_size=14, patch_size=7, width=16,
                                                     layers=2, heads=2, projection_dim=8),
                             text=text, projection_dim=8),
        spacetime=SpaceTimeConfig(num_steps=3, latent_size=16, image_size=32, max_objects=2,
                                  epochs=2))
    sd = JSD.create(cfg, jax.random.PRNGKey(0), abstract=True)
    sd = dataclasses.replace(
        sd,
        unet_params=randomize_params(sd.unet_params, jax.random.PRNGKey(1), 0.2),
        vae_params=randomize_params(sd.vae_params, jax.random.PRNGKey(2), 0.2),
        text_params=randomize_params(sd.text_params, jax.random.PRNGKey(3), 0.2))
    clip = JCLIP(cfg.loss_clip)
    cp = randomize_params(jax.eval_shape(clip.init, jax.random.PRNGKey(4),
                                         jnp.zeros((1, 14, 14, 3)),
                                         jnp.zeros((1, 12), jnp.int32))["params"],
                          jax.random.PRNGKey(5), 0.2)
    lcfg = LayoutConfig(hidden=32, layers=2, heads=2, ffn_dim=64, max_positions=140,
                        max_len=24)
    lmodel, lparams = create_layout_predictor(lcfg, jax.random.PRNGKey(6))
    tsd = StableDiffusion.from_flat(port_cfg(cfg), flat(sd.unet_params), flat(sd.vae_params),
                                    flat(sd.text_params), device="cpu")
    tloss = DCLIPLoss.from_flat(port_cfg(cfg.loss_clip), flat(cp), device="cpu")
    tlayout = LayoutPredictor(port_cfg(lcfg))
    tlayout.load_state_dict(layout_state_dict(jax.device_get(lparams), tlayout))
    tlayout.eval().requires_grad_(False)
    jtok, ttok = jclip_tok(max_len=12), make_clip_tokenizer(max_len=12)
    out = {}
    for mode in MODES:
        d = tmp_path_factory.mktemp(mode)
        j = JPromptRunner(sd=sd, clip_loss=JDCLIPLoss(clip, cp),
                          layout=JLayoutInference(lmodel, lparams, jrob_tok(), 24),
                          clip_tokenize=lambda t: jtok.pad_to(jtok.encode(t), 12),
                          text_tokenize=lambda t: jtok.pad_to(jtok.encode(t), 12),
                          cfg=cfg.spacetime, outdir=str(d / "jax"), mode=mode,
                          save_epoch_images=True)
        t = PromptRunner(sd=tsd, clip_loss=tloss, layout=LayoutInference(tlayout,
                                                                       make_roberta_tokenizer()),
                         clip_tokenize=lambda t: ttok.pad_to(ttok.encode(t), 12),
                         text_tokenize=lambda t: ttok.pad_to(ttok.encode(t), 12),
                         cfg=port_cfg(cfg.spacetime), outdir=str(d / "port"), mode=mode,
                         save_epoch_images=True)
        out[mode] = (j, t)
    return out


def close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    excess = np.abs(got - want) - (TOL + TOL * np.abs(want))
    assert excess.max() <= 0, (what, float(np.abs(got - want).max()))


def pngs_close(port_path, jax_path):
    """The port's PNG (read by utils/png.py) against JAX's (read by PIL):
    within 1 LSB, and off by one on at most 0.1 % of the values."""
    got = read_png(port_path).astype(int)
    want = np.asarray(Image.open(jax_path).convert("RGB")).astype(int)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())


def pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def test_prepare_host_matches_jax(runners):
    j, t = runners["spatial"]
    for p in PROMPTS:
        jh, th = j.prepare_host(p), t.prepare_host(p)
        if jh is None:
            assert th is None
            continue
        np.testing.assert_allclose(th["centers"], jh["centers"], atol=1e-5, rtol=0)
        for k in ("active", "obj_tokens", "caption_tokens"):
            np.testing.assert_array_equal(th[k], jh[k])
        assert th["local_texts"] == jh["local_texts"] and th["prompt"] == jh["prompt"]


@pytest.mark.parametrize("mode", MODES)
def test_prompt_runner_matches_jax(runners, mode):
    """run_one of a prompt with a relation (spacetime: and a second one)
    and of a skipped one: the float images, the files written (spacetime: every epoch's,
    `save_epoch_images`) and their pixels."""
    j, t = runners[mode]
    for idx in (0, 3) if mode == "spacetime" else (0,):
        want = j.run_one(PROMPTS[idx], idx, seed=1)
        got = t.run_one(PROMPTS[idx], idx, seed=1)
        close(got, want, f"{mode} prompt {idx}")
    assert j.run_one(PROMPTS[2], 2, seed=1) is None and t.run_one(PROMPTS[2], 2, seed=1) is None
    names = pngs(t.outdir)
    assert names == pngs(j.outdir)
    want_names = ["final1_s1_index_0.png"]
    if mode == "spacetime":
        want_names = ["final0_s1_index_0.png", "final0_s1_index_3.png",
                      "final1_s1_index_0.png", "final1_s1_index_3.png"]
    assert names == want_names
    for n in names:
        pngs_close(os.path.join(t.outdir, n), os.path.join(j.outdir, n))


def _png_bytes(rows, bpp, ftype):
    """An 8-bit PNG whose rows all carry filter `ftype` (spec section 9)."""
    h, stride = rows.shape
    out, prior = [], np.zeros(stride, np.int64)
    for y in range(h):
        x = rows[y].astype(np.int64)
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(x)
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (a + prior) // 2
        else:
            p = a + prior - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prior), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prior, c))
        out.append(bytes([ftype]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prior = x

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(
            ">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ctype = {3: 2, 4: 6}[bpp]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", stride // bpp, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_reads_write_png_pil_and_every_filter(tmp_path, channels):
    r = np.random.RandomState(channels)
    img = (r.rand(23, 17, channels) * 255).astype(np.uint8)
    img[4:15, 2:9] = 200                                   # flat and smooth areas
    img[:, 10:] = (np.arange(7)[None, :, None] * 30).astype(np.uint8)
    if channels == 3:
        write_png(str(tmp_path / "w.png"), img)
        np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), img)
    mode = "RGB" if channels == 3 else "RGBA"
    for i, opts in enumerate([{}, {"optimize": True}, {"compress_level": 0}]):
        Image.fromarray(img, mode).save(tmp_path / f"pil{i}.png", **opts)
        np.testing.assert_array_equal(read_png(str(tmp_path / f"pil{i}.png")), img)
    for ftype in range(5):
        path = tmp_path / f"f{ftype}.png"
        path.write_bytes(_png_bytes(img.reshape(23, -1), channels, ftype))
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)   # a valid file
        np.testing.assert_array_equal(read_png(str(path)), img)
    Image.fromarray(img[..., 0], "L").save(tmp_path / "gray.png")   # grey is read too
    np.testing.assert_array_equal(read_png(str(tmp_path / "gray.png"))[..., 0], img[..., 0])
    Image.fromarray(img[..., 0], "L").convert("P").save(tmp_path / "palette.png")
    with pytest.raises(ValueError, match="colour type"):
        read_png(str(tmp_path / "palette.png"))


def test_save_image_truncates_as_jax(tmp_path):
    img = np.array([[[0.0, 0.5, 1.0], [0.99999, 1.2, -0.1]]], np.float32)
    save_image(img, str(tmp_path / "a" / "x.png"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "a" / "x.png")),
                                  [[[0, 127, 255], [254, 255, 0]]])
