"""PyTorch port, training from image folders held against the JAX package on
the CPU:

  * `train_ldm --tiny --data-dir` with text conditioning (a folder of JPEGs
    and `captions.jsonl`) and with class conditioning (a synset tree): the
    first batch's (latents, context) within 1e-5 of JAX's (PIL's open,
    convert and resize, JAX's `encode_images` on PRNGKey(step) and
    `encode_text`, or JAX's `imagenet_tree` batches), and the first
    `train_step`'s loss within 1e-4 relative of JAX's (`p_losses` on the
    step's key, from the same init).  JAX's script cannot run these cases at
    `--tiny`: it builds the full-width VAE and text tower whatever the
    flags, and their 768-wide context does not fit the tiny UNet;
  * `train_ldm --tiny --conditioning superres --synthetic`: three steps'
    losses within 1e-4 relative of JAX's `LDMTrainer` from JAX's init on
    the batches JAX's script makes (the LR images within 1e-6).  JAX's
    script itself is not run: on the test session's 8 virtual CPU devices
    it compiles a sharded step, about 70 s here;
  * `train_vae --tiny --paths-txt`: the batches equal JAX's `lsun_split`
    ones; the VAE step itself is held in `test_torch_vae_training.py` (JAX's
    script draws its own flax init, which the port's entry point does not
    take), here finite;
  * `train_vae --lpips-ckpt` on a seeded synthetic file in taming's
    `vgg.pth` + torchvision's VGG16 `features.*` layout: parameter-exact
    through `convert_lpips`, equal to JAX's on the `net.slice` layout;
  * `train_searcher --image-dir` on JPEGs: JAX's script's embeddings within
    1e-4 (its CLIP replaced by the tiny one, as the port's `--tiny`);
  * `img2img --init` / `--mask` on non-square PNGs: the resized inputs
    equal PIL's bytes.
Torch takes one thread.
"""
import importlib.util
import io
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import diffusion_spacetime_attn_tpu.config as jconfig
from diffusion_spacetime_attn_tpu.config import CLIPTextConfig as JCLIPTextConfig
from diffusion_spacetime_attn_tpu.config import LDMTrainConfig as JLDMTrainConfig
from diffusion_spacetime_attn_tpu.config import ScheduleConfig as JScheduleConfig
from diffusion_spacetime_attn_tpu.config import UNetConfig as JUNetConfig
from diffusion_spacetime_attn_tpu.config import VAEConfig as JVAEConfig
from diffusion_spacetime_attn_tpu.models.clip import CLIPTextTower as JCLIPTextTower
from diffusion_spacetime_attn_tpu.models.encoders import ClassEmbedder as JClassEmbedder
from diffusion_spacetime_attn_tpu.models.unet import UNet as JUNet
from diffusion_spacetime_attn_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from diffusion_spacetime_attn_tpu.ops.schedule import make_schedule as jmake_schedule
from diffusion_spacetime_attn_tpu.training import image_data as jdata
from diffusion_spacetime_attn_tpu.training import ldm_trainer as jldm
from diffusion_spacetime_attn_tpu.training.degradation import degradation_bsrgan_light as jdegrade
from diffusion_spacetime_attn_tpu.training.ldm_trainer import LDMTrainer as JLDMTrainer
from diffusion_spacetime_attn_tpu.utils import convert as jconvert
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_clip_tokenizer as jclip_tokenizer
from diffusion_spacetime_attn_tpu_torch.models.clip import CLIP, CLIPTextTower
from diffusion_spacetime_attn_tpu_torch.models.layers import Conv, Dense
from diffusion_spacetime_attn_tpu_torch.models.vae import AutoencoderKL
from diffusion_spacetime_attn_tpu_torch.pipeline.knn2img import joint_clip_config
from diffusion_spacetime_attn_tpu_torch.scripts import img2img as img2img_cli
from diffusion_spacetime_attn_tpu_torch.scripts import train_ldm, train_searcher, train_vae
from diffusion_spacetime_attn_tpu_torch.training.perceptual import LPIPS
from diffusion_spacetime_attn_tpu_torch.utils import convert as tconvert
from diffusion_spacetime_attn_tpu_torch.utils.jpeg import encode_jpeg
from diffusion_spacetime_attn_tpu_torch.utils.png import write_png
from diffusion_spacetime_attn_tpu_torch.utils.testing import lpips_shapes, seeded_state_dict
from diffusion_spacetime_attn_tpu_torch.utils.weights import flatten_tree, load_flat
from test_torch_pipeline import flat, port_cfg

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4
TINY_UNET = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                 attention_resolutions=(1, 2), num_heads=2, context_dim=16)
TINY_VAE = JVAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1)
TINY_TEXT = JCLIPTextConfig(width=16, layers=2, heads=2, vocab_size=49408, max_len=7)
SCHED = JScheduleConfig()
B = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def photo(h, w, seed):
    r = np.random.RandomState(seed)
    coarse = r.randint(0, 256, (h // 8 + 2, w // 8 + 2, 3), dtype=np.uint8)
    base = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR)).astype(int)
    return np.clip(base + r.randint(-10, 11, base.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Port-written JPEGs of odd sizes with captions.jsonl, an LSUN-style
    split, and a two-synset tree."""
    root = tmp_path_factory.mktemp("data")
    rows = []
    for i in range(6):
        name = f"img{i}.jpg"
        (root / name).write_bytes(encode_jpeg(photo(40 + 3 * i, 52 - 2 * i, i), 70 + 4 * i))
        rows.append({"file": name, "text": f"a photo of thing number {i}"})
    (root / "captions.jsonl").write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    (root / "split.txt").write_text("\n".join(r["file"] for r in rows) + "\n")
    for s, syn in enumerate(("n03", "n01")):
        (root / "tree" / syn).mkdir(parents=True)
        for j in range(3):
            (root / "tree" / syn / f"{j}.JPEG").write_bytes(encode_jpeg(photo(36, 44 + j, 10 * s + j),
                                                                        85))
    return root


@pytest.fixture(scope="module")
def encoders():
    """JAX's tiny VAE and text tower (N(0, 0.2²) weights) and the port's on
    the same weights."""
    vae, text = JAutoencoderKL(TINY_VAE), JCLIPTextTower(TINY_TEXT)
    vp = jax.eval_shape(vae.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]
    tp = jax.eval_shape(text.init, jax.random.PRNGKey(1), jnp.zeros((1, 7), jnp.int32))["params"]
    vp = randomize_params(vp, jax.random.PRNGKey(2), 0.2)
    tp = randomize_params(tp, jax.random.PRNGKey(3), 0.2)
    with torch.device("cpu"):
        tvae, ttext = AutoencoderKL(port_cfg(TINY_VAE)), CLIPTextTower(port_cfg(TINY_TEXT))
    load_flat(tvae, flat(vp)).eval().requires_grad_(False)
    load_flat(ttext, flat(tp)).eval().requires_grad_(False)
    return (vae, vp, text, tp), (tvae, ttext)


def _jax_unet_init(cond):
    """N(0, 0.2²) weights of the tiny UNet (and the class embedder) in
    JAX's tree, and JAX's eps model of the conditioning."""
    unet = JUNet(JUNetConfig(**TINY_UNET), radius=0.2)
    ctx = jnp.zeros((B, 1, 16)) if cond == "class" else jnp.zeros((B, 7, 16))
    params = randomize_params(jax.eval_shape(unet.init, jax.random.PRNGKey(0),
                                             jnp.zeros((B, 16, 16, 4)), jnp.zeros((B,), jnp.int32),
                                             ctx)["params"], jax.random.PRNGKey(4), 0.2)
    if cond == "class":
        embed = JClassEmbedder(n_classes=2, embed_dim=16)
        params = {"unet": params, "cond": randomize_params(jax.eval_shape(
            embed.init, jax.random.PRNGKey(1), jnp.zeros((1,), jnp.int32))["params"],
            jax.random.PRNGKey(5), 0.2)}
        return params, lambda p, x, t, c: unet.apply(
            {"params": p["unet"]}, x, t, embed.apply({"params": p["cond"]},
                                                     c[:, 0].astype(jnp.int32)))
    return params, lambda p, x, t, c: unet.apply({"params": p}, x, t, c)


def _jax_first_batch(cond, data, jenc):
    """next_batch(0) of JAX's script at the tiny encoders: PIL's loading, its
    resize, encode_images on PRNGKey(0)."""
    vae, vp, text, tp = jenc
    if cond == "class":
        imgs, labels = next(jdata.imagenet_tree(str(data / "tree"), size=32).batches(B, seed=0))
        ctx = jnp.asarray(labels[:, None], jnp.float32)
    else:
        rows = [json.loads(line) for line in open(data / "captions.jsonl")]
        pick = [rows[j] for j in np.random.RandomState(0).randint(0, len(rows), B)]
        imgs = np.stack([np.asarray(Image.open(data / p["file"]).convert("RGB").resize((32, 32)))
                         / 127.5 - 1.0 for p in pick]).astype(np.float32)
        tok = jclip_tokenizer()
        ids = np.stack([tok.pad_to(tok.encode(p["text"]), 7) for p in pick]).astype(np.int32)
        ctx = jax.jit(lambda p, i: text.apply({"params": p}, i)[0])(tp, jnp.asarray(ids))
    z = jax.jit(lambda p, x, k: vae.apply({"params": p}, x, k, method=JAutoencoderKL.encode))(
        vp, jnp.asarray(imgs), jax.random.PRNGKey(0)) * TINY_VAE.scale_factor
    return z, ctx


@pytest.mark.parametrize("cond", ["text", "class"])
def test_train_ldm_data_dir_matches_jax(cond, data, encoders, tmp_path):
    jenc, tenc = encoders
    params, eps_model = _jax_unet_init(cond)
    argv = ["--tiny", "--cpu", "--dtype", "float32", "--steps", "3", "--batch-size", str(B),
            "--log-every", "1", "--ckpt-dir", str(tmp_path), "--conditioning", cond,
            "--data-dir", str(data / "tree" if cond == "class" else data), "--num-classes", "2"]
    argv[argv.index("--steps") + 1] = "2"
    out = train_ldm.main(argv, init=flat(params), encoders=tenc)
    z, ctx = _jax_first_batch(cond, data, jenc)
    for got, want in zip(out["first_batch"], (z, ctx)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    assert len(out["metrics"]) == 2 and all(np.isfinite(m["loss"]) for m in out["metrics"])
    # the first train_step's loss: JAX's p_losses on the step's key and the
    # initial logvar (the step reports the loss before its update)
    cfg = JLDMTrainConfig(batch_size=B)
    w = jnp.asarray(jldm.lvlb_weights(SCHED, cfg.parameterization))
    loss = jax.jit(lambda p, x, c, k: jldm.p_losses(
        cfg, jmake_schedule(SCHED, 50), w, eps_model, p,
        jnp.full((SCHED.num_train_timesteps,), cfg.logvar_init), x, c, k)[1]["loss"])(
        params, z, ctx, jax.random.fold_in(jax.random.PRNGKey(42), 0))
    assert rel(out["metrics"][0]["loss"], loss) <= TOL


def test_data_dir_text_tower_stays_float32_under_bfloat16(data, encoders):
    """`--dtype bfloat16` casts the VAE only: JAX's script builds
    `PipelineConfig(vae=VAEConfig(dtype=args.dtype))` and leaves the text
    tower at float32, so the contexts equal JAX's float32 ones."""
    jenc, _ = encoders
    args = train_ldm.parse_args(["--tiny", "--cpu", "--dtype", "bfloat16", "--conditioning",
                                 "text", "--data-dir", str(data), "--batch-size", str(B)])
    vae, text = train_ldm.data_encoders(args, "cpu")
    assert {p.dtype for m in vae.modules() if isinstance(m, (Dense, Conv))
            for p in m.parameters(recurse=False)} == {torch.bfloat16}
    assert {p.dtype for p in text.parameters()} == {torch.float32}
    load_flat(vae, flat(jenc[1]))
    load_flat(text, flat(jenc[3]))
    z, ctx = train_ldm.folder_batches(args, B, train_ldm.configs(args)[1], "cpu", (vae, text))(0)
    jz, jctx = _jax_first_batch("text", data, jenc)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), atol=1e-5, rtol=1e-5)
    assert tuple(z.shape) == jz.shape and torch.isfinite(z).all()


def test_train_ldm_superres_matches_jax(tmp_path):
    """Three steps from JAX's init on JAX's script's synthetic superres
    batches (its next_batch: RandomState(step) HQ images, JAX's
    `degradation_bsrgan_light` per row on seed step·B + b, noise latents)
    through JAX's `LDMTrainer` on one device."""
    unet = JUNet(JUNetConfig(**TINY_UNET, in_channels=7), radius=0.2)
    params = jax.jit(lambda k: unet.init(k, jnp.zeros((B, 16, 16, 7)), jnp.zeros((B,), jnp.int32),
                                         None)["params"])(jax.random.PRNGKey(0))
    flags = ["--tiny", "--cpu", "--synthetic", "--conditioning", "superres", "--steps", "3",
             "--log-every", "1", "--dtype", "float32", "--base-lr", "1e-5", "--sr-factor", "2",
             "--batch-size", str(B), "--ckpt-dir", str(tmp_path / "port")]
    out = train_ldm.main(flags, init=flat(params))
    trainer = JLDMTrainer(JLDMTrainConfig(batch_size=B, base_lr=1e-5), SCHED,
                          jmake_schedule(SCHED, 50),
                          lambda p, x, t, c: unet.apply({"params": p},
                                                        jnp.concatenate([x, c], -1), t, None),
                          ckpt_dir=str(tmp_path / "jax"), context_rank=4)
    state = trainer.init(params)
    for i, m in enumerate(out["metrics"]):
        r = np.random.RandomState(i)
        hq = r.rand(B, 32, 32, 3).astype(np.float32)
        lrs = np.stack([jdegrade(hq[b], sf=2, seed=i * B + b)[0] for b in range(B)])
        x0 = jnp.asarray(r.randn(B, 16, 16, 4), jnp.float32)
        ctx = jnp.asarray(lrs * 2.0 - 1.0, jnp.float32)
        if i == 0:
            got_x0, got_lr = out["first_batch"]
            np.testing.assert_array_equal(got_x0.numpy(), np.asarray(x0))
            np.testing.assert_allclose(got_lr.numpy(), np.asarray(ctx), atol=1e-6, rtol=0)
        state, jm = trainer.train_step(state, x0, ctx,
                                       jax.random.fold_in(jax.random.PRNGKey(42), i))
        assert rel(m["loss"], jm["loss"]) <= TOL, (i, m["loss"], float(jm["loss"]))


def test_train_vae_paths_txt_and_lpips_file(data, tmp_path):
    args = train_vae.parse_args(["--tiny", "--cpu", "--data-dir", str(data), "--paths-txt",
                                 str(data / "split.txt"), "--batch-size", "2"])
    nb = train_vae.image_batches(args, 2, 32, "cpu")
    it = jdata.lsun_split(str(data / "split.txt"), str(data), size=32, flip_p=0.5).batches(2, seed=0)
    for i in range(4):                          # past the first epoch's 3 batches
        np.testing.assert_array_equal(nb(i).numpy(), next(it)[0])
    # LPIPS weights in the published layouts: taming's heads + torchvision's VGG16
    sd = seeded_state_dict(lpips_shapes(), seed=5, scale=0.05)
    taming = {}
    for k, v in sd.items():
        if k.startswith("features."):
            i = int(k.split(".")[1])
            k = k.replace(f"features.{i}.", f"net.slice{tconvert._VGG16_SLICE_OF[i]}.{i}.")
        taming[k] = v
    got = flatten_tree(tconvert.convert_lpips(sd))
    want = flat(jconvert.convert_lpips(taming))
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    path = tmp_path / "lpips.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    lp = train_vae.load_lpips(str(path), "cpu")
    ref = load_flat(LPIPS(), want)
    for (k, v), (k2, v2) in zip(lp.state_dict().items(), ref.state_dict().items()):
        assert k == k2 and torch.equal(v, v2), k
    out = train_vae.main(["--tiny", "--cpu", "--data-dir", str(data), "--paths-txt",
                          str(data / "split.txt"), "--batch-size", "2", "--steps", "2",
                          "--disc-start", "0", "--log-every", "1", "--ckpt-every", "0",
                          "--lpips-ckpt", str(path), "--ckpt-dir", str(tmp_path / "v")])
    assert len(out["metrics"]) == 2 and len(out["host_s"]) == 2
    assert all(np.isfinite(v) for m in out["metrics"] for v in m.values())


def test_train_searcher_image_dir_jpegs_match_jax(data, tmp_path, monkeypatch):
    import diffusion_spacetime_attn_tpu.utils.cache as jcache
    from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
    from diffusion_spacetime_attn_tpu.utils.testing import randomize_params_on_device

    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    tiny = joint_clip_config(True)
    clip_config = jconfig.CLIPConfig

    def jax_tiny_clip():
        return clip_config(
            vision=jconfig.CLIPVisionConfig(**{f: getattr(tiny.vision, f) for f in (
                "image_size", "patch_size", "width", "layers", "heads", "projection_dim")}),
            text=jconfig.CLIPTextConfig(width=32, layers=1, heads=2), projection_dim=32)

    monkeypatch.setattr(jconfig, "CLIPConfig", jax_tiny_clip)
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(3):
        (imgs / f"{i}.jpg").write_bytes((data / f"img{i}.jpg").read_bytes())
    write_png(str(imgs / "3.png"), photo(30, 47, 9))
    monkeypatch.setattr(sys, "argv", ["train_searcher.py", "--image-dir", str(imgs), "--batch",
                                      "2", "--out", str(tmp_path / "jax.npz")])
    jax_script("train_searcher").main()
    jclip = JCLIP(jax_tiny_clip())
    params = randomize_params_on_device(
        jax.eval_shape(jclip.init, jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
                       jnp.zeros((1, 77), jnp.int32))["params"], jax.random.PRNGKey(1))
    clip = load_flat(CLIP(tiny), flat(params)).eval().requires_grad_(False)
    train_searcher.main(["--tiny", "--cpu", "--image-dir", str(imgs), "--batch", "2",
                         "--out", str(tmp_path / "port.npz")], clip=clip)
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert got["embedding"].shape == want["embedding"].shape == (4, 32)
    np.testing.assert_allclose(got["embedding"], want["embedding"], atol=1e-4, rtol=0)


def test_img2img_resizes_non_square_inputs_as_pil(tmp_path):
    init, mask = photo(37, 61, 3), photo(50, 29, 4)
    write_png(str(tmp_path / "init.png"), init)
    buf = io.BytesIO()
    Image.fromarray(mask).save(buf, "JPEG", quality=90)
    (tmp_path / "mask.jpg").write_bytes(buf.getvalue())
    for size in (32, 64):
        want = np.asarray(Image.open(tmp_path / "init.png").convert("RGB").resize((size, size)))
        got = img2img_cli.read_square(str(tmp_path / "init.png"), size)
        assert got.tobytes() == want.tobytes()
        want = np.asarray(Image.open(tmp_path / "mask.jpg").convert("L").resize((size, size)))
        got = img2img_cli.read_square(str(tmp_path / "mask.jpg"), size, grey=True)
        assert got.tobytes() == want.tobytes()
