"""PyTorch port, first-stage (VAE) training held against the JAX package on
the CPU: LPIPS and `convert_lpips` on a synthetic taming-layout LPIPS state
dict (as `test_vae_training.py` builds one), the discriminator's train-mode
calls and flax's BatchNorm statistics, the d losses, `kl_divergence`, one
`VAETrainer` step with the discriminator and the perceptual term on, and the
`train_vae` entry point.

Same weights in both packages (the weight bridge), the same JAX key for the
posterior sample.  Tolerances, float32: LPIPS 1e-5 relative; the
discriminator's logits and batch statistics 1e-5; the losses 1e-6; the step's
metrics 1e-4 relative, each updated parameter 1e-4 relative in norm.  Torch
takes one thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.config import VAEConfig as JVAEConfig
from diffusion_spacetime_attn_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from diffusion_spacetime_attn_tpu.training import image_data as jdata
from diffusion_spacetime_attn_tpu.training import perceptual as jper
from diffusion_spacetime_attn_tpu.training import vae_trainer as jvt
from diffusion_spacetime_attn_tpu.utils import convert as jconvert
from diffusion_spacetime_attn_tpu_torch.utils.jpeg import encode_jpeg
from diffusion_spacetime_attn_tpu_torch.utils.png import write_png
from diffusion_spacetime_attn_tpu_torch.models.vae import AutoencoderKL
from diffusion_spacetime_attn_tpu_torch.scripts import train_vae
from diffusion_spacetime_attn_tpu_torch.training import perceptual as tper
from diffusion_spacetime_attn_tpu_torch.training import vae_trainer as tvt
from diffusion_spacetime_attn_tpu_torch.utils import convert as tconvert
from diffusion_spacetime_attn_tpu_torch.utils import prng
from diffusion_spacetime_attn_tpu_torch.utils.weights import bridge, flatten_tree, load_flat
from test_torch_pipeline import flat, port_cfg

# 64 channels: two per GroupNorm group, so no bias sits before a per-channel
# norm (whose gradient would be rounding noise, which Adam turns into ±lr)
VAE_CFG = JVAEConfig(ch=64, ch_mult=(1, 2), num_res_blocks=1, z_channels=2, embed_dim=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def lpips_sd():
    """A taming LPIPS checkpoint's keys (torchvision VGG16 indices inside the
    slices, `lin{j}.model.1` heads), seeded He-scaled convolutions and
    positive heads."""
    r = np.random.RandomState(0)
    plan = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    sd, cin = {}, 3
    for j, i in enumerate(jconvert._VGG16_CONV_IDX):
        k = f"net.slice{jconvert._VGG16_SLICE_OF[i]}.{i}"
        sd[f"{k}.weight"] = (r.randn(plan[j], cin, 3, 3) * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        sd[f"{k}.bias"] = (r.randn(plan[j]) * 0.1).astype(np.float32)
        cin = plan[j]
    for j, c in enumerate([64, 128, 256, 512, 512]):
        sd[f"lin{j}.model.1.weight"] = np.abs(r.randn(1, c, 1, 1)).astype(np.float32) / c
    return sd


def images(seed, n=2, hw=32):
    return (np.random.RandomState(seed).rand(n, hw, hw, 3) * 2 - 1).astype(np.float32)


def test_lpips_and_convert_lpips_match_jax(lpips_sd):
    got, want = flatten_tree(tconvert.convert_lpips(lpips_sd)), flat(jconvert.convert_lpips(lpips_sd))
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in want)
    lp = load_flat(tper.LPIPS(), got)
    x, y = images(0), images(1)
    with torch.no_grad():
        d = lp(torch.from_numpy(x), torch.from_numpy(y))
        same = lp(torch.from_numpy(x), torch.from_numpy(x))
    ref = jper.LPIPS().apply({"params": jconvert.convert_lpips(lpips_sd)}, jnp.asarray(x),
                             jnp.asarray(y))
    assert d.shape == (2, 1, 1, 1)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref), rtol=1e-5)
    assert float(same.abs().max()) == 0.0 and float(d.min()) > 0


def test_discriminator_train_mode_matches_jax_batch_stats():
    """Two chained train-mode calls (real, then fake) update flax's running
    statistics: momentum 0.99 and the biased batch variance, which torch's
    BatchNorm2d would take unbiased.  Logits and batch_stats within 1e-5;
    then an eval-mode call on the updated statistics."""
    jd = jper.NLayerDiscriminator(ndf=8, n_layers=3)
    x1, x2 = images(2, hw=64), images(3, hw=64) * 0.5
    v = jd.init(jax.random.PRNGKey(0), jnp.asarray(x1), train=True)
    params = v["params"]
    train = jax.jit(lambda p, s, x: jd.apply({"params": p, "batch_stats": s}, x, train=True,
                                             mutable=["batch_stats"]))
    l1, s1 = train(params, v["batch_stats"], jnp.asarray(x1))
    l2, s2 = train(params, s1["batch_stats"], jnp.asarray(x2))
    l3 = jd.apply({"params": params, "batch_stats": s2["batch_stats"]}, jnp.asarray(x1),
                  train=False)
    td = tper.NLayerDiscriminator(ndf=8, n_layers=3)
    load_flat(td, {**flat(params), **flat(v["batch_stats"])})
    with torch.no_grad():
        close(td(torch.from_numpy(x1), train=True), l1, 1e-5)
        close(td(torch.from_numpy(x2), train=True), l2, 1e-5)
        for path, want in flat(s2["batch_stats"]).items():   # bn{n}/mean, bn{n}/var
            close(td.state_dict()[path.replace("/", ".")], want, 1e-5)
        close(td(torch.from_numpy(x1), train=False), l3, 1e-5)


def test_d_losses_kl_and_adopt_weight_match_jax():
    r = np.random.RandomState(0)
    lr_, lf_ = r.randn(4, 5, 5, 1).astype(np.float32), r.randn(4, 5, 5, 1).astype(np.float32)
    for name in ("hinge_d_loss", "vanilla_d_loss"):
        got = getattr(tper, name)(torch.from_numpy(lr_), torch.from_numpy(lf_))
        want = getattr(jper, name)(jnp.asarray(lr_), jnp.asarray(lf_))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    mean, logvar = r.randn(2, 4, 4, 3).astype(np.float32), r.randn(2, 4, 4, 3).astype(np.float32)
    close(tvt.kl_divergence(torch.from_numpy(mean), torch.from_numpy(logvar)),
          jvt.kl_divergence(jnp.asarray(mean), jnp.asarray(logvar)), 1e-6)
    for step, thr in ((10, 50), (50, 50), (0, 0), (7, 3)):
        assert tper.adopt_weight(0.7, step, thr) == pytest.approx(
            float(jper.adopt_weight(0.7, jnp.asarray(step), thr)), rel=1e-7)


def rel_norm(got, want) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()).clamp_min(1e-30))


def test_vae_trainer_steps_match_jax(lpips_sd, steps=2):
    """disc_start 0 and the perceptual term on (LPIPS from the converted
    checkpoint): d_weight (the decoder's conv_out kernel gradients), every
    metric within 1e-4 relative, and each updated parameter of the
    autoencoder and the discriminator, and its running statistics, within
    1e-4 relative in norm.  Two steps: the second runs on the first's chained
    batch statistics.  Adam's first steps are ±lr wherever |g| ≫ eps, so an
    element whose gradient is rounding noise steps either way; at lr 1e-4 one
    such element moves a parameter's norm by ~1e-5 relative, a missing update
    by ~3e-3.  The attention key biases are left out: their gradient is
    exactly zero (a softmax ignores a per-row shift), rounding noise in both
    packages."""
    lpips_params = jconvert.convert_lpips(lpips_sd)
    cfg = dict(base_lr=1e-4, disc_start=0, disc_ndf=8, disc_layers=2, perceptual_weight=1.0,
               kl_weight=1e-3)
    jtr = jvt.VAETrainer(JAutoencoderKL(VAE_CFG), jvt.VAETrainConfig(**cfg))
    js = jtr.init(jax.random.PRNGKey(0), image_hw=32, lpips_params=lpips_params)
    vae = AutoencoderKL(port_cfg(VAE_CFG))
    ttr = tvt.VAETrainer(vae, tvt.VAETrainConfig(**cfg))
    ts = ttr.init(seed=0, lpips=load_flat(tper.LPIPS(), flat(lpips_params)))
    load_flat(vae, flat(js.ae_params))
    load_flat(ttr.disc, {**flat(js.disc_params), **flat(js.disc_stats)})
    for i in range(steps):
        x = images(10 + i)
        js, jm = jtr.train_step(js, jnp.asarray(x), jax.random.PRNGKey(i))
        ts, tm = ttr.train_step(ts, torch.from_numpy(x), prng.PRNGKey(i))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-4 * abs(float(jm[k])) + 1e-6, k
    assert float(jm["d_weight"]) > 0 and float(jm["disc_loss"]) > 0
    for model, tree in ((vae, flat(js.ae_params)),
                        (ttr.disc, {**flat(js.disc_params), **flat(js.disc_stats)})):
        want, got = bridge(tree, model), model.state_dict()
        for k in want:
            if not k.endswith("attn_1.k.bias"):
                assert rel_norm(got[k], want[k]) <= 1e-4, k
    close(ts.logvar, js.logvar, 1e-4)
    assert float(ts.logvar) != 0.0 and ts.step == steps


def test_train_vae_cli(lpips_sd, tmp_path):
    """`train_vae --tiny --cpu --synthetic` with the discriminator from step
    0: finite metrics, a checkpoint readable with weights_only; with
    `--lpips-ckpt` the perceptual term runs on the converted weights;
    without --synthetic, --data-dir trains on the folder's sorted images,
    the batches equal to JAX's `ImagePathsDataset` over the same files.
    The trainer takes a mesh with a model axis: over a (1, 2) mesh of two
    gloo ranks it replicates the step (fsdp over a data axis of 1 shards
    nothing), each rank's metrics the one-process step's."""
    from helpers.torch_ranks import model_axis_ranks

    vae0 = AutoencoderKL(port_cfg(VAE_CFG))
    vcfg = tvt.VAETrainConfig(base_lr=1e-4, disc_start=0, disc_ndf=8, disc_layers=2,
                              perceptual_weight=0.0, kl_weight=1e-3)
    one = tvt.VAETrainer(vae0, vcfg)
    ones = one.init(seed=0)
    images = (np.random.RandomState(10).rand(2, 32, 32, 3) * 2 - 1).astype(np.float32)
    payload = dict(vae_cfg=port_cfg(VAE_CFG), cfg=vcfg,
                   ae={k: v.clone() for k, v in vae0.state_dict().items()},
                   disc={k: v.clone() for k, v in one.disc.state_dict().items()},
                   images=[images], keys=[prng.PRNGKey(0)])
    (tmp_path / "ranks").mkdir()
    ranks = model_axis_ranks(str(tmp_path / "ranks"), {"vae": payload})
    _, m_one = one.train_step(ones, torch.from_numpy(images), prng.PRNGKey(0))
    argv = ["--tiny", "--cpu", "--synthetic", "--disc-start", "0", "--log-every", "1",
            "--ckpt-dir", str(tmp_path)]
    out = train_vae.main(argv + ["--steps", "3", "--ckpt-every", "2"])
    assert len(out["metrics"]) == 3
    assert all(np.isfinite(v) for m in out["metrics"] for v in m.values())
    ck = torch.load(tmp_path / "step_2.pt", weights_only=True)
    assert ck["step"] == 2 and "decoder.conv_out.weight" in ck["ae"] and "bn1.var" in ck["disc"]
    path = tmp_path / "lpips.pth"
    torch.save({k: torch.from_numpy(v) for k, v in lpips_sd.items()}, path)
    out = train_vae.main(argv + ["--steps", "1", "--lpips-ckpt", str(path), "--ckpt-every", "0"])
    assert all(np.isfinite(v) for v in out["metrics"][0].values())
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    for i in range(2):
        write_png(str(imgs / f"{i}.png"), np.random.RandomState(i).randint(0, 256, (40, 36, 3),
                                                                            dtype=np.uint8))
    (imgs / "2.JPG").write_bytes(encode_jpeg(np.random.RandomState(2).randint(
        0, 256, (30, 52, 3), dtype=np.uint8), 80))
    (imgs / "notes.txt").write_text("not an image")
    folder = ["--tiny", "--cpu", "--disc-start", "0", "--log-every", "1", "--batch-size", "2",
              "--data-dir", str(imgs), "--ckpt-dir", str(tmp_path / "folder")]
    nb = train_vae.image_batches(train_vae.parse_args(folder), 2, 32, "cpu")
    files = sorted(str(imgs / f) for f in ("0.png", "1.png", "2.JPG"))
    it = jdata.ImagePathsDataset(paths=files, size=32, flip_p=0.5).batches(2, seed=0)
    for i in range(3):                          # past the first epoch's one batch
        np.testing.assert_array_equal(nb(i).numpy(), next(it)[0])
    out = train_vae.main(folder + ["--steps", "1", "--ckpt-every", "0"])
    assert all(np.isfinite(v) for v in out["metrics"][0].values())
    for o in (r["model_axis_trainers"] for r in ranks.join()):
        got = o["vae"]
        assert got["sharded"] == 0 and o["devices"] == 2
        for k, v in m_one.items():
            assert got["metrics"][0][k] == pytest.approx(float(v), rel=1e-6, abs=1e-9), k
