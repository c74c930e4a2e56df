"""PyTorch port, the testbed's training held against the JAX package on the
CPU: `prng.randint` bit for bit, `build_dataset`, the CLIP trainer, the
`train_testbed` script stage by stage (the JAX script's `main` on the same
flags, its per-step losses from its log), the msgpack writer and
`save_bundle` (JAX's `load_bundle` reads the port's bundle bit for bit).

The script runs in both packages at a few steps per stage (`--chunk 1`, so
JAX logs every step) from the same initial weights (JAX's inits, handed to
the port through `main(init=...)`) on the same keys.  Tolerances, float32:
per-step losses and accuracies 1e-4 relative (the VAE stage's 1e-3, see
VAE_STAGE_TOL); the CLIP trainer's parameters 1e-4; the bundle's arrays
equal.  Torch takes one thread.
"""
import functools
import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
from diffusion_spacetime_attn_tpu.models.unet import UNet as JUNet
from diffusion_spacetime_attn_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from diffusion_spacetime_attn_tpu.testbed import bundle as jbundle
from diffusion_spacetime_attn_tpu.testbed import data as jdata
from diffusion_spacetime_attn_tpu.testbed.configs import testbed_clip_cfg, testbed_pipeline_cfg
from diffusion_spacetime_attn_tpu.testbed.scenes import MAX_LEN
from diffusion_spacetime_attn_tpu.training import clip_trainer as jclip
from diffusion_spacetime_attn_tpu.training.vae_trainer import VAETrainConfig, VAETrainer
from diffusion_spacetime_attn_tpu_torch.models.clip import CLIP
from diffusion_spacetime_attn_tpu_torch.scripts import train_testbed
from diffusion_spacetime_attn_tpu_torch.testbed import bundle as tbundle
from diffusion_spacetime_attn_tpu_torch.testbed import data as tdata
from diffusion_spacetime_attn_tpu_torch.training import clip_trainer as tclip
from diffusion_spacetime_attn_tpu_torch.utils import msgpack, prng
from diffusion_spacetime_attn_tpu_torch.utils.weights import flax_flat, load_flat
from test_torch_pipeline import flat, port_cfg

TOL = 1e-4
REPO = Path(__file__).resolve().parents[1]
SHAPES = [(), (1,), (7,), (4, 5), (3, 2, 2), (512,)]
SPANS = [(0, 1000), (0, 3), (5, 6), (-10, 17), (0, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1),
         (3, 3), (7, 2), (0, 2 ** 16 + 1), (100, 12345), (0, 8192), (0, 6000), (-2 ** 31, 0)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.mark.parametrize("span", SPANS, ids=[f"{a}_{b}" for a, b in SPANS])
def test_randint_bit_equal_to_jax(span):
    """int32 draws in [lo, hi) for spans below, at and above 2¹⁶ (where the
    uint32 product of jax's span reduction wraps), powers of two or not,
    empty (lo >= hi: lo), over several keys and shapes."""
    lo, hi = span
    for seed in (0, 1, 1234):
        for shape in SHAPES:
            got = prng.randint(prng.PRNGKey(seed), shape, lo, hi)
            want = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, lo, hi))
            assert got.dtype == want.dtype == np.int32 and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    folded = prng.fold_in(prng.PRNGKey(5), 17)
    np.testing.assert_array_equal(
        prng.randint(folded, (64,), lo, hi),
        np.asarray(jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(5), 17), (64,),
                                      lo, hi)))
    with pytest.raises(ValueError, match="int32"):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2 ** 31)


def test_build_dataset_and_views_equal_jax(tmp_path):
    for seed in (0, 3):
        got, want = tdata.build_dataset(n_scenes=24, seed=seed), jdata.build_dataset(n_scenes=24,
                                                                                    seed=seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    img = np.random.RandomState(0).rand(64, 64, 3).astype(np.float32)
    np.testing.assert_array_equal(tdata.global_view(img[None]), jdata.global_view(img[None]))
    np.testing.assert_array_equal(tdata.local_view(img, 0.9, 0.1), jdata.local_view(img, 0.9, 0.1))
    cache = str(tmp_path / "c.npz")
    a = tdata.cached_dataset(cache, n_scenes=8, seed=1)
    b = jdata.cached_dataset(cache, n_scenes=999)            # JAX reads the port's cache
    assert all(np.array_equal(a[k], b[k]) for k in a)


def _clip_pair():
    jc = JCLIP(testbed_clip_cfg())
    params = jax.jit(jc.init)(jax.random.PRNGKey(3), jnp.zeros((1, 28, 28, 3)),
                              jnp.zeros((1, MAX_LEN), jnp.int32))["params"]
    tc = load_flat(CLIP(port_cfg(testbed_clip_cfg())), flat(params))
    return jc, params, tc


def test_clip_trainer_three_steps_match_jax():
    """Batch 8 with duplicate captions (masked off the diagonal): loss,
    accuracy and scale per step, then each parameter within 1e-4 relative in
    norm (+1e-6), and the log temperature; `clip_contrastive_loss` alone;
    `retrieval_accuracy` equal.  At lr 1e-4 an element whose gradient is
    rounding noise (Adam steps it ±lr either way) moves a parameter's norm by
    ~1e-5 relative.  The attention key biases are left out: their gradient is
    exactly zero (a softmax ignores a per-row shift), noise in both."""
    jc, params, tc = _clip_pair()
    ds = tdata.build_dataset(n_scenes=16, seed=2)
    imgs = ds["clip_images"][:8].astype(np.float32) / 255.0
    toks = ds["clip_tokens"][:8].copy()
    toks[5] = toks[1]                                  # a duplicate caption
    jinit, jstep = jclip.make_clip_train_step(jc, lr=1e-4)
    js, jstep = jinit(params), jax.jit(jstep)
    tinit, tstep = tclip.make_clip_train_step(tc, lr=1e-4)
    ts = tinit()
    for _ in range(3):
        js, jm = jstep(js, jnp.asarray(imgs), jnp.asarray(toks))
        ts, tm = tstep(ts, torch.from_numpy(imgs), torch.from_numpy(toks))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert rel(tm[k], jm[k]) <= TOL, k
    want, got, init = flat(js.params), flax_flat(tc), flat(params)
    for k in want:
        if not k.endswith("k_proj/bias"):
            assert np.linalg.norm(got[k] - want[k]) <= TOL * np.linalg.norm(want[k]) + 1e-6, k
            assert not np.array_equal(want[k], init[k]), k
    assert rel(ts.logit_scale, js.logit_scale) <= 1e-6
    feats = np.random.RandomState(0).randn(2, 8, 16).astype(np.float32)
    lj, mj = jclip.clip_contrastive_loss(jnp.asarray(feats[0]), jnp.asarray(feats[1]),
                                         jnp.asarray(2.0), jnp.asarray(toks))
    lt, mt = tclip.clip_contrastive_loss(torch.from_numpy(feats[0]), torch.from_numpy(feats[1]),
                                         torch.tensor(2.0), torch.from_numpy(toks))
    assert rel(lt, lj) <= 1e-6 and float(mt["acc_i2t"]) == float(mj["acc_i2t"])
    va_i, va_t = ds["clip_images"].astype(np.float32) / 255.0, ds["clip_tokens"]
    assert tclip.retrieval_accuracy(tc, va_i, va_t, batch=16) == \
        jclip.retrieval_accuracy(jc, js.params, va_i, va_t, batch=16)


def test_msgpack_writer_matches_flax_bytes(tmp_path):
    """`packb` writes flax's bytes for the same tree (sorted keys, shortest
    forms, ext 1 arrays of every dtype a bundle holds); `unpackb` reads them."""
    from flax import serialization

    r = np.random.RandomState(0)
    tree = {"b": {"kernel": r.randn(3, 4).astype(np.float32), "bias": np.zeros(4, np.float32)},
            "a": {"x": r.randn(300, 70).astype(np.float32), "s": np.ones((), np.float32),
                  "i": np.arange(5, dtype=np.int32), "e": np.zeros((0, 3), np.float32),
                  "big": np.zeros((70000,), np.float32), "h": np.ones((9,), np.float16)},
            "k" * 40: np.ones((1,), np.float64),
            **{f"m{i:02d}": {"v": np.full((2,), i, np.float32)} for i in range(20)}}
    want = serialization.msgpack_serialize(jax.tree_util.tree_map(np.asarray, tree))
    assert msgpack.packb(tree) == want
    back = msgpack.unpackb(want)
    assert np.array_equal(back["a"]["x"], tree["a"]["x"]) and back["a"]["s"].shape == ()


def jax_script(name):
    """The JAX package's `scripts/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_inits():
    """The initial weights of JAX's `train_testbed` stages: VAETrainer.init
    at PRNGKey(0), CLIP at PRNGKey(3), UNet at PRNGKey(5)."""
    cfg = testbed_pipeline_cfg()
    tcfg = VAETrainConfig(base_lr=2e-4, perceptual_weight=0.0, disc_start=10 ** 9, disc_ndf=8,
                          disc_layers=1, kl_weight=1e-6)
    trainer = VAETrainer(JAutoencoderKL(cfg.vae), tcfg)
    vs = jax.jit(lambda k: trainer.init(k, image_hw=64, lpips_params={}))(jax.random.PRNGKey(0))
    clip = jax.jit(JCLIP(testbed_clip_cfg()).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 28, 28, 3)), jnp.zeros((1, MAX_LEN), jnp.int32))
    L = cfg.spacetime.latent_size
    unet = jax.jit(JUNet(cfg.unet, radius=cfg.spacetime.radius).init)(
        jax.random.PRNGKey(5), jnp.zeros((1, L, L, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, MAX_LEN, cfg.unet.context_dim)))
    return {"vae": flat(vs.ae_params), "disc": {**flat(vs.disc_params), **flat(vs.disc_stats)},
            "clip": flat(clip["params"]), "unet": flat(unet["params"])}


# The VAE stage's losses within 1e-3: its flax-initialized encoder is
# ill-conditioned on the scenes' flat backgrounds (a GroupNorm over a nearly
# constant group, then ×1/√(var + 1e-6)): a 1e-6 relative change of the input
# moves the port's own moments by 5e-4 of values up to 7, and flax's GroupNorm
# takes the variance as E[x²] − E[x]² where torch's takes two passes.  The
# VAE step itself is held at 1e-4 on random images (test_torch_vae_training).
VAE_STAGE_TOL = 1e-3
# lr a tenth of the defaults: Adam steps an element whose gradient is rounding
# noise (a bias before a per-channel GroupNorm) by ±lr either way, which the
# next steps' losses see through the convolutions' zero padding
FLAGS = ["--scenes", "48", "--vae-steps", "3", "--clip-steps", "3", "--ldm-steps", "3",
         "--chunk", "1", "--vae-batch", "4", "--clip-batch", "8", "--ldm-batch", "4",
         "--vae-lr", "2e-5", "--clip-lr", "1e-4", "--ldm-lr", "3e-5", "--cpu"]


def test_train_testbed_stages_match_jax_script(tmp_path, monkeypatch):
    """vae, clip and ldm at 3 steps each: the port's per-step losses (and
    CLIP's accuracy) against the JAX script's log, the stages' meta; then the
    port's calibrate stage (cut to 2 prompts and PLMS-3 here, 32 and PLMS-50
    on the card) and JAX's `load_bundle` on the port's bundle: every array
    equal to the port's, meta.json merged as JAX merges it."""
    import diffusion_spacetime_attn_tpu.utils.cache as jcache

    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    cache = str(tmp_path / "scenes.npz")
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for stage in ("vae", "clip", "ldm"):
        monkeypatch.setattr(sys, "argv", ["train_testbed.py", *FLAGS, "--stage", stage,
                                          "--ckpt-dir", str(jdir), "--data-cache", cache])
        jax_script("train_testbed").main()
    monkeypatch.setattr(train_testbed, "stage_calibrate", functools.partial(
        train_testbed.stage_calibrate, prompts=2, num_steps=3))
    out = train_testbed.main([*FLAGS, "--stage", "all", "--ckpt-dir", str(tdir),
                              "--data-cache", cache], init=_jax_inits())
    log = [json.loads(line) for line in open(jdir / "train_log.jsonl")]
    for tag, keys, tol in (("vae", ("rec", "kl"), VAE_STAGE_TOL), ("clip", ("loss", "acc"), TOL),
                           ("ldm", ("loss",), TOL)):
        jrows = [r for r in log if r["event"] == f"{tag}_chunk"]
        trows = out["history"][tag]
        assert len(jrows) == len(trows) == 3
        for j, t in zip(jrows, trows):
            for k in keys:
                assert rel(t[k], j[k]) <= tol, (tag, k, t[k], j[k])
    jmeta = json.load(open(jdir / "meta.json"))
    tmeta = json.load(open(tdir / "meta.json"))
    assert set(jmeta) | {"guidance_scale", "guidance_calibration"} == set(tmeta)
    for k, tol in (("scale_factor", VAE_STAGE_TOL), ("vae_recon_l1", VAE_STAGE_TOL),
                   ("clip_logit_scale", TOL), ("ldm_loss_simple", TOL)):
        assert rel(tmeta[k], jmeta[k]) <= tol, k
    assert tmeta["guidance_scale"] in (1.5, 3.0, 5.0, 7.5)

    b = jbundle.load_bundle(str(tdir), num_steps=3)
    assert b.meta == tmeta
    trees = tbundle.load_trees(str(tdir))
    for name, jtree in (("unet", b.sd.unet_params), ("vae", b.sd.vae_params),
                        ("clip", b.clip_params)):
        jflat = flat(jtree)
        assert sorted(jflat) == sorted(trees[name])
        for k, v in jflat.items():
            assert v.dtype == trees[name][k].dtype and np.array_equal(v, trees[name][k]), k
    port = tbundle.load_bundle(str(tdir), num_steps=3, device="cpu")
    with torch.no_grad():
        got = port.sd.encode_text(np.stack([np.arange(MAX_LEN, dtype=np.int32) % 7]))
    want = b.sd.encode_text(jnp.asarray(np.stack([np.arange(MAX_LEN, dtype=np.int32) % 7])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
