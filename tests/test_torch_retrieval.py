"""PyTorch port, retrieval-augmented diffusion and the safety checkers held
against the JAX package on the CPU: `pipeline/retrieval.py` (exact search,
the npz database format both ways, the database built by a CLIP vision
tower), `pipeline/knn2img.py` (the RDM configs field by field; the tiny
RDM's conditioning and sampling on one JAX key under DDIM at eta 0 and 0.5
and PLMS, with and without neighbours), `pipeline/safety.py`
(`DiffusersSafetyChecker` on a transformers CLIPVisionModel's state dict in
diffusers' layout, `SafetyChecker`), and the entry points
`scripts/{train_searcher,knn2img}.py` at `--tiny --cpu` against the
library.  The weights come from JAX through the bridge (`utils/weights.py`).

Tolerances, float32: search scores 1e-6 with equal indices; database
embeddings 1e-5; RDM images 1e-4 (absolute and relative); checker image
embeddings and scores 1e-5 with equal flags; the entry points' outputs
equal the library's bit for bit.  Torch takes one thread.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.config import CLIPConfig as JCLIPConfig
from diffusion_spacetime_attn_tpu.config import CLIPTextConfig as JCLIPTextConfig
from diffusion_spacetime_attn_tpu.config import CLIPVisionConfig as JCLIPVisionConfig
from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
from diffusion_spacetime_attn_tpu.models.clip import clip_normalize as jclip_normalize
from diffusion_spacetime_attn_tpu.pipeline import knn2img as jknn
from diffusion_spacetime_attn_tpu.pipeline import retrieval as jret
from diffusion_spacetime_attn_tpu.pipeline import safety as jsafety
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models.clip import CLIP, clip_normalize
from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
from diffusion_spacetime_attn_tpu_torch.pipeline import knn2img as tknn
from diffusion_spacetime_attn_tpu_torch.parallel.mesh import Mesh
from diffusion_spacetime_attn_tpu_torch.pipeline import retrieval as tret
from diffusion_spacetime_attn_tpu_torch.pipeline import safety as tsafety
from diffusion_spacetime_attn_tpu_torch.pipeline.runners import save_image
from diffusion_spacetime_attn_tpu_torch.scripts import knn2img as knn2img_cli
from diffusion_spacetime_attn_tpu_torch.scripts import train_searcher
from diffusion_spacetime_attn_tpu_torch.utils import prng
from diffusion_spacetime_attn_tpu_torch.utils.png import read_png, write_png
from diffusion_spacetime_attn_tpu_torch.utils.resample import resize
from diffusion_spacetime_attn_tpu_torch.utils.testing import randomize_
from diffusion_spacetime_attn_tpu_torch.utils.weights import load_flat
from test_torch_pipeline import flat, port_cfg

ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _db(m=64, d=16, seed=0):
    emb = np.random.RandomState(seed).randn(m, d).astype(np.float32)
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


def test_exact_search_matches_jax():
    db = _db(m=300, d=24)
    q = np.random.RandomState(1).randn(5, 24).astype(np.float32)
    js, ji = jret.exact_search(jnp.asarray(db), jnp.asarray(q), k=7)
    ts, ti = tret.exact_search(torch.from_numpy(db), torch.from_numpy(q), k=7)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)


def test_npz_databases_read_both_ways(tmp_path):
    db = _db(m=32, d=16, seed=2)
    ids = np.arange(100, 132)
    coords = np.random.RandomState(3).rand(32, 4).astype(np.float32)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jret.Retriever(embedding=jnp.asarray(db), img_id=ids, patch_coords=coords).save_npz(jpath)
    tret.Retriever(embedding=torch.from_numpy(db), img_id=ids, patch_coords=coords).save_npz(tpath)
    for path in (jpath, tpath):
        j, t = jret.Retriever.from_npz(path), tret.Retriever.from_npz(path, device="cpu")
        np.testing.assert_array_equal(t.embedding.numpy(), np.asarray(j.embedding))
        np.testing.assert_array_equal(t.img_id, j.img_id)
        np.testing.assert_array_equal(t.patch_coords, j.patch_coords)
    q = np.random.RandomState(4).randn(3, 16).astype(np.float32)
    jo = jret.Retriever.from_npz(jpath).search(jnp.asarray(q)[:, None], 4)
    to = tret.Retriever.from_npz(tpath, device="cpu").search(torch.from_numpy(q)[:, None], 4)
    assert set(to) == set(jo)
    np.testing.assert_array_equal(to["nns"].numpy(), np.asarray(jo["nns"]))
    np.testing.assert_array_equal(to["img_ids"], jo["img_ids"])
    np.testing.assert_array_equal(to["patch_coords"], jo["patch_coords"])
    for key in ("nn_embeddings", "scores", "q_embeddings"):
        np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]), atol=1e-6, rtol=0)


def test_one_device_only():
    """The data axis is ported (`tests/test_torch_parallel.py`) and so is the
    model axis: the database splits over 'data' only, so on a (1, 2) mesh
    every model rank holds it whole (no collective runs) and the search and
    the Retriever equal the one-device exact search, bit for bit."""
    tp = Mesh(data=1, model=2, rank=1, model_index=1)
    db = torch.nn.functional.normalize(torch.from_numpy(
        np.random.RandomState(0).randn(10, 4).astype(np.float32)), dim=-1)
    q = torch.from_numpy(np.random.RandomState(1).randn(3, 4).astype(np.float32))
    shard = tret.shard_database(db, tp)
    assert torch.equal(shard, db)
    for k in (2, 10):
        s, i = tret.sharded_search(shard, q, k, mesh=tp, rows=10)
        s0, i0 = tret.exact_search(db, q, k)
        assert torch.equal(s, s0) and torch.equal(i, i0)
    r = tret.Retriever(embedding=shard, img_id=np.arange(10), patch_coords=np.zeros((10, 4)),
                       mesh=tp)
    one = tret.Retriever(embedding=db, img_id=np.arange(10), patch_coords=np.zeros((10, 4)))
    got, want = r.search(q, 3), one.search(q, 3)
    for key in ("nn_embeddings", "scores", "nns", "q_embeddings"):
        assert torch.equal(got[key], want[key]), key


TINY_CLIP = JCLIPConfig(
    vision=JCLIPVisionConfig(image_size=32, patch_size=8, width=32, layers=2, heads=2,
                             projection_dim=16),
    text=JCLIPTextConfig(vocab_size=100, width=32, layers=1, heads=2, max_len=8),
    projection_dim=16)


@pytest.fixture(scope="module")
def clip_pair():
    """(JAX CLIP, its params, the port's CLIP on the same weights) at TINY_CLIP."""
    model = JCLIP(TINY_CLIP)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                            jnp.zeros((1, 8), jnp.int32))["params"]
    params = randomize_params(params, jax.random.PRNGKey(1), 0.2)
    port = CLIP(port_cfg(TINY_CLIP)).eval().requires_grad_(False)
    load_flat(port, flat(params))
    return model, params, port


def test_build_database_from_images_matches_jax(clip_pair):
    model, params, port = clip_pair
    imgs = np.random.RandomState(5).rand(10, 32, 32, 3).astype(np.float32)

    def jembed(p, px):
        return model.apply({"params": p}, jclip_normalize(px), method=JCLIP.encode_image)

    j = jret.build_database_from_images(imgs, jembed, batch=4, img_ids=np.arange(10),
                                        params=params)
    t = tret.build_database_from_images(imgs, lambda px: port.encode_image(clip_normalize(px)),
                                        batch=4, img_ids=np.arange(10), device="cpu")
    np.testing.assert_allclose(t.embedding.numpy(), np.asarray(j.embedding), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t.patch_coords, j.patch_coords)
    np.testing.assert_array_equal(t.img_id, j.img_id)


def test_rdm_configs_match_jax_field_by_field():
    for jfn, tfn in ((jknn.rdm_unet_config, tknn.rdm_unet_config),
                     (jknn.rdm_vae_config, tknn.rdm_vae_config)):
        for dtype in ("bfloat16", "float32"):
            assert dataclasses.asdict(tfn(dtype)) == dataclasses.asdict(jfn(dtype))
    assert dataclasses.asdict(tknn.rdm_schedule_config()) == dataclasses.asdict(
        jknn.rdm_schedule_config())
    # the tiny model: JAX's create, field by field
    ju, jv = _jax_tiny_configs()
    tu, tv, hw = tknn.configs("float32", tiny=True)
    assert dataclasses.asdict(tu) == dataclasses.asdict(ju) and hw == 8
    assert dataclasses.asdict(tv) == dataclasses.asdict(jv)


def _jax_tiny_configs():
    rdm = jknn.RetrievalAugmentedDiffusion.create(jax.random.PRNGKey(0), steps=4,
                                                  dtype="float32", tiny=True)
    return rdm.unet.cfg, rdm.vae.cfg


def test_full_width_rdm_takes_the_vit_l14_joint_space():
    """The full-width bundle: the RDM with the serving kernel flags, its
    cross-attention keys 768 wide, which the ViT-L/14 joint CLIP's
    projection feeds (JAX's knn2img builds ViT-B/32, 512 wide)."""
    ucfg, vcfg, hw = tknn.configs("bfloat16", tiny=False)
    assert ucfg.use_mha and ucfg.use_fused_ff and hw == 48
    assert dataclasses.replace(ucfg, use_mha=False, use_fused_ff=False) == \
        tknn.rdm_unet_config("bfloat16")
    with torch.device("meta"):
        unet = UNet(ucfg, radius=0.2)
    keys = [m.in_features for n, m in unet.named_modules() if n.endswith("attn2.to_k")]
    assert len(keys) == 16 and set(keys) == {768}
    clip = tknn.joint_clip_config()
    assert clip is tcfg.VIT_L14_JOINT_CLIP and clip.projection_dim == 768
    assert (clip.vision.patch_size, clip.vision.width, clip.vision.layers,
            clip.vision.heads) == (14, 1024, 24, 16)
    assert (clip.text.width, clip.text.layers, clip.text.heads) == (768, 12, 12)
    assert JCLIPConfig().projection_dim == 512 != ucfg.context_dim


@pytest.fixture(scope="module")
def rdm_weights():
    """JAX's tiny RDM params, N(0, 0.2²)."""
    rdm = jknn.RetrievalAugmentedDiffusion.create(jax.random.PRNGKey(0), steps=4,
                                                  dtype="float32", tiny=True, abstract=True)
    return (randomize_params(rdm.unet_params, jax.random.PRNGKey(1), 0.2),
            randomize_params(rdm.vae_params, jax.random.PRNGKey(2), 0.2))


@pytest.mark.parametrize("sampler,eta,knn", [("ddim", 0.0, 3), ("ddim", 0.5, 3),
                                             ("plms", 0.0, 3), ("ddim", 0.0, 0)])
def test_tiny_rdm_conditioning_and_sample_match_jax(rdm_weights, sampler, eta, knn):
    unet_p, vae_p = rdm_weights
    j = jknn.RetrievalAugmentedDiffusion.create(jax.random.PRNGKey(0), steps=4, dtype="float32",
                                                tiny=True, eta=eta)
    j.unet_params, j.vae_params = unet_p, vae_p
    t = tknn.RetrievalAugmentedDiffusion.from_flat(flat(unet_p), flat(vae_p), steps=4,
                                                   dtype="float32", tiny=True, eta=eta,
                                                   device="cpu")
    db = _db(m=16, d=16)
    jr = jret.Retriever(embedding=jnp.asarray(db), img_id=np.arange(16),
                        patch_coords=np.zeros((16, 4), np.float32))
    tr = tret.Retriever(embedding=torch.from_numpy(db), img_id=np.arange(16),
                        patch_coords=np.zeros((16, 4), np.float32))
    txt = np.random.RandomState(3).randn(2, 16).astype(np.float32)
    jc = j.build_conditioning(jnp.asarray(txt), jr if knn else None, knn=knn)
    tc = t.build_conditioning(torch.from_numpy(txt), tr if knn else None, knn=knn)
    assert tuple(tc.shape) == (2, 1 + knn, 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    want = np.asarray(j.sample(jc, jax.random.PRNGKey(4), sampler=sampler))
    got = t.sample(tc, prng.PRNGKey(4), sampler=sampler).numpy()
    assert got.shape == (2, 16, 16, 3) and np.isfinite(got).all()
    assert float(np.std(want)) > 1e-3          # not a constant image
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)


# ---------------------------------------------------------------- safety


@pytest.fixture(scope="module")
def diffusers_state():
    """The synthetic checker of JAX's `test_aux.py::
    test_diffusers_safety_checker_faithful` (a transformers CLIPVisionModel
    in diffusers' key layout), 64-wide heads so the dims can be inferred."""
    from transformers import CLIPVisionConfig as HFVCfg
    from transformers import CLIPVisionModel

    hf_cfg = HFVCfg(hidden_size=128, intermediate_size=512, num_hidden_layers=2,
                    num_attention_heads=2, image_size=28, patch_size=14, hidden_act="quick_gelu")
    torch.manual_seed(5)
    hf = CLIPVisionModel(hf_cfg).eval()
    proj = torch.nn.Linear(128, 8, bias=False)
    rng = np.random.RandomState(6)
    state = {f"vision_model.vision_model.{k}": v.detach().numpy()
             for k, v in hf.vision_model.state_dict().items()}
    state["visual_projection.weight"] = proj.weight.detach().numpy()
    state["concept_embeds"] = rng.randn(4, 8).astype(np.float32)
    state["special_care_embeds"] = rng.randn(2, 8).astype(np.float32)
    state["concept_embeds_weights"] = np.zeros(4, np.float32)
    state["special_care_embeds_weights"] = np.full(2, 0.1, np.float32)
    return state


def _images():
    """6 images at the tower's 28² (no resize) and 6 at 40² (bilinear)."""
    return [np.random.RandomState(s).rand(6, s, s, 3).astype(np.float32) for s in (28, 40)]


def _jax_scores(checker, imgs):
    emb = checker.image_embeds(jnp.asarray(imgs))
    embn = emb / jnp.linalg.norm(emb, axis=-1, keepdims=True)
    cn = checker.concepts / jnp.linalg.norm(checker.concepts, axis=-1, keepdims=True)
    sn = checker.specials / jnp.linalg.norm(checker.specials, axis=-1, keepdims=True)
    special = embn @ sn.T - checker.special_w[None, :]
    adj = jnp.where(jnp.any(special > 0, axis=-1), 0.01, 0.0)[:, None]
    return np.asarray(emb), np.asarray(embn @ cn.T - checker.concept_w[None, :] + adj)


def test_diffusers_safety_checker_matches_jax(diffusers_state, tmp_path):
    cfg = JCLIPVisionConfig(image_size=28, patch_size=14, width=128, layers=2, heads=2,
                            projection_dim=8)
    j = jsafety.DiffusersSafetyChecker.from_checkpoint(diffusers_state, cfg=cfg)
    # one concept weight at the median score: some images flagged, some not
    w = float(np.median(np.concatenate([_jax_scores(j, x)[1].max(-1) for x in _images()])))
    diffusers_state = dict(diffusers_state, concept_embeds_weights=np.full(4, w, np.float32))
    j = jsafety.DiffusersSafetyChecker.from_checkpoint(diffusers_state, cfg=cfg)
    inferred = tsafety.DiffusersSafetyChecker.infer_config(diffusers_state)
    assert inferred == port_cfg(dataclasses.replace(cfg, projection_dim=512))
    torch.save({k: torch.from_numpy(v) for k, v in diffusers_state.items()},
               tmp_path / "checker.pt")
    from_jax = tsafety.DiffusersSafetyChecker.from_flat(   # JAX's parts through the bridge
        port_cfg(cfg), flat(j.params), np.asarray(j.proj), np.asarray(j.concepts),
        np.asarray(j.concept_w), np.asarray(j.specials), np.asarray(j.special_w), device="cpu")
    for t in [tsafety.DiffusersSafetyChecker.from_checkpoint(src, device="cpu")
              for src in (diffusers_state, str(tmp_path / "checker.pt"))] + [from_jax]:
        n_flagged = 0
        for imgs in _images():
            jemb, jscores = _jax_scores(j, imgs)
            jout, jflags = j(jnp.asarray(imgs))
            np.testing.assert_allclose(t.image_embeds(torch.from_numpy(imgs)).numpy(), jemb,
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(t.scores(torch.from_numpy(imgs)).numpy(), jscores,
                                       atol=1e-5, rtol=0)
            out, flags = t(torch.from_numpy(imgs))
            np.testing.assert_array_equal(flags, np.asarray(jflags))
            n_flagged += int(flags.sum())
            np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
            assert all(float(out[i].abs().max()) == 0.0 for i in np.flatnonzero(flags))
        assert 0 < n_flagged < 12                    # both branches taken


def test_safety_checker_matches_jax(clip_pair):
    model, params, port = clip_pair
    imgs = np.random.RandomState(7).rand(6, 40, 40, 3).astype(np.float32)
    concepts = _db(m=5, d=16, seed=8)
    assert tsafety.SafetyChecker()(torch.from_numpy(imgs))[1].tolist() == [False] * 6
    probe = tsafety.SafetyChecker(port, concepts, threshold=0.0)
    sims = probe.similarities(torch.from_numpy(imgs)).numpy()
    threshold = float(np.median(sims.max(axis=-1)))
    j = jsafety.SafetyChecker(model, params, concepts, threshold=threshold)
    t = tsafety.SafetyChecker(port, concepts, threshold=threshold)
    jout, jflags = j(jnp.asarray(imgs))
    out, flags = t(torch.from_numpy(imgs))
    emb = model.apply({"params": params}, jsafety.bilinear_resize(jnp.asarray(imgs), 32),
                      method=JCLIP.encode_image)
    emb = emb / jnp.linalg.norm(emb, axis=-1, keepdims=True)
    np.testing.assert_allclose(sims, np.asarray(emb @ jnp.asarray(concepts).T), atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(flags, np.asarray(jflags))
    assert 0 < flags.sum() < len(flags)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))


# ---------------------------------------------------------------- entry points


def test_entry_points_give_the_librarys_outputs(tmp_path):
    db_path = str(tmp_path / "db.npz")
    summary = train_searcher.main(["--tiny", "--cpu", "--synthetic", "6", "--batch", "4",
                                   "--out", db_path])
    assert (summary["rows"], summary["dim"]) == (6, 32)
    clip = train_searcher.build_clip(True, "cpu")
    imgs = np.random.RandomState(0).rand(6, 224, 224, 3).astype(np.float32)
    lib = tret.build_database_from_images(imgs, lambda px: clip.encode_image(clip_normalize(px)),
                                          batch=4, device="cpu")
    np.testing.assert_array_equal(np.load(db_path)["embedding"], lib.embedding.numpy())

    rdm = tknn.RetrievalAugmentedDiffusion.create(seed=0, steps=3, dtype="float32", tiny=True,
                                                  device="cpu")
    randomize_(rdm.unet, 1, 0.2)
    randomize_(rdm.vae, 2, 0.2)
    text_clip = train_searcher.build_clip(True, "cpu", seed=4)
    out = str(tmp_path / "knn")
    # the flags set the schedule of a bundle handed in: made for 50 steps, run at 3
    rdm50 = dataclasses.replace(rdm, schedule=make_schedule(tknn.rdm_schedule_config(), 50,
                                                            device="cpu"))
    got = knn2img_cli.main(["--tiny", "--cpu", "--ddim-steps", "3", "--use-neighbors",
                            "--database", db_path, "--knn", "2", "--n-samples", "2",
                            "--prompt", "a red bird", "--outdir", out, "--seed", "7"],
                           models=(rdm50, text_clip))
    assert got["context_len"] == 3 and len(got["s_per_batch"]) == 1
    assert got["paths"] == [os.path.join(out, f"{i:05}.png") for i in range(2)]
    assert got["launches"] == [{"mha_fwd": 0, "geglu_fwd": 0}]     # CPU: plain versions only
    # the library on the same key and weights
    tok_ids = knn2img_cli.padded(knn2img_cli.make_clip_tokenizer(), 77)("a red bird")
    txt = text_clip.encode_text(torch.tensor([tok_ids] * 2))[:, :16]
    r = tret.Retriever.from_npz(db_path, device="cpu")
    r.embedding = tret.normalize(r.embedding[:, :16])
    cond = rdm.build_conditioning(txt, r, 2)
    want = rdm.sample(cond, prng.split(prng.PRNGKey(7))[1]).numpy()
    for i, path in enumerate(got["paths"]):
        save_image(want[i], str(tmp_path / "lib.png"))
        np.testing.assert_array_equal(read_png(path), read_png(str(tmp_path / "lib.png")))
    with pytest.raises(NotImplementedError):
        knn2img_cli.main(["--tiny", "--cpu", "--rdm-ckpt", "x"])
    with pytest.raises(ValueError, match="bfloat16"):
        knn2img_cli.main(["--tiny", "--cpu", "--dtype", "bfloat16", "--outdir", out],
                         models=(rdm, text_clip))


def test_train_searcher_reads_png_dirs_and_refuses_jpeg(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.RandomState(9)
    write_png(str(d / "a.png"), rng.randint(0, 256, (30, 40, 3), dtype=np.uint8))
    write_png(str(d / "b.png"), rng.randint(0, 256, (224, 224, 3), dtype=np.uint8))
    imgs = train_searcher.load_image_dir(str(d))
    assert imgs.shape == (2, 224, 224, 3) and imgs.dtype == np.float32
    np.testing.assert_allclose(imgs[1], read_png(str(d / "b.png")) / 255.0, atol=1e-6)
    out = str(tmp_path / "db.npz")
    s = train_searcher.main(["--tiny", "--cpu", "--image-dir", str(d), "--out", out])
    assert s["rows"] == 2
    assert np.load(out)["patch_coords"].tolist() == [[0, 0, 224, 224]] * 2
    # a truncated WebP raises ValueError; the port reads WebP and progressive
    # JPEG since they were ported, where this refused them naming A.12
    (d / "c.webp").write_bytes(b"RIFF\x00\x00\x00\x00WEBP")
    with pytest.raises(ValueError, match="truncated|RIFF"):
        train_searcher.load_image_dir(str(d))
    (d / "c.webp").unlink()
    from PIL import Image
    Image.fromarray(rng.randint(0, 256, (16, 16, 3), dtype=np.uint8)).save(
        d / "c.jpg", "JPEG", progressive=True)
    imgs = train_searcher.load_image_dir(str(d))
    want = resize(np.asarray(Image.open(d / "c.jpg").convert("RGB")), (224, 224)) / 255.0
    assert imgs.shape == (3, 224, 224, 3)
    np.testing.assert_allclose(imgs[2], want, atol=1e-6)
