"""PyTorch port, the weight converters held against the JAX package on the
CPU (`utils/convert.py`, through `utils/loader.py`).

The synthetic CompVis state dict comes from the port's
`utils/testing.compvis_shapes` in the published key layout (the v1 UNet: 4
levels, 2 res blocks, attention at ds 1/2/4, so every key pattern of
`sd-v1-4.ckpt` appears, at model_channels 32, 2 heads, context 16).  It is
first validated against the JAX package: JAX's converter reads every key
and yields the shapes of `jax.eval_shape` of JAX's `UNet.init`,
`AutoencoderKL.init` and `CLIPTextTower.init`.  The HF CLIP vision, HF
RoBERTa and fairseq dicts come from transformers, as the JAX package's
`tests/test_fairseq_convert.py` builds them.

Then, for all seven converters, the port's parameters must equal
`weights.bridge(flatten(jax_convert(S)))` bit for bit; and at the 2-level
TINY config of `tests/test_loader.py` the port's UNet eps, VAE decode, text
tower and layout outputs on the same file match JAX's within
1e-4·max|ref| + 1e-5 (float32, the same products in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu import config as jcfg
from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
from diffusion_spacetime_attn_tpu.utils import convert as jconvert
from diffusion_spacetime_attn_tpu.utils import loader as jloader
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models.clip import CLIPTextTower, CLIPVisionTower
from diffusion_spacetime_attn_tpu_torch.utils import convert as tconvert
from diffusion_spacetime_attn_tpu_torch.utils import loader as tloader
from diffusion_spacetime_attn_tpu_torch.utils import testing
from diffusion_spacetime_attn_tpu_torch.utils.weights import bridge, flatten_tree, load_flat
from test_fairseq_convert import TINY as JLAYOUT_TINY
from test_fairseq_convert import _add_head, _fairseq_sd_from_hf, _hf_tiny_sd

CLIP_TINY = dict(width=16, layers=2, heads=2, vocab_size=100, max_len=7)
VISION_TINY = dict(image_size=14, patch_size=7, width=16, layers=2, heads=2, projection_dim=8)
# the v1 structure at narrow width
V1_NARROW = dict(
    unet=dict(model_channels=32, channel_mult=(1, 2, 4, 4), num_res_blocks=2,
              attention_resolutions=(1, 2, 4), num_heads=2, context_dim=16),
    vae=dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=2),
    text_encoder=CLIP_TINY,
    loss_clip=dict(vision=VISION_TINY, text=CLIP_TINY, projection_dim=8),
    spacetime=dict(num_steps=2, latent_size=16, image_size=32, max_objects=2))
# tests/test_loader.py's TINY
TINY = dict(
    unet=dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
              attention_resolutions=(1, 2), num_heads=2, context_dim=16),
    vae=dict(ch=32, ch_mult=(1, 2), num_res_blocks=1),
    text_encoder=dict(vocab_size=100, width=16, layers=1, heads=2, max_len=8),
    loss_clip=dict(vision=VISION_TINY, text=CLIP_TINY, projection_dim=8),
    spacetime=dict(num_steps=2, latent_size=8, image_size=16))


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """The test workers share the CPU cores; this module's torch work is
    small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pipeline_cfgs(spec):
    """(JAX PipelineConfig, port PipelineConfig) from one dict of fields."""
    def build(mod):
        kw = dict(spec)
        loss = kw.pop("loss_clip")
        return mod.PipelineConfig(
            unet=mod.UNetConfig(**kw["unet"]), vae=mod.VAEConfig(**kw["vae"]),
            text_encoder=mod.CLIPTextConfig(**kw["text_encoder"]),
            loss_clip=mod.CLIPConfig(vision=mod.CLIPVisionConfig(**loss["vision"]),
                                     text=mod.CLIPTextConfig(**loss["text"]),
                                     projection_dim=loss["projection_dim"]),
            spacetime=mod.SpaceTimeConfig(**kw["spacetime"]))
    return build(jcfg), build(tcfg)


def save_ckpt(path, sd, wrap=True):
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    torch.save({"state_dict": state} if wrap else state, path)
    return str(path)


def compvis_file(tmp_path, cfg, seed=0, scale=0.02, name="sd.ckpt"):
    """(path, the state dict): the CompVis layout at cfg's widths, with the
    EMA copy, a schedule buffer and the text tower's position_ids that the
    converters must ignore."""
    sd = testing.seeded_state_dict(testing.compvis_shapes(cfg), seed, scale)
    key = "model.diffusion_model.input_blocks.0.0.weight"
    extra = {"model_ema.input_blocks00weight": sd[key] + 1.0,
             "betas": np.linspace(1e-4, 2e-2, 10, dtype=np.float32)}
    state = {k: torch.from_numpy(v) for k, v in {**sd, **extra}.items()}
    state["cond_stage_model.transformer.text_model.embeddings.position_ids"] = \
        torch.arange(cfg.text_encoder.max_len)[None]
    torch.save({"state_dict": state, "global_step": 470000}, tmp_path / name)
    return str(tmp_path / name), sd


def roots(tree):
    """ids of the arrays the leaves of a converted tree view."""
    out = set()
    for leaf in flatten_tree(tree).values():
        while isinstance(leaf.base, np.ndarray):
            leaf = leaf.base
        out.add(id(leaf))
    return out


def shape_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(shape_paths(v, p) if isinstance(v, dict) else {p: tuple(v.shape)})
    return out


def jax_sd_trees(jc, sd):
    return (jconvert.convert_sd_unet(sd, channel_mult=jc.unet.channel_mult,
                                     num_res_blocks=jc.unet.num_res_blocks,
                                     attention_ds=jc.unet.attention_resolutions),
            jconvert.convert_sd_vae(sd, ch_mult=jc.vae.ch_mult,
                                    num_res_blocks=jc.vae.num_res_blocks),
            jconvert.convert_hf_clip_text(sd, prefix="cond_stage_model.transformer.text_model."))


def test_compvis_layout_is_what_jax_reads():
    """Every key of the synthetic CompVis dict is read by JAX's converters,
    which yield exactly the shapes of JAX's own module inits."""
    jc, tc = pipeline_cfgs(V1_NARROW)
    sd = testing.seeded_state_dict(testing.compvis_shapes(tc), 0)
    trees = jax_sd_trees(jc, sd)
    used = set().union(*(roots(t) for t in trees))
    assert {k for k, v in sd.items() if id(v) not in used} == set()
    abstract = JSD.create(jc, jax.random.PRNGKey(0), abstract=True)
    for tree, want in zip(trees, (abstract.unet_params, abstract.vae_params,
                                  abstract.text_params)):
        assert shape_paths(tree) == shape_paths(want)
    n_unet = sum(int(np.prod(s)) for k, s in testing.compvis_shapes(tcfg.PipelineConfig()).items()
                 if k.startswith("model.diffusion_model."))
    assert n_unet == 859520964          # SD v1's UNet


def test_openai_and_rel2bbox_layouts_are_what_jax_reads():
    jc, tc = pipeline_cfgs(V1_NARROW)
    sd = testing.seeded_state_dict(testing.openai_clip_shapes(tc.loss_clip), 1)
    tree = jconvert.convert_openai_clip(sd)
    assert {k for k, v in sd.items() if id(v) not in roots(tree)} == set()
    from diffusion_spacetime_attn_tpu.models.clip import CLIP as JCLIP
    v = jc.loss_clip.vision
    want = jax.eval_shape(JCLIP(jc.loss_clip).init, jax.random.PRNGKey(0),
                          jnp.zeros((1, v.image_size, v.image_size, 3)),
                          jnp.zeros((1, jc.loss_clip.text.max_len), jnp.int32))["params"]
    assert shape_paths(tree) == shape_paths(want)
    lcfg = dict(hidden=32, layers=2, heads=2, ffn_dim=64, max_positions=40, max_len=8)
    sd = testing.seeded_state_dict(testing.rel2bbox_shapes(tcfg.LayoutConfig(**lcfg)), 2)
    tree = jconvert.convert_fairseq_rel2bbox(sd)
    assert {k for k, v in sd.items() if id(v) not in roots(tree)} == set()
    from diffusion_spacetime_attn_tpu.models.layout.model import LayoutPredictor
    L = lcfg["max_len"]
    want = jax.eval_shape(LayoutPredictor(jcfg.LayoutConfig(**lcfg)).init, jax.random.PRNGKey(0),
                          jnp.ones((1, L), jnp.int32), jnp.zeros((1, L), jnp.bool_))["params"]
    assert shape_paths(tree) == shape_paths(want)


def hf_clip_vision_sd():
    from transformers import CLIPVisionConfig as HFCfg, CLIPVisionModel

    torch.manual_seed(3)
    hf = CLIPVisionModel(HFCfg(hidden_size=16, intermediate_size=64, num_hidden_layers=2,
                               num_attention_heads=2, image_size=14, patch_size=7,
                               hidden_act="quick_gelu")).eval()
    return {k: v.numpy() for k, v in hf.state_dict().items()}


def hf_clip_text_sd():
    from transformers import CLIPTextConfig as HFCfg, CLIPTextModel

    torch.manual_seed(4)
    hf = CLIPTextModel(HFCfg(vocab_size=100, hidden_size=16, intermediate_size=64,
                             num_hidden_layers=2, num_attention_heads=2,
                             max_position_embeddings=7, hidden_act="quick_gelu")).eval()
    return {k: v.numpy() for k, v in hf.state_dict().items()}


def hf_roberta_sd():
    """JAX's tiny HF RoBERTa with a nonzero token-type row (folded into the
    positions by both converters), under `roberta.`."""
    sd = _hf_tiny_sd()
    sd["embeddings.token_type_embeddings.weight"] = testing.seeded_normal(
        5, "tt", sd["embeddings.token_type_embeddings.weight"].shape)
    return {f"roberta.{k}": v for k, v in sd.items()}


def port_and_jax(name, tmp_path):
    """(the port's module after loading S through its loader or converter,
    JAX's converted tree of the same S)."""
    jc, tc = pipeline_cfgs(V1_NARROW)
    if name in ("sd_unet", "sd_vae", "sd_text"):
        path, sd = compvis_file(tmp_path, tc)
        bundle = tloader.load_stable_diffusion(tc, path, device="cpu")
        i = ("sd_unet", "sd_vae", "sd_text").index(name)
        return (bundle.unet, bundle.vae, bundle.text_encoder)[i], jax_sd_trees(jc, sd)[i]
    if name == "hf_clip_text":
        sd = hf_clip_text_sd()
        module = CLIPTextTower(tc.loss_clip.text)
        return (load_flat(module, flatten_tree(tconvert.convert_hf_clip_text(sd))),
                jconvert.convert_hf_clip_text(sd))
    if name == "openai_clip":
        sd = testing.seeded_state_dict(testing.openai_clip_shapes(tc.loss_clip), 1)
        clip = tloader.load_clip_loss(tc.loss_clip, save_ckpt(tmp_path / "vit.pt", sd, False),
                                      device="cpu").clip
        return clip, jconvert.convert_openai_clip(sd)
    if name == "hf_clip_vision":
        sd = hf_clip_vision_sd()
        module = CLIPVisionTower(tc.loss_clip.vision)
        return (load_flat(module, flatten_tree(tconvert.convert_hf_clip_vision(sd))),
                jconvert.convert_hf_clip_vision(sd))
    lcfg = tcfg.LayoutConfig(**dataclasses.asdict(JLAYOUT_TINY))
    if name == "hf_roberta":
        sd = hf_roberta_sd()
        model = tloader.load_layout_predictor(lcfg, save_ckpt(tmp_path / "rb.pth", sd, False),
                                              device="cpu")
        tree = jconvert.convert_hf_roberta(sd, prefix="roberta.")
        tree["object_embedding"] = model.backbone.object_embedding.numpy()
        return model.backbone, tree
    sd = _add_head(_fairseq_sd_from_hf(_hf_tiny_sd(), 2, 32), 32)
    model = tloader.load_layout_predictor(lcfg, save_ckpt(tmp_path / "fs.pth", sd), device="cpu")
    return model, jconvert.convert_fairseq_rel2bbox(sd)


@pytest.mark.parametrize("name", ["sd_unet", "sd_vae", "sd_text", "hf_clip_text", "openai_clip",
                                  "hf_clip_vision", "hf_roberta", "fairseq_rel2bbox"])
def test_parameters_equal_bridged_jax_conversion(name, tmp_path):
    module, tree = port_and_jax(name, tmp_path)
    want = bridge(flatten_tree(tree), module)
    got = module.state_dict()
    assert list(got) and set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k]), k


def close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape and np.isfinite(got).all()
    tol = 1e-4 * np.abs(ref).max() + 1e-5
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)


def test_outputs_match_jax_on_the_same_file(tmp_path):
    """TINY (2 levels): one CompVis file through both loaders; UNet eps, VAE
    decode and text tower agree; a fairseq file through both layout loaders
    gives the same raw GMM outputs."""
    jc, tc = pipeline_cfgs(TINY)
    path, _ = compvis_file(tmp_path, tc, seed=7, scale=0.1)
    jsd = jloader.load_stable_diffusion(jc, path)
    tsd = tloader.load_stable_diffusion(tc, path, device="cpu")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4), dtype=np.float32)
    t = np.array([981, 21], np.int32)
    ctx = rng.standard_normal((2, 8, 16), dtype=np.float32)
    ref = jsd.unet.apply({"params": jsd.unet_params}, jnp.asarray(x), jnp.asarray(t),
                         jnp.asarray(ctx))
    with torch.no_grad():
        got = tsd.unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    close(got, ref)
    z = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    with torch.no_grad():
        close(tsd.decode_latents(torch.from_numpy(z)), jsd.decode_latents(jnp.asarray(z)))
        ids = np.array([[1, 5, 9, 3, 2, 0, 99, 4]], np.int32)
        close(tsd.encode_text(ids), jsd.encode_text(jnp.asarray(ids)))
    sd = _add_head(_fairseq_sd_from_hf(_hf_tiny_sd(), 2, 32), 32)
    lpath = save_ckpt(tmp_path / "fs.pth", sd)
    jmodel, jparams = jloader.load_layout_predictor(JLAYOUT_TINY, lpath)
    tmodel = tloader.load_layout_predictor(tcfg.LayoutConfig(**dataclasses.asdict(JLAYOUT_TINY)),
                                           lpath, device="cpu")
    tokens = np.array([[0, 7, 23, 45, 9, 2, 1, 1]], np.int32)
    obj = np.zeros((1, 8), np.float32)
    obj[0, 2] = 1.0
    ref = jmodel.apply({"params": jparams}, jnp.asarray(tokens), jnp.asarray(obj))
    with torch.no_grad():
        close(tmodel(torch.from_numpy(tokens), torch.from_numpy(obj)), ref)


def test_vq_and_lpips_converters_raise_naming_their_items():
    """convert_sd_vq converts a VQModel file in the published key layout as
    JAX's does, bit for bit, and raises naming a key the file lacks; the
    LPIPS converter still raises naming its item (ROADMAP A.12)."""
    vcfg = tcfg.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, n_embed=16)
    sd = testing.seeded_state_dict(testing.vq_shapes(vcfg), seed=4)
    kw = dict(ch_mult=vcfg.ch_mult, num_res_blocks=vcfg.num_res_blocks)
    got = flatten_tree(tconvert.convert_sd_vq(sd, **kw))
    want = flatten_tree(jconvert.convert_sd_vq(sd, **kw))
    assert sorted(got) == sorted(want) and "quantize/embedding" in got
    assert all(np.array_equal(got[k], want[k]) for k in want)
    sd.pop("first_stage_model.quantize.embedding.weight")
    with pytest.raises(KeyError, match="first_stage_model.quantize.embedding.weight"):
        tconvert.convert_sd_vq(sd, **kw)
    with pytest.raises(NotImplementedError, match="A.12"):
        tconvert.convert_lpips({})
