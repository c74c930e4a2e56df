"""PyTorch port, the trainers over a data mesh held against the JAX
package's `Mesh(('data',))` steps on the CPU: the LDM trainer data-parallel
(the global batch's t and noise, the scaled learning rate), with class
conditioning, and under FSDP with EMA (the global-norm clip over shards,
the per-rank state bytes, a checkpoint saved on two ranks restored on one
and a one-device checkpoint restored on two); the VAE trainer data-parallel
and under FSDP (the global batch's posterior sample, the adaptive weight
from the averaged last-layer gradients, the discriminator's BatchNorm on
the global batch); the layout trainer under FSDP and data-parallel (the
loss a sum over the ranks).

JAX runs its mesh over two of the conftest's eight virtual CPU devices;
the port runs two gloo ranks (`tests/helpers/torch_ranks.py`, spawned
once for the module while the JAX side computes), each on its rows of the
same seeded global batch, on the same weights (the weight bridge).
Configs: `test_ldm_training.py`'s TINY UNet at 64 channels (two per
GroupNorm group, so no bias sits before a per-channel norm, whose gradient
is rounding noise that Adam turns into ±lr; `test_torch_ldm_training.py`
explains), 16² latents, global batch 4; `test_torch_vae_training.py`'s
VAE at one level, 32² images, global batch 4, the discriminator from step 0; the
2-layer layout predictor of `test_torch_layout_training.py`, global batch
8.  Tolerances are JAX's own mesh tests': losses rtol 2e-5, parameters and
EMA atol 2e-5; the gradients 1e-4 relative in norm above a 1e-6 floor of
the global norm (`test_torch_ldm_training.py`); the VAE's metrics 1e-4
relative and its parameters 1e-4 relative in norm without the attention
key biases (`test_torch_vae_training.py`, a softmax ignores their exact
zero gradient); the layout predictor's parameters atol 2e-5 without its
attention key biases.  Torch takes one thread in each process.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.torch_ranks import ClassToy, Ranks

from diffusion_spacetime_attn_tpu.config import LayoutConfig as JLayoutConfig
from diffusion_spacetime_attn_tpu.config import LayoutTrainConfig as JLayoutTrainConfig
from diffusion_spacetime_attn_tpu.config import LDMTrainConfig as JLDMTrainConfig
from diffusion_spacetime_attn_tpu.config import ScheduleConfig as JScheduleConfig
from diffusion_spacetime_attn_tpu.config import UNetConfig as JUNetConfig
from diffusion_spacetime_attn_tpu.config import VAEConfig as JVAEConfig
from diffusion_spacetime_attn_tpu.models import encoders as jenc
from diffusion_spacetime_attn_tpu.models.layout.model import create_layout_predictor as jcreate
from diffusion_spacetime_attn_tpu.models.unet import UNet as JUNet
from diffusion_spacetime_attn_tpu.models.vae import AutoencoderKL as JAutoencoderKL
from diffusion_spacetime_attn_tpu.ops.schedule import make_schedule as jmake_schedule
from diffusion_spacetime_attn_tpu.parallel.mesh import make_mesh as jmake_mesh
from diffusion_spacetime_attn_tpu.training import datasets as jdata
from diffusion_spacetime_attn_tpu.training import ldm_trainer as jldm
from diffusion_spacetime_attn_tpu.training import layout_trainer as jlayout
from diffusion_spacetime_attn_tpu.training import vae_trainer as jvt
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_roberta_tokenizer as jtokenizer
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.models.layout.model import LayoutPredictor
from diffusion_spacetime_attn_tpu_torch.models.unet import UNet
from diffusion_spacetime_attn_tpu_torch.models.vae import AutoencoderKL
from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
from diffusion_spacetime_attn_tpu_torch.scripts import train_ldm, train_vae
from diffusion_spacetime_attn_tpu_torch.training import ldm_trainer as tldm
from diffusion_spacetime_attn_tpu_torch.training.perceptual import NLayerDiscriminator
from diffusion_spacetime_attn_tpu_torch.utils import prng
from diffusion_spacetime_attn_tpu_torch.utils.png import write_png
from diffusion_spacetime_attn_tpu_torch.utils.weights import bridge, layout_state_dict, load_flat
from test_torch_pipeline import flat, port_cfg

UNET = JUNetConfig(model_channels=64, channel_mult=(1,), num_res_blocks=1,
                   attention_resolutions=(1,), num_heads=2, context_dim=16)
SCHED = JScheduleConfig()
VAE_CFG = JVAEConfig(ch=64, ch_mult=(1,), num_res_blocks=1, z_channels=2, embed_dim=2)
VAE_TRAIN = dict(base_lr=1e-4, disc_start=0, disc_ndf=8, disc_layers=2, perceptual_weight=0.0,
                 kl_weight=1e-3)
LAYOUT = dict(vocab_size=50265, hidden=32, layers=2, heads=2, ffn_dim=64, max_positions=140,
              max_len=16)
LAYOUT_TRAIN = dict(batch_size=8, encoder_max_lr=1e-4, head_max_lr=3e-3, warmup_steps=5,
                    hold_steps=5, decay_steps=10000)
# lr = accum x ranks x per-rank batch x base_lr (scaled) = 1e-4, EMA, a clip that acts
MESH_CFG = dict(use_ema=True, scale_lr=True, batch_size=2, base_lr=2.5e-5, grad_clip_norm=0.05)
CLASS_CFG = dict(batch_size=2, base_lr=1e-3, scale_lr=False, use_ema=False)
CASES = ["ldm_dp", "ldm_class", "ldm_fsdp", "vae_dp", "vae_fsdp", "layout_fsdp", "layout_dp",
         "scripts", "model_axis_trainers"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_mesh():
    return jmake_mesh(data=2, devices=jax.devices()[:2])


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def rel_norm(got, want) -> float:
    return float(torch.linalg.vector_norm(got.float() - want.float())
                 / torch.linalg.vector_norm(want.float()).clamp_min(1e-30))


def params_close(got: dict, want: dict, atol=2e-5, skip=()):
    assert sorted(got) == sorted(want)
    for k in want:
        if not any(k.endswith(s) for s in skip):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0,
                                       err_msg=k)


def grads_close(got: dict, want: dict):
    """Each gradient within 1e-4 relative in norm, above a floor of 1e-6 of
    the global norm."""
    total = float(np.sqrt(sum(float((v.float() ** 2).sum()) for v in want.values())))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        err = float(torch.linalg.vector_norm(got[k] - w))
        assert err <= 1e-4 * float(torch.linalg.vector_norm(w)) + 1e-6 * total, k


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs (JAX's initial weights through the bridge, seeded
    batches), the one-device checkpoint the ranks restore, and the ranks,
    started before any JAX step compiles."""
    d = str(tmp_path_factory.mktemp("ranks"))
    junet = JUNet(UNET, radius=0.2)
    shapes = jax.eval_shape(junet.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)),
                            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 16)))["params"]
    uparams = randomize_params(shapes, jax.random.PRNGKey(1))
    ucfg = port_cfg(UNET)
    unet = load_flat(UNet(ucfg, radius=0.2), flat(uparams))
    r = np.random.RandomState(2)
    x0 = r.randn(4, 16, 16, 4).astype(np.float32)
    ctx = r.randn(4, 7, 16).astype(np.float32)
    classes = np.array([[3.0], [7.0], [3.0], [1.0]], np.float32)
    jemb = jenc.ClassEmbedder(n_classes=10, embed_dim=8)
    cparams = {"w": jnp.ones(()),
               "cond": jemb.init(jax.random.PRNGKey(0), jnp.zeros((1,), jnp.int32))["params"]}
    toy = load_flat(ClassToy(10, 8), flat(cparams))
    ldm = dict(unet_cfg=ucfg, state=unet.state_dict(), x0=x0, ctx=ctx, key=prng.PRNGKey(5),
               cfg=tcfg.LDMTrainConfig(**MESH_CFG))
    inputs = {"ldm_dp": ldm, "ldm_fsdp": ldm,
              "ldm_class": dict(state=toy.state_dict(), x0=np.ones((4, 4, 4, 2), np.float32),
                                ctx=classes, classes=(10, 8), key=prng.PRNGKey(1),
                                cfg=tcfg.LDMTrainConfig(**CLASS_CFG))}
    # a one-device checkpoint (one step) for the ranks to restore
    one = load_flat(UNet(ucfg, radius=0.2), flat(uparams))
    tr = tldm.LDMTrainer(tcfg.LDMTrainConfig(**MESH_CFG), tcfg.ScheduleConfig(),
                         make_schedule(tcfg.ScheduleConfig(), 50), one,
                         ckpt_dir=os.path.join(d, "one"))
    st, _ = tr.train_step(tr.init(), torch.from_numpy(x0), torch.from_numpy(ctx),
                          prng.PRNGKey(5))
    tr.save(st, 1)
    # the one-process gradient of the global batch, which the ranks' reduced
    # gradients must equal (the port's p_losses is held against JAX's in
    # test_torch_ldm_training.py)
    single = load_flat(UNet(ucfg, radius=0.2), flat(uparams))
    tr = tldm.LDMTrainer(tcfg.LDMTrainConfig(**MESH_CFG), tcfg.ScheduleConfig(),
                         make_schedule(tcfg.ScheduleConfig(), 50), single)
    loss1, _ = tr.gradients(tr.init(), torch.from_numpy(x0), torch.from_numpy(ctx),
                            prng.PRNGKey(5))
    one_grads = {k: p.grad.clone() for k, p in single.named_parameters()}
    # VAE: JAX's init through the bridge
    jvtr = jvt.VAETrainer(JAutoencoderKL(VAE_CFG), jvt.VAETrainConfig(**VAE_TRAIN))
    js = jvtr.init(jax.random.PRNGKey(0), image_hw=32, lpips_params={})
    vae = load_flat(AutoencoderKL(port_cfg(VAE_CFG)), flat(js.ae_params))
    disc = load_flat(NLayerDiscriminator(ndf=8, n_layers=2),
                     {**flat(js.disc_params), **flat(js.disc_stats)})
    images = [(np.random.RandomState(10).rand(4, 32, 32, 3) * 2 - 1).astype(np.float32)]
    inputs["vae"] = dict(vae_cfg=port_cfg(VAE_CFG), cfg=tvt_cfg(), ae=vae.state_dict(),
                         disc=disc.state_dict(), images=images,
                         keys=[prng.PRNGKey(0)])
    # layout
    jlcfg = JLayoutConfig(**LAYOUT)
    _, lparams = jcreate(jlcfg, jax.random.PRNGKey(0))
    lparams = jax.tree_util.tree_map(np.asarray, jax.device_get(lparams))
    lmodel = LayoutPredictor(tcfg.LayoutConfig(**LAYOUT))
    lmodel.load_state_dict(layout_state_dict(lparams, lmodel), strict=True)
    examples = jdata.synthetic_examples(16, np.random.RandomState(7))
    batches = list(jdata.batches(examples, jtokenizer(), 8, np.random.RandomState(0),
                                 max_len=16, max_rels=2, max_objs=2, epochs=1))[:2]
    inputs["layout"] = dict(cfg=tcfg.LayoutConfig(**LAYOUT),
                            train_cfg=tcfg.LayoutTrainConfig(**LAYOUT_TRAIN),
                            state=lmodel.state_dict(), batches=[tuple(b) for b in batches])
    inputs["scripts"] = script_argv(os.path.join(d, "images"))
    inputs["model_axis"] = {"ldm": inputs["ldm_class"], "vae": inputs["vae"],
                            "layout": inputs["layout"]}
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    ranks = Ranks(d, CASES)
    return dict(d=d, ranks=ranks, junet=junet, uparams=uparams, jemb=jemb, cparams=cparams,
                x0=x0, ctx=ctx, classes=classes, js=js, images=images, lparams=lparams,
                batches=batches, vae=vae, disc=disc, lmodel=lmodel, one_grads=one_grads,
                one_loss=float(loss1))


def script_argv(folder: str) -> dict:
    """Four PNGs of odd sizes with captions.jsonl in `folder`, and the
    argv (but --batch-size and --ckpt-dir) of two steps of `train_ldm
    --tiny --data-dir` (text) and `train_vae --tiny --data-dir` over it."""
    os.makedirs(folder)
    with open(os.path.join(folder, "captions.jsonl"), "w") as f:
        for i in range(4):
            r = np.random.RandomState(20 + i)
            write_png(os.path.join(folder, f"img{i}.png"),
                      r.randint(0, 256, (34 + 3 * i, 40 - 2 * i, 3), dtype=np.uint8))
            f.write(json.dumps({"file": f"img{i}.png", "text": f"a photo of thing {i}"}) + "\n")
    common = ["--tiny", "--cpu", "--steps", "2", "--log-every", "1", "--data-dir", folder]
    return {"ldm": common + ["--dtype", "float32", "--ckpt-every", "0"],
            "vae": common + ["--disc-start", "0", "--ckpt-every", "0"]}


def tvt_cfg():
    from diffusion_spacetime_attn_tpu_torch.training.vae_trainer import VAETrainConfig

    return VAETrainConfig(**VAE_TRAIN)


def outs(setup, name):
    o = setup["ranks"].join()
    return o[0][name], o[1][name]


def _jax_ldm_step(eps_model, params, x0, ctx, cfg, key, context_rank=3):
    trainer = jldm.LDMTrainer(JLDMTrainConfig(**cfg), SCHED, jmake_schedule(SCHED, 50),
                              eps_model, mesh=jax_mesh(), context_rank=context_rank)
    state, m = trainer.train_step(trainer.init(params), jnp.asarray(x0), jnp.asarray(ctx), key)
    return trainer, state, m


@pytest.fixture(scope="module")
def jax_ldm(setup):
    """JAX's data-parallel mesh step on the UNet."""
    junet = setup["junet"]

    def eps(p, x, t, c):
        return junet.apply({"params": p}, x, t, c)

    trainer, state, m = _jax_ldm_step(eps, setup["uparams"], setup["x0"], setup["ctx"],
                                      MESH_CFG, jax.random.PRNGKey(5))
    model = UNet(port_cfg(UNET), radius=0.2)
    return dict(lr=trainer.lr, loss=float(m["loss"]), params=bridge(flat(state.params), model),
                ema=bridge(flat(state.ema_params), model))


def test_ldm_data_parallel_step_matches_jax_mesh(setup, jax_ldm):
    """Each rank's two rows see JAX's global t and noise: the loss and every
    gradient of the global batch, the learning rate scaled by the two
    ranks, the global-norm clip (it acts), and the updated weights and EMA
    of JAX's data-parallel step."""
    a, b = outs(setup, "ldm_dp")
    norm = float(torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in
                                                       setup["one_grads"].values()])))
    assert a["rows"] == b["rows"] == 2 and norm > MESH_CFG["grad_clip_norm"]
    assert a["lr"] == pytest.approx(jax_ldm["lr"], rel=1e-12) and a["lr"] == pytest.approx(1e-4)
    assert rel(a["loss"], jax_ldm["loss"]) <= 2e-5 and a["loss"] == b["loss"]
    assert rel(a["grad_loss"], setup["one_loss"]) <= 2e-5
    grads_close(a["grads"], setup["one_grads"])
    params_close(a["params"], jax_ldm["params"])
    params_close(a["ema"], jax_ldm["ema"])
    params_close(b["params"], a["params"], atol=0)


def test_ldm_class_conditioning_under_mesh_matches_jax(setup):
    """`test_ldm_training.py`'s class-conditional model (a jointly trained
    ClassEmbedder, rank-2 class-id context; each row's embedding mean here,
    where JAX's test takes the batch's, which couples the rows) over the
    mesh: the loss and the
    updated weights of JAX's data-parallel step (context_rank 2); the used
    rows of the table move."""
    jemb = setup["jemb"]

    def eps(p, x, t, c):
        emb = jemb.apply({"params": p["cond"]}, c[:, 0].astype(jnp.int32))
        return x * p["w"] + jnp.mean(emb.reshape(x.shape[0], -1), axis=-1)[:, None, None, None]

    _, state, m = _jax_ldm_step(eps, setup["cparams"], np.ones((4, 4, 4, 2), np.float32),
                                setup["classes"], CLASS_CFG, jax.random.PRNGKey(1),
                                context_rank=2)
    a, b = outs(setup, "ldm_class")
    assert rel(a["loss"], m["loss"]) <= 2e-5 and a["rows"] == 2
    params_close(a["params"], bridge(flat(state.params), ClassToy(10, 8)))
    table0 = np.asarray(setup["cparams"]["cond"]["embedding"]["embedding"])
    moved = np.abs(a["params"]["cond.embedding.weight"].numpy() - table0).max(axis=1)
    assert (moved[[1, 3, 7]] > 1e-5).all()
    params_close(b["params"], a["params"], atol=0)


def test_ldm_fsdp_step_matches_jax_mesh(setup, jax_ldm):
    """fsdp=True: every parameter a shard; the loss, the gradients (gathered
    from the shards), the global-norm clip over the shards, the weights and
    EMA equal JAX's mesh step (JAX's own tests hold its FSDP step equal to
    its replicated one); each rank holds at most 0.6 of the replicated
    state's bytes (weights, AdamW's moments, EMA)."""
    a, b = outs(setup, "ldm_fsdp")
    assert a["sharded"] == a["n_params"] > 0
    for o in (a, b):
        assert o["state_bytes"] <= 0.6 * o["replicated_bytes"], (o["state_bytes"],
                                                                 o["replicated_bytes"])
    assert rel(a["loss"], jax_ldm["loss"]) <= 2e-5
    assert rel(a["grad_loss"], setup["one_loss"]) <= 2e-5
    grads_close(a["grads"], setup["one_grads"])
    params_close(a["params"], jax_ldm["params"])
    params_close(a["ema"], jax_ldm["ema"])
    params_close(b["params"], a["params"], atol=0)


def test_checkpoint_saved_on_two_ranks_restores_on_one(setup):
    """The FSDP run's checkpoint (whole tensors, written by rank 0) restores
    on one device equal to the ranks' gathered state, and a fresh sharded
    state restored from it equals the one that saved it; the one-device
    checkpoint restores onto the two ranks' shards."""
    a, b = outs(setup, "ldm_fsdp")
    assert a["restored_equal"] and b["restored_equal"]
    assert a["one_device_onto_ranks"] and b["one_device_onto_ranks"]
    model = UNet(port_cfg(UNET), radius=0.2)
    tr = tldm.LDMTrainer(tcfg.LDMTrainConfig(**MESH_CFG), tcfg.ScheduleConfig(),
                         make_schedule(tcfg.ScheduleConfig(), 50), model,
                         ckpt_dir=os.path.join(setup["d"], "mesh"))
    st = tr.restore(1, tr.init())
    assert st.step == 1 and st.opt_state.count == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, a["params"][k]), k
    for k, v in st.ema_params.items():
        assert torch.equal(v, a["ema"][k]), k
    # the next step runs on one device from the ranks' state
    st, m2 = tr.train_step(st, torch.from_numpy(setup["x0"]), torch.from_numpy(setup["ctx"]),
                           prng.PRNGKey(6))
    assert np.isfinite(float(m2["loss"])) and st.step == 2


@pytest.fixture(scope="module")
def jax_vae(setup):
    """JAX's VAE step (the discriminator on) over its data mesh."""
    jtr = jvt.VAETrainer(JAutoencoderKL(VAE_CFG), jvt.VAETrainConfig(**VAE_TRAIN),
                         mesh=jax_mesh())
    js = jtr.init(jax.random.PRNGKey(0), image_hw=32)
    jms = []
    for i, x in enumerate(setup["images"]):
        js, jm = jtr.train_step(js, jnp.asarray(x), jax.random.PRNGKey(i))
        jms.append({k: float(v) for k, v in jm.items()})
    return js, jms


@pytest.mark.parametrize("fsdp", [False, True], ids=["dp", "fsdp"])
def test_vae_step_over_mesh_matches_jax_mesh(setup, jax_vae, fsdp):
    """A VAE step with the discriminator on: the global batch's posterior
    sample, d_weight from the averaged last-layer gradients, the
    discriminator's BatchNorm over the global batch (its running statistics
    too), every metric of JAX's mesh step and the updated weights (JAX's
    own tests hold its FSDP step equal to its replicated one).  One step:
    with the perceptual term off, the second step's d_weight is a ratio of
    near-cancelling norms, 1.1e-4 apart between the packages on one device
    too."""
    js, jms = jax_vae
    a, b = outs(setup, "vae_fsdp" if fsdp else "vae_dp")
    assert (a["sharded"] > 0) == fsdp
    for tm, jm in zip(a["metrics"], jms):
        assert sorted(tm) == sorted(jm)
        for k in jm:
            assert abs(tm[k] - jm[k]) <= 1e-4 * abs(jm[k]) + 1e-6, k
    assert jms[-1]["d_weight"] > 0 and a["metrics"] == b["metrics"]
    for got, (model, tree) in ((a["ae"], (setup["vae"], flat(js.ae_params))),
                               (a["disc"], (setup["disc"],
                                            {**flat(js.disc_params), **flat(js.disc_stats)}))):
        want = bridge(tree, model)
        assert sorted(got) == sorted(want)
        for k in want:
            if not k.endswith("attn_1.k.bias"):
                assert rel_norm(got[k], want[k]) <= 1e-4, k
    assert abs(a["logvar"] - float(js.logvar)) <= 1e-4
    for k, v in a["ae"].items():
        assert torch.equal(v, b["ae"][k]), k


@pytest.fixture(scope="module")
def jax_layout(setup):
    """JAX's layout trainer over its mesh with fsdp: two steps."""
    jtr = jlayout.LayoutTrainer.create(JLayoutConfig(**LAYOUT),
                                       JLayoutTrainConfig(**LAYOUT_TRAIN), setup["lparams"],
                                       mesh=jax_mesh(), fsdp=True)
    params = setup["lparams"]
    opt = jtr.init_state(params)
    jl = []
    for b in setup["batches"]:
        params, opt, loss, m = jtr.train_step(params, opt, b)
        jl.append({"loss": float(loss), **{k: float(v) for k, v in m.items()}})
    return layout_state_dict(jax.tree_util.tree_map(np.asarray, jax.device_get(params)),
                             setup["lmodel"]), jl


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "dp"])
def test_layout_step_over_mesh_matches_jax_mesh_fsdp(setup, jax_layout, fsdp):
    """Two steps of the layout trainer: the loss (a sum over the global
    batch: each rank's rows summed over the ranks) and its terms, the
    gradient summed (not averaged) over the ranks, the updated weights of
    JAX's mesh+fsdp step; under fsdp the two groups' Adam moments are
    shards."""
    want, jl = jax_layout
    a, b = outs(setup, "layout_fsdp" if fsdp else "layout_dp")
    assert a["count"] == 2
    assert (a["sharded_moments"] == a["n_moments"] > 0) if fsdp else a["sharded_moments"] == 0
    for got, w in zip(a["losses"], jl):
        assert sorted(got) == sorted(w)
        for k in w:
            assert rel(got[k], w[k]) <= 2e-5, k
    params_close(a["params"], want, skip=("attn.k.bias",))
    params_close(b["params"], a["params"], atol=0)


def test_trainers_refuse_the_model_axis_and_fsdp_without_a_mesh(setup):
    """The model axis, refused until it was ported, replicates each trainer's
    step as JAX's trainers do: over a (1, 2) mesh made on the two ranks
    (rank m at (0, m)) the class-conditional LDM, VAE and layout steps, fsdp
    asked (a data axis of 1 shards nothing), equal the data-parallel steps
    on the same global batch (each rank computes all of it), at the same lr
    (data·model = 2 devices), equal on both ranks; LDMTrainer(fsdp=True) without a mesh
    raises as JAX's asserts; a mesh that is not a parallel.mesh.Mesh raises
    TypeError."""
    a, b = outs(setup, "model_axis_trainers")
    dp = outs(setup, "ldm_class")[0]
    for r, o in enumerate((a, b)):
        assert o["coords"] == (r, 0, r) and o["devices"] == 2
        assert not o["ldm"]["fsdp"] and o["ldm"]["rows"] == 4 and o["ldm"]["lr"] == dp["lr"]
        assert rel(o["ldm"]["loss"], dp["loss"]) <= 2e-5
        grads_close(o["ldm"]["grads"], dp["grads"])
        params_close(o["ldm"]["params"], dp["params"])
        assert o["vae"]["sharded"] == 0 and o["layout"]["sharded_moments"] == 0
    vdp, ldp = outs(setup, "vae_dp")[0], outs(setup, "layout_dp")[0]
    for got, want in zip(a["vae"]["metrics"], vdp["metrics"]):
        for k in want:
            assert abs(got[k] - want[k]) <= 1e-4 * abs(want[k]) + 1e-6, k
    for got, want in zip(a["layout"]["losses"], ldp["losses"]):
        for k in want:
            assert rel(got[k], want[k]) <= 2e-5, k
    params_close(a["layout"]["params"], ldp["params"], skip=("attn.k.bias",))
    for part in ("ldm", "vae", "layout"):
        key = "ae" if part == "vae" else "params"
        assert all(torch.equal(v, b[part][key][k]) for k, v in a[part][key].items()), part
    sched = make_schedule(tcfg.ScheduleConfig(), 50)
    with pytest.raises(ValueError, match="requires a mesh"):
        tldm.LDMTrainer(tcfg.LDMTrainConfig(), tcfg.ScheduleConfig(), sched,
                        torch.nn.Linear(1, 1), fsdp=True)
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tldm.LDMTrainer(tcfg.LDMTrainConfig(), tcfg.ScheduleConfig(), sched,
                        torch.nn.Linear(1, 1), mesh=object())
    from diffusion_spacetime_attn_tpu_torch.training import layout_trainer

    assert not layout_trainer.LayoutTrainer.create(tcfg.LayoutConfig(**LAYOUT),
                                                   tcfg.LayoutTrainConfig(), fsdp=True).fsdp


def test_train_scripts_over_two_ranks_match_one_process(setup, tmp_path):
    """`train_ldm --data-dir` and `train_vae --data-dir` on two ranks at a
    per-device batch of 1: each rank reads, encodes and captions only its
    row of the global batch (the picks, flips and posterior noise drawn for
    the whole batch), and the two steps' metrics, the global batch's, equal
    one process's at a batch of 2 (losses rtol 2e-5; the VAE's metrics 1e-4
    relative, `test_torch_vae_training.py`'s)."""
    a = script_argv(str(tmp_path / "images"))
    one_ldm = train_ldm.main([*a["ldm"], "--batch-size", "2", "--ckpt-dir", str(tmp_path / "l")])
    one_vae = train_vae.main([*a["vae"], "--batch-size", "2", "--ckpt-dir", str(tmp_path / "v")])
    r0, r1 = outs(setup, "scripts")
    for r, rank in enumerate((r0, r1)):
        for got, want in zip(rank["ldm_first"], one_ldm["first_batch"]):
            np.testing.assert_allclose(got.numpy(), want[r:r + 1].numpy(), atol=1e-5, rtol=1e-5)
        for tol, part, one in ((2e-5, "ldm", one_ldm), (1e-4, "vae", one_vae)):
            assert len(rank[part]) == len(one["metrics"]) == 2
            for got, want in zip(rank[part], one["metrics"]):
                assert got.keys() == want.keys()
                for k in want:
                    if k != "step":
                        assert rel(got[k], want[k]) <= tol, (part, k, got[k], want[k])
