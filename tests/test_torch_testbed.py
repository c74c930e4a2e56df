"""PyTorch port, the closed-loop testbed held against the JAX package on the CPU.

  * `utils/msgpack.py` against flax's `msgpack_restore` on the committed
    trees (`saved/testbed/*.msgpack`) and on synthetic trees;
  * the trained testbed models, loaded by each package its own way (JAX:
    `testbed/bundle.py` `load_bundle` through flax; the port: its reader and
    the weight bridge): text tower, UNet eps with and without control, VAE
    decode and the DCLIP losses, f32, tolerance 1e-4·max|ref| + 1e-5;
  * scenes, tokens, the oracle detector and the protocol math (equal);
  * `utils/prng.py` against `jax.random` on the protocol's 12 noise keys;
  * the method-eval loop against JAX's (`tests/test_testbed.py`
    `test_method_eval_loop_smoke`: smoke config, 4 PLMS steps, 1 epoch, JAX's
    random weights through the bridge), and the entry point's `main()` with
    its resume file.

Each tree and bundle is loaded once per module.
"""
import dataclasses as dc
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util
from scipy import ndimage

from diffusion_spacetime_attn_tpu.eval import metrics as jmetrics
from diffusion_spacetime_attn_tpu.ops.attention import SpatialControl as JControl
from diffusion_spacetime_attn_tpu.testbed import oracle as joracle
from diffusion_spacetime_attn_tpu.testbed import scenes as jscenes
from diffusion_spacetime_attn_tpu.testbed.bundle import load_bundle as jload_bundle
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.eval import metrics
from diffusion_spacetime_attn_tpu_torch.ops.attention import SpatialControl
from diffusion_spacetime_attn_tpu_torch.scripts import method_eval_testbed as tme
from diffusion_spacetime_attn_tpu_torch.testbed import oracle, scenes
from diffusion_spacetime_attn_tpu_torch.testbed.bundle import TREES, TestbedBundle, load_bundle
from diffusion_spacetime_attn_tpu_torch.testbed.configs import testbed_clip_cfg
from diffusion_spacetime_attn_tpu_torch.utils import msgpack as tmsgpack
from diffusion_spacetime_attn_tpu_torch.utils import prng
from diffusion_spacetime_attn_tpu_torch.utils.weights import bridge

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "saved" / "testbed"
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def port_cfg(c):
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (port_cfg(getattr(c, f.name))
                           if dc.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dc.fields(c)})


def flat(params):
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


def assert_close(got, want, what=""):
    """max |got − want| ≤ 1e-4·max|want| + 1e-5."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, lim = np.abs(got - want).max(), 1e-4 * np.abs(want).max() + 1e-5
    assert err <= lim, (what, err, lim)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test processes side by side on few cores,
    where torch's spinning intra-op threads slow each other down many-fold;
    this module's torch work is small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """{name: (port's flat tree, flax's flat tree)} of the committed files."""
    out = {}
    for name in TREES:
        raw = (CKPT / f"{name}.msgpack").read_bytes()
        out[name] = (tmsgpack.flatten(tmsgpack.unpackb(raw)),
                     traverse_util.flatten_dict(serialization.msgpack_restore(raw), sep="/"))
    return out


@pytest.fixture(scope="module")
def bundles():
    """(JAX bundle, port bundle on the CPU) of the trained testbed."""
    return (jload_bundle(str(CKPT)),
            load_bundle(str(CKPT), device="cpu"))


# ---------------------------------------------------------------- reader


@pytest.mark.parametrize("name", TREES)
def test_reader_tree_equals_flax_bit_for_bit(trees, name):
    got, want = trees[name]
    assert list(got) == list(want)
    for k, v in want.items():
        assert isinstance(got[k], np.ndarray) and got[k].dtype == v.dtype, k
        assert got[k].shape == v.shape and got[k].tobytes() == v.tobytes(), k
        assert got[k].flags.owndata and got[k].flags.writeable, k


def test_reader_counts_the_committed_arrays(trees):
    assert {k: len(v[0]) for k, v in trees.items()} == {"unet": 286, "vae": 156, "clip": 141}
    assert tmsgpack.load_flat(str(CKPT / "vae.msgpack")).keys() == trees["vae"][1].keys()


def _same(got, want):
    """Equal trees, arrays bit for bit (bfloat16: the port's torch tensor)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, np.ndarray) and want.dtype == jnp.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        assert got.shape == want.shape
        assert got.view(torch.int16).numpy().tobytes() == want.tobytes()
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and (got == want or got != got and want != want), (got,
                                                                                          want)


def test_reader_round_trips_flax_serialize():
    """Nested dicts with every int width, floats, str, bool, None, and
    arrays of several dtypes, bfloat16 included, through flax's writer."""
    r = np.random.RandomState(0)
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32, 2 ** 64 - 1,
            -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    tree = {
        "ints": {str(i): v for i, v in enumerate(ints)},
        "floats": {"a": 0.1, "b": -1e300, "c": float("inf"), "d": float("nan")},
        "text": {"short": "abc", "long": "x" * 40, "unicode": "größe", "empty": ""},
        "flags": {"t": True, "f": False, "none": None},
        "arrays": {
            "f32": r.randn(3, 4).astype(np.float32),
            "f64": r.randn(5).astype(np.float64),
            "i32": np.arange(7, dtype=np.int32).reshape(7, 1),
            "u8": np.arange(3, dtype=np.uint8),
            "scalar": np.asarray(2.5, np.float32),
            "empty": np.zeros((0, 3), np.float32),
            "bf16": r.randn(4, 3).astype(jnp.bfloat16),
        },
        "nested": {"a": {"b": {"c": np.ones((2, 2, 2), np.float32)}}},
    }
    raw = serialization.msgpack_serialize(tree)
    _same(tmsgpack.unpackb(raw), serialization.msgpack_restore(raw))
    flat_keys = set(tmsgpack.flatten(tmsgpack.unpackb(raw)))
    assert "nested/a/b/c" in flat_keys and "arrays/bf16" in flat_keys


def test_reader_decodes_every_container_width():
    """The forms flax does not pick for the trees above: float32, bin8/16/32,
    str8/16/32, array16/32, map16/32, fixext16 and ext8/16/32."""
    def ext(arr):
        return msgpack.ExtType(1, msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes())))

    cases = {
        0xCA: 1.5, 0xC4: b"ab", 0xC5: b"b" * 300, 0xC6: b"c" * 70000,
        0xD9: "s" * 40, 0xDA: "t" * 300, 0xDB: "u" * 70000,
        0xDC: list(range(20)), 0xDD: list(range(70000)),
        0xDE: {str(i): i for i in range(20)}, 0xDF: {str(i): i for i in range(70000)},
        0xD8: np.asarray(3.0, np.float32),                  # payload of exactly 16 bytes
        0xC7: np.arange(3, dtype=np.int16), 0xC8: np.arange(100, dtype=np.float32),
        0xC9: np.arange(20000, dtype=np.float32),
    }
    for head, value in cases.items():
        obj = ext(value) if isinstance(value, np.ndarray) else value
        raw = msgpack.packb(obj, use_single_float=head == 0xCA, use_bin_type=True)
        assert raw[0] == head, (hex(head), hex(raw[0]))
        got = tmsgpack.unpackb(raw)
        if isinstance(value, np.ndarray):
            assert got.dtype == value.dtype and np.array_equal(got, value)
        else:
            assert got == value


def test_reader_rejects_other_ext_codes_and_unknown_bytes():
    for code in (2, 3, 127):
        for n in (1, 2, 4, 8, 16, 3):
            raw = msgpack.packb({"k": msgpack.ExtType(code, b"\x00" * n)})
            with pytest.raises(ValueError, match=f"ext code {code} at byte 3"):
                tmsgpack.unpackb(raw)
    with pytest.raises(ValueError, match="ext code -1 at byte 0"):
        tmsgpack.unpackb(b"\xd4\xff\x00")                 # fixext1, code -1
    with pytest.raises(ValueError, match="0xc1 at byte 1"):
        tmsgpack.unpackb(b"\x91\xc1")
    with pytest.raises(ValueError, match="truncated"):
        tmsgpack.unpackb(msgpack.packb("abcdef")[:-2])
    with pytest.raises(ValueError, match="trailing"):
        tmsgpack.unpackb(msgpack.packb(1) + b"\x00")
    # flax's numpy scalars and complex numbers are ext codes 3 and 2
    with pytest.raises(ValueError, match="ext code 3"):
        tmsgpack.unpackb(serialization.msgpack_serialize({"s": np.float32(1.0)}))


def test_trees_load_into_the_testbed_modules(bundles, trees):
    """The bridge reports no missing or unexpected key for any tree (it
    raises otherwise), and one key fewer is reported."""
    _, tb = bundles
    sd = tb.sd
    assert len(bridge(trees["unet"][0], sd.unet)) == len(sd.unet.state_dict())
    assert len(bridge(trees["vae"][0], sd.vae)) == len(sd.vae.state_dict())
    clip = trees["clip"][0]
    assert len(bridge(clip, tb.clip_loss.clip)) == len(tb.clip_loss.clip.state_dict())
    text = {k[5:]: v for k, v in clip.items() if k.startswith("text/")}
    assert len(bridge(text, sd.text_encoder)) == len(sd.text_encoder.state_dict())
    short = dict(trees["unet"][0])
    short.pop(next(iter(short)))
    with pytest.raises(KeyError, match="missing"):
        bridge(short, sd.unet)
    assert tb.sd.cfg.vae.scale_factor == tb.meta["scale_factor"]
    assert tb.sd.cfg.spacetime.guidance_scale == tb.meta["guidance_scale"] == 7.5
    assert tb.clip_loss.normalize is False and tb.sd.cfg.loss_clip == testbed_clip_cfg()


# ---------------------------------------------------------------- trained models


CAPTIONS = ["a red circle above a blue square", "a green triangle left of a yellow circle",
            "a photo of a red circle", "a photo of a blue square", ""]


def test_trained_text_tower_matches_jax(bundles):
    jb, tb = bundles
    with torch.no_grad():
        got = tb.encode_captions(CAPTIONS)
    assert_close(got, jb.encode_captions(CAPTIONS), "text")


@pytest.fixture(scope="module")
def eps_inputs(bundles):
    """2 prompts x 2 objects: embeddings, layout, a noisy latent at t = 501."""
    jb, _ = bundles
    emb = np.asarray(jb.encode_captions(CAPTIONS[:2] + CAPTIONS[2:4] * 2 + [""] * 2))
    r = np.random.RandomState(3)
    return dict(cond=emb[:2], uncond=emb[6:8], local=emb[2:6].reshape(2, 2, *emb.shape[1:]),
                centers=np.array([[[0.5, 0.28], [0.5, 0.72]], [[0.28, 0.5], [0.72, 0.5]]],
                                 np.float32),
                active=np.array([[1, 1], [1, 0]], np.float32),
                coef=(1.0 + r.rand(2, 2, 50)).astype(np.float32),
                x=r.randn(2, 16, 16, 4).astype(np.float32))


@pytest.fixture(scope="module")
def jax_eps(bundles, eps_inputs):
    """JAX's CFG eps at t = 501, loop position 24, without and with control
    (one compile)."""
    jb, _ = bundles
    a = {k: jnp.asarray(v) for k, v in eps_inputs.items()}
    ctl = JControl(a["local"], a["centers"], a["coef"][:, :, 0], a["active"])

    def both(x):
        plain = jb.sd.make_eps_fn(a["cond"], a["uncond"], 7.5)
        blend = jb.sd.make_eps_fn(a["cond"], a["uncond"], 7.5, ctl, a["coef"])
        return [f(x, jnp.int32(501), jnp.int32(24)) for f in (plain, blend)]

    return [np.asarray(e) for e in jax.jit(both).lower(a["x"]).compile(FAST)(a["x"])]


@pytest.mark.parametrize("control", [False, True])
def test_trained_unet_eps_matches_jax(bundles, eps_inputs, jax_eps, control):
    _, tb = bundles
    a = {k: torch.from_numpy(v.copy()) for k, v in eps_inputs.items()}
    ctl = coef = None
    if control:
        ctl = SpatialControl(a["local"], a["centers"], a["coef"][:, :, 0], a["active"])
        coef = a["coef"]
    with torch.no_grad():
        got = tb.sd.make_eps_fn(a["cond"], a["uncond"], 7.5, ctl, coef)(a["x"], 501, 24)
    assert_close(got, jax_eps[int(control)], f"eps control={control}")


def test_control_moves_the_trained_eps(jax_eps):
    """The controlled eps is not the vanilla one: the blend reaches it, so
    the parity above holds the control path too."""
    assert float(np.abs(jax_eps[1] - jax_eps[0]).max()) > 1e-2


def test_trained_vae_decode_matches_jax(bundles):
    jb, tb = bundles
    z = np.random.RandomState(5).randn(2, 16, 16, 4).astype(np.float32)
    want = jax.jit(jb.sd.decode_latents).lower(jnp.asarray(z)).compile(FAST)(jnp.asarray(z))
    with torch.no_grad():
        got = tb.sd.decode_latents(torch.from_numpy(z))
    assert_close(got, want, "decode")
    assert float(np.asarray(want).std()) > 0.05


def test_trained_dclip_losses_match_jax(bundles):
    """Global and local losses on rendered scenes of two eval prompts."""
    jb, tb = bundles
    ps = scenes.make_eval_prompts(2, seed=777)
    objs = []
    for p in ps:
        (ax, ay), (bx, by) = p.centers
        objs.append([scenes.SceneObject(*p.cat_a.split(), ax, ay, 0.3),
                     scenes.SceneObject(*p.cat_b.split(), bx, by, 0.3)])
    images = np.stack([scenes.render_scene(o) for o in objs])
    cap = np.stack([scenes.tokenize(p.caption) for p in ps])
    obj = np.stack([[scenes.tokenize(f"a photo of a {c}") for c in (p.cat_a, p.cat_b)]
                    for p in ps])
    centers = np.asarray([p.centers for p in ps], np.float32)
    active = np.array([[1, 1], [1, 0]], np.float32)
    jl = jb.clip_loss
    args = [jnp.asarray(a) for a in (images, cap, centers, obj, active)]
    want_g, want_l = jax.jit(
        lambda im, c, ce, o, a: (jl.global_loss(im, c), jl.local_loss(im, ce, o, a, crop_half=0.2))
    ).lower(*args).compile(FAST)(*args)
    with torch.no_grad():
        got_g = tb.clip_loss.global_loss(torch.from_numpy(images), cap)
        got_l = tb.clip_loss.local_loss(torch.from_numpy(images), torch.from_numpy(centers),
                                        obj, torch.from_numpy(active), crop_half=0.2)
    assert_close(got_g, want_g, "global")
    assert_close(got_l, want_l, "local")
    assert float(np.asarray(want_g).max()) < 0.5        # a trained judge: captions fit


# ---------------------------------------------------------------- scenes, oracle, metrics


def test_eval_prompts_and_tokens_equal_jax():
    got, want = scenes.make_eval_prompts(100, 777), jscenes.make_eval_prompts(100, 777)
    assert [dc.asdict(p) for p in got] == [dc.asdict(p) for p in want]
    assert [p.centers for p in got] == [p.centers for p in want]
    assert (scenes.MAX_LEN, scenes.VOCAB_SIZE, scenes.EOT_ID) == (
        jscenes.MAX_LEN, jscenes.VOCAB_SIZE, jscenes.EOT_ID)
    for c in [p.caption for p in got] + CAPTIONS + ["a photo of a yellow triangle"]:
        np.testing.assert_array_equal(scenes.tokenize(c), jscenes.tokenize(c))
    assert scenes.heldout_pairs() == jscenes.heldout_pairs()


def test_label_equals_scipy():
    r = np.random.RandomState(0)
    for i in range(60):
        m = r.rand(48, 64) < r.uniform(0.1, 0.7)
        got, want = oracle.label(m), ndimage.label(m)
        assert got[1] == want[1] and np.array_equal(got[0], want[0]), i
    assert oracle.label(np.zeros((4, 4), bool))[1] == 0


def test_detect_and_self_check_equal_jax():
    r = np.random.RandomState(1)
    images = [jscenes.sample_training_scene(r)[0] for _ in range(12)]
    images += [np.clip(im + 0.15 * r.randn(*im.shape), 0, 1).astype(np.float32)
               for im in images[:6]]
    for im in images:
        got, want = oracle.detect(im), joracle.detect(im)
        assert [dc.astuple(d) for d in got] == [dc.astuple(d) for d in want]
        assert ([dc.astuple(d) for d in oracle.detect_color_only(im)]
                == [dc.astuple(d) for d in joracle.detect_color_only(im)])
    assert oracle.oracle_self_check() == joracle.oracle_self_check() == {
        "n_scenes": 50, "recall": 1.0, "precision": 1.0}


def test_recall_and_relation_equal_jax_on_seeded_detections():
    r = np.random.RandomState(2)
    cats = jscenes.CATEGORIES
    dets, gts, rels = [], [], []
    for _ in range(40):
        n = r.randint(0, 4)
        boxes = r.rand(n, 2) * 48
        dets.append([(float(x), float(y), float(x) + 10, float(y) + 12,
                      cats[r.randint(len(cats))], float(r.rand())) for x, y in boxes])
        a, b = r.choice(len(cats), 2, replace=False)
        gts.append([cats[a], cats[b]])
        rels.append([(cats[a], cats[b], jscenes.RELATIONS[r.randint(4)])])
    for mod, jmod in ((metrics, jmetrics),):
        mk = [[mod.Detection(d[:4], d[4], d[5]) for d in ds] for ds in dets]
        jmk = [[jmod.Detection(d[:4], d[4], d[5]) for d in ds] for ds in dets]
        for conf in (0.4, 0.5, 0.0):
            assert mod.object_recall(mk, gts, conf) == jmod.object_recall(jmk, gts, conf)
            assert mod.relation_accuracy(mk, rels, conf) == jmod.relation_accuracy(jmk, rels,
                                                                                   conf)
    for rel in jscenes.RELATIONS:
        for b1, b2 in (((0, 0, 4, 4), (8, 8, 12, 12)), ((8, 0, 12, 4), (0, 8, 4, 12))):
            assert metrics.relation_pass(rel, b1, b2) == jmetrics.relation_pass(rel, b1, b2)


# ---------------------------------------------------------------- noise


def test_prng_equals_jax_random_on_the_protocol_keys():
    """4 batches x 3 seeds of (25, 16, 16, 4): keys and bits equal, uniform
    equal bit for bit, normal within 4 ulp (XLA's fused erfinv polynomial
    and log1p round differently from numpy's in ~1 % of values)."""
    shape = (25, 16, 16, 4)
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))

    @jax.jit
    def draws(seed, bi):              # one compile for the 12 keys
        jk = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(2025), seed), bi)
        return (jk, jax.random.bits(jk, shape, jnp.uint32),
                jax.random.uniform(jk, shape, jnp.float32, 0.0, 1.0),
                jax.random.uniform(jk, shape, jnp.float32, lo, 1.0), jax.random.normal(jk, shape))

    n = differ = 0
    for seed in range(3):
        for bi in range(4):
            jk, jbits, ju0, ju1, jn = (np.asarray(a) for a in draws(seed, bi))
            k = prng.fold_in(prng.fold_in(prng.PRNGKey(2025), seed), bi)
            np.testing.assert_array_equal(k, jk)
            np.testing.assert_array_equal(prng.bits(k, shape), jbits)
            assert prng.uniform(k, shape).tobytes() == ju0.tobytes()
            assert prng.uniform(k, shape, lo, 1.0).tobytes() == ju1.tobytes()
            got, want = prng.normal(k, shape), jn
            assert got.dtype == np.float32 and np.all(np.sign(got) == np.sign(want))
            ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
            assert ulp.max() <= 4
            n, differ = n + got.size, differ + int((ulp > 0).sum())
    assert n == 307200 and differ <= 0.02 * n, differ
    np.testing.assert_array_equal(prng.PRNGKey(7), np.asarray(jax.random.PRNGKey(7)))
    with pytest.raises(ValueError):
        prng.PRNGKey(2 ** 31)


# ---------------------------------------------------------------- the loop


@pytest.fixture(scope="module")
def smoke_loop():
    """JAX's method-eval loop (`test_method_eval_loop_smoke`) and the port's
    `run_cell` on the same weights, prompts and protocol noise (batch 0,
    seed 0): smoke config, 4 PLMS steps, 1 epoch."""
    from diffusion_spacetime_attn_tpu.models.clip import CLIP
    from diffusion_spacetime_attn_tpu.pipeline.losses import DCLIPLoss as JDCLIPLoss
    from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
    from diffusion_spacetime_attn_tpu.pipeline.spacetime import (
        SpaceTimeInputs,
        make_final_forward,
        model_params,
        optimize_prompt,
    )
    from diffusion_spacetime_attn_tpu.testbed.configs import smoke_pipeline_cfg
    from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
    from diffusion_spacetime_attn_tpu_torch.pipeline.losses import DCLIPLoss
    from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion

    cfg = smoke_pipeline_cfg(num_steps=4)
    st = dc.replace(cfg.spacetime, epochs=1)
    # abstract trees filled by randomize_params (flax's init of the smoke
    # bundle takes about a minute on this CPU)
    sd = JSD.create(cfg, jax.random.PRNGKey(0), abstract=True)
    sd = dc.replace(
        sd,
        unet_params=randomize_params(sd.unet_params, jax.random.PRNGKey(1), scale=0.1),
        vae_params=randomize_params(sd.vae_params, jax.random.PRNGKey(2), scale=0.1),
        text_params=randomize_params(sd.text_params, jax.random.PRNGKey(3), scale=0.1))
    clip = CLIP(cfg.loss_clip)
    clip_params = randomize_params(
        jax.eval_shape(clip.init, jax.random.PRNGKey(4), jnp.zeros((1, 14, 14, 3)),
                       jnp.zeros((1, jscenes.MAX_LEN), jnp.int32))["params"],
        jax.random.PRNGKey(5), scale=0.1)
    clip_loss = JDCLIPLoss(clip, clip_params, normalize=False)
    prompts = jscenes.make_eval_prompts(2, seed=777)
    L = st.latent_size
    obj_caps = [[f"a photo of a {p.cat_a}", f"a photo of a {p.cat_b}"] for p in prompts]
    # one text-tower call (rows are independent) instead of the script's four
    emb = sd.encode_text(jnp.asarray(np.stack([jscenes.tokenize(c) for c in (
        [p.caption for p in prompts] + obj_caps[0] + obj_caps[1] + [""])])))
    cond = emb[:2]
    uncond = jnp.broadcast_to(emb[6:], cond.shape)
    # the protocol noise of batch 0, seed 0 (held against jax.random in
    # test_prng_equals_jax_random_on_the_protocol_keys)
    x_T = jnp.asarray(tme.initial_noise(0, 0, 2, L, "cpu").numpy())
    inputs = SpaceTimeInputs(
        cond=cond, uncond=uncond,
        local_contexts=emb[2:6].reshape(2, 2, *emb.shape[1:]),
        centers=jnp.asarray([p.centers for p in prompts], jnp.float32),
        active=jnp.ones((2, 2), jnp.float32),
        caption_tokens=jnp.asarray(np.stack([jscenes.tokenize(p.caption) for p in prompts])),
        object_tokens=jnp.asarray(np.stack([np.stack([jscenes.tokenize(c) for c in cs])
                                            for cs in obj_caps])),
        x_T=x_T)
    eps = sd.make_eps_fn(cond, uncond, st.guidance_scale)
    vanilla = jax.jit(lambda x: sd.decode_latents(sd.sample_from(eps, x, sampler="plms")))
    v_imgs = vanilla.lower(x_T).compile(FAST)(x_T)
    params = model_params(sd, clip_loss)
    ff = make_final_forward(sd, clip_loss, st)
    coef0 = jnp.ones((2, 2, st.num_steps))
    ff = ff.lower(params, coef0, inputs).compile(FAST)
    m_imgs, coef, losses = optimize_prompt(sd, clip_loss, inputs, st, final_forward=ff)
    rows = []
    for imgs in (v_imgs, m_imgs):
        r = []
        for im, p in zip(np.asarray(imgs), prompts):
            d = joracle.detect(im)
            r.append((jmetrics.object_recall([d], [[p.cat_a, p.cat_b]])[2],
                      jmetrics.relation_accuracy([d], [[(p.cat_a, p.cat_b, p.rel)]])[2]))
        rows.append(r)
    jax_out = dict(vanilla=np.asarray(v_imgs), method=np.asarray(m_imgs), coef=np.asarray(coef),
                   losses=np.asarray(losses), rows=rows)

    pcfg = port_cfg(cfg)
    tsd = StableDiffusion.from_flat(pcfg, flat(sd.unet_params), flat(sd.vae_params),
                                    flat(sd.text_params), device="cpu")
    tloss = DCLIPLoss.from_flat(pcfg.loss_clip, flat(clip_params), device="cpu")
    bundle = TestbedBundle(sd=tsd, clip_loss=tloss, meta={})
    cell = tme.run_cell(bundle, port_cfg(st), scenes.make_eval_prompts(2, seed=777), 2, 0, 0)
    return jax_out, cell


def test_method_loop_matches_jax_smoke(smoke_loop):
    want, cell = smoke_loop
    for k in ("vanilla", "method", "coef", "losses"):
        got = cell[k].detach().numpy()
        assert got.shape == want[k].shape, k
        np.testing.assert_allclose(got, want[k], atol=1e-4 * np.abs(want[k]).max(), rtol=1e-4,
                                   err_msg=k)
    assert float(np.abs(want["vanilla"] - want["method"]).max()) > 1e-4   # the control acts
    for arm, rows in zip(("vanilla", "method"), want["rows"]):
        assert [(r[arm]["recall"], r[arm]["relation"]) for r in cell["rows"]] == rows
        assert all(-1.0 <= r[arm]["clip"] <= 1.0 for r in cell["rows"])   # a cosine


def test_entry_point_main_and_resume(tmp_path, monkeypatch):
    """`main()` on the CPU with the trained bundle writes the JAX script's
    artifact keys; a run cut after its first cell resumes from the
    .partial.jsonl and gives the same `overall` as an uncut one."""
    argv = ["--ckpt-dir", str(CKPT), "--cpu", "--prompts", "2", "--seeds", "2", "--batch", "2",
            "--num-steps", "3", "--epochs", "1"]
    full = tme.main(argv + ["--out", str(tmp_path / "full.json")])
    ref = json.loads((ROOT / "METHOD_EVAL_r05.json").read_text())
    assert list(full) == list(ref) and list(full["protocol"]) == list(ref["protocol"])
    assert list(full["weights"]) == list(ref["weights"])
    assert list(full["overall"]) == list(ref["overall"])
    assert full["overall"]["n"] == 4 and full["device"] == "cpu"
    assert full["protocol"]["detector_self_check"] == ref["protocol"]["detector_self_check"]
    assert json.loads((tmp_path / "full.json").read_text())["overall"] == full["overall"]

    out = tmp_path / "cut.json"
    real, calls = tme.run_cell, []

    def cut_after_one(*a, **kw):
        if calls:
            raise KeyboardInterrupt
        calls.append(a[4:6])
        return real(*a, **kw)

    monkeypatch.setattr(tme, "run_cell", cut_after_one)
    with pytest.raises(KeyboardInterrupt):
        tme.main(argv + ["--out", str(out)])
    partial = out.with_name("cut.json.partial.jsonl")
    assert [json.loads(ln)["seed"] for ln in partial.read_text().splitlines()] == [0]

    def count(*a, **kw):
        calls.append(a[4:6])
        return real(*a, **kw)

    monkeypatch.setattr(tme, "run_cell", count)
    resumed = tme.main(argv + ["--out", str(out)])
    assert calls == [(0, 0), (1, 0)]                  # (seed, batch): only the missing cell ran
    assert resumed["overall"] == full["overall"] and not partial.exists()


def test_entry_point_needs_a_card_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        tme.main(["--ckpt-dir", str(CKPT), "--prompts", "1"])
    assert os.path.basename(tme.DEFAULT_OUT) == "method_eval_h100.json"
