"""PyTorch port, reading what a JAX user has on disk, held against orbax,
tensorstore and zstandard on the CPU:

* `utils/zstd.py` (the C++ frame decoder) against `zstandard`'s input:
  random, repetitive and text-like data at levels 1, 3 and 19 and a
  negative level, with and without checksum and content size, frames of
  several 128 KiB blocks, concatenated and skippable frames; corrupt and
  truncated frames raise `ValueError`;
* `utils/ocdbt.py` `Database.keys()` / `.read()` against tensorstore's
  `ocdbt` kvstore (inline and indirect values, interior b-tree nodes,
  version-tree nodes);
* `utils/orbax.restore` against `ocp.StandardCheckpointer().restore`, bit
  for bit: f32 / bf16 / f16 / i32 / i64 / u32 / bool / scalar leaves, empty
  leaves, an array over 1 MB (a multi-block zstd frame), zarr3 and
  non-OCDBT saves;
* the layout loader on a JAX run dir (`best_params`) and a trainer step at
  `test_torch_layout.py`'s SMALL config: the greedy centers within 1e-4;
* `sample_diffusion --ckpt-dir` on a JAX `LDMTrainer.save` at the tiny
  config against JAX's script: within 1e-4 + 1e-4·|jax|;
* resume: JAX takes n steps and saves, then the port's trainer and JAX's
  each restore and take the next: the layout trainer (both groups' Adam
  state, apply_if_finite's counters) and the LDM trainer (MultiSteps over
  2 with its accumulators, the clip, lambda_linear, the learned logvar,
  EMA); loss 1e-5 relative, weights and EMA 1e-5 + 1e-5·|jax| (the layout
  attention's key bias left out: its gradient is rounding noise, ROADMAP
  C "Adam on rounding noise");
* the committed `tests/fixtures/port_formats/` state, rebuilt from its seeds.

Torch takes one thread; each JAX program compiles once per module.
"""
import contextlib
import dataclasses
import hashlib
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch
import zstandard
from flax import traverse_util
from hypothesis import given, settings
from hypothesis import strategies as st

from diffusion_spacetime_attn_tpu.config import LayoutConfig as JLayoutConfig
from diffusion_spacetime_attn_tpu.config import LayoutTrainConfig as JLayoutTrainConfig
from diffusion_spacetime_attn_tpu.config import LDMTrainConfig as JLDMTrainConfig
from diffusion_spacetime_attn_tpu.config import ScheduleConfig as JScheduleConfig
from diffusion_spacetime_attn_tpu.models.layout.model import create_layout_predictor as jcreate
from diffusion_spacetime_attn_tpu.ops.schedule import make_schedule as jmake_schedule
from diffusion_spacetime_attn_tpu.training import datasets as jdata
from diffusion_spacetime_attn_tpu.training import layout_trainer as jlayout
from diffusion_spacetime_attn_tpu.training import ldm_trainer as jldm
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_roberta_tokenizer as jtokenizer
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.config import LayoutConfig, LayoutTrainConfig
from diffusion_spacetime_attn_tpu_torch.models.layout.model import LayoutPredictor
from diffusion_spacetime_attn_tpu_torch.ops.schedule import make_schedule
from diffusion_spacetime_attn_tpu_torch.scripts import sample_diffusion
from diffusion_spacetime_attn_tpu_torch.training import layout_trainer as tlayout
from diffusion_spacetime_attn_tpu_torch.training import ldm_trainer as tldm
from diffusion_spacetime_attn_tpu_torch.utils import loader, ocdbt, orbax, prng, zstd
from diffusion_spacetime_attn_tpu_torch.utils.weights import flax_flat, layout_state_dict, load_flat
from helpers import port_formats
from test_torch_ldm_training import SmallEps, small_eps_jax
from test_torch_pipeline import flat, port_cfg

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(hidden=32, layers=2, heads=2, ffn_dim=64, max_positions=140, max_len=24)
LAYOUT_TRAIN = dict(batch_size=8, encoder_max_lr=1e-3, head_max_lr=3e-3, warmup_steps=2,
                    hold_steps=2, decay_steps=100)
TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def save(path, tree, **handler):
    """ocp.StandardCheckpointer's save, or PyTreeCheckpointHandler's with
    `use_zarr3` / `use_ocdbt`."""
    if handler:
        ocp.Checkpointer(ocp.PyTreeCheckpointHandler(**handler)).save(str(path), tree)
    else:
        with ocp.StandardCheckpointer() as c:
            c.save(str(path), tree)


def assert_same_tree(got, want, at=()):
    """The port's tree equals orbax's bit for bit: same structure, dtypes,
    shapes and bits; bf16 as torch.bfloat16 of the same bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (at, got, want)
        for k in want:
            assert_same_tree(got[k], want[k], at + (k,))
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, list) or got == want == (), at
        assert len(got) == len(want), at
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, at + (i,))
    elif want is None:
        assert got is None, at
    elif isinstance(want, (int, float)):
        assert type(got) is type(want) and got == want, (at, got, want)
    else:
        w = np.asarray(want)
        if w.dtype == jnp.bfloat16:
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, at
            assert tuple(got.shape) == w.shape, at
            np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                          w.view(np.uint16))
        else:
            assert isinstance(got, np.ndarray) and got.dtype == w.dtype, (at, got.dtype, w.dtype)
            assert got.shape == w.shape, at
            np.testing.assert_array_equal(got, w)


# ---------------------------------------------------------------------- zstd


def _data(kind, n, seed):
    r = np.random.RandomState(seed)
    if kind == "random":
        return r.randint(0, 256, n).astype(np.uint8).tobytes()
    if kind == "repetitive":
        return (bytes(r.randint(0, 256, 37).astype(np.uint8)) * (n // 37 + 1))[:n]
    if kind == "text":
        return bytes(r.choice(list(b"eeeeetaoinshrdlu  \n"), n).astype(np.uint8))
    return np.round(r.randn(n // 4), 2).astype(np.float32).tobytes()      # rounded floats


@pytest.mark.parametrize("level", [1, 3, 19, -5])
@pytest.mark.parametrize("kind", ["random", "repetitive", "text", "floats"])
def test_zstd_decodes_zstandard_frames(kind, level):
    """Sizes up to three 128 KiB blocks and more, with and without the
    checksum and the content size."""
    for n in (0, 1, 17, 1000, 131072, 300_001):
        data = _data(kind, n, n + abs(level))
        for checksum in (True, False):
            for size in (True, False):
                frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                                 write_content_size=size).compress(data)
                assert zstd.decompress(frame) == data, (n, checksum, size)
                assert zstd.content_size(frame) == (len(data) if size else None)


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=5000), st.integers(1, 9), st.integers(0, 3))
def test_zstd_matches_zstandard_on_any_input(data, level, repeat):
    data = data * (repeat + 1)
    assert zstd.decompress(zstandard.ZstdCompressor(level=level).compress(data)) == data


def test_zstd_concatenated_skippable_and_streamed_frames():
    a, b = _data("text", 50_000, 1), _data("floats", 70_000, 2)
    c = zstandard.ZstdCompressor(level=3)
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    both = c.compress(a) + skippable + c.compress(b)
    assert zstd.decompress(both) == a + b
    out = np.empty(len(a) + len(b), np.uint8)
    assert zstd.decompress(both, out=out).tobytes() == a + b
    streamed = io.BytesIO()          # no content size: the output grows
    with zstandard.ZstdCompressor(level=19).stream_writer(streamed, closefd=False) as w:
        w.write(b)
    assert zstd.content_size(streamed.getvalue()) is None
    assert zstd.decompress(streamed.getvalue()) == b
    assert zstd.crc32c(b"123456789") == 0xE3069283


def test_zstd_corrupt_frames_raise_value_error():
    data = _data("text", 200_000, 3)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    r = np.random.RandomState(0)
    cases = [frame[:n] for n in (0, 3, 5, 10, len(frame) // 2, len(frame) - 1)]
    for _ in range(40):
        b = bytearray(frame)
        i = r.randint(4, len(b))
        b[i] ^= 1 << r.randint(8)
        cases.append(bytes(b))
    cases.append(b"\x00" * 16)
    raised = 0
    for c in cases:
        try:
            out = zstd.decompress(c)
        except ValueError:
            raised += 1
            continue
        assert out != data or c == frame      # a flip the checksum cannot see decodes
    assert raised >= len(cases) - 2
    dict_frame = zstandard.ZstdCompressor(
        dict_data=zstandard.train_dictionary(4096, [_data("text", 3000, i) for i in range(40)])
    ).compress(data[:1000])
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(dict_frame)


# --------------------------------------------------------------------- OCDBT


def _kvstore(path, **config):
    spec = {"driver": "ocdbt", "base": f"file://{path}/"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _same_database(path):
    kv = _kvstore(path)
    want = sorted(kv.list().result())
    db = ocdbt.Database(path)
    assert db.keys() == want
    for k in want:
        assert db.read(k) == kv.read(k).result().value, k
    return db


def test_ocdbt_matches_tensorstore(tmp_path):
    """Inline and indirect values, interior b-tree nodes (a small node
    limit), several versions (version-tree nodes past 16)."""
    path = tmp_path / "db"
    kv = _kvstore(path, max_decoded_node_bytes=600, max_inline_value_bytes=40)
    with ts.Transaction() as txn:
        for i in range(300):
            kv.with_transaction(txn).write(b"key/%05d/x" % i, bytes([i % 251]) * (i % 90)).result()
    for i in range(40):
        kv.write(b"late/%02d" % i, b"v" * i).result()
    db = _same_database(path)
    assert db.latest.root_height > 0
    versions = db.versions()
    assert len(versions) > 20 and db.latest.num_keys == 340
    assert [v.generation for v in versions] == list(range(1, db.latest.generation + 1))
    with pytest.raises(KeyError):
        db.read("missing")
    # an unfinished save: only the per-process databases
    (tmp_path / "part" / "ocdbt.process_0").mkdir(parents=True)
    with pytest.raises(ValueError, match="not finished"):
        ocdbt.Database(tmp_path / "part")
    raw = bytearray((path / "manifest.ocdbt").read_bytes())
    raw[20] ^= 0xFF
    (path / "manifest.ocdbt").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="checksum"):
        ocdbt.Database(path)


# ---------------------------------------------------------------------- orbax


def _tree():
    r = np.random.RandomState(0)
    params = {"w": jnp.asarray(r.randn(3, 4).astype(np.float32)),
              "b": jnp.asarray(r.randn(5).astype(np.float32)).astype(jnp.bfloat16)}
    return {"params": params,
            "opt": jax.tree_util.tree_map(jnp.zeros_like, (params, None)),
            "none": None, "emptyd": {}, "emptyl": [], "emptyt": (), "step": 3, "lr": 2.5,
            "np": np.arange(4, dtype=np.int64), "i32": jnp.arange(6, dtype=jnp.int32),
            "u32": jnp.arange(3, dtype=jnp.uint32), "h": jnp.ones(3, jnp.float16),
            "bool": jnp.array([True, False]), "scalar": jnp.float32(1.5),
            "big": jnp.asarray(r.randn(400_000).astype(np.float32)),     # 1.6 MB
            "tup": (jnp.ones(2), [jnp.zeros(1, jnp.int32)])}


@pytest.mark.parametrize("layout", ["ocdbt_zarr2", "ocdbt_zarr3", "files_zarr2", "files_zarr3"])
def test_orbax_restore_matches_orbax(tmp_path, layout):
    handler = {"ocdbt_zarr2": {}, "ocdbt_zarr3": dict(use_zarr3=True),
               "files_zarr2": dict(use_ocdbt=False),
               "files_zarr3": dict(use_ocdbt=False, use_zarr3=True)}[layout]
    save(tmp_path / "ck", _tree(), **handler)
    want = ocp.StandardCheckpointer().restore(str(tmp_path / "ck"))
    assert_same_tree(orbax.restore(tmp_path / "ck"), want)
    meta = json.loads((tmp_path / "ck" / "_METADATA").read_text())
    assert meta["use_ocdbt"] == ("ocdbt" in layout) and meta["use_zarr3"] == ("zarr3" in layout)
    if layout == "ocdbt_zarr2":        # the 1.6 MB array is an indirect value, several blocks
        db = ocdbt.Database(tmp_path / "ck")
        assert len(db.read("big/0")) > 1_000_000 and db.read("big/0")[:4] == b"\x28\xb5\x2f\xfd"
        os.remove(tmp_path / "ck" / "_METADATA")
        with pytest.raises(FileNotFoundError, match="_METADATA"):
            orbax.restore(tmp_path / "ck")


# ----------------------------------------------------------------- the layout


def numpy_tree(shapes, seed, scale=0.2):
    """Seeded N(0, scale²) leaves of a tree of shapes, made with numpy (no
    JAX program to compile)."""
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(lambda s: (r.randn(*s.shape) * scale).astype(s.dtype), shapes)


@pytest.fixture(scope="module")
def small_layout():
    """JAX's predictor at SMALL and its initial params (numpy), shared by
    the loader and the resume tests."""
    jmodel, params = jcreate(JLayoutConfig(**SMALL), jax.random.PRNGKey(6))
    return jmodel, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def layout_run(tmp_path_factory, small_layout):
    """A JAX run dir at SMALL: best.json, config.json and best_params as
    `scripts/train_layout.py` writes them, and a trainer step."""
    run = tmp_path_factory.mktemp("layout_run")
    jcfg = JLayoutConfig(**SMALL)
    jmodel, base = small_layout
    np_params = jax.tree_util.tree_map(lambda a, n: a + n, base, numpy_tree(base, 7))
    params = np_params
    save(run / "best_params", np_params)
    (run / "best.json").write_text(json.dumps({"step": 4, "params_path": "best_params"}))
    (run / "config.json").write_text(json.dumps({"layout": dataclasses.asdict(jcfg)}))
    trainer = jlayout.LayoutTrainer.create(jcfg, JLayoutTrainConfig(), np_params)
    trainer.save_checkpoint(str(run), 4, np_params, trainer.init_state(np_params))
    return run, jmodel, params


def test_layout_loader_reads_jax_run_dirs(layout_run, monkeypatch):
    run, jmodel, params = layout_run
    r = np.random.RandomState(0)
    tokens = r.randint(3, 50265, (2, 24)).astype(np.int32)
    tokens[:, 0], tokens[1, 10:] = 0, 1
    opos = (r.rand(2, 24) > 0.6).astype(np.float32)
    jxy, _ = jmodel.apply({"params": params}, jnp.asarray(tokens), jnp.asarray(opos),
                          method=type(jmodel).predict_xy)
    want = layout_state_dict(jax.tree_util.tree_map(np.asarray, params),
                             LayoutPredictor(LayoutConfig(**SMALL)))
    monkeypatch.setenv("DSTA_LAYOUT_CKPT", str(run))
    assert loader.find_default_layout_checkpoint() == str(run)
    for path in (str(run), str(run / "best_params"), str(run / "step_4")):
        # the run dir rebuilds SMALL from config.json; the bare dirs take cfg
        model = loader.load_layout_predictor(LayoutConfig(**SMALL) if path != str(run)
                                             else LayoutConfig(), path, device="cpu")
        assert model.cfg.hidden == 32 and model.cfg.layers == 2
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (path, k)
        with torch.inference_mode():
            xy, _ = model.predict_xy(torch.from_numpy(tokens.astype(np.int64)),
                                     torch.from_numpy(opos), greedy_component=True)
        np.testing.assert_allclose(xy.numpy(), np.asarray(jxy), atol=1e-4, rtol=1e-4)


# -------------------------------------------------------------- sample_diffusion


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sample_diffusion_ckpt_dir_matches_jax(tmp_path, monkeypatch):
    """A JAX LDMTrainer.save of sample_diffusion --tiny's UNet: the port's
    script takes the newest step's EMA weights, as JAX's does, and gives
    JAX's images; an older step without EMA gives its params ("raw")."""
    args = sample_diffusion.parse_args(["--tiny", "--cpu", "--dtype", "float32"])
    ucfg, vcfg, hw, scfg = sample_diffusion.configs(args)
    unet, vae = sample_diffusion.build_models(ucfg, vcfg, "cpu")
    # the flax tree's shapes from the port's UNet (`flax_flat`, the bridge's
    # inverse): JAX's script applies them to its own UNet
    shapes = traverse_util.unflatten_dict(flax_flat(unet, norm_scope=True), sep="/")
    params, ema = numpy_tree(shapes, 8), numpy_tree(shapes, 9)
    ck = tmp_path / "ck"
    jsched = JScheduleConfig(**dataclasses.asdict(scfg))
    trainer = jldm.LDMTrainer(JLDMTrainConfig(), jsched, jmake_schedule(jsched, 4), None,
                              ckpt_dir=str(ck))
    state = jldm.init_state(trainer.cfg, jsched, params, 1e-4)
    trainer.save(state._replace(ema_params=ema), 3)
    save(ck / "step_1", {"params": params, "ema_params": None})     # a state without EMA
    # JAX's script, its images caught where it writes them
    from diffusion_spacetime_attn_tpu.pipeline import runners as jrunners

    from diffusion_spacetime_attn_tpu.utils import testing as jtesting

    caught, vae_params = [], []
    monkeypatch.setattr(jrunners, "save_image", lambda img, path: caught.append(np.asarray(img)))
    real = jtesting.randomize_params_on_device       # the script's seeded VAE weights
    monkeypatch.setattr(jtesting, "randomize_params_on_device",
                        lambda *a, **k: vae_params.append(real(*a, **k)) or vae_params[-1])
    argv = ["--tiny", "--dtype", "float32", "-n", "1", "--batch-size", "1", "-c", "2",
            "--ckpt-dir", str(ck), "-l", str(tmp_path / "jax")]
    monkeypatch.setattr(sys, "argv", ["sample_diffusion.py", *argv])
    _jax_script("sample_diffusion").main()
    # the port, with the JAX script's VAE weights
    (vp,) = vae_params
    load_flat(vae, flat(vp))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = sample_diffusion.main([*argv[:-2], "--cpu", "-l", str(tmp_path / "port")],
                                    models=(unet, vae))["images"]
    assert f"restored {ck} step 3 (ema)" in out.getvalue()
    want = caught[0][None]
    assert got.shape == want.shape and np.isfinite(got).all()
    excess = np.abs(got - want) - (1e-4 + 1e-4 * np.abs(want))
    assert excess.max() <= 0, float(np.abs(got - want).max())
    assert float(np.abs(want).max()) > 0.05
    assert sample_diffusion.restore_unet(unet, str(ck), 1) == (1, "raw")
    raw = load_flat(sample_diffusion.build_models(ucfg, vcfg, "cpu")[0], flat(params))
    for (k, a), b in zip(unet.state_dict().items(), raw.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(FileNotFoundError, match="step_2"):
        sample_diffusion.restore_unet(unet, str(ck), 2)


# --------------------------------------------------------------------- resume


@pytest.fixture(scope="module")
def layout_batches():
    examples = jdata.synthetic_examples(32, np.random.RandomState(0))
    return list(jdata.batches(examples, jtokenizer(), 8, np.random.RandomState(1), max_len=16,
                              max_rels=2, max_objs=2))


def test_layout_resume_from_a_jax_step(tmp_path, layout_batches, small_layout):
    jcfg = JLayoutConfig(**SMALL)
    params = small_layout[1]
    jt = jlayout.LayoutTrainer.create(jcfg, JLayoutTrainConfig(**LAYOUT_TRAIN), params)
    opt_state = jt.init_state(params)
    for b in layout_batches[:2]:
        params, opt_state, _, _ = jt.train_step(params, opt_state, b)
    jt.save_checkpoint(str(tmp_path), 2, params, opt_state)
    # JAX: restore and take step 3
    like = jax.tree_util.tree_map(np.asarray, params)
    jp, jo = jt.restore_checkpoint(str(tmp_path), 2, like, jt.init_state(like))
    jp, jo, jloss, _ = jt.train_step(jp, jo, layout_batches[2])
    # the port: a fresh model and optimizer, restored from JAX's step 2
    trainer = tlayout.LayoutTrainer.create(LayoutConfig(**SMALL),
                                           LayoutTrainConfig(**LAYOUT_TRAIN))
    model = LayoutPredictor(LayoutConfig(**SMALL))
    opt = trainer.init_state(model)
    model, opt = trainer.restore_checkpoint(str(tmp_path), 2, model, opt)
    assert opt.count == 2 and opt.notfinite_count == 0 and opt.total_notfinite == 0
    assert opt.last_finite is True
    model, opt, loss, _ = trainer.train_step(model, opt, layout_batches[2])
    assert abs(float(loss) - float(jloss)) <= TOL * abs(float(jloss))
    assert opt.count == 3
    want = layout_state_dict(jax.tree_util.tree_map(np.asarray, jp), model)
    for name, p in model.state_dict().items():
        if name.endswith("attn.k.bias"):      # rounding-noise gradient (module docstring)
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=TOL, rtol=TOL,
                                   err_msg=name)


LDM_RESUME = dict(use_ema=True, scale_lr=False, base_lr=2e-2, grad_clip_norm=0.5, accum_steps=2,
                  lr_schedule="lambda_linear", lr_warmup_steps=3, lr_f_start=0.1,
                  learn_logvar=True, ema_decay=0.9)


@pytest.fixture(scope="module")
def jax_ldm_trainer():
    """JAX's LDMTrainer over the well-conditioned eps model (one compile)."""
    sched = JScheduleConfig()
    return jldm.LDMTrainer(JLDMTrainConfig(**LDM_RESUME), sched, jmake_schedule(sched, 50),
                           small_eps_jax)


@pytest.mark.parametrize("saved", [2, 3])
def test_ldm_resume_from_a_jax_step(tmp_path, saved, jax_ldm_trainer):
    """MultiSteps over 2: saved after step 2 the accumulators are empty, after
    step 3 they hold one micro-gradient and mini_step is 1."""
    model = SmallEps()
    jt = jax_ldm_trainer
    jt.ckpt_dir = str(tmp_path)
    jcfg = jt.cfg
    r = np.random.RandomState(0)
    x0, ctx = r.randn(2, 8, 8, 4).astype(np.float32), r.randn(2, 7, 16).astype(np.float32)
    state = jt.init(model.jax_params())
    keys = [jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(saved + 1)]
    for i in range(saved):
        state, _ = jt.train_step(state, jnp.asarray(x0), jnp.asarray(ctx), keys[i])
    jt.save(state, saved)
    js = jt.restore(saved, jt.init(model.jax_params()))
    js, jm = jt.train_step(js, jnp.asarray(x0), jnp.asarray(ctx), keys[saved])

    tc = port_cfg(jcfg)
    tt = tldm.LDMTrainer(tc, tcfg.ScheduleConfig(), make_schedule(tcfg.ScheduleConfig(), 50),
                         SmallEps(), ckpt_dir=str(tmp_path))
    ts = tt.restore(saved, tt.init())
    assert ts.step == saved and ts.opt_state.count == 1
    assert ts.opt_state.mini_step == saved % 2
    ts, tm = tt.train_step(ts, torch.from_numpy(x0), torch.from_numpy(ctx),
                           prng.fold_in(prng.PRNGKey(7), saved))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * abs(float(jm["loss"]))
    assert ts.step == saved + 1 and ts.opt_state.count == (saved + 1) // 2

    def close(got, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    for k, v in tt.eps_model.named_parameters():
        close(v, js.params[k])
        close(ts.ema_params[k], js.ema_params[k])
    close(ts.logvar, js.logvar)


# ---------------------------------------------------------- committed fixtures


def test_committed_fixtures_are_rebuilt_from_their_seeds(tmp_path):
    """`tests/helpers/port_formats.py` writes the fixtures from seeds; what
    `chip_smoke.py` is held to (the restored arrays' and Pillow's pixels'
    SHA-256, `digests.json`) is what a rebuild gives, and the committed
    orbax state restores to it in both readers."""
    committed = port_formats.FIXTURES
    want = json.loads((committed / "digests.json").read_text())
    built = port_formats.build(tmp_path / "rebuilt")
    assert built == want
    tree = ocp.StandardCheckpointer().restore(str(committed / port_formats.STATE))
    assert port_formats.tree_digests(tree) == want["state"]
    assert port_formats.tree_digests(orbax.restore(committed / port_formats.STATE)) == \
        want["state"]
    for name, d in want["images"].items():
        assert hashlib.sha256((committed / name).read_bytes()).hexdigest() == d["file"], name
    total = sum(f.stat().st_size for f in committed.rglob("*") if f.is_file())
    assert total <= 1_500_000
