"""PyTorch port, the checkpoint readers and loaders held against the JAX
package on the CPU: `utils/convert.load_torch_checkpoint` (torch `.ckpt` /
`.pt` / `.pth`, TorchScript archives, pickles naming classes of packages
that are not installed) and `utils/safetensors.py`; `load_stable_diffusion`
on a CompVis file (a 2-step image within tolerance of JAX's on the same
file; a missing key raises naming it); the real-weights drill
(`scripts/ingest_weights.py`) at tiny config with every checkpoint flag,
against JAX's `run_drill` on the same files (its report keys; CLIP scores
within 1e-4).
"""
import dataclasses
import json
import os
import struct
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu import config as jcfg
from diffusion_spacetime_attn_tpu.utils import convert as jconvert
from diffusion_spacetime_attn_tpu.utils import loader as jloader
from diffusion_spacetime_attn_tpu_torch.scripts import ingest_weights
from diffusion_spacetime_attn_tpu_torch.scripts.run_dataset import tiny_configs
from diffusion_spacetime_attn_tpu_torch.utils import convert as tconvert
from diffusion_spacetime_attn_tpu_torch.utils import loader as tloader
from diffusion_spacetime_attn_tpu_torch.utils import testing
from diffusion_spacetime_attn_tpu_torch.utils.safetensors import load_file
from test_torch_convert import TINY, compvis_file, pipeline_cfgs, save_ckpt
from test_torch_tokenizer import write_clip_vocab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "a black cat sitting on a desk next to a laptop"


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """The test workers share the CPU cores; this module's torch work is
    small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARRAYS = {"w": np.arange(12, dtype=np.float32).reshape(3, 4) / 7.0,
          "b": np.array([-1.5, 0.25, 3.0], np.float32)}


def _pickle_with_missing_class(path):
    """torch.save of a Lightning-style checkpoint whose callback state is an
    object of a module that is then uninstalled."""
    mod = types.ModuleType("lightning_stub_cb")
    ModelCheckpoint = type("ModelCheckpoint", (), {"__module__": "lightning_stub_cb"})
    mod.ModelCheckpoint = ModelCheckpoint
    sys.modules["lightning_stub_cb"] = mod
    try:
        cb = ModelCheckpoint()
        cb.best_model_path = "/x.ckpt"
        torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in ARRAYS.items()},
                    "callbacks": {"ModelCheckpoint": cb}, "epoch": 3}, path)
    finally:
        del sys.modules["lightning_stub_cb"]


class _Scripted(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(ARRAYS["w"]).half())
        self.register_buffer("b", torch.from_numpy(ARRAYS["b"]))

    def forward(self, x):
        return x @ self.w.float().T + self.b


def _bf16_safetensors(path):
    """Written by hand: BF16 and I64 tensors, a __metadata__ entry."""
    w = torch.from_numpy(ARRAYS["w"]).bfloat16()
    tensors = [("w", "BF16", w.view(torch.int16).numpy().tobytes(), [3, 4]),
               ("ids", "I64", np.arange(5, dtype=np.int64).tobytes(), [5])]
    header, pos = {"__metadata__": {"format": "pt"}}, 0
    for name, dt, raw, shape in tensors:
        header[name] = {"dtype": dt, "shape": shape, "data_offsets": [pos, pos + len(raw)]}
        pos += len(raw)
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob + b"".join(t[2] for t in tensors))
    return {"w": w.float().numpy(), "ids": np.arange(5, dtype=np.float32)}


def write_case(case, tmp_path):
    """(path, the arrays load_torch_checkpoint must return)."""
    path = str(tmp_path / f"{case}.bin")
    if case == "ckpt_state_dict":
        return save_ckpt(path, ARRAYS), ARRAYS
    if case == "pth_flat":
        return save_ckpt(path, ARRAYS, wrap=False), ARRAYS
    if case == "ckpt_f16_bf16":
        torch.save({"w": torch.from_numpy(ARRAYS["w"]).half(),
                    "b": torch.from_numpy(ARRAYS["b"]).bfloat16(), "step": 5, "name": "x"}, path)
        return path, {"w": ARRAYS["w"].astype(np.float16).astype(np.float32),
                      "b": torch.from_numpy(ARRAYS["b"]).bfloat16().float().numpy()}
    if case == "missing_module":
        _pickle_with_missing_class(path)
        return path, ARRAYS
    if case == "torchscript":
        torch.jit.script(_Scripted()).save(path)
        return path, {"w": ARRAYS["w"].astype(np.float16).astype(np.float32), "b": ARRAYS["b"]}
    from safetensors.numpy import save_file

    path = str(tmp_path / f"{case}.safetensors")
    if case == "safetensors_f32":
        save_file(ARRAYS, path)
        return path, ARRAYS
    if case == "safetensors_f16":
        save_file({k: v.astype(np.float16) for k, v in ARRAYS.items()}, path)
        return path, {k: v.astype(np.float16).astype(np.float32) for k, v in ARRAYS.items()}
    return path, _bf16_safetensors(path)


@pytest.mark.parametrize("case", ["ckpt_state_dict", "pth_flat", "ckpt_f16_bf16", "missing_module",
                                  "torchscript", "safetensors_f32", "safetensors_f16",
                                  "safetensors_bf16_by_hand"])
def test_reader_gives_float32_arrays_bit_equal(case, tmp_path):
    path, want = write_case(case, tmp_path)
    got = tconvert.load_torch_checkpoint(path)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == np.float32 and np.array_equal(got[k], v), k
    if case in ("ckpt_state_dict", "pth_flat", "ckpt_f16_bf16", "safetensors_f32"):
        ref = jconvert.load_torch_checkpoint(path)     # JAX reads these too
        assert all(np.array_equal(got[k], ref[k]) for k in want)


def _write_header(path, header, data: bytes, n=None):
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob) if n is None else n) + blob + data)


@pytest.mark.parametrize("case, match", [
    ("truncated", "runs past the file"), ("overlap", "gap or an overlap"),
    ("gap", "gap or an overlap"), ("short", "needs"), ("tail", "data section holds"),
    ("dtype", "F64")])
def test_malformed_safetensors_raise(case, match, tmp_path):
    path = str(tmp_path / "bad.safetensors")
    t = {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]}
    data = np.arange(4, dtype=np.float32).tobytes()
    headers = {
        "overlap": {"a": t, "b": {**t, "data_offsets": [4, 12]}},
        "gap": {"a": t, "b": {**t, "data_offsets": [12, 20]}},
        "short": {"a": {**t, "shape": [3]}},
        "tail": {"a": t},
        "dtype": {"a": {**t, "dtype": "F64", "shape": [1]}},
    }
    if case == "truncated":
        _write_header(path, {"a": t}, b"", n=10 ** 6)
    else:
        _write_header(path, headers[case], data if case != "short" else data[:8])
    with pytest.raises(ValueError, match=match):
        load_file(path)


def test_missing_file_raises_naming_it(tmp_path):
    for name in ("none.ckpt", "none.safetensors"):
        with pytest.raises(FileNotFoundError, match=name):
            tconvert.load_torch_checkpoint(str(tmp_path / name))


def test_two_step_image_matches_jax_on_the_same_file(tmp_path):
    """load_stable_diffusion(TINY, ckpt, device="cpu"): the image of a
    2-step PLMS chain from the same noise matches JAX's
    load_stable_diffusion on the same file."""
    jc, tc = pipeline_cfgs(TINY)
    path, _ = compvis_file(tmp_path, tc, seed=3, scale=0.1)
    jsd = jloader.load_stable_diffusion(jc, path)
    tsd = tloader.load_stable_diffusion(tc, path, device="cpu")
    rng = np.random.default_rng(1)
    x_T = rng.standard_normal((1, 8, 8, 4), dtype=np.float32)
    ids = np.array([[1, 5, 9, 3, 2, 0, 99, 4]], np.int32)
    uids = np.array([[1, 2, 0, 0, 0, 0, 99, 4]], np.int32)
    jeps = jsd.make_eps_fn(jsd.encode_text(jnp.asarray(ids)), jsd.encode_text(jnp.asarray(uids)),
                           7.5)
    ref = jsd.decode_latents(jsd.sample_from(jeps, jnp.asarray(x_T), "plms", remat=False))
    with torch.no_grad():
        teps = tsd.make_eps_fn(tsd.encode_text(ids), tsd.encode_text(uids), 7.5)
        got = tsd.decode_latents(tsd.sample_from(teps, torch.from_numpy(x_T), "plms", remat=False))
    ref, got = np.asarray(ref), got.numpy()
    assert got.shape == (1, 16, 16, 3) and float(ref.std()) > 0
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-5


def test_missing_key_raises_naming_it(tmp_path):
    """A file without one UNet key raises, naming it; nothing is filled with
    random values.  A file without the text tower's last layer raises in the
    strict bridge, naming the missing parameters."""
    _, tc = pipeline_cfgs(TINY)
    sd = testing.seeded_state_dict(testing.compvis_shapes(tc), 0)
    key = "model.diffusion_model.middle_block.1.transformer_blocks.0.attn2.to_k.weight"
    with pytest.raises(KeyError, match=key.replace(".", r"\.")):
        tloader.load_stable_diffusion(tc, save_ckpt(tmp_path / "a.ckpt", {
            k: v for k, v in sd.items() if k != key}), device="cpu")
    last = "cond_stage_model.transformer.text_model.encoder.layers.0."
    with pytest.raises(KeyError, match="layer_0"):
        tloader.load_stable_diffusion(tc, save_ckpt(tmp_path / "b.ckpt", {
            k: v for k, v in sd.items() if not k.startswith(last)}), device="cpu")


def jax_cfg(c):
    """The JAX package's config of a port config, field for field."""
    cls = getattr(jcfg, type(c).__name__)
    return cls(**{f.name: jax_cfg(v) if dataclasses.is_dataclass(v) else v
                  for f in dataclasses.fields(c) for v in [getattr(c, f.name)]})


def drill_files(tmp_path, cfg, lcfg):
    """CompVis, OpenAI CLIP, fairseq Rel2Bbox and CLIP BPE files at the
    tiny configs."""
    sd_path, _ = compvis_file(tmp_path, cfg, seed=11, scale=0.1)
    clip = testing.seeded_state_dict(testing.openai_clip_shapes(cfg.loss_clip), 12, 0.1)
    layout = testing.seeded_state_dict(testing.rel2bbox_shapes(lcfg), 13, 0.1)
    return dict(sd_ckpt=sd_path, clip_ckpt=save_ckpt(tmp_path / "vit.pt", clip, wrap=False),
                layout_ckpt=save_ckpt(tmp_path / "rel2bbox.pth", layout),
                clip_vocab=write_clip_vocab(tmp_path / "bpe.txt"))


def test_drill_matches_jax_on_the_same_files(tmp_path):
    """run_drill at tiny config on the CPU with every checkpoint file: JAX's
    report keys and values, both CLIP scores within 1e-4 of JAX's."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from ingest_weights import run_drill as jrun_drill

    cfg, lcfg = tiny_configs(3)
    files = drill_files(tmp_path, cfg, lcfg)
    common = dict(prompt=PROMPT, steps=3, epochs=2, seed=1, sampler="plms", **files)
    jrep = jrun_drill(outdir=str(tmp_path / "jax"), pipeline_cfg=jax_cfg(cfg),
                      layout_cfg=jax_cfg(lcfg), **common)
    trep = ingest_weights.run_drill(outdir=str(tmp_path / "port"), pipeline_cfg=cfg,
                                    layout_cfg=lcfg, device="cpu", **common)
    assert list(trep) == list(jrep)
    assert trep["sd_weights"] == trep["layout_weights"] == trep["clip_weights"] == "checkpoint"
    for k in jrep:
        if k.endswith("clip_score"):
            assert abs(trep[k] - jrep[k]) <= 1e-4, (k, trep[k], jrep[k])
        elif not k.endswith("_image"):
            assert trep[k] == jrep[k], k
    for mode in ("vanilla", "method"):
        assert trep[f"{mode}_image"] == str(tmp_path / "port" / mode)
        assert os.listdir(trep[f"{mode}_image"]) == ["final1_s1_index_0.png"]
    assert json.loads((tmp_path / "port" / "clip_scores.json").read_text()) == trep


def test_drill_cli_tiny_cpu(tmp_path, capsys):
    """`ingest_weights --tiny --cpu` without files: random weights, flagged,
    the hash tokenizer's core printed, the report written."""
    rep = ingest_weights.main(["--tiny", "--cpu", "--steps", "2", "--epochs", "2",
                               "--outdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "layout tokenizer core: hash" in out and "no --sd-ckpt" in out
    assert rep["sd_weights"] == rep["clip_weights"] == rep["layout_weights"] == "random"
    assert np.isfinite(rep["vanilla_clip_score"])
    assert json.loads((tmp_path / "clip_scores.json").read_text()) == rep
    with pytest.raises(FileNotFoundError, match="gone.ckpt"):
        ingest_weights.main(["--tiny", "--cpu", "--sd-ckpt", str(tmp_path / "gone.ckpt")])


def checkpoint_flag_file(flag, tmp_path):
    """(path, loader the flag goes through, check of what it returned): a
    small real file at the tiny configs for one checkpoint flag."""
    cfg, lcfg = tiny_configs(2)
    if flag == "--clip-vocab":
        return (write_clip_vocab(tmp_path / "bpe.txt"), "make_clip_tokenizer",
                lambda tok: tok.core == "python" and tok.tokenize("a cat")[:2] == [49406, 320])
    shapes, key, name, get = {
        "--ckpt": (testing.compvis_shapes(cfg), "model.diffusion_model.input_blocks.0.0.weight",
                   "load_stable_diffusion", lambda sd: sd.unet.in_conv.weight),
        "--clip-ckpt": (testing.openai_clip_shapes(cfg.loss_clip), "visual.proj",
                        "load_clip_loss", lambda loss: loss.clip.visual_projection.weight.T),
        "--layout-ckpt": (testing.rel2bbox_shapes(lcfg),
                          "encoder.model.encoder.sentence_encoder.object_embedding",
                          "load_layout_predictor", lambda m: m.backbone.object_embedding),
    }[flag]
    sd = testing.seeded_state_dict(shapes, 5)
    path = str(tmp_path / "weights.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path, name, lambda obj: torch.equal(get(obj), torch.from_numpy(sd[key]))
