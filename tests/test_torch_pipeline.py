"""PyTorch port, the serving slice as a whole, held against the JAX package on
the CPU: text encoding, controlled PLMS sampling and VAE decode from the same
x_T; the port's TextToImageEngine; the tokenizer; and the rule that the port
imports nothing of JAX.

f32 tolerance ~1e-4 on latents and images: each UNet evaluation agrees to
~1e-5 (flax norms use E[x²]−E[x]²), and PLMS carries the difference through
7 evaluations.
"""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_spacetime_attn_tpu.ops.attention import SpatialControl as JControl
from diffusion_spacetime_attn_tpu.pipeline.pipeline import StableDiffusion as JSD
from diffusion_spacetime_attn_tpu.testbed.configs import smoke_pipeline_cfg
from diffusion_spacetime_attn_tpu.utils.testing import randomize_params
from diffusion_spacetime_attn_tpu.utils.tokenizer import make_clip_tokenizer as j_tokenizer
from diffusion_spacetime_attn_tpu_torch import config as tcfg
from diffusion_spacetime_attn_tpu_torch.ops.attention import SpatialControl
from diffusion_spacetime_attn_tpu_torch.pipeline.pipeline import StableDiffusion
from diffusion_spacetime_attn_tpu_torch.serving.server import TextToImageEngine
from diffusion_spacetime_attn_tpu_torch.utils import prng
from diffusion_spacetime_attn_tpu_torch.utils.tokenizer import make_clip_tokenizer

ROOT = Path(__file__).resolve().parent.parent
ATOL = 1e-4


def port_cfg(c):
    cls = getattr(tcfg, type(c).__name__)
    return cls(**{f.name: (port_cfg(getattr(c, f.name))
                           if dataclasses.is_dataclass(getattr(c, f.name))
                           else getattr(c, f.name))
                  for f in dataclasses.fields(c)})


def flat(params):
    from flax import traverse_util

    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(params), sep="/").items()}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test processes side by side on few cores,
    where torch's spinning intra-op threads slow each other down many-fold;
    this module's torch work is small, so it takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_slice_controlled_plms_txt2img_matches_jax():
    """smoke_pipeline_cfg, 2 prompts x 2 objects, a fixed per-step coef
    schedule, x_T from numpy: encode_text -> make_eps_fn -> PLMS -> decode
    in both packages."""
    cfg = smoke_pipeline_cfg(num_steps=6)
    sd = JSD.create(cfg, jax.random.PRNGKey(0), abstract=True)
    sd = dataclasses.replace(
        sd,
        unet_params=randomize_params(sd.unet_params, jax.random.PRNGKey(1), 0.2),
        vae_params=randomize_params(sd.vae_params, jax.random.PRNGKey(2), 0.2),
        text_params=randomize_params(sd.text_params, jax.random.PRNGKey(3), 0.2))
    tsd = StableDiffusion.from_flat(port_cfg(cfg), flat(sd.unet_params),
                                    flat(sd.vae_params), flat(sd.text_params),
                                    device="cpu")
    B, N, S, L = 2, 2, 6, cfg.text_encoder.max_len
    V = cfg.text_encoder.vocab_size
    r = np.random.RandomState(0)

    def ids(n):
        a = r.randint(1, V - 1, size=(n, L)).astype(np.int32)
        a[:, -1] = V - 1
        return a

    cond_ids, uncond_ids, local_ids = ids(B), ids(B), ids(B * N)
    centers = np.array([[[0.3, 0.4], [0.7, 0.6]], [[0.5, 0.2], [0.5, 0.8]]], np.float32)
    active = np.array([[1, 1], [1, 0]], np.float32)
    coef_sched = (1.0 + r.rand(B, N, S)).astype(np.float32)
    x_T = r.randn(B, 8, 8, 4).astype(np.float32)

    jloc = sd.encode_text(jnp.asarray(local_ids)).reshape(B, N, L, -1)
    jctl = JControl(jloc, jnp.asarray(centers), jnp.asarray(coef_sched[:, :, 0]),
                    jnp.asarray(active))
    jeps = sd.make_eps_fn(sd.encode_text(jnp.asarray(cond_ids)),
                          sd.encode_text(jnp.asarray(uncond_ids)), 5.0, jctl,
                          jnp.asarray(coef_sched))
    jz = jax.jit(lambda x: sd.sample_from(jeps, x, "plms", remat=False))(jnp.asarray(x_T))
    jimg = jax.jit(sd.decode_latents)(jz)

    with torch.inference_mode():
        tloc = tsd.encode_text(local_ids).reshape(B, N, L, -1)
        tctl = SpatialControl(tloc, torch.from_numpy(centers),
                              torch.from_numpy(coef_sched[:, :, 0]), torch.from_numpy(active))
        teps = tsd.make_eps_fn(tsd.encode_text(cond_ids), tsd.encode_text(uncond_ids), 5.0,
                               tctl, torch.from_numpy(coef_sched))
        tz = tsd.sample_from(teps, torch.from_numpy(x_T), "plms")
        timg = tsd.decode_latents(tz)

    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), atol=ATOL, rtol=ATOL)
    # the control moved the latents (not a vanilla run in disguise)
    assert float(np.abs(np.asarray(jz) - x_T).max()) > 0


def test_other_samplers_raise():
    """sample_from takes JAX's names ("plms", "ddim", "dpm") and raises
    ValueError for any other, as `StableDiffusion.sample_from` does."""
    cfg = port_cfg(smoke_pipeline_cfg(num_steps=2))
    tsd = StableDiffusion.create(cfg, seed=0, device="cpu")
    x = torch.zeros(1, 8, 8, 4)
    for name in ("dpm_solver", "ddpm", "PLMS"):
        with pytest.raises(ValueError, match="unknown sampler"):
            tsd.sample_from(lambda x, t, i: x, x, sampler=name)
    for name in ("plms", "ddim", "dpm"):
        assert tsd.sample_from(lambda x, t, i: x, x, sampler=name).shape == x.shape


# ---------------------------------------------------------------- engine


@pytest.fixture(scope="module")
def engines():
    """(spatial, vanilla) engines on the smoke config at CLIP's vocab size."""
    base = smoke_pipeline_cfg(num_steps=3)
    cfg = port_cfg(dataclasses.replace(
        base, text_encoder=dataclasses.replace(base.text_encoder, vocab_size=49408)))
    sd = StableDiffusion.create(cfg, seed=0, device="cpu", scale=0.2)
    tok = make_clip_tokenizer(max_len=cfg.text_encoder.max_len)

    def tokenize(t):
        return tok.pad_to(tok.encode(t), cfg.text_encoder.max_len)

    def prepare_host(prompt):
        if prompt == "no layout":
            return None
        return {"centers": np.array([[0.3, 0.3], [0.7, 0.7]], np.float32),
                "active": np.ones(2, np.float32),
                "local_texts": [f"a photo of {prompt}", "a photo of a thing"]}

    spatial = TextToImageEngine(sd=sd, tokenize=tokenize, batch_size=3,
                                prepare_host=prepare_host)
    vanilla = TextToImageEngine(sd=sd, tokenize=tokenize, batch_size=3)
    return spatial, vanilla


def test_engine_shapes_and_seed_determinism(engines):
    eng, _ = engines
    a = eng.generate_batch(["a cat", "a dog"], [1, 2])     # one pad row
    assert a.shape == (2, 32, 32, 3) and a.dtype == np.uint8
    # same request at another batch position, no pad row -> same image
    b = eng.generate_batch(["a bird", "a cat", "x"], [9, 1, 5])
    np.testing.assert_array_equal(a[0], b[1])
    # another seed -> another image
    c = eng.generate_batch(["a cat"], [3])
    assert (c[0] != a[0]).any()


def test_engine_failed_layout_row_is_vanilla(engines):
    """A prompt whose host stage fails runs with inactive control, an exact
    no-op: its image is the vanilla engine's for the same seed (up to one
    uint8 step, since the text encoder sees another batch)."""
    spatial, vanilla = engines
    a = spatial.generate_batch(["no layout"], [4])
    b = vanilla.generate_batch(["no layout"], [4])
    assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1


def test_txt2img_samples_from_the_given_generator():
    """txt2img on a JAX key: x_T = jax.random.normal(key) (`utils/prng.py`)
    -> PLMS with CFG -> decode, held against JAX's txt2img on the same key
    and weights (smoke config, f32, ATOL); another key gives another image."""
    cfg = smoke_pipeline_cfg(num_steps=3)
    sd = JSD.create(cfg, jax.random.PRNGKey(0), abstract=True)
    sd = dataclasses.replace(
        sd,
        unet_params=randomize_params(sd.unet_params, jax.random.PRNGKey(1), 0.2),
        vae_params=randomize_params(sd.vae_params, jax.random.PRNGKey(2), 0.2),
        text_params=randomize_params(sd.text_params, jax.random.PRNGKey(3), 0.2))
    tsd = StableDiffusion.from_flat(port_cfg(cfg), flat(sd.unet_params),
                                    flat(sd.vae_params), flat(sd.text_params), device="cpu")
    V, L = cfg.text_encoder.vocab_size, cfg.text_encoder.max_len
    ids = np.random.RandomState(1).randint(1, V - 1, size=(2, L)).astype(np.int32)
    jimg = sd.txt2img(sd.encode_text(jnp.asarray(ids[:1])), sd.encode_text(jnp.asarray(ids[1:])),
                      jax.random.PRNGKey(5))
    with torch.inference_mode():
        cond, uncond = tsd.encode_text(ids[:1]), tsd.encode_text(ids[1:])
        img = tsd.txt2img(cond, uncond, prng.PRNGKey(5))
        other = tsd.txt2img(cond, uncond, prng.PRNGKey(6))
    size = cfg.spacetime.image_size
    assert img.shape == (1, size, size, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), atol=ATOL, rtol=ATOL)
    assert float((img - other).abs().max()) > 1e-3


def test_engine_rejects_oversized_batch(engines):
    with pytest.raises(ValueError):
        engines[1].generate_batch(["a"] * 4, [0] * 4)


# ---------------------------------------------------------------- tokenizer


@pytest.mark.parametrize("text", ["", "a cat", "a red circle right of a blue square",
                                  "Hello, World!  two  spaces"])
def test_hash_tokenizer_matches_jax(text):
    jt, tt = j_tokenizer(), make_clip_tokenizer()
    assert tt.encode(text) == jt.encode(text)
    assert tt.pad_to(tt.encode(text), 77) == jt.pad_to(jt.encode(text), 77)
    words = text.split()
    assert tt.encode_with_alignment(words) == jt.encode_with_alignment(words)


# ---------------------------------------------------------------- imports


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard", "msgpack",
             "PIL", "safetensors", "transformers", "pytorch_lightning", "fairseq",
             "diffusion_spacetime_attn_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    files = sorted((ROOT / "diffusion_spacetime_attn_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "chip_spacetime_variants.py",
                    ROOT / "tests" / "helpers" / "torch_ranks.py"]


def test_import_rule_matches_names_exactly():
    assert _forbidden("jax.numpy") and _forbidden("diffusion_spacetime_attn_tpu.ops")
    assert not _forbidden("diffusion_spacetime_attn_tpu_torch.ops")
    assert not _forbidden("jaxtyping")
    assert _forbidden("safetensors.numpy") and _forbidden("fairseq")
    assert not _forbidden("diffusion_spacetime_attn_tpu_torch.utils.safetensors")
    assert _forbidden("orbax.checkpoint") and _forbidden("tensorstore") and _forbidden("zstandard")
    assert not _forbidden("diffusion_spacetime_attn_tpu_torch.utils.orbax")


def test_port_imports_nothing_of_jax():
    """AST walk over every module of the port (`parallel/` included), the
    on-card scripts (chip_smoke.py, chip_spacetime_variants.py) and the
    multi-device tests' rank helper (tests/helpers/torch_ranks.py): no import
    of jax, flax, optax, orbax or the JAX package, nor of tensorstore,
    zstandard, msgpack, PIL, safetensors, transformers, pytorch_lightning
    or fairseq, which the card's machine lacks (relative imports stay
    inside the port)."""
    files = _port_files()
    assert len(files) > 20
    scripts = ROOT / "diffusion_spacetime_attn_tpu_torch" / "scripts"
    serving = ROOT / "diffusion_spacetime_attn_tpu_torch" / "serving"
    for new in (scripts / "serve.py", scripts / "txt2img.py", scripts / "measure_loadtest.py",
                serving / "loadtest.py",
                serving / "server.py", ROOT / "diffusion_spacetime_attn_tpu_torch" / "utils"
                / "watermark.py", scripts / "ingest_weights.py", scripts / "img2img.py",
                scripts / "sample_diffusion.py", scripts / "evaluate.py",
                scripts / "calibrate_clip_detector.py", scripts / "compare_outputs.py",
                scripts / "eval_frontend_extraction.py", scripts / "eval_layout_consistency.py",
                ROOT / "diffusion_spacetime_attn_tpu_torch" / "pipeline" / "img2img.py",
                ROOT / "diffusion_spacetime_attn_tpu_torch" / "samplers" / "ddpm.py",
                *(ROOT / "diffusion_spacetime_attn_tpu_torch" / "training" / f"{m}.py"
                  for m in ("schedules", "ldm_trainer", "perceptual", "vae_trainer",
                            "clip_trainer")),
                ROOT / "diffusion_spacetime_attn_tpu_torch" / "models" / "encoders.py",
                ROOT / "diffusion_spacetime_attn_tpu_torch" / "testbed" / "data.py",
                scripts / "train_testbed.py", scripts / "train_ldm.py", scripts / "train_vae.py",
                scripts / "bench_train.py", scripts / "flops_model.py", scripts / "profiler.py",
                scripts / "analyze_trace.py",
                ROOT / "diffusion_spacetime_attn_tpu_torch" / "utils" / "flops.py",
                ROOT / "diffusion_spacetime_attn_tpu_torch" / "utils" / "profiling.py",
                ROOT / "diffusion_spacetime_attn_tpu_torch" / "parallel" / "mesh.py",
                ROOT / "diffusion_spacetime_attn_tpu_torch" / "parallel" / "sharding.py",
                *(ROOT / "diffusion_spacetime_attn_tpu_torch" / "utils" / f"{m}.py"
                  for m in ("zstd", "ocdbt", "orbax", "bmp", "webp", "image_io")),
                ROOT / "diffusion_spacetime_attn_tpu_torch" / "training" / "jax_checkpoints.py",
                ROOT / "tests" / "helpers" / "torch_ranks.py"):
        assert new in files, new
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                names = [node.args[0].value]
            bad += [f"{path.name}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad
