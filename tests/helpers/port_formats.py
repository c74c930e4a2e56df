"""The fixtures of `tests/fixtures/port_formats/`, made from seeds with JAX,
orbax and Pillow, and the SHA-256 digests `chip_smoke.py` (phase formats)
holds the port's readers to on a machine that has none of the three.

    python tests/helpers/port_formats.py          # rewrites the fixtures

* `ldm/step_2/`: a JAX `LDMTrainer.save` of an unconditional UNet at
  `UNET` (one level of 32 channels, no attention outside the middle
  block; 182,820 parameters): params, EMA, AdamW's two moments, logvar and
  step.  Random float32 barely compresses (16 bytes a parameter for the
  four copies), so the values are seeded normal draws rounded to halves
  (about 1.3 bytes each after orbax's zstd) and each moment leaf repeats one
  seeded run of values: the state takes about half a megabyte;
* one file of each image format the port reads besides PNG and baseline
  JPEG, written by Pillow: a progressive, a CMYK and an RGB-coded JPEG;
  8-bit palette and 24-bit BMPs; lossy, lossless and alpha WebPs.  The
  three `TRAIN` files stand in for port-written JPEGs in phase train_data.

`digests.json` holds {"state": {path: sha256 of the restored array's
bytes}, "images": {file: {"file", "mode", "pixels", "rgb", "shape"}}}:
the file's bytes, `Image.open(f).mode`, the SHA-256 of
`np.asarray(Image.open(f))` and of `.convert("RGB")`.
`tests/test_torch_orbax.py` rebuilds everything and holds it to the
committed digests.  Orbax writes a fresh uuid and commit time into every
save, so the state's files differ from build to build; its digests do not.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

FIXTURES = Path(__file__).resolve().parents[1] / "fixtures" / "port_formats"
STATE = "ldm/step_2"
UNET = dict(model_channels=32, channel_mult=(1,), num_res_blocks=1, attention_resolutions=(),
            num_heads=1, dtype="float32")
LATENT = 8
TRAIN = ("progressive.jpg", "rgb24.bmp", "lossy.webp")


def _image(h, w, seed, c=3):
    """Integer gradients plus RandomState noise (the same bytes on every numpy)."""
    r = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * (3 + k) + yy * (2 + 2 * k) + 40 * k) % 256 for k in range(c)], -1)
    return np.clip(base + r.randint(-12, 13, (h, w, c)), 0, 255).astype(np.uint8)


def write_images(out: Path) -> None:
    from PIL import Image

    big = Image.fromarray(_image(192, 256, 1))
    small = Image.fromarray(_image(47, 63, 2))
    alpha = Image.fromarray(_image(47, 63, 3, c=4))
    saves = {
        "progressive.jpg": (big, dict(format="JPEG", quality=85, progressive=True)),
        "rgb24.bmp": (big, dict(format="BMP")),
        "lossy.webp": (big, dict(format="WEBP", quality=80)),
        "cmyk.jpg": (small.convert("CMYK"), dict(format="JPEG", quality=90)),
        "rgb_coded.jpg": (small, dict(format="JPEG", quality=90, keep_rgb=True)),
        "palette.bmp": (small.quantize(64), dict(format="BMP")),
        "lossless.webp": (small, dict(format="WEBP", lossless=True)),
        "alpha.webp": (alpha, dict(format="WEBP", quality=70)),
    }
    for name, (img, kw) in saves.items():
        buf = io.BytesIO()
        img.save(buf, **kw)
        (out / name).write_bytes(buf.getvalue())


def image_digests(out: Path) -> dict:
    from PIL import Image

    d = {}
    for name in sorted(os.listdir(out)):
        if name.endswith((".jpg", ".bmp", ".webp")):
            im = Image.open(out / name)
            px = np.asarray(im)
            d[name] = {"file": hashlib.sha256((out / name).read_bytes()).hexdigest(),
                       "mode": im.mode, "shape": list(px.shape),
                       "pixels": hashlib.sha256(px.tobytes()).hexdigest(),
                       "rgb": hashlib.sha256(np.asarray(im.convert("RGB")).tobytes()).hexdigest()}
    return d


def _leaves(tree, at=()):
    if hasattr(tree, "_asdict"):                 # optax's named tuples restore as dicts
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], at + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, at + (str(i),))
    elif tree is not None:
        yield "/".join(at), tree


def _bits(v) -> np.ndarray:
    """A leaf's bytes: bfloat16 (numpy's or torch's) as its 16-bit words."""
    if type(v).__module__.startswith("torch"):
        import torch

        return (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).contiguous().numpy()
    a = np.ascontiguousarray(np.asarray(v))
    return a.view(np.int16) if str(a.dtype) == "bfloat16" else a


def tree_digests(tree) -> dict:
    """{path: sha256 of the leaf's bytes} over a restored (or saved) tree."""
    return {path: hashlib.sha256(_bits(v).tobytes()).hexdigest() for path, v in _leaves(tree)}


def write_state(out: Path) -> dict:
    """The LDMTrainer state at step 2 -> its digests."""
    import jax
    import jax.numpy as jnp

    from diffusion_spacetime_attn_tpu.config import LDMTrainConfig, ScheduleConfig, UNetConfig
    from diffusion_spacetime_attn_tpu.models.unet import UNet
    from diffusion_spacetime_attn_tpu.ops.schedule import make_schedule
    from diffusion_spacetime_attn_tpu.training import ldm_trainer

    unet = UNet(UNetConfig(**UNET), radius=0.2)
    shapes = jax.eval_shape(unet.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, LATENT, LATENT, 4)), jnp.zeros((1,), jnp.int32),
                            None)["params"]
    r = np.random.RandomState(17)

    def draw(scale, positive=False, period=None):
        """Normal draws rounded to halves times `scale`; with `period`, one
        seeded run of that many values repeated over each leaf."""
        def leaf(s):
            v = r.randn(*((period,) if period else s.shape))
            v = np.round((np.abs(v) if positive else v) * 2) / 2 * scale
            return np.resize(v, s.shape).astype(np.float32)
        return jax.tree_util.tree_map(leaf, shapes)

    params, ema = draw(0.125), draw(0.125)
    mu, nu = draw(2 ** -10, period=97), draw(2 ** -20, positive=True, period=89)
    cfg, sched = LDMTrainConfig(), ScheduleConfig()
    state = ldm_trainer.init_state(cfg, sched, params, 1e-4)
    adam = state.opt_state[0]
    state = state._replace(
        params=params, ema_params=ema, step=jnp.asarray(2, jnp.int32),
        opt_state=(adam._replace(count=jnp.asarray(2, jnp.int32), mu=mu, nu=nu),)
        + tuple(state.opt_state[1:]))
    trainer = ldm_trainer.LDMTrainer(cfg, sched, make_schedule(sched, 50), None,
                                     ckpt_dir=str(out / "ldm"))
    trainer.save(state, 2)
    (out / "ldm" / "config.json").write_text(json.dumps({"unet": UNET, "latent": LATENT}))
    return tree_digests(jax.tree_util.tree_map(np.asarray, state._asdict()))


def build(out: Path) -> dict:
    """Write every fixture into `out` (emptied first) -> the digests."""
    out = Path(out)
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    write_images(out)
    return {"state": write_state(out), "images": image_digests(out)}


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    target = Path(sys.argv[1]) if len(sys.argv) > 1 else FIXTURES
    digests = build(target)
    (target / "digests.json").write_text(json.dumps(digests, indent=1, sort_keys=True) + "\n")
    total = sum(f.stat().st_size for f in target.rglob("*") if f.is_file())
    print(f"wrote {target}: {total} bytes")
