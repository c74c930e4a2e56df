"""img2img / inpaint CLI; port of the JAX package's `scripts/img2img.py`
(reference: the stock CompVis `scripts/img2img.py` and `scripts/inpaint.py`),
with its flags and `--tiny` / `--cpu`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.img2img --init in.png \\
        --prompt "a fantasy landscape" --strength 0.75 --ckpt sd-v1-4.ckpt
    python -m diffusion_spacetime_attn_tpu_torch.scripts.img2img --init in.png \\
        --mask mask.png --prompt "..."                       # inpaint
    python -m diffusion_spacetime_attn_tpu_torch.scripts.img2img --tiny --cpu --size 32 \\
        --steps 4 --init in.png --prompt "a cat"

Writes `{img2img|inpaint}_s{seed}.png` into `--outdir` and prints its path.
The images (PNG, JPEG, BMP or WebP, `utils/image_io.py`) are read as JAX's
script reads them with PIL: the init image converted to RGB, the mask to
PIL's luma (white = keep, black = generate), each resized to `--size`
square with PIL's default bicubic filter (`utils/resample.py`).  The
noise is JAX's from `PRNGKey(--seed)` (`pipeline/img2img.py`).  Without
`--ckpt` the weights are seeded and random (smoke mode).  At full width the
UNet runs self-attention through the MHA kernel and the feed-forward through
the GEGLU kernel (`use_mha`, `use_fused_ff`), which the JAX script leaves
off; `--scores-dtype` defaults to bfloat16, as there (it reaches the plain
self-attention sites only).  `--tiny` takes the run_dataset tiny configs
(VAE factor 2).  Runs on the card and raises without one,
unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from ..config import PipelineConfig, SpaceTimeConfig, UNetConfig, VAEConfig
from ..pipeline.img2img import img2img, inpaint
from ..utils import prng
from ..utils.cudnn import deterministic
from ..utils.loader import load_stable_diffusion
from ..utils.image_io import open_image
from ..utils.png import write_png
from ..utils.resample import resize
from ..utils.tokenizer import make_clip_tokenizer, padded
from .layout_infer import pick_device
from .run_dataset import tiny_configs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init", required=True, help="init image (png or jpeg)")
    ap.add_argument("--mask", default=None,
                    help="inpaint mask (png or jpeg): white = keep, black = generate")
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--strength", type=float, default=0.75,
                    help="img2img: fraction of the chain to run")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=7.5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--outdir", default="outputs")
    ap.add_argument("--ckpt", default=None, help="CompVis sd-v1-4 checkpoint")
    ap.add_argument("--clip-vocab", default=None)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--scores-dtype", default="bfloat16")
    ap.add_argument("--tiny", action="store_true", help="tiny model configs (smoke mode)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


def pipeline_config(args) -> PipelineConfig:
    if args.tiny:
        cfg, _ = tiny_configs(args.steps)
    else:
        cfg = PipelineConfig(
            unet=UNetConfig(dtype=args.dtype, attn_scores_dtype=args.scores_dtype,
                            use_mha=True, use_fused_ff=True),
            vae=VAEConfig(dtype=args.dtype))
    factor = 2 ** (len(cfg.vae.ch_mult) - 1)
    return dataclasses.replace(cfg, spacetime=SpaceTimeConfig(
        num_steps=args.steps, guidance_scale=args.scale, image_size=args.size,
        latent_size=args.size // factor))


def read_square(path: str, size: int, grey: bool = False) -> np.ndarray:
    """[size, size, 3] (or [size, size] luma) uint8 of an image file:
    `Image.open(path).convert("RGB" or "L").resize((size, size))`, PIL's
    default (bicubic) filter, PIL-exact (`utils/resample.py`)."""
    return resize(open_image(path, "L" if grey else "RGB"), (size, size))


def main(argv=None) -> str:
    """Run img2img or inpaint; returns the path written."""
    args = parse_args(argv)
    device = pick_device(args.cpu)
    cfg = pipeline_config(args)
    img = read_square(args.init, args.size).astype(np.float32)[None] / 127.5 - 1.0
    mask = None
    if args.mask:
        mask = read_square(args.mask, args.size, grey=True).astype(np.float32)
        mask = mask[None, :, :, None] / 255.0
    if not args.ckpt:
        print("WARNING: no --ckpt; running with random weights (smoke mode)")
    sd = load_stable_diffusion(cfg, args.ckpt, device=device)
    L = sd.cfg.text_encoder.max_len
    tokenize = padded(make_clip_tokenizer(args.clip_vocab, max_len=L), L)
    with torch.inference_mode():
        cond, uncond = (sd.encode_text(np.asarray(tokenize(t), np.int32)[None])
                        for t in (args.prompt, ""))
    rng = prng.PRNGKey(args.seed)
    init = torch.from_numpy(img).to(sd.device)
    with deterministic():
        if mask is not None:
            out = inpaint(sd, init, torch.from_numpy(mask).to(sd.device), cond, uncond, rng,
                          guidance_scale=args.scale)
            tag = "inpaint"
        else:
            out = img2img(sd, init, cond, uncond, rng, strength=args.strength,
                          guidance_scale=args.scale)
            tag = "img2img"
    os.makedirs(args.outdir, exist_ok=True)
    arr = (out[0].float().cpu().numpy() * 255.0 + 0.5).astype(np.uint8)
    path = os.path.join(args.outdir, f"{tag}_s{args.seed}.png")
    write_png(path, arr)
    print(path)
    return path


if __name__ == "__main__":
    main()
