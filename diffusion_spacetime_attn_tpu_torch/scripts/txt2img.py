"""txt2img for one prompt in the vanilla, spatial-control and full
spatio-temporal modes; port of the JAX package's `scripts/txt2img.py`, with
its flags and `--tiny` / `--cpu`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.txt2img \\
        --prompt "a cat next to a dog" --mode spacetime --outdir outputs/
    python -m diffusion_spacetime_attn_tpu_torch.scripts.txt2img \\
        --prompt "a photo" --tiny --cpu --steps 3 --watermark

The image goes to `--outdir` as `final{epochs-1}_s{seed}_index_0.png`
(`PromptRunner.run_one`).  A prompt whose layout fails falls back to a
vanilla chain from the same noise, written as `final_s{seed}_index_0.png`,
as in the JAX script, which does so outside vanilla mode only (its
vanilla mode, whose runner also needs a layout, writes nothing then).
`--watermark` embeds "SDV1" (`utils/watermark.py`) in the image written;
the JAX script marks only the first name, so its fallback image stays
unmarked.  The flags keep the JAX script's defaults (MHA and GEGLU on,
flash off); at full width the spatial and spacetime modes also run the
controlled cross-attention through the spacetime kernel
(`use_fused_control`, as `scripts/run_dataset.py` does).  `--tiny` takes the
run_dataset tiny configs.

`--ckpt` (CompVis sd-v1-4 `.ckpt` / `.safetensors`), `--layout-ckpt`
(fairseq Rel2Bbox or HF RoBERTa), `--clip-ckpt` (OpenAI ViT-B/32) and
`--clip-vocab` (CLIP's BPE) read the published files (`utils/loader.py`,
`utils/tokenizer.py`); without them the weights are seeded and random and
the tokenizer hashes words.  Runs on the card and raises without one,
unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import LayoutConfig, PipelineConfig, SpaceTimeConfig, UNetConfig, VAEConfig
from ..pipeline.frontend import LayoutInference
from ..pipeline.runners import PromptRunner, result_name, save_image
from ..utils.cudnn import deterministic
from ..utils.loader import (
    find_default_layout_checkpoint,
    load_clip_loss,
    load_layout_predictor,
    load_stable_diffusion,
)
from ..utils.png import read_png, write_png
from ..utils.tokenizer import make_clip_tokenizer, make_roberta_tokenizer, padded
from ..utils.watermark import embed_watermark
from .layout_infer import pick_device
from .run_dataset import tiny_configs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompt", required=True)
    ap.add_argument("--mode", choices=["vanilla", "spatial", "spacetime"], default="vanilla")
    ap.add_argument("--sampler", choices=["plms", "ddim", "dpm"], default="plms")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--scale", type=float, default=7.5)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--outdir", default="outputs")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--layout-ckpt", default=None)
    ap.add_argument("--clip-ckpt", default=None)
    ap.add_argument("--clip-vocab", default=None)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--flash", action="store_true")
    ap.add_argument("--no-mha", dest="mha", action="store_false",
                    help="the plain self-attention instead of the MHA kernel")
    ap.add_argument("--no-fused-ff", dest="fused_ff", action="store_false",
                    help="the plain feed-forward instead of the GEGLU kernel")
    ap.add_argument("--watermark", action="store_true")
    ap.add_argument("--tiny", action="store_true", help="tiny model configs (smoke mode)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


def generate(runner: PromptRunner, prompt: str, seed: int):
    """`runner.run_one` of the prompt, or, where its layout fails, a vanilla
    chain from the same noise (`runner.sample` of an empty host record);
    returns (the path written under `runner.outdir`, the image [S, S, 3] in
    [0, 1] as float32 numpy)."""
    img = runner.run_one(prompt, 0, seed)
    if img is not None:
        return os.path.join(runner.outdir, result_name(runner.cfg.epochs - 1, seed, 0)), img
    print("layout failed; falling back to vanilla")
    with deterministic():
        img = runner.sample(runner.assemble_inputs([runner.empty_host(prompt)], seed))
    img = img[0].float().cpu().numpy()
    path = os.path.join(runner.outdir, f"final_s{seed}_index_0.png")
    save_image(img, path)
    return path, img


def main(argv=None) -> str:
    """Generate the image; returns the path written."""
    args = parse_args(argv)
    device = pick_device(args.cpu)
    if args.tiny:
        cfg, lcfg = tiny_configs(args.steps)
    else:
        cfg = PipelineConfig(
            unet=UNetConfig(dtype=args.dtype, use_flash=args.flash, use_mha=args.mha,
                            use_fused_ff=args.fused_ff,
                            use_fused_control=args.mode != "vanilla"),
            vae=VAEConfig(dtype=args.dtype),
            spacetime=SpaceTimeConfig(num_steps=args.steps, guidance_scale=args.scale))
        lcfg = LayoutConfig()
    if not args.ckpt:
        print("WARNING: no --ckpt; running with random weights (smoke mode)")
    sd = load_stable_diffusion(cfg, args.ckpt, device=device)
    clip_loss = load_clip_loss(cfg.loss_clip, args.clip_ckpt, seed=9, device=device)
    ckpt = args.layout_ckpt or (None if args.tiny else find_default_layout_checkpoint())
    layout = LayoutInference(load_layout_predictor(lcfg, ckpt, device=device),
                             make_roberta_tokenizer())
    L = cfg.text_encoder.max_len
    tokenize = padded(make_clip_tokenizer(args.clip_vocab, max_len=L), L)
    runner = PromptRunner(sd=sd, clip_loss=clip_loss, layout=layout, clip_tokenize=tokenize,
                          text_tokenize=tokenize, cfg=cfg.spacetime, outdir=args.outdir,
                          mode=args.mode, sampler=args.sampler)
    path, _ = generate(runner, args.prompt, args.seed)
    if args.watermark:
        write_png(path, embed_watermark(np.ascontiguousarray(read_png(path)[..., :3])))
    print(f"done -> {path}")
    return path


if __name__ == "__main__":
    main()
