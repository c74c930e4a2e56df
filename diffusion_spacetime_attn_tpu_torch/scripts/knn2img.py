"""Retrieval-augmented text-to-image; port of the JAX package's
`scripts/knn2img.py` (reference `scripts/knn2img.py`), with its flags and
`--cpu`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.knn2img --prompt "a virus monster" \\
        --use-neighbors --database db.npz --knn 10 --n-samples 3
    python -m diffusion_spacetime_attn_tpu_torch.scripts.knn2img --tiny --cpu --ddim-steps 4 \\
        --use-neighbors --database db.npz --knn 2 --n-samples 2 --outdir /tmp/knn

Prompt -> CLIP joint-space text embedding -> (with `--use-neighbors`) its
k nearest neighbours in the database written by `scripts/train_searcher.py`
(exact search, `pipeline/retrieval.py`) -> conditioning [B, 1 + knn, 768]
-> the RDM UNet and the f16 VAE under DDIM (or `--plms`) with zero-context
CFG (`pipeline/knn2img.py`).  Each prompt is one batch of `--n-samples`
with the key `split(rng)` of `PRNGKey(--seed)`, as the JAX script draws it;
images are written as `{count:05}.png` into `--outdir`.

The text tower is the ViT-L/14 joint-space CLIP (`config.VIT_L14_JOINT_CLIP`,
768 wide, what the RDM's context takes); the JAX script builds ViT-B/32
(512 wide) and cannot run its RDM at full width.  `--tiny` takes the tiny
RDM and a tiny CLIP, and crops the database and the text embedding to the
tiny context as the JAX script does.  The UNet runs the MHA and GEGLU
kernels at full width (`use_mha`, `use_fused_ff`), which the JAX script
leaves off.  Weights are seeded and random (smoke mode; `--clip-ckpt`
loads an OpenAI CLIP); `--rdm-ckpt` raises, as in JAX: no RDM checkpoint
is published.  Runs on the card and raises without one, unless `--cpu`
is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from ..ops import cuda_geglu, cuda_mha
from ..ops.schedule import make_schedule
from ..pipeline.knn2img import RetrievalAugmentedDiffusion, rdm_schedule_config
from ..pipeline.retrieval import Retriever, normalize
from ..pipeline.runners import save_image
from ..utils import prng
from ..utils.tokenizer import make_clip_tokenizer, padded
from .layout_infer import pick_device
from .train_searcher import build_clip


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prompt", default="a painting of a virus monster playing guitar")
    ap.add_argument("--from-file", default=None, help="file of prompts, one per line")
    ap.add_argument("--outdir", default="outputs/knn2img-samples")
    ap.add_argument("--ddim-steps", type=int, default=50)
    ap.add_argument("--plms", action="store_true")
    ap.add_argument("--ddim-eta", type=float, default=0.0)
    ap.add_argument("--n-samples", type=int, default=3, help="batch size")
    ap.add_argument("--scale", type=float, default=5.0)
    ap.add_argument("--database", default=None, help=".npz from scripts/train_searcher.py")
    ap.add_argument("--use-neighbors", action="store_true")
    ap.add_argument("--knn", type=int, default=10)
    ap.add_argument("--clip-ckpt", default=None, help="OpenAI CLIP state_dict")
    ap.add_argument("--rdm-ckpt", default=None, help="RDM weights (none is published)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--dtype", default=None,
                    help="weights' dtype (default bfloat16; a bundle handed in keeps its own)")
    ap.add_argument("--tiny", action="store_true", help="tiny model (CPU smoke)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def main(argv=None, models=None) -> dict:
    """Sample every prompt and write the PNGs; returns {"paths", "s_per_batch",
    "context_len", "launches" (per batch: MHA and GEGLU forward launches)}.
    `models` = (RetrievalAugmentedDiffusion, CLIP) replaces the seeded
    weights; it samples under `--ddim-steps` / `--ddim-eta` like the seeded
    bundle, and a `--dtype` other than its own raises."""
    args = parse_args(argv)
    if args.rdm_ckpt:
        raise NotImplementedError("--rdm-ckpt: no RDM checkpoint is published with the "
                                  "repository; the weights are random (smoke mode)")
    if args.use_neighbors and not args.database:
        raise ValueError("--use-neighbors needs --database")
    device = pick_device(args.cpu)
    if models is None:
        rdm = RetrievalAugmentedDiffusion.create(seed=0, dtype=args.dtype or "bfloat16",
                                                 tiny=args.tiny, device=device)
        if not args.clip_ckpt:
            print("no --clip-ckpt: random text tower (smoke mode)")
        clip = build_clip(args.tiny, device, args.clip_ckpt, seed=4)
        models = (rdm, clip)
    rdm, clip = models
    if args.dtype is not None and args.dtype != rdm.unet.cfg.dtype:
        raise ValueError(f"--dtype {args.dtype}: the bundle handed in is {rdm.unet.cfg.dtype}")
    rdm = dataclasses.replace(rdm, schedule=make_schedule(
        rdm_schedule_config(), args.ddim_steps, eta=args.ddim_eta, device=rdm.device))
    ctx_dim = rdm.unet.cfg.context_dim
    tok = make_clip_tokenizer()
    tokenize = padded(tok, 77)

    retriever = None
    if args.use_neighbors:
        retriever = Retriever.from_npz(args.database, device=device)
        if args.tiny:   # smoke mode: crop the database to the tiny context
            retriever.embedding = normalize(retriever.embedding[:, :ctx_dim])
        print(f"database: {retriever.embedding.shape[0]} x {retriever.embedding.shape[1]}")

    if args.from_file:
        with open(args.from_file) as f:
            prompts = [ln.strip() for ln in f if ln.strip()]
    else:
        prompts = [args.prompt]
    os.makedirs(args.outdir, exist_ok=True)

    rng = prng.PRNGKey(args.seed)
    count, paths, seconds, launches, ctx_len = 0, [], [], [], None
    for prompt in prompts:
        _sync(device)
        t0 = time.perf_counter()
        before = (cuda_mha.mha_attention.launches, cuda_geglu.geglu_ff.launches)
        ids = torch.as_tensor(np.tile(np.asarray(tokenize(prompt))[None], (args.n_samples, 1)),
                              device=device)
        with torch.inference_mode():
            txt = clip.encode_text(ids)                          # [B, D]
        if args.tiny:   # the tiny model's context is narrower
            txt = txt[:, :ctx_dim]
        cond = rdm.build_conditioning(txt, retriever, args.knn)
        rng, k = prng.split(rng)
        imgs = rdm.sample(cond, k, guidance_scale=args.scale,
                          sampler="plms" if args.plms else "ddim").float().cpu().numpy()
        for img in imgs:
            path = os.path.join(args.outdir, f"{count:05}.png")
            save_image(img, path)
            paths.append(path)
            count += 1
        seconds.append(time.perf_counter() - t0)
        launches.append({"mha_fwd": cuda_mha.mha_attention.launches - before[0],
                         "geglu_fwd": cuda_geglu.geglu_ff.launches - before[1]})
        ctx_len = cond.shape[1]
        print(f"prompt {prompt!r} -> {imgs.shape[0]} samples (context len {ctx_len})")
    return {"paths": paths, "s_per_batch": seconds, "context_len": ctx_len,
            "launches": launches}


if __name__ == "__main__":
    main()
