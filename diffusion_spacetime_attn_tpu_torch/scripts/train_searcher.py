"""Build a retrieval database for knn2img; port of the JAX package's
`scripts/train_searcher.py` (reference `scripts/train_searcher.py`), with
its flags and `--tiny` / `--cpu`.

    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_searcher --synthetic 256
    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_searcher --image-dir imgs/ --clip-ckpt ViT-L-14.pt
    python -m diffusion_spacetime_attn_tpu_torch.scripts.train_searcher --tiny --cpu --synthetic 8 --out db.npz

The "index" is the normalized embedding matrix (`pipeline/retrieval.py`:
exact search).  Input: an embeddings npz in the reference format
(`embedding`, optional `img_id` / `patch_coords`), or images embedded by the
CLIP vision tower in batches of `--batch`: `--synthetic N` numpy
`RandomState(0)` images at 224², as the JAX script draws them, or the
images of `--image-dir` (PNG and baseline JPEG, `utils/image_io.py`; WebP
raises, ROADMAP A.12) converted to RGB and resized to 224² with PIL's
default filter (`utils/resample.py`, PIL-exact), as the JAX script does.  The tower is the ViT-L/14 joint-space CLIP
(`config.VIT_L14_JOINT_CLIP`), whose 768-wide space the RDM is conditioned
on; the JAX script builds ViT-B/32 (512 wide), whose databases cannot feed
the RDM.  `--tiny` takes a tiny CLIP (`pipeline/knn2img.joint_clip_config`).
Without `--clip-ckpt` (an OpenAI CLIP state dict) the weights are seeded
and random (smoke mode).  Writes the npz to `--out`; runs on the card and
raises without one, unless `--cpu` is given.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..models.clip import CLIP, clip_normalize
from ..pipeline.knn2img import joint_clip_config
from ..pipeline.retrieval import Retriever, build_database_from_images
from ..utils import convert
from ..utils.image_io import open_image
from ..utils.resample import resize
from ..utils.testing import randomize_
from ..utils.weights import flatten_tree, load_flat
from .layout_infer import pick_device

IMAGE_SIZE = 224


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--image-dir", default=None, help="directory of images")
    ap.add_argument("--embeddings", default=None,
                    help="existing .npz with an `embedding` array (reference format)")
    ap.add_argument("--clip-ckpt", default=None,
                    help="OpenAI CLIP state_dict for the vision tower (random weights without)")
    ap.add_argument("--out", default="data/rdm/searchers/database.npz")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--synthetic", type=int, default=0, help="N random images (smoke mode)")
    ap.add_argument("--tiny", action="store_true", help="tiny CLIP (CPU smoke)")
    ap.add_argument("--cpu", action="store_true", help="run on the host CPU")
    return ap.parse_args(argv)


def load_image_dir(path: str) -> np.ndarray:
    """The directory's images (sorted by name) as [N, 224, 224, 3] float32
    in [0, 1]: `Image.open(f).convert("RGB").resize((224, 224)) / 255`."""
    files = sorted(f for f in os.listdir(path)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".webp")))
    return np.stack([resize(open_image(os.path.join(path, f), "RGB"), (IMAGE_SIZE, IMAGE_SIZE))
                     / 255.0 for f in files]).astype(np.float32)


def build_clip(tiny: bool, device, clip_ckpt=None, seed: int = 1) -> CLIP:
    """The joint-space CLIP on `device`, float32: an OpenAI checkpoint, or
    seeded N(0, 0.02²) weights."""
    with torch.device(device):
        clip = CLIP(joint_clip_config(tiny))
    clip.eval().requires_grad_(False)
    if clip_ckpt:
        load_flat(clip, flatten_tree(convert.convert_openai_clip(
            convert.load_torch_checkpoint(clip_ckpt))))
    else:
        randomize_(clip, seed, 0.02)
    return clip


def main(argv=None, clip=None) -> dict:
    """Build and write the database; returns {"out", "rows", "dim",
    "seconds" (embedding and writing)}.  `clip` replaces the seeded tower."""
    args = parse_args(argv)
    device = pick_device(args.cpu)
    t0 = time.perf_counter()
    if args.embeddings:
        r = Retriever.from_npz(args.embeddings, device=device)
        print(f"loaded {r.embedding.shape[0]} embeddings from {args.embeddings}")
    else:
        if args.synthetic:
            imgs = np.random.RandomState(0).rand(
                args.synthetic, IMAGE_SIZE, IMAGE_SIZE, 3).astype(np.float32)
        else:
            imgs = load_image_dir(args.image_dir)
            print(f"embedding {len(imgs)} images from {args.image_dir}")
        ids = np.arange(len(imgs))
        if clip is None:
            if not args.clip_ckpt:
                print("no --clip-ckpt: random vision tower (smoke mode)")
            clip = build_clip(args.tiny, device, args.clip_ckpt)
        r = build_database_from_images(imgs, lambda px: clip.encode_image(clip_normalize(px)),
                                       batch=args.batch, img_ids=ids, device=device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    r.save_npz(args.out)
    rows, dim = r.embedding.shape
    print(f"wrote database [{rows}, {dim}] -> {args.out}")
    return {"out": args.out, "rows": rows, "dim": dim, "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    main()
