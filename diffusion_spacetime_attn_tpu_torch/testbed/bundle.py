"""The trained testbed models as one bundle, port of `save_bundle` and
`load_bundle` in the JAX package's `testbed/bundle.py`.

A checkpoint directory holds three parameter trees written by flax's
`msgpack_serialize` (`unet.msgpack`, `vae.msgpack`, `clip.msgpack`) and a
`meta.json` with the VAE's latent scale factor and the calibrated guidance
scale.  The trees are read with the port's own reader (`utils/msgpack.py`)
and loaded through the weight bridge (`utils/weights.py`), which raises on a
missing, unexpected or mis-shaped key.  The trained CLIP's text tower is
also the SD conditioning encoder, and the whole CLIP is the DCLIP judge,
fed [0, 1] images without CLIP's normalization, as it was trained.

`save_bundle` writes flat flax trees (`utils/weights.flax_flat`) with the
port's msgpack writer, in the bytes flax would write, so JAX's `load_bundle`
reads what the port trained; `meta.json` is merged as JAX merges it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..pipeline.losses import DCLIPLoss
from ..pipeline.pipeline import StableDiffusion
from ..utils.msgpack import load_flat, save_flat
from .configs import testbed_clip_cfg, testbed_pipeline_cfg
from .scenes import tokenize as scene_tokenize

TREES = ("unet", "vae", "clip")


def save_bundle(ckpt_dir: str, *, vae_params: Optional[Dict[str, np.ndarray]] = None,
                clip_params: Optional[Dict[str, np.ndarray]] = None,
                unet_params: Optional[Dict[str, np.ndarray]] = None,
                meta: Optional[Dict] = None) -> None:
    """Write any subset of the three flat trees (staged training saves as it
    goes) and merge `meta` into meta.json."""
    os.makedirs(ckpt_dir, exist_ok=True)
    for name, flat in (("vae", vae_params), ("clip", clip_params), ("unet", unet_params)):
        if flat is not None:
            save_flat(os.path.join(ckpt_dir, f"{name}.msgpack"), flat)
    meta_path = os.path.join(ckpt_dir, "meta.json")
    merged = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            merged = json.load(f)
    merged.update(meta or {})
    with open(meta_path, "w") as f:
        json.dump(merged, f, indent=2, sort_keys=True)


@dataclasses.dataclass
class TestbedBundle:
    sd: StableDiffusion
    clip_loss: DCLIPLoss
    meta: Dict

    def encode_captions(self, captions, tokenize=None) -> torch.Tensor:
        """captions: list[str] → [B, L, D] conditioning embeddings."""
        tok = tokenize or scene_tokenize
        return self.sd.encode_text(np.stack([tok(c) for c in captions]))


def load_trees(ckpt_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """{"unet" | "vae" | "clip": flat "a/b/c" tree} of a checkpoint directory."""
    return {name: load_flat(os.path.join(ckpt_dir, f"{name}.msgpack")) for name in TREES}


def load_bundle(ckpt_dir: str, num_steps: int = 50, guidance_scale: Optional[float] = None,
                device="cuda") -> TestbedBundle:
    """The trained models of `ckpt_dir` on `device`, f32."""
    with open(os.path.join(ckpt_dir, "meta.json")) as f:
        meta = json.load(f)
    if guidance_scale is None:
        guidance_scale = float(meta.get("guidance_scale", 7.5))
    cfg = testbed_pipeline_cfg(scale_factor=float(meta["scale_factor"]),
                               num_steps=num_steps, guidance_scale=guidance_scale)
    trees = load_trees(ckpt_dir)
    clip = trees["clip"]
    text = {k[len("text/"):]: v for k, v in clip.items() if k.startswith("text/")}
    sd = StableDiffusion.from_flat(cfg, trees["unet"], trees["vae"], text, device=device)
    clip_loss = DCLIPLoss.from_flat(testbed_clip_cfg(), clip, device=device, normalize=False)
    return TestbedBundle(sd=sd, clip_loss=clip_loss, meta=meta)
