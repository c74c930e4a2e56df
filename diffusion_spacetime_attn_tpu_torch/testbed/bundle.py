"""The trained testbed models as one bundle, port of `load_bundle` in the JAX
package's `testbed/bundle.py`.

A checkpoint directory holds three parameter trees written by flax's
`msgpack_serialize` (`unet.msgpack`, `vae.msgpack`, `clip.msgpack`) and a
`meta.json` with the VAE's latent scale factor and the calibrated guidance
scale.  The trees are read with the port's own reader (`utils/msgpack.py`)
and loaded through the weight bridge (`utils/weights.py`), which raises on a
missing, unexpected or mis-shaped key.  The trained CLIP's text tower is
also the SD conditioning encoder, and the whole CLIP is the DCLIP judge,
fed [0, 1] images without CLIP's normalization, as it was trained.
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
from ..utils.msgpack import load_flat
from .configs import testbed_clip_cfg, testbed_pipeline_cfg
from .scenes import tokenize as scene_tokenize

TREES = ("unet", "vae", "clip")


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
