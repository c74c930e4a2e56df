"""Checkpoint loading: CompVis `sd-v1-4.ckpt` -> StableDiffusion bundle;
OpenAI CLIP -> the DCLIP loss; fairseq / HF RoBERTa checkpoints -> layout
predictor; port of the JAX package's `utils/loader.py` (and of the entry
points' OpenAI CLIP branch).

With a path the weights come from the file, and a key the file lacks
raises, naming it: nothing is filled with random values.  Without a path
the weights are seeded and random, as the JAX package falls back to.

A trained run dir of the JAX trainer (`scripts/train_layout.py`) holds
`best.json`, `config.json` and an orbax params dir; `saved/layout_gpt3/`
commits the first two, and the params are git-ignored.  The port finds a
run dir as the JAX package does and rebuilds its config, but reads no orbax
params: that needs orbax and tensorstore (ROADMAP A.15).
"""
from __future__ import annotations

import json
import os
from typing import Optional

from ..config import CLIPConfig, LayoutConfig, PipelineConfig
from ..models.layout.model import LayoutPredictor, create_layout_predictor
from ..pipeline.losses import DCLIPLoss
from ..pipeline.pipeline import StableDiffusion
from . import convert
from .weights import flatten_tree, load_flat


def load_stable_diffusion(cfg: PipelineConfig, ckpt_path: Optional[str] = None, seed: int = 0,
                          device="cuda") -> StableDiffusion:
    """The bundle from a CompVis `.ckpt` / `.safetensors` holding
    `model.diffusion_model.*`, `first_stage_model.*` and
    `cond_stage_model.transformer.text_model.*` (other keys are ignored), at
    `cfg`'s widths; each weight is copied to `device` once, in the module's
    compute dtype, and no host copy is kept.  Without a path: seeded random
    weights (`StableDiffusion.create`)."""
    if not ckpt_path:
        return StableDiffusion.create(cfg, seed=seed, device=device)
    state = convert.load_torch_checkpoint(ckpt_path)
    unet = convert.convert_sd_unet(state, channel_mult=cfg.unet.channel_mult,
                                   num_res_blocks=cfg.unet.num_res_blocks,
                                   attention_ds=cfg.unet.attention_resolutions)
    vae = convert.convert_sd_vae(state, ch_mult=cfg.vae.ch_mult,
                                 num_res_blocks=cfg.vae.num_res_blocks)
    text = convert.convert_hf_clip_text(state, prefix="cond_stage_model.transformer.text_model.")
    return StableDiffusion.from_flat(cfg, flatten_tree(unet), flatten_tree(vae),
                                     flatten_tree(text), device=device)


def load_clip_loss(cfg: CLIPConfig, ckpt_path: Optional[str] = None, seed: int = 0,
                   device="cuda") -> DCLIPLoss:
    """The DCLIP loss over OpenAI CLIP weights (`ViT-B-32.pt`, TorchScript or
    a plain state dict) at `cfg`'s widths; without a path, seeded random
    weights (`DCLIPLoss.create`)."""
    if not ckpt_path:
        return DCLIPLoss.create(cfg, seed=seed, device=device)
    tree = convert.convert_openai_clip(convert.load_torch_checkpoint(ckpt_path))
    return DCLIPLoss.from_flat(cfg, flatten_tree(tree), device=device)


def _is_loadable_run_dir(path: str) -> bool:
    """True when `path` is a train_layout.py run dir whose params exist
    (best.json names them; a fresh checkout has best.json without them)."""
    best = os.path.join(path, "best.json")
    if not os.path.isfile(best):
        return False
    try:
        with open(best) as f:
            params_rel = json.load(f).get("params_path", "best_params")
    except (OSError, ValueError):
        return False
    return os.path.exists(os.path.join(path, params_rel))


def find_default_layout_checkpoint() -> Optional[str]:
    """A trained layout run dir (best.json and its params): $DSTA_LAYOUT_CKPT
    if set, else the repo's `saved/layout_gpt3/`; None when absent.  A set
    DSTA_LAYOUT_CKPT that is not loadable raises."""
    env = os.environ.get("DSTA_LAYOUT_CKPT")
    if env:
        if not _is_loadable_run_dir(env):
            raise FileNotFoundError(
                f"DSTA_LAYOUT_CKPT={env} is not a loadable train_layout.py "
                "run dir (best.json + its params_path must exist)")
        return env
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    default = os.path.join(repo_root, "saved", "layout_gpt3")
    return default if _is_loadable_run_dir(default) else None


def load_layout_predictor(cfg: LayoutConfig, ckpt_path: Optional[str] = None, seed: int = 0,
                          device="cuda") -> LayoutPredictor:
    """The model (its config in `model.cfg`).  `ckpt_path`:
      * None: seeded random weights at `cfg`;
      * a torch or safetensors file with `sentence_encoder.*` keys: the
        reference's fairseq Rel2Bbox, the whole model;
      * such a file otherwise: HF RoBERTa under `roberta.` for the backbone,
        the object embedding and the GMM head seeded;
      * a run dir (best.json): its config.json rebuilds the trained config,
        then its orbax params dir raises `NotImplementedError`, as a bare
        params dir does;
      * a path that does not exist: `FileNotFoundError`."""
    if ckpt_path and os.path.isfile(os.path.join(ckpt_path, "best.json")):
        with open(os.path.join(ckpt_path, "best.json")) as f:
            best = json.load(f)
        cfg_file = os.path.join(ckpt_path, "config.json")
        if os.path.isfile(cfg_file):
            with open(cfg_file) as f:
                cfg = LayoutConfig(**json.load(f)["layout"])
        ckpt_path = os.path.join(ckpt_path, best.get("params_path", "best_params"))
    if ckpt_path and os.path.isdir(ckpt_path):
        raise NotImplementedError(
            f"{ckpt_path} (layout {cfg.layers} layers, hidden {cfg.hidden}): the PyTorch "
            "port reads no orbax layout params (ROADMAP A.15)")
    state = convert.load_torch_checkpoint(ckpt_path) if ckpt_path else None
    model = create_layout_predictor(cfg, seed, device)
    if state is not None:
        if any("sentence_encoder." in k for k in state):
            load_flat(model, flatten_tree(convert.convert_fairseq_rel2bbox(state)))
        else:
            flat = flatten_tree(convert.convert_hf_roberta(state, prefix="roberta."))
            flat["object_embedding"] = model.backbone.object_embedding.detach().cpu().numpy()
            load_flat(model.backbone, flat)
    return model
