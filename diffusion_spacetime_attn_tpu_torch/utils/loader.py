"""Layout-predictor checkpoint discovery and loading; port of the layout half
of the JAX package's `utils/loader.py`.

A trained run dir of the JAX trainer (`scripts/train_layout.py`) holds
`best.json`, `config.json` and an orbax params dir; `saved/layout_gpt3/`
commits the first two, and the params are git-ignored.  The port finds a
run dir as the JAX package does and rebuilds its config, but has no reader
for orbax, fairseq `.pth` or HF `.safetensors` checkpoints yet (ROADMAP
A.11): such a path raises.  With no checkpoint the weights are seeded and
random, which is what the JAX package falls back to.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from ..config import LayoutConfig
from ..models.layout.model import LayoutPredictor, create_layout_predictor

_A11 = "the PyTorch port has no reader for {what} yet (ROADMAP A.11)"


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
    """The model (its config in `model.cfg`).  `ckpt_path` None: seeded
    random weights at `cfg`.  A run dir (best.json) rebuilds the trained
    config from its config.json, then raises for its orbax params; a `.pth` / `.pt` /
    `.ckpt` / `.safetensors` file or a bare params dir raises too
    (`NotImplementedError`, ROADMAP A.11)."""
    if ckpt_path and os.path.isfile(os.path.join(ckpt_path, "best.json")):
        with open(os.path.join(ckpt_path, "best.json")) as f:
            best = json.load(f)
        cfg_file = os.path.join(ckpt_path, "config.json")
        if os.path.isfile(cfg_file):
            with open(cfg_file) as f:
                cfg = LayoutConfig(**json.load(f)["layout"])
        ckpt_path = os.path.join(ckpt_path, best.get("params_path", "best_params"))
    if ckpt_path:
        what = ("torch checkpoints (fairseq Rel2Bbox, HF RoBERTa)"
                if ckpt_path.endswith((".pth", ".pt", ".ckpt", ".safetensors"))
                else "orbax layout params")
        raise NotImplementedError(f"{ckpt_path} (layout {cfg.layers} layers, hidden "
                                  f"{cfg.hidden}): " + _A11.format(what=what))
    return create_layout_predictor(cfg, seed, device)
