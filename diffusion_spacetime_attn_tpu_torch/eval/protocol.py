"""The full evaluation protocol as library functions: a results folder of
generated images → detections → object recall / relation accuracy / CLIP
fidelity → one JSON-able dict.

Port of the JAX package's `eval/protocol.py`: the same functions and the
same artifact keys; images are read by `utils/image_io.open_image` and the CLIP
towers are the port's, with OpenAI CLIP weights (`utils/loader.load_clip_loss`)
or seeded random ones.

The reference's visible evaluation output is the pair of printed numbers at
`evaluation/detector_result_gpt.py:164-166` (object recall) and
`evaluation/relation_result_gpt.py` (relation accuracy), computed from an
external detrex DINO-Swin-L detector.  Here the same protocol math
(`eval/metrics.py`) runs over a pluggable detector:

- ``detections.json`` produced anywhere (the faithful route — detrex on a
  GPU box, `scripts/export_detections.py`), or
- the self-contained CLIP grid detector (`eval/clip_detector.py`), a
  calibrated approximation (mechanism ceiling recall@IoU0.5 = 0.95 with an
  oracle classifier, floor = 0.0 with random embeddings —
  `scripts/calibrate_clip_detector.py`, docs/EVALUATION.md).  Any number it
  produces must be read against that calibration AND the provenance of the
  CLIP weights (random weights ⇒ scores are mechanism-only).

`scripts/run_eval_protocol.py` is the CLI over this module.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.image_io import open_image
from .metrics import (
    Detection,
    clip_scores,
    object_recall,
    parse_gpt_ground_truth,
    parse_pkl_ground_truth,
    relation_accuracy,
    result_index,
)

CLIP_DETECTOR_CAVEAT = (
    "CLIP grid detector is a calibrated APPROXIMATION of the reference's "
    "detrex protocol: mechanism ceiling recall@IoU0.5=0.95 (oracle "
    "classifier), floor=0.0 (random embeddings) — "
    "scripts/calibrate_clip_detector.py, docs/EVALUATION.md"
)


def list_result_files(
    results_dir: str,
    prompt_range: Optional[Sequence[int]] = None,
    epoch: Optional[int] = None,
    seed: Optional[int] = None,
) -> List[str]:
    """Result images in reference naming (`final*_s*_index_*.png`), sorted.

    `prompt_range=(lo, hi)` keeps only indices in [lo, hi) — outdirs are
    reused across runs (`run_dataset.py` resumes, never clears), so a
    scorer that globs everything would silently fold a previous run's
    stale images into this run's denominators.

    `epoch` / `seed` filter on the `final{epoch}_s{seed}_` prefix exactly
    like the reference scorer (`detector_result_gpt.py:144` keeps only
    `"final2_s1_"`) — required when runners save per-epoch intermediates
    (`--save-epochs`), which would otherwise multiply the denominators."""
    files = sorted(
        f for f in os.listdir(results_dir) if result_index(f) is not None
    )
    if epoch is not None:
        files = [f for f in files if f.startswith(f"final{epoch}_")]
    if seed is not None:
        files = [f for f in files if f"_s{seed}_" in f]
    if prompt_range is not None:
        lo, hi = prompt_range
        files = [f for f in files if lo <= result_index(f) < hi]
    return files


def load_ground_truth(dataset: str, data_root: str):
    """(gt_objects, gt_relations) per prompt index, reference formats
    (`detector_result_gpt.py:36-93` gpt.txt blocks; pkl rows otherwise)."""
    if dataset == "gpt":
        return parse_gpt_ground_truth(os.path.join(data_root, "gpt.txt"))
    return parse_pkl_ground_truth(os.path.join(data_root, f"{dataset}.pkl"))


def _clip_tokenize(cfg, clip_vocab: Optional[str]):
    from ..utils.tokenizer import make_clip_tokenizer, padded

    return padded(make_clip_tokenizer(clip_vocab, max_len=cfg.text.max_len), cfg.text.max_len)


def build_clip_detector(
    clip_ckpt: Optional[str] = None,
    clip_vocab: Optional[str] = None,
    cfg=None,
    categories: Optional[Sequence[str]] = None,
    device="cuda",
    **detector_kw,
):
    """A `CLIPDetector` over the full CLIP tower on `device`: OpenAI CLIP
    weights from `clip_ckpt` and CLIP's BPE from `clip_vocab`, else seeded
    random weights (seed 11, N(0, 0.02²)) and the hash tokenizer, whose
    scores are mechanism-only (callers must surface that).  Returns
    (detector, weights provenance: the path or "random")."""
    from ..config import CLIPConfig
    from ..pipeline.frontend import COCO_CATEGORIES
    from ..utils.loader import load_clip_loss
    from .clip_detector import CLIPDetector

    cfg = cfg or CLIPConfig()
    clip = load_clip_loss(cfg, clip_ckpt, seed=11, device=device).clip
    det = CLIPDetector(clip, _clip_tokenize(cfg, clip_vocab),
                       categories=categories or COCO_CATEGORIES, **detector_kw)
    return det, clip_ckpt or "random"


def build_clip_loss(
    clip_ckpt: Optional[str] = None,
    clip_vocab: Optional[str] = None,
    cfg=None,
    device="cuda",
):
    """The CLIP-fidelity scorer (`DCLIPLoss`) and its tokenizer, built as
    `build_clip_detector` builds the detector's tower (random weights:
    seed 0).  Returns (clip_loss, tokenize, provenance)."""
    from ..config import CLIPConfig
    from ..utils.loader import load_clip_loss

    cfg = cfg or CLIPConfig()
    return (load_clip_loss(cfg, clip_ckpt, seed=0, device=device),
            _clip_tokenize(cfg, clip_vocab), clip_ckpt or "random")


def read_image01(path: str) -> np.ndarray:
    """A result image -> [H, W, 3] float32 in [0, 1]: JAX's
    `Image.open(path).convert("RGB")` (grey repeated, alpha dropped, a
    palette looked up, 16-bit grey clipped) over 255."""
    return open_image(path, "RGB").astype(np.float32) / 255.0


def detect_folder(
    results_dir: str,
    detector,
    files: Optional[Sequence[str]] = None,
    top_per_category: int = 1,
    log=None,
) -> Dict[str, list]:
    """Run `detector` over every result image → the detections-JSON mapping
    (filename → [[x1, y1, x2, y2, category, score], ...]) that
    JAX package's `scripts/evaluate.py --detections` consumes — so the CLIP route and the
    external-detrex route produce interchangeable artifacts."""
    files = list(files) if files is not None else list_result_files(results_dir)
    out: Dict[str, list] = {}
    for f in files:
        img = read_image01(os.path.join(results_dir, f))
        dets = detector(img, top_per_category=top_per_category)
        out[f] = [
            [float(d.box[0]), float(d.box[1]), float(d.box[2]),
             float(d.box[3]), d.category, float(d.score)]
            for d in dets
        ]
        if log:
            log(f"{f}: {len(out[f])} detections")
    return out


def score_results(
    results_dir: str,
    dataset: str,
    data_root: str,
    detections: Dict[str, list],
    conf_recall: float = 0.4,
    conf_relation: float = 0.5,
    prompt_range: Optional[Sequence[int]] = None,
    epoch: Optional[int] = None,
    seed: Optional[int] = None,
) -> dict:
    """Protocol math over a detections mapping (reference thresholds:
    conf 0.4 for recall `detector_result_gpt.py:115`, 0.5 for relations
    `relation_result_gpt.py:95-110`; epoch/seed filter =
    `detector_result_gpt.py:144`'s "final2_s1_" keep-rule)."""
    gt_objects, gt_relations = load_ground_truth(dataset, data_root)
    files = list_result_files(results_dir, prompt_range, epoch=epoch, seed=seed)
    dets, objs, rels = [], [], []
    for f in files:
        idx = result_index(f)
        if idx >= len(gt_objects):
            raise ValueError(
                f"{f}: prompt index {idx} exceeds {dataset} GT size "
                f"{len(gt_objects)} — stale images from another dataset/run "
                "in this outdir? Pass prompt_range or clean the dir.")
        rows = detections.get(f, [])
        dets.append([Detection(tuple(r[:4]), r[4], r[5]) for r in rows])
        objs.append(gt_objects[idx])
        rels.append(gt_relations[idx])
    corr, cnt, rec = object_recall(dets, objs, conf_recall)
    rc, rn, racc = relation_accuracy(dets, rels, conf_relation)
    return {
        "n_images": len(files),
        "gt_objects": cnt,
        "generated_objects": corr,
        "object_recall": round(rec, 4),
        "relations_correct": rc,
        "relations_total": rn,
        "relation_accuracy": round(racc, 4),
        "conf_recall": conf_recall,
        "conf_relation": conf_relation,
    }


def clip_score_results(
    results_dir: str,
    dataset: str,
    data_root: str,
    clip_loss,
    tokenize,
    prompt_range: Optional[Sequence[int]] = None,
    epoch: Optional[int] = None,
    seed: Optional[int] = None,
) -> dict:
    """Mean CLIP fidelity over (image, prompt) pairs — the BASELINE.json
    north-star metric (reference computes it inside the method at
    `plms.py:204-293`; here it doubles as an offline eval)."""
    from ..pipeline.runners import parse_gpt_prompts, parse_line_prompts

    if dataset == "gpt":
        prompts = parse_gpt_prompts(os.path.join(data_root, "gpt.txt"))
    else:
        prompts = parse_line_prompts(os.path.join(data_root, f"{dataset}.txt"))
    files = list_result_files(results_dir, prompt_range, epoch=epoch, seed=seed)
    scores = []
    for f in files:
        idx = result_index(f)
        if idx >= len(prompts):
            raise ValueError(
                f"{f}: prompt index {idx} exceeds {dataset} prompt count "
                f"{len(prompts)} — stale images in this outdir?")
        img = read_image01(os.path.join(results_dir, f))[None]
        toks = np.asarray(tokenize(prompts[idx]), np.int32)[None]
        scores.append(float(clip_scores(clip_loss, img, toks)[0]))
    return {
        "mean_clip_score": round(float(np.mean(scores)), 4) if scores else None,
        "n_scored": len(scores),
    }
