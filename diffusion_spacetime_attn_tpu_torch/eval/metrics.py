"""Evaluation protocol math: object recall, relation accuracy, layout
consistency, ground-truth parsers and the CLIP fidelity score.

A copy of the JAX package's `eval/metrics.py`; `clip_scores` runs the
port's DCLIP loss.  Reference: `evaluation/detector_result_*.py`
(object recall: a GT object name appears among the detected category names,
conf ≥ 0.4) and `evaluation/relation_result_*.py` (relation accuracy:
box-center geometry, conf ≥ 0.5, `relation_result_gpt.py:95-110`).
`Detection` is the interchange type any detector fills.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..pipeline.frontend import CATEGORY_ALIASES, COCO_CATEGORIES


@dataclasses.dataclass
class Detection:
    box: Tuple[float, float, float, float]  # x1, y1, x2, y2
    category: str
    score: float


def relation_pass(
    relation: str, object1_pos: Sequence[float], object2_pos: Sequence[float]
) -> bool:
    """Center-geometry check (exact reference semantics,
    `relation_result_gpt.py:95-110`)."""
    if relation not in ("below", "left of", "right of", "above"):
        raise ValueError(f"unknown relation {relation!r}")
    x1 = (object1_pos[0] + object1_pos[2]) / 2
    y1 = (object1_pos[1] + object1_pos[3]) / 2
    x2 = (object2_pos[0] + object2_pos[2]) / 2
    y2 = (object2_pos[1] + object2_pos[3]) / 2
    if relation == "below":
        return y1 > y2
    if relation == "left of":
        return x1 < x2
    if relation == "right of":
        return x1 > x2
    return y1 < y2


def object_recall(
    detections_per_image: List[List[Detection]],
    gt_objects_per_image: List[List[str]],
    conf: float = 0.4,
) -> Tuple[int, int, float]:
    """(correct, total, recall): GT object name ∈ detected category names
    (`detector_result_gpt.py:151-166`)."""
    corr = cnt = 0
    for dets, gts in zip(detections_per_image, gt_objects_per_image):
        names = {d.category for d in dets if d.score >= conf}
        for g in gts:
            cnt += 1
            if g in names:
                corr += 1
    return corr, cnt, corr / cnt if cnt else 0.0


def relation_accuracy(
    detections_per_image: List[List[Detection]],
    gt_relations_per_image: List[List[Tuple[str, str, str]]],  # (obj1, obj2, rel)
    conf: float = 0.5,
) -> Tuple[int, int, float]:
    """For each GT (obj1, obj2, rel): both objects detected and the
    highest-scoring detection of each satisfies the relation
    (`relation_result_vsr.py:195-219`)."""
    corr = cnt = 0
    for dets, rels in zip(detections_per_image, gt_relations_per_image):
        dets = [d for d in dets if d.score >= conf]
        by_cat: Dict[str, List[Detection]] = {}
        for d in dets:
            by_cat.setdefault(d.category, []).append(d)
        for o1, o2, rel in rels:
            cnt += 1
            if o1 in by_cat and o2 in by_cat:
                d1 = max(by_cat[o1], key=lambda d: d.score)
                d2 = max(by_cat[o2], key=lambda d: d.score)
                if relation_pass(rel, d1.box, d2.box):
                    corr += 1
    return corr, cnt, corr / cnt if cnt else 0.0


def parse_gpt_ground_truth(path: str) -> Tuple[List[List[str]], List[List[Tuple[str, str, str]]]]:
    """GT objects + relations from `datasets/gpt.txt`
    (`detector_result_gpt.py:119-134`; objects keep only the category head
    noun — the last word of each 'adjective category' phrase)."""
    with open(path) as f:
        rows = f.read().split("\n")[:2000]
    objects, relations = [], []
    for i in range(len(rows) // 4):
        objs = [o.strip() for o in rows[4 * i][9:].split(",")]
        # strip adjectives: keep the trailing category words that match
        clean = []
        for o in objs:
            low = o.lower()
            match = None
            for cat in sorted(COCO_CATEGORIES, key=len, reverse=True):
                if low.endswith(cat):
                    match = cat
                    break
            clean.append(match or low.split()[-1])
        objects.append(clean)
        rel_line = rows[4 * i + 1][10:]
        rel = None
        for r in ("left of", "right of", "above", "below"):
            if f" {r} " in rel_line:
                a, _, b = rel_line.partition(f" {r} ")
                first_is_0 = a.strip().lower().endswith(clean[0])
                rel = (
                    clean[0] if first_is_0 else clean[-1],
                    clean[-1] if first_is_0 else clean[0],
                    r,
                )
                break
        relations.append([rel] if rel else [])
    return objects, relations


def head_category(phrase: str) -> Optional[str]:
    """COCO category head of a noun phrase ('the silver bed' → 'bed'),
    longest-category-first, suffix then interior match
    (`relation_result_vsr.py:141-163` phrase→label convention)."""
    low = phrase.lower()
    names = [(cat, cat) for cat in COCO_CATEGORIES]
    names += [(alias, cat) for alias, cat in CATEGORY_ALIASES.items()]
    for name, cat in sorted(names, key=lambda e: len(e[0]), reverse=True):
        if low.endswith(name) or f" {name} " in f" {low} ":
            return cat
    return None


def layout_relation_consistency(
    pred_centers_per_prompt: List[Optional[Dict[str, Sequence[float]]]],
    gt_relations_per_prompt: List[List[Tuple[str, str, str]]],
) -> Dict[str, float]:
    """Score PREDICTED LAYOUTS (not generated images) against GT relations.

    The image-level relation accuracy (`relation_accuracy` above) measures
    the whole method — layout predictor + diffusion + detector — and is
    honestly 0 while the diffusion weights are random.  This metric isolates
    the layout predictor through the same center-geometry rule
    (`relation_result_gpt.py:95-110`): a GT (obj1, obj2, rel) counts as
    *evaluated* when both categories received a predicted center, and as
    *satisfied* when those centers pass `relation_pass`.  Chance level for
    a non-degenerate predictor is 0.5.

    `pred_centers_per_prompt[i]` maps category → (x, y) predicted center
    for prompt i (None when the frontend found no objects).
    """
    total = evaluated = satisfied = 0
    gt_objs = covered = 0
    for centers, rels in zip(pred_centers_per_prompt, gt_relations_per_prompt):
        centers = centers or {}
        for o1, o2, rel in rels:
            total += 1
            if o1 in centers and o2 in centers:
                evaluated += 1
                c1, c2 = centers[o1], centers[o2]
                if relation_pass(rel, (c1[0], c1[1], c1[0], c1[1]),
                                 (c2[0], c2[1], c2[0], c2[1])):
                    satisfied += 1
        for o1, o2, _ in rels:
            for o in (o1, o2):
                gt_objs += 1
                covered += o in centers
    return {
        "relations_total": total,
        "relations_evaluated": evaluated,
        "relations_satisfied": satisfied,
        "consistency_evaluated": satisfied / evaluated if evaluated else 0.0,
        "consistency_total": satisfied / total if total else 0.0,
        "relation_object_coverage": covered / gt_objs if gt_objs else 0.0,
    }


def parse_pkl_ground_truth(path: str):
    """GT from `datasets/{mscoco,vsr}.pkl`: rows
    [caption, words, obj_word_indices, relations_or_None, noun_phrases]
    (`evaluation/relation_result_vsr.py:141-163`,
    `detector_result_mscoco.py`).  Objects = COCO category head of each noun
    phrase; relations normalized ("at the right side of" → "right of")."""
    import pickle

    with open(path, "rb") as f:
        rows = pickle.load(f)
    objects, relations = [], []
    for row in rows:
        phrases = row[4] or []
        cats = [head_category(p) or p.lower().split()[-1] for p in phrases]
        objects.append(cats)
        obj_word_idx = list(row[2] or [])
        rels = []
        for trip in row[3] or []:
            rel = trip[2]
            if rel == "at the right side of":
                rel = "right of"
            if rel == "at the left side of":
                rel = "left of"
            if rel not in ("above", "below", "left of", "right of"):
                continue
            try:
                a = cats[obj_word_idx.index(trip[0])]
                b = cats[obj_word_idx.index(trip[1])]
            except ValueError:
                continue
            rels.append((a, b, rel))
        relations.append(rels)
    return objects, relations


def result_index(filename: str) -> Optional[int]:
    """prompt index from `final2_s1_index_{i}.png` naming."""
    m = re.match(r"final\d+_s\d+_index_(\d+)\.png$", os.path.basename(filename))
    return int(m.group(1)) if m else None


# ----------------------------------------------------------------------
# CLIP fidelity score (self-contained TPU metric; BASELINE.md parity axis)
# ----------------------------------------------------------------------

def clip_scores(clip_loss, images01: np.ndarray, token_batches: np.ndarray) -> np.ndarray:
    """Cosine similarity between CLIP(global-resized image) and
    CLIP(caption) per image: 1 − the optimization's global loss term, on
    the loss CLIP's device."""
    with torch.inference_mode():
        loss = clip_loss.global_loss(torch.as_tensor(np.asarray(images01, np.float32),
                                                     device=clip_loss._device()),
                                     np.asarray(token_batches, np.int64))
    return 1.0 - loss.float().cpu().numpy()
