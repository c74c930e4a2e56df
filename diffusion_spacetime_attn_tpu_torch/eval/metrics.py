"""Evaluation protocol math: object recall and relation accuracy.

A copy of the part of the JAX package's `eval/metrics.py` (lines 23-88) the
closed-loop testbed scores with.  Reference: `evaluation/detector_result_*.py`
(object recall: a GT object name appears among the detected category names,
conf ≥ 0.4) and `evaluation/relation_result_*.py` (relation accuracy:
box-center geometry, conf ≥ 0.5, `relation_result_gpt.py:95-110`).
`Detection` is the interchange type any detector fills.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple


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
