"""Validation IoU with the reference's semantics (`trainer/iou.py:6-109`);
a numpy copy of the JAX package's `training/iou.py`.

The live model predicts (x, y) centers only, so the layout trainer's
validation metric is the mean center distance (`training/layout_trainer.py`).
This is the full box-IoU calculator for paths that predict (xc, yc, w, h):

  * rows [1::2] carry labels (interleaved legacy layout sequences), and
    sentinel rows (x == 2) are ignored (`iou.py:18-20`);
  * optional de-standardization x·std + mean from the dataset's
    `sta_dict.json` stats (`iou.py:37-45`, `COCODataset.py:219-250`);
  * normalized (xc, yc, w, h) -> pixel xyxy on the reference's fixed
    [800, 600] canvas (`iou.py:47-59`);
  * pairwise IoU summed over boxes with a legal (overlapping) intersection
    (`iou.py:61-109`), including its return-0 guard when nothing overlaps.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

IGNORE = 2.0
CANVAS_WH = (800, 600)  # `iou.py:25-28` pins image_wh=[800,600]


def xcycwh_to_xyxy(boxes: np.ndarray, image_wh=CANVAS_WH) -> np.ndarray:
    b = np.asarray(boxes, np.float64).copy()
    b[:, 0] *= image_wh[0]
    b[:, 1] *= image_wh[1]
    b[:, 2] *= image_wh[0]
    b[:, 3] *= image_wh[1]
    center = b[:, :2].copy()
    b[:, :2] = center - b[:, 2:] / 2.0
    b[:, 2:] = center + b[:, 2:] / 2.0
    return b


def pairwise_iou_sum(bb1: np.ndarray, bb2: np.ndarray) -> float:
    """`get_iou`: Σ IoU over row pairs whose intersection is legal
    (x_right ≥ x_left and y_bottom ≥ y_top); 0 if none or out of range."""
    x_left = np.maximum(bb1[:, 0], bb2[:, 0])
    y_top = np.maximum(bb1[:, 1], bb2[:, 1])
    x_right = np.minimum(bb1[:, 2], bb2[:, 2])
    y_bottom = np.minimum(bb1[:, 3], bb2[:, 3])
    legal = (x_right >= x_left) & (y_bottom >= y_top)
    if not legal.any():
        return 0.0
    inter = (x_right[legal] - x_left[legal]) * (y_bottom[legal] - y_top[legal])
    a1 = (bb1[legal, 2] - bb1[legal, 0]) * (bb1[legal, 3] - bb1[legal, 1])
    a2 = (bb2[legal, 2] - bb2[legal, 0]) * (bb2[legal, 3] - bb2[legal, 1])
    iou = inter / (a1 + a2 - inter)
    total = float(iou.sum())
    n = int(legal.sum())
    if n == 0 or not (0.0 <= total / n <= 1.0):
        return 0.0
    return total


class IOUCalculator:
    """`IOU_calculator` — reduction 'sum' or 'mean'; optional sta_dict for
    standardized targets."""

    def __init__(self, reduction: str = "sum",
                 sta_dict: Optional[Dict[str, float]] = None,
                 sta_path: Optional[str] = None):
        self.reduction = reduction
        if sta_dict is None and sta_path and os.path.exists(sta_path):
            with open(sta_path) as f:
                sta_dict = json.load(f)
        self.sta = sta_dict

    def de_standardize(self, boxes: np.ndarray) -> np.ndarray:
        s = self.sta
        b = np.asarray(boxes, np.float64).copy()
        b[:, 0] = b[:, 0] * s["x_std"] + s["x_mean"]
        b[:, 1] = b[:, 1] * s["y_std"] + s["y_mean"]
        b[:, 2] = b[:, 2] * s["w_std"] + s["w_mean"]
        b[:, 3] = b[:, 3] * s["h_std"] + s["h_mean"]
        return b

    def val_iou(self, pred_boxes, target_boxes, is_std: bool = False) -> float:
        pred = np.asarray(pred_boxes, np.float64).reshape(-1, 4)[1::2]
        target = np.asarray(target_boxes, np.float64).reshape(-1, 4)[1::2]
        keep = target[:, 0] != IGNORE
        pred, target = pred[keep], target[keep]
        if is_std:
            pred, target = self.de_standardize(pred), self.de_standardize(target)
        p = xcycwh_to_xyxy(pred)
        t = xcycwh_to_xyxy(target)
        total = pairwise_iou_sum(p, t)
        if self.reduction == "sum" or len(t) == 0:
            return total
        return total / len(t)
