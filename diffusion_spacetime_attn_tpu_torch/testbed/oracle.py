"""Weights-independent oracle detector for testbed scenes, port of the JAX
package's `testbed/oracle.py`.

Pure color/shape thresholding, no learned weights, so its recall and
relation numbers measure the generator, not a detector.  It stands in for
the reference's external detrex DINO (`evaluation/detector_result_gpt.py:95-151`)
and fills `eval.metrics.Detection`, so the protocol math is reused unchanged.

  * color: per-pixel nearest prototype over {bg} ∪ COLORS in RGB, with a
    distance acceptance threshold; confidence is the match purity;
  * shape: bounding-box fill ratio of each 4-connected component — square
    ≈ 1.0, circle ≈ π/4, triangle ≈ 0.5 — cut at the midpoints.

The JAX module labels components with `scipy.ndimage.label`; `label` here
computes the same labels with numpy (each component numbered in raster
order of its first pixel).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..eval.metrics import Detection
from .scenes import COLORS

_COLOR_NAMES = list(COLORS)
_PROTOS = np.asarray([COLORS[c] for c in _COLOR_NAMES], np.float32)  # [4,3]

# fill-ratio cutoffs: triangle 0.5 | circle 0.785 | square 1.0
_TRI_CIRCLE = 0.655
_CIRCLE_SQUARE = 0.885


def label(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """4-connected components of a 2-D boolean mask: (labels, count), with
    0 for background and 1..count in raster order of each component's first
    pixel (`scipy.ndimage.label` with its default structure)."""
    mask = np.asarray(mask, bool)
    big = np.iinfo(np.int64).max
    lab = np.where(mask, np.arange(mask.size, dtype=np.int64).reshape(mask.shape), big)
    while True:
        new = lab.copy()
        np.minimum(new[1:], lab[:-1], out=new[1:])
        np.minimum(new[:-1], lab[1:], out=new[:-1])
        np.minimum(new[:, 1:], lab[:, :-1], out=new[:, 1:])
        np.minimum(new[:, :-1], lab[:, 1:], out=new[:, :-1])
        new = np.where(mask, new, big)
        # jump to the label of the pixel each label names: halves the rounds
        flat = new.ravel()
        new = np.where(mask, flat[np.where(mask, new, 0)], big)
        if np.array_equal(new, lab):
            break
        lab = new
    roots = np.unique(lab[mask])
    out = np.zeros(mask.shape, np.int32)
    out[mask] = np.searchsorted(roots, lab[mask]) + 1
    return out, len(roots)


def detect(image01: np.ndarray, bg: float = 0.72,
           color_slack: float = 0.35, min_area_frac: float = 0.004,
           ) -> List[Detection]:
    """image01: [H, W, 3] in [0,1] → list of eval.metrics.Detection.

    conf = mean color purity of the component (1 − dist/slack clipped), so
    crisp objects score near 1 and mushy blobs drop below the protocol's
    0.4/0.5 thresholds naturally.
    """
    img = np.asarray(image01, np.float32)
    H, W = img.shape[:2]
    d_colors = np.linalg.norm(
        img[None] - _PROTOS[:, None, None], axis=-1)       # [4, H, W]
    d_bg = np.abs(img - bg).mean(-1) * np.sqrt(3.0)        # [H, W]
    nearest = np.argmin(d_colors, axis=0)                  # [H, W]
    best = np.min(d_colors, axis=0)
    fg = (best < d_bg) & (best < color_slack)
    out: List[Detection] = []
    min_area = min_area_frac * H * W
    for ci, cname in enumerate(_COLOR_NAMES):
        mask = fg & (nearest == ci)
        labels, n = label(mask)
        for k in range(1, n + 1):
            comp = labels == k
            area = float(comp.sum())
            if area < min_area:
                continue
            ys, xs = np.nonzero(comp)
            x0, x1 = float(xs.min()), float(xs.max() + 1)
            y0, y1 = float(ys.min()), float(ys.max() + 1)
            fill = area / max((x1 - x0) * (y1 - y0), 1.0)
            if fill < _TRI_CIRCLE:
                shape = "triangle"
            elif fill < _CIRCLE_SQUARE:
                shape = "circle"
            else:
                shape = "square"
            purity = float(np.mean(1.0 - best[comp] / color_slack).clip(0, 1))
            out.append(Detection(
                box=(x0, y0, x1, y1),
                category=f"{cname} {shape}",
                score=purity,
            ))
    return out


def detect_color_only(image01: np.ndarray, **kw) -> List[Detection]:
    """Color-component detections with shape stripped — used for the
    relation metric variant that does not require shape identity."""
    return [Detection(d.box, d.category.split()[0], d.score)
            for d in detect(image01, **kw)]


def oracle_self_check(n: int = 50, seed: int = 0) -> dict:
    """Detector calibration on CLEAN rendered scenes: recall/precision of
    exact (color, shape) identity.  Committed in METHOD_EVAL artifacts so
    the oracle's own ceiling is on record."""
    from .scenes import sample_training_scene

    rng = np.random.RandomState(seed)
    tp = fp = fn = 0
    for _ in range(n):
        img, _, objs = sample_training_scene(rng)
        dets = {d.category for d in detect(img) if d.score >= 0.4}
        gts = {o.category for o in objs}
        tp += len(dets & gts)
        fp += len(dets - gts)
        fn += len(gts - dets)
    return {
        "n_scenes": n,
        "recall": round(tp / max(tp + fn, 1), 4),
        "precision": round(tp / max(tp + fp, 1), 4),
    }
