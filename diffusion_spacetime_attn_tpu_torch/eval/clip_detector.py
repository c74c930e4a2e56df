"""Self-contained CLIP-based open-vocabulary detection (evaluation fallback);
port of the JAX package's `eval/clip_detector.py`.

The reference evaluates with an external detrex DINO-Swin-L detector on a
separate GPU environment (`evaluation/detector_result_gpt.py`, SURVEY §2.4
notes "substitute CLIP-based open-vocabulary detection" as the TPU-native
alternative).  This module scores a multi-scale grid of crops with the CLIP
image tower against per-category text embeddings ("a photo of a {name}") and
emits `eval.metrics.Detection` records, so recall / relation accuracy can be
computed without the detrex pipeline.  It is an
approximation of the protocol, clearly labeled as such — the detections JSON
path remains the faithful route.

Localization mechanism (calibrated — scripts/calibrate_clip_detector.py,
docs/EVALUATION.md): classification probability alone does NOT localize — a
crop containing a small part of the object and nothing else can classify as
well as the tight box.  And naive center-surround contrast (sim(crop) -
sim(1.5x-expanded crop)) systematically over-sizes: cosine similarity is
second-order FLAT at the tight box (adding a little background barely moves
a near-aligned embedding) while the expanded crop's similarity still falls,
so the contrast keeps rising past the true boundary.  Boxes are therefore
scored by ``prob(category | crop) * (sim(crop) - sim(ring))`` where the
*ring* is the 1.5x-expanded crop with the inner box masked to neutral gray:

- for any box >= the tight box the ring contains no object, so its
  similarity is a constant floor and the score strictly DECREASES as the
  crop dilutes — the peak sits exactly at the tight box;
- for a box inside the object the ring shows the rest of the object, so
  the contrast collapses (and the score tells the refinement to grow);
- the probability factor zeroes boxes that do not actually classify as the
  category, which bare contrast rewards whenever the surround merely gets
  *worse* (e.g. a background crop whose ring clips a different object).

A batched local refinement pass (scale/offset perturbations re-scored by
the same objective) then sharpens past grid quantization.  Reported
confidence is the numerically-stable softmax probability over categories.

The grid, the ring expansion, the softmax and the refinement are the JAX
module's host numpy, copied.  Crops are resized on the host with the port's
half-pixel bilinear matrices (`pipeline/losses._bilinear_matrix`) and
embedded in one batched `CLIP.encode_image` call per scoring call on the
CLIP's device.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..models.clip import CLIP
from ..pipeline.frontend import COCO_CATEGORIES
from ..pipeline.losses import _bilinear_matrix
from .metrics import Detection

DEFAULT_SCALES = (1.0, 0.5, 0.33, 0.25, 0.18)
MASK_FILL = 0.45  # neutral gray for the masked ring interior


def _host_resize(crop: np.ndarray, size: int, cache: dict) -> np.ndarray:
    """[h, w, 3] → [size, size, 3] half-pixel bilinear, pure numpy: two
    small products per crop, so the device sees one fixed-size embedding
    batch per scoring call.  `cache` holds the matrices by (src, size)."""
    h, w = crop.shape[:2]
    for n in (h, w):
        if (n, size) not in cache:
            cache[(n, size)] = _bilinear_matrix(n, size)
    wh, ww = cache[(h, size)], cache[(w, size)]
    # [size,h]@[h,w*3] → [size,w,3];  then contract w with ww.T
    out = (wh @ crop.reshape(h, -1)).reshape(size, w, 3)
    return np.einsum("kw,jwc->jkc", ww, out, optimize=True)


def _grid_boxes(size: int, scales=DEFAULT_SCALES) -> np.ndarray:
    """Multi-scale sliding windows with 50% overlap, as [n, 4] x1y1x2y2."""
    boxes = []
    for s in scales:
        w = int(size * s)
        if w < 32:
            continue
        step = max(w // 2, 1)
        ys = list(range(0, size - w + 1, step))
        if ys[-1] != size - w:  # cover the far edge
            ys.append(size - w)
        for y in ys:
            for x in ys:
                boxes.append((x, y, x + w, y + w))
    return np.asarray(boxes, np.float32)


def _expand_boxes(boxes: np.ndarray, size: int, factor: float = 1.5) -> np.ndarray:
    """Scale each box around its center by `factor`, clipped to the image."""
    cx = (boxes[:, 0] + boxes[:, 2]) / 2
    cy = (boxes[:, 1] + boxes[:, 3]) / 2
    hw = (boxes[:, 2] - boxes[:, 0]) * factor / 2
    hh = (boxes[:, 3] - boxes[:, 1]) * factor / 2
    out = np.stack([cx - hw, cy - hh, cx + hw, cy + hh], axis=-1)
    return np.clip(out, 0, size)


def _stable_softmax(sims: np.ndarray, temp: float = 100.0) -> np.ndarray:
    z = sims * temp
    z = z - z.max(-1, keepdims=True)
    p = np.exp(z)
    return p / p.sum(-1, keepdims=True)


class CLIPDetector:
    def __init__(
        self,
        clip: CLIP = None,              # the port's CLIP, weights inside
        tokenize=None,                  # text → token ids (CLIP)
        categories: Sequence[str] = COCO_CATEGORIES,
        scales=DEFAULT_SCALES,
        embed_crops_fn=None,            # calibration seam: [n,S,S,3]→[n,d]
        text_emb=None,                  # calibration seam: [C,d]
        refine_rounds: int = 5,
        refine_prob_gate: float = 0.10,
        refine_starts: int = 2,
    ):
        """Either pass (clip, tokenize) for the real CLIP scorer, or
        inject (embed_crops_fn, text_emb) — the seam the calibration fixture
        uses to measure the box-selection MECHANISM with an oracle embedder
        (scripts/calibrate_clip_detector.py, docs/EVALUATION.md)."""
        self.clip = clip
        self.categories = list(categories)
        self.scales = scales
        self.refine_rounds = refine_rounds
        self.refine_prob_gate = refine_prob_gate
        self.refine_starts = refine_starts
        self._text_emb = text_emb
        self._resize_cache: dict = {}
        self.embed_calls = 0            # CLIP.encode_image calls (one per scoring call)
        if embed_crops_fn is not None:
            self._embed_crops = embed_crops_fn
            self._tokens = None
            return
        self._tokens = np.stack(
            [np.asarray(tokenize(f"a photo of a {c}"), np.int32) for c in self.categories]
        )
        self._embed_crops = self._clip_embed_crops

    def _device(self):
        return self.clip.visual_projection.weight.device

    @staticmethod
    def _unit(emb: torch.Tensor) -> np.ndarray:
        emb = emb.float()
        emb = emb / torch.clamp(torch.linalg.vector_norm(emb, dim=-1, keepdim=True), min=1e-8)
        return emb.cpu().numpy()

    def _clip_embed_crops(self, crops: np.ndarray) -> np.ndarray:
        """[n, S, S, 3] → unit embeddings [n, d] in one encode_image call."""
        self.embed_calls += 1
        with torch.inference_mode():
            return self._unit(self.clip.encode_image(
                torch.as_tensor(crops, device=self._device())))

    def _text(self) -> np.ndarray:
        if self._text_emb is None:
            with torch.inference_mode():
                self._text_emb = self._unit(self.clip.encode_text(
                    torch.as_tensor(self._tokens, dtype=torch.int64, device=self._device())))
        return np.asarray(self._text_emb)

    # ---- crop embedding, batched per unique crop size ----

    def _vsize(self) -> int:
        return self.clip.cfg.vision.image_size if self.clip is not None else 64

    def _sims(
        self,
        im: np.ndarray,
        boxes: np.ndarray,
        mask_boxes: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """[n, 4] boxes → [n, C] cosine sims.  Crops are assembled on the
        host (grouped by size so the resize + image tower run as a few big
        device batches, not n tiny calls).  With `mask_boxes`, each crop's
        intersection with its mask box is filled with neutral gray — this is
        how ring similarities are computed (boxes=expanded, mask=original)."""
        vsize = self._vsize()
        ib = boxes.astype(int)
        ib[:, 2] = np.maximum(ib[:, 2], ib[:, 0] + 1)
        ib[:, 3] = np.maximum(ib[:, 3], ib[:, 1] + 1)
        text = self._text()
        crops = np.empty((len(boxes), vsize, vsize, 3), np.float32)
        for i, (x1, y1, x2, y2) in enumerate(ib):
            crop = np.array(im[y1:y2, x1:x2], np.float32, copy=True)
            if mask_boxes is not None:
                mx1, my1, mx2, my2 = mask_boxes[i].astype(int)
                # intersection of the mask with this crop, in crop coords
                ax1, ay1 = max(mx1, x1) - x1, max(my1, y1) - y1
                ax2, ay2 = min(mx2, x2) - x1, min(my2, y2) - y1
                if ax2 > ax1 and ay2 > ay1:
                    crop[ay1:ay2, ax1:ax2] = MASK_FILL
            crops[i] = _host_resize(crop, vsize, self._resize_cache)
        emb = np.asarray(self._embed_crops(crops))
        return emb @ text.T

    def _scores(self, im: np.ndarray, boxes: np.ndarray, size: int):
        """Return (score[n, C], sims[n, C]) for the ring-contrast objective:
        prob(category | crop) * (sim(crop) - sim(masked ring))."""
        sims = self._sims(im, boxes)
        ring = self._sims(im, _expand_boxes(boxes, size), mask_boxes=boxes)
        probs = _stable_softmax(sims)
        return probs * (sims - ring), sims

    def _refine(self, im, box: np.ndarray, c: int, size: int):
        """Local search: perturb (scale, dx, dy) around `box` — including
        pure translations (s=1), so an oversized-but-containing box can
        re-center first and then shrink without ever clipping the object
        (clipping raises ring similarity and walls off the greedy descent).
        Re-score by the ring-contrast objective for category c, keep the
        argmax.  Returns (box, final_score)."""
        score = None
        for _ in range(self.refine_rounds):
            w = box[2] - box[0]
            h = box[3] - box[1]
            cx, cy = (box[0] + box[2]) / 2, (box[1] + box[3]) / 2
            cands = [np.clip(box, 0, size)]
            for s in (0.7, 0.85, 1.0, 1.15, 1.4):
                for dx in (-0.2, 0.0, 0.2):
                    for dy in (-0.2, 0.0, 0.2):
                        if s == 1.0 and dx == 0.0 and dy == 0.0:
                            continue  # incumbent already at index 0
                        nw, nh = w * s / 2, h * s / 2
                        ncx, ncy = cx + dx * w, cy + dy * h
                        cands.append(np.clip(np.array(
                            [ncx - nw, ncy - nh, ncx + nw, ncy + nh],
                            np.float32), 0, size))
            cands = np.stack(cands)
            keep = (cands[:, 2] - cands[:, 0] >= 16) & (cands[:, 3] - cands[:, 1] >= 16)
            keep[0] = True  # always keep the incumbent (argmax-0 = converged)
            cands = cands[keep]
            scores, _ = self._scores(im, cands, size)
            best = int(np.argmax(scores[:, c]))
            score = float(scores[best, c])
            if best == 0:  # current box already optimal → converged
                return cands[0], score
            box = cands[best]
        return box, score

    def __call__(self, image01: np.ndarray, top_per_category: int = 1) -> List[Detection]:
        """image01: [S, S, 3] in [0,1] → detections.  Boxes are selected by
        prob-weighted ring contrast and locally refined; `score` is the
        stable softmax probability of the category at the selected crop."""
        size = image01.shape[0]
        boxes = _grid_boxes(size, self.scales)
        im = np.asarray(image01, np.float32)
        scores, sims = self._scores(im, boxes, size)
        probs = _stable_softmax(sims)
        dets: List[Detection] = []
        for c, name in enumerate(self.categories):
            order = np.argsort(-scores[:, c])
            for rank in range(min(top_per_category, len(order))):
                i = order[rank]
                box = boxes[i]
                prob = float(probs[i, c])
                if self.refine_rounds and prob >= self.refine_prob_gate:
                    # multi-start: greedy descent from an oversized grid box
                    # can stall on the containing-but-dilated ridge — refine
                    # the next few grid candidates too, keep the best score
                    starts = order[rank:rank + max(self.refine_starts, 1)]
                    best_box, best_score = None, -np.inf
                    for j in starts:
                        b, s = self._refine(im, boxes[j].copy(), c, size)
                        if s is not None and s > best_score:
                            best_box, best_score = b, s
                    # the emitted (box, score) must co-occur: the refined
                    # box is reported with the prob of ITS crop (carrying the
                    # discarded grid box's higher prob would pass the
                    # protocol's conf gate on a crop it never scored)
                    if best_box is not None:
                        box = best_box
                        prob = float(
                            _stable_softmax(self._sims(im, box[None]))[0, c]
                        )
                dets.append(Detection(tuple(np.asarray(box, np.float32)), name, prob))
        return dets
