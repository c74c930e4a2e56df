"""Synthetic colored-shape scenes, the testbed's data layer: a copy of the JAX
package's `testbed/scenes.py` (numpy only), so the port's eval prompts,
tokens and rendered scenes equal the reference's.

Design: 12 object categories = {red, green, blue,
yellow} × {circle, square, triangle} rendered on a gray canvas with 2×
supersampled antialiasing.  Two caption families:

  * single-object:  "a photo of a {color} {shape}"        (object anywhere)
  * two-object:     "a {c1} {s1} {rel} a {c2} {s2}"       (rel ∈ RELATIONS)

In TRAINING scenes the relation word is drawn UNIFORMLY AT RANDOM,
independent of the actual layout, so the text carries no positional
information and vanilla relation accuracy is chance; what the spacetime
optimization adds on top is the paper's mechanism (reference
`plms.py:249-273`).  Held-out pairs never co-occur in training scenes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

COLORS: Dict[str, Tuple[float, float, float]] = {
    "red": (0.85, 0.10, 0.10),
    "green": (0.10, 0.75, 0.15),
    "blue": (0.10, 0.20, 0.85),
    "yellow": (0.90, 0.85, 0.10),
}
SHAPES = ("circle", "square", "triangle")
CATEGORIES = [f"{c} {s}" for c in COLORS for s in SHAPES]  # 12
RELATIONS = ("above", "below", "left of", "right of")
BG = 0.72  # gray canvas

# word-level vocabulary; PAD=0, EOT = highest id (CLIPTextTower pools the
# ARGMAX token id — models/clip.py:122-124 — so EOT must be the max)
_WORDS = (
    ["<pad>"]
    + sorted({"a", "photo", "of", "and", "next", "to",
              "above", "below", "left", "right",
              *COLORS.keys(), *SHAPES})
    + ["<eot>"]
)
WORD_TO_ID = {w: i for i, w in enumerate(_WORDS)}
VOCAB_SIZE = len(_WORDS)
EOT_ID = VOCAB_SIZE - 1
MAX_LEN = 12  # "a red circle right of a blue square" = 8 words + eot


def tokenize(caption: str, max_len: int = MAX_LEN) -> np.ndarray:
    ids = [WORD_TO_ID[w] for w in caption.lower().split()]
    ids = ids[: max_len - 1] + [EOT_ID]
    return np.asarray(ids + [0] * (max_len - len(ids)), np.int32)


# ----------------------------------------------------------------------
# rendering
# ----------------------------------------------------------------------

def _render_mask(shape: str, size: int, canvas: int, cx: float, cy: float
                 ) -> np.ndarray:
    """Boolean mask [canvas, canvas] of one shape (center cx, cy in pixels,
    nominal diameter `size`), drawn at 2× and box-downsampled (antialias)."""
    s = 2  # supersample
    C = canvas * s
    yy, xx = np.mgrid[0:C, 0:C]
    x, y, r = cx * s, cy * s, size * s / 2.0
    if shape == "circle":
        m = (xx - x) ** 2 + (yy - y) ** 2 <= r * r
    elif shape == "square":
        m = (np.abs(xx - x) <= r) & (np.abs(yy - y) <= r)
    else:  # upward triangle with the same bounding box
        # vertices: (x, y-r), (x-r, y+r), (x+r, y+r)
        u = (yy - (y - r)) / (2.0 * r + 1e-9)       # 0 at apex → 1 at base
        m = (yy >= y - r) & (yy <= y + r) & (np.abs(xx - x) <= r * u)
    m = m.astype(np.float32).reshape(canvas, s, canvas, s).mean(axis=(1, 3))
    return m


@dataclasses.dataclass
class SceneObject:
    color: str
    shape: str
    cx: float  # normalized [0,1]
    cy: float
    size: float  # diameter in normalized units

    @property
    def category(self) -> str:
        return f"{self.color} {self.shape}"


def render_scene(objects: Sequence[SceneObject], canvas: int = 64,
                 bg: float = BG) -> np.ndarray:
    """[canvas, canvas, 3] float32 in [0,1]."""
    img = np.full((canvas, canvas, 3), bg, np.float32)
    for o in objects:
        m = _render_mask(o.shape, o.size * canvas, canvas,
                         o.cx * canvas, o.cy * canvas)[..., None]
        img = img * (1.0 - m) + m * np.asarray(COLORS[o.color], np.float32)
    return img


# ----------------------------------------------------------------------
# scene sampling
# ----------------------------------------------------------------------

def heldout_pairs(n: int = 20, seed: int = 1234) -> List[Tuple[str, str]]:
    """Fixed ordered (catA, catB) pairs excluded from two-object TRAINING
    scenes (deterministic across the training and evaluation scripts)."""
    rng = np.random.RandomState(seed)
    pairs = [(a, b) for a in CATEGORIES for b in CATEGORIES if a != b]
    idx = rng.permutation(len(pairs))[:n]
    return [pairs[i] for i in idx]


def _sample_object(rng, category: Optional[str] = None,
                   size_range=(0.18, 0.42)) -> SceneObject:
    cat = category or CATEGORIES[rng.randint(len(CATEGORIES))]
    color, shape = cat.split()
    size = rng.uniform(*size_range)
    half = size / 2.0
    return SceneObject(
        color, shape,
        cx=rng.uniform(half + 0.02, 0.98 - half),
        cy=rng.uniform(half + 0.02, 0.98 - half),
        size=size,
    )


def _overlap(a: SceneObject, b: SceneObject) -> bool:
    return (abs(a.cx - b.cx) < (a.size + b.size) / 2.0 + 0.04
            and abs(a.cy - b.cy) < (a.size + b.size) / 2.0 + 0.04)


def caption_single(o: SceneObject) -> str:
    return f"a photo of a {o.color} {o.shape}"


def caption_pair(a: SceneObject, b: SceneObject, rel: str) -> str:
    return f"a {a.color} {a.shape} {rel} a {b.color} {b.shape}"


def sample_training_scene(rng, canvas: int = 64,
                          excluded_pairs: Optional[set] = None):
    """→ (image [canvas,canvas,3], caption, objects).

    50% single-object, 50% two-object.  Two-object captions use a relation
    word drawn INDEPENDENTLY of the layout (see module docstring)."""
    if rng.rand() < 0.5:
        o = _sample_object(rng)
        return render_scene([o], canvas), caption_single(o), [o]
    for _ in range(64):
        a = _sample_object(rng, size_range=(0.18, 0.34))
        b = _sample_object(rng, size_range=(0.18, 0.34))
        if a.category == b.category or _overlap(a, b):
            continue
        if excluded_pairs and ((a.category, b.category) in excluded_pairs
                               or (b.category, a.category) in excluded_pairs):
            continue
        rel = RELATIONS[rng.randint(len(RELATIONS))]  # uninformative!
        return render_scene([a, b], canvas), caption_pair(a, b, rel), [a, b]
    # overlap rejection exhausted (vanishingly rare) — fall back to single
    o = _sample_object(rng)
    return render_scene([o], canvas), caption_single(o), [o]


def make_training_batch(rng, batch: int, canvas: int = 64,
                        excluded_pairs: Optional[set] = None,
                        max_len: int = MAX_LEN):
    imgs, toks = [], []
    for _ in range(batch):
        img, cap, _ = sample_training_scene(rng, canvas, excluded_pairs)
        imgs.append(img)
        toks.append(tokenize(cap, max_len))
    return np.stack(imgs), np.stack(toks)


# ----------------------------------------------------------------------
# evaluation prompts
# ----------------------------------------------------------------------

def relation_layout(rel: str) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """Deterministic GT layout centers for "A rel B" (the testbed's stand-in
    for the layout predictor, which is evaluated separately in
    LAYOUT_EVAL_*.json; reference geometry rule `relation_result_gpt.py:95-110`
    — A above B ⇔ centerA.y < centerB.y etc.)."""
    return {
        "above": ((0.5, 0.28), (0.5, 0.72)),
        "below": ((0.5, 0.72), (0.5, 0.28)),
        "left of": ((0.28, 0.5), (0.72, 0.5)),
        "right of": ((0.72, 0.5), (0.28, 0.5)),
    }[rel]


@dataclasses.dataclass
class EvalPrompt:
    caption: str
    cat_a: str
    cat_b: str
    rel: str
    held_out: bool   # (cat_a, cat_b) pair excluded from two-object training

    @property
    def centers(self):
        return relation_layout(self.rel)


def make_eval_prompts(n: int = 100, seed: int = 777,
                      n_heldout_pairs: int = 20) -> List[EvalPrompt]:
    """Deterministic eval set: `n` prompts sampled over (pair, relation)
    combos, upweighting held-out pairs so both splits have support."""
    held = heldout_pairs(n_heldout_pairs)
    held_set = set(held)
    rng = np.random.RandomState(seed)
    all_pairs = [(a, b) for a in CATEGORIES for b in CATEGORIES if a != b]
    seen_pairs = [p for p in all_pairs if p not in held_set]
    prompts: List[EvalPrompt] = []
    for i in range(n):
        if i % 4 == 3:  # 25% held-out pairs
            a, b = held[rng.randint(len(held))]
            ho = True
        else:
            a, b = seen_pairs[rng.randint(len(seen_pairs))]
            ho = False
        rel = RELATIONS[rng.randint(len(RELATIONS))]
        ca, sa = a.split()
        cb, sb = b.split()
        prompts.append(EvalPrompt(
            caption=f"a {ca} {sa} {rel} a {cb} {sb}",
            cat_a=a, cat_b=b, rel=rel, held_out=ho))
    return prompts
