"""The testbed's datasets, made on the host (numpy, deterministic); port of
the JAX package's `testbed/data.py`.  For the same seed and size,
`build_dataset` gives JAX's arrays.

Three aligned training sets from one stream of scenes:
  * LDM set: (image, caption with an UNINFORMATIVE relation): the generator
    never learns positions from text, so vanilla relation accuracy is
    chance by construction;
  * CLIP set: (28×28 view, TRUTHFUL caption): global views by the DCLIP
    global resize (×7 nearest + 16 average pool, `plms.py:25-26,41`), local
    views by crop_window + bilinear (`plms.py:256-270`), with the port's
    resize matrices (`pipeline/losses.py`);
  * VAE set: the raw 64×64 images.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..pipeline.losses import _bilinear_matrix, _upsample_avgpool_matrix
from .scenes import (
    MAX_LEN,
    SceneObject,
    caption_pair,
    caption_single,
    heldout_pairs,
    sample_training_scene,
    tokenize,
)


def truthful_relation(a: SceneObject, b: SceneObject) -> str:
    """The relation 'a REL b' that holds, by the dominant axis (the center
    geometry of `eval/metrics.relation_pass`)."""
    dx, dy = a.cx - b.cx, a.cy - b.cy
    if abs(dy) >= abs(dx):
        return "above" if dy < 0 else "below"
    return "left of" if dx < 0 else "right of"


def global_view(images: np.ndarray, up: int = 7, pool: int = 16) -> np.ndarray:
    """`pipeline/losses.global_resize` in numpy ([N, S, S, 3] -> [N, S·7/16, ...])."""
    w = _upsample_avgpool_matrix(images.shape[1], up, pool)
    out = np.einsum("js,nshc->njhc", w, images)
    return np.einsum("kh,njhc->njkc", w, out)


def local_view(image: np.ndarray, cx: float, cy: float, crop_half: float = 0.2,
               out_size: int = 28) -> np.ndarray:
    """crop_window + dynamic_crop + bilinear_resize in numpy."""
    S = image.shape[0]
    size = int(2 * crop_half * S)
    sx = int(np.clip(int(cx * S) - size // 2, 0, S - size))
    sy = int(np.clip(int(cy * S) - size // 2, 0, S - size))
    crop = image[sy:sy + size, sx:sx + size]
    w = _bilinear_matrix(size, out_size)
    out = np.einsum("js,shc->jhc", w, crop)
    return np.einsum("kh,jhc->jkc", w, out)


def build_dataset(n_scenes: int = 8192, seed: int = 0, canvas: int = 64,
                  n_heldout_pairs: int = 20, max_len: int = MAX_LEN,
                  clip_size: int = 28) -> Dict[str, np.ndarray]:
    """uint8 images and int32 tokens: images [N, c, c, 3], ldm_tokens
    [N, L], clip_images [M, s, s, 3], clip_tokens [M, L].  The held-out
    ordered pairs (`scenes.heldout_pairs`) never share a two-object scene."""
    excluded = set(heldout_pairs(n_heldout_pairs))
    rng = np.random.RandomState(seed)
    images: List[np.ndarray] = []
    ldm_tokens: List[np.ndarray] = []
    clip_locals: List[np.ndarray] = []
    clip_local_tokens: List[np.ndarray] = []
    truthful_tokens: List[np.ndarray] = []
    for _ in range(n_scenes):
        img, cap, objs = sample_training_scene(rng, canvas, excluded)
        images.append(img)
        ldm_tokens.append(tokenize(cap, max_len))
        if len(objs) == 1:
            truthful = caption_single(objs[0])
        else:
            truthful = caption_pair(objs[0], objs[1], truthful_relation(objs[0], objs[1]))
        truthful_tokens.append(tokenize(truthful, max_len))
        for o in objs:
            clip_locals.append(local_view(img, o.cx, o.cy, out_size=clip_size))
            clip_local_tokens.append(tokenize(f"a photo of a {o.color} {o.shape}", max_len))
    imgs = np.stack(images)
    clip_images = np.concatenate([global_view(imgs), np.stack(clip_locals)], axis=0)
    clip_tokens = np.concatenate([np.stack(truthful_tokens), np.stack(clip_local_tokens)], axis=0)

    def to_u8(a):
        return np.clip(np.round(a * 255.0), 0, 255).astype(np.uint8)

    return {
        "images": to_u8(imgs),
        "ldm_tokens": np.stack(ldm_tokens).astype(np.int32),
        "clip_images": to_u8(clip_images),
        "clip_tokens": clip_tokens.astype(np.int32),
    }


def cached_dataset(cache_path: Optional[str] = None, **kw) -> Dict[str, np.ndarray]:
    """`build_dataset` behind an npz cache at `cache_path` (about a minute at
    the default 8192 scenes)."""
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            return {k: z[k] for k in z.files}
    ds = build_dataset(**kw)
    if cache_path:
        os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
        np.savez_compressed(cache_path, **ds)
    return ds
