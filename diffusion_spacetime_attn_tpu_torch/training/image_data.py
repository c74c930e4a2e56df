"""Image dataset pipelines for first-stage / LDM training; port of the JAX
package's `training/image_data.py` (reference `ldm/data/lsun.py` and
`ldm/data/imagenet.py` `ImagePaths`).

A list of image paths (+ optional class labels), each loaded as RGB,
center-cropped square, resized, randomly h-flipped and scaled to [-1, 1]
float32.  Images are opened with `utils/image_io.open_image` (every format
it reads, found by content as Pillow finds it: a folder's extension filter
passes a Targa named `.jpg` on to it) and resized with
`utils/resample.resize`, which equal PIL's, so the arrays, the flips drawn
from the same `random.Random` and the order are JAX's exactly.  `batches()`
yields fixed-shape [B, H, W, 3] (+ [B] int32 labels) numpy arrays, shuffled
per epoch with the tail dropped.
"""
from __future__ import annotations

import dataclasses
import os
import random
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.image_io import open_image
from ..utils.resample import resize

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def load_image(path: str, size: Optional[int], interpolation: str = "bicubic") -> np.ndarray:
    """One image -> center-cropped square, resized, uint8 [H, W, 3]
    (`lsun.py:39-55` score-sde preprocessing)."""
    img = open_image(path, "RGB")
    crop = min(img.shape[0], img.shape[1])
    h, w = img.shape[0], img.shape[1]
    img = img[(h - crop) // 2:(h + crop) // 2, (w - crop) // 2:(w + crop) // 2]
    if size is not None:
        img = resize(np.ascontiguousarray(img), (size, size), interpolation)
    return img


@dataclasses.dataclass
class ImagePathsDataset:
    """LSUNBase / taming ImagePaths equivalent.

    paths: image paths; labels: optional per-path class ids (ImageNet);
    size / interpolation / flip_p as in the reference constructor."""

    paths: List[str]
    size: Optional[int] = 256
    interpolation: str = "bicubic"
    flip_p: float = 0.5
    labels: Optional[List[int]] = None

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int, rng: Optional[random.Random] = None):
        return self._example(i, (rng or random).random() < self.flip_p)

    def _example(self, i: int, flip: bool) -> dict:
        img = load_image(self.paths[i], self.size, self.interpolation)
        if flip:
            img = img[:, ::-1]
        example = {
            "image": (img.astype(np.float32) / 127.5 - 1.0),
            "relative_file_path_": os.path.basename(self.paths[i]),
            "file_path_": self.paths[i],
        }
        if self.labels is not None:
            example["class_label"] = int(self.labels[i])
        return example

    def batches(self, batch_size: int, seed: int = 0, epochs: Optional[int] = None,
                rows: Optional[slice] = None
                ) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Fixed-shape [B, size, size, 3] float32 in [-1, 1] (+ [B] int32
        labels), shuffled per epoch; tail dropped (static shapes).  `rows`:
        only these rows of each batch (a rank's), no other file read; the
        shuffle and the flips are drawn for the whole batch."""
        rng = random.Random(seed)
        epoch = 0
        order = list(range(len(self.paths)))
        while epochs is None or epoch < epochs:
            rng.shuffle(order)
            for s in range(0, len(order) - batch_size + 1, batch_size):
                picks = order[s:s + batch_size]
                flips = [rng.random() < self.flip_p for _ in picks]
                keep = range(len(picks))[rows or slice(None)]
                exs = [self._example(picks[j], flips[j]) for j in keep]
                imgs = np.stack([e["image"] for e in exs])
                labels = (np.asarray([e["class_label"] for e in exs], np.int32)
                          if self.labels is not None else None)
                yield imgs, labels
            epoch += 1


def lsun_split(txt_file: str, data_root: str, size: int = 256, interpolation: str = "bicubic",
               flip_p: float = 0.5) -> ImagePathsDataset:
    """`LSUNBase(txt_file, data_root, ...)` (`lsun.py:10-34`): one relative
    path per line."""
    with open(txt_file) as f:
        rel = f.read().splitlines()
    return ImagePathsDataset(paths=[os.path.join(data_root, l) for l in rel if l], size=size,
                             interpolation=interpolation, flip_p=flip_p)


def imagenet_tree(data_root: str, size: int = 256, flip_p: float = 0.5,
                  synsets: Optional[Sequence[str]] = None) -> ImagePathsDataset:
    """ImageNetTrain / Validation over an extracted tree of
    `{data_root}/{synset}/*.JPEG` directories; class ids are the sorted
    synset index (the reference's `sorted(self.synsets)`)."""
    found = sorted(d for d in os.listdir(data_root)
                   if os.path.isdir(os.path.join(data_root, d))
                   and (synsets is None or d in synsets))
    paths, labels = [], []
    for cls, syn in enumerate(found):
        for f in sorted(os.listdir(os.path.join(data_root, syn))):
            if f.lower().endswith(IMG_EXTS):
                paths.append(os.path.join(data_root, syn, f))
                labels.append(cls)
    return ImagePathsDataset(paths=paths, size=size, flip_p=flip_p, labels=labels)
