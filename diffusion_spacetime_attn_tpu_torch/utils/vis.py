"""Layout visualization; port of the JAX package's `utils/vis.py`
(reference `layout_predictor/.../vis.py`): predicted (x, y) centers with
their control circles, drawn with `utils/draw.py` and written with
`utils/png.py` (no imaging library)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from . import draw
from .png import write_png
from .resample import resize

COLORS = [
    (230, 80, 60), (60, 130, 230), (70, 190, 100), (235, 180, 50),
    (170, 90, 220), (60, 200, 200), (240, 130, 180), (150, 150, 150),
]


def draw_layout(layout: Dict[str, Sequence[float]], size: int = 512, radius: float = 0.2,
                image: Optional[np.ndarray] = None) -> np.ndarray:
    """Render {phrase: (x, y)} centers in [0, 1] with their control circles
    over a white canvas or `image` ([H, W, 3] uint8, resized to `size` with
    PIL's default filter); returns [size, size, 3] uint8."""
    if image is not None:
        img = resize(np.ascontiguousarray(image, np.uint8), (size, size))
    else:
        img = np.full((size, size, 3), 255, np.uint8)
    r = radius * size
    for i, (phrase, (x, y)) in enumerate(layout.items()):
        cx, cy = x * size, y * size
        color = COLORS[i % len(COLORS)]
        draw.ellipse(img, [cx - r, cy - r, cx + r, cy + r], outline=color, width=3)
        draw.ellipse(img, [cx - 4, cy - 4, cx + 4, cy + 4], fill=color)
        draw.text(img, (min(cx + 6, size - 60), min(cy + 6, size - 14)), phrase, fill=color)
    return img


def save_layout_vis(layout, path: str, **kw) -> None:
    write_png(path, draw_layout(layout, **kw))
