"""Compare two result folders image by image (numerics drift A/B); port of
the JAX package's `scripts/compare_outputs.py`, reading the PNGs with
`utils/image_io.open_image` (as RGB, as the JAX script's PIL
`convert("RGB")` does).

    python -m diffusion_spacetime_attn_tpu_torch.scripts.compare_outputs DIR_A DIR_B [--json]

Matches files by name and reports per-image MAE and max |diff| in [0, 1]
pixel units, then one JSON summary line (the only line with `--json`).
Exit code 1 when the folders share no PNG or a shared one differs in shape.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..utils.image_io import open_image


def load_dir(d: str) -> dict:
    return {name: open_image(os.path.join(d, name), "RGB").astype(np.float32) / 255.0
            for name in sorted(os.listdir(d)) if name.endswith(".png")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--json", action="store_true", help="one JSON line only")
    args = ap.parse_args(argv)
    a, b = load_dir(args.dir_a), load_dir(args.dir_b)
    common = sorted(set(a) & set(b))
    if not common:
        print(f"no common .png files between {args.dir_a} and {args.dir_b}", file=sys.stderr)
        return 1
    rows = []
    for name in common:
        if a[name].shape != b[name].shape:
            print(f"shape mismatch for {name}: {a[name].shape} vs {b[name].shape}",
                  file=sys.stderr)
            return 1
        diff = np.abs(a[name] - b[name])
        rows.append((name, float(diff.mean()), float(diff.max())))
    maes = [r[1] for r in rows]
    maxes = [r[2] for r in rows]
    summary = {
        "n_images": len(rows),
        "only_in_a": len(set(a) - set(b)),
        "only_in_b": len(set(b) - set(a)),
        "mean_mae": float(np.mean(maes)),
        "worst_mae": float(np.max(maes)),
        "mean_maxdiff": float(np.mean(maxes)),
        "worst_maxdiff": float(np.max(maxes)),
        "unit": "pixel fraction of [0,1]",
    }
    if not args.json:
        for name, mae, mx in rows:
            print(f"{name}: mae={mae:.6f} max={mx:.6f}")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
