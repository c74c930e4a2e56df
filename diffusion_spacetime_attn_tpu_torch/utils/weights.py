"""Weight bridge: a flat JAX parameter tree -> a PyTorch state_dict.

The input is `{"a/b/c": np.ndarray}`: the flax parameter tree flattened with
"/" (e.g. `flax.traverse_util.flatten_dict(params, sep="/")`, or
`utils/msgpack.py` `load_flat` of a file flax wrote).  The port's
modules carry the flax module names, so a path maps to a state-dict key by
four rules:

  * flax's auto-named `GroupNorm_0` inside `GroupNorm32` is dropped (the
    port's `GroupNorm32` holds its parameters itself);
  * `kernel` becomes `weight`: a Dense [in, out] is transposed to
    [out, in], a conv HWIO is permuted to OIHW (this covers the GEGLU
    `_DenseParams`, which store Dense-shaped kernels);
  * `scale` (norms) and `embedding` (`nn.Embed`) become `weight`;
  * every other leaf keeps its name.

`bridge` raises on a missing, unexpected, duplicate or mis-shaped key.  The
same rules cover the SD trees (UNet, VAE, text tower), the dual-tower
loss CLIP (`vision/...`, `text/...`, `class_embedding`,
`position_embedding`, `visual_projection/kernel`, `text_projection/kernel`)
and the layout predictor (`layout_state_dict`: `backbone/...` with its
`object_embedding` row, `head/...`).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

_AUTO_NAMES = {"GroupNorm_0"}


def torch_key(path: str, value: np.ndarray):
    """(state-dict key, value in torch layout) of one flat JAX entry."""
    parts = [p for p in path.split("/") if p not in _AUTO_NAMES]
    leaf = parts[-1]
    if leaf == "kernel":
        if value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)
        elif value.ndim == 2:
            value = value.T
        else:
            raise ValueError(f"{path}: kernel of rank {value.ndim}")
        leaf = "weight"
    elif leaf in ("scale", "embedding"):
        leaf = "weight"
    return ".".join(parts[:-1] + [leaf]), value


def bridge(flat: Dict[str, np.ndarray], model: nn.Module) -> Dict[str, torch.Tensor]:
    """State dict for `model` from a flat JAX tree; raises unless the keys
    and shapes match the model's exactly."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in flat.items():
        if isinstance(arr, torch.Tensor):      # bfloat16 leaves of utils/msgpack.py
            arr = arr.float().numpy()
        key, value = torch_key(path, np.asarray(arr))
        if key in sd:
            raise KeyError(f"two JAX parameters map to {key!r}")
        sd[key] = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
    want = model.state_dict()
    missing = sorted(set(want) - set(sd))
    unexpected = sorted(set(sd) - set(want))
    if missing or unexpected:
        raise KeyError(f"weight bridge: missing {missing[:10]} ({len(missing)}), "
                       f"unexpected {unexpected[:10]} ({len(unexpected)})")
    bad = [(k, tuple(sd[k].shape), tuple(want[k].shape)) for k in want
           if tuple(sd[k].shape) != tuple(want[k].shape)]
    if bad:
        raise ValueError(f"weight bridge: shape mismatches {bad[:10]}")
    return sd


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of arrays (a flax parameter tree as numpy) -> the flat
    "a/b/c" form `bridge` takes."""
    flat: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(flatten_tree(v, path))
        else:
            flat[path] = np.asarray(v)
    return flat


def layout_state_dict(params, model: nn.Module) -> Dict[str, torch.Tensor]:
    """State dict of the port's `LayoutPredictor` from the JAX package's
    layout params (the nested flax tree as numpy): each Dense kernel
    [in, out] transposed to a Linear weight [out, in], `embedding` tables
    and LayerNorm `scale` renamed to `weight` unchanged, and
    `backbone/object_embedding` [1, hidden] kept as it is."""
    return bridge(flatten_tree(params), model)


def load_flat(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Load a flat JAX tree into `model` (values copied to each parameter's
    device and dtype)."""
    model.load_state_dict(bridge(flat, model), strict=True)
    return model
