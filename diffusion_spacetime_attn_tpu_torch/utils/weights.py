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
  * the per-head kernels of flax's `MultiHeadDotProductAttention`
    (`query` / `key` / `value` [dim, heads, dh], `out` [heads, dh, dim]) and
    their [heads, dh] biases fold the heads into one Linear
    (`models/encoders.py`);
  * every other leaf keeps its name.

`flax_flat` goes the other way, from a module's tensors to the flat tree
flax writes (`testbed/bundle.py` `save_bundle`).

`bridge` raises on a missing, unexpected, duplicate or mis-shaped key.  It
keeps each value's dtype and makes no host copy where torch can view the
array (a transposed kernel stays a strided view of the file's map);
`load_flat` moves each value to its parameter's device in that dtype and
casts it there, so a float16 or bfloat16 file is never widened on the host.  The
same rules cover the SD trees (UNet, VAE, text tower), the dual-tower
CLIPs (the ViT-B/32 loss CLIP and knn2img's ViT-L/14 joint-space CLIP:
`vision/...`, `text/...`, `class_embedding`, `position_embedding`,
`visual_projection/kernel`, `text_projection/kernel`), the RDM UNet and its
f16 VAE (`pipeline/knn2img.RetrievalAugmentedDiffusion.from_flat`), the
diffusers safety checker's vision tower
(`pipeline/safety.DiffusersSafetyChecker.from_flat`) and the layout
predictor, trained or not (`layout_state_dict`: `backbone/...` with its
`object_embedding` row, `head/...`).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

_AUTO_NAMES = {"GroupNorm_0"}


def _as_tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor over `a`'s memory where torch can view it (writable, non-negative
    strides, a dtype torch has), else over a contiguous copy."""
    if a.flags.writeable:
        try:
            return torch.from_numpy(a)
        except (ValueError, TypeError):
            pass
    return torch.from_numpy(np.array(a, order="C"))


def torch_key(path: str, value):
    """(state-dict key, value in torch layout) of one flat JAX entry (a
    numpy array or a tensor)."""
    parts = [p for p in path.split("/") if p not in _AUTO_NAMES]
    leaf = parts[-1]
    if leaf == "kernel" and value.ndim == 3:   # flax attention: heads folded
        value = (value.reshape(-1, value.shape[-1]) if parts[-2] == "out"
                 else value.reshape(value.shape[0], -1))
        value, leaf = value.T, "weight"
    elif leaf == "bias" and value.ndim == 2:
        value = value.reshape(-1)
    elif leaf == "kernel":
        if value.ndim == 4:
            value = (value.permute(3, 2, 0, 1) if isinstance(value, torch.Tensor)
                     else value.transpose(3, 2, 0, 1))
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
        if not isinstance(arr, torch.Tensor):  # torch keeps bfloat16 leaves
            arr = np.asarray(arr)
        key, value = torch_key(path, arr)
        if key in sd:
            raise KeyError(f"two JAX parameters map to {key!r}")
        sd[key] = value if isinstance(value, torch.Tensor) else _as_tensor(value)
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


def flax_flat(model: nn.Module, tensors: Optional[Dict[str, torch.Tensor]] = None,
              norm_scope: bool = False) -> Dict[str, np.ndarray]:
    """The flat flax tree ("a/b/kernel": float32 array in flax's layout) of
    `model`'s parameters, or of `tensors` keyed like them (an EMA copy):
    Linear weights transposed to [in, out], convolutions permuted to HWIO,
    norm weights named `scale`, `nn.Embedding` weights `embedding`.
    `norm_scope`: the model's `GroupNorm32`s hold their parameters under
    flax's `GroupNorm_0` (the UNet's do; the VAE's are plain flax
    GroupNorms).  Models with per-head attention kernels are not covered."""
    from ..models.layers import GroupNorm32

    values = dict(model.named_parameters()) if tensors is None else tensors
    flat: Dict[str, np.ndarray] = {}
    for mname, m in model.named_modules():
        prefix = mname.replace(".", "/")
        if norm_scope and isinstance(m, GroupNorm32):
            prefix += "/GroupNorm_0"
        for pname, _ in m.named_parameters(recurse=False):
            v = values[f"{mname}.{pname}" if mname else pname].detach().float().cpu()
            if pname == "weight" and isinstance(m, nn.Linear):
                leaf, v = "kernel", v.T
            elif pname == "weight" and isinstance(m, nn.Conv2d):
                leaf, v = "kernel", v.permute(2, 3, 1, 0)
            elif pname == "weight" and isinstance(m, nn.Embedding):
                leaf = "embedding"
            elif pname == "weight" and isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                leaf = "scale"
            else:
                leaf = pname
            flat[f"{prefix}/{leaf}" if prefix else leaf] = np.ascontiguousarray(v.numpy())
    return flat


def load_flat(model: nn.Module, flat: Dict[str, np.ndarray]) -> nn.Module:
    """Load a flat JAX tree into `model`: each value goes to its
    parameter's device in its own dtype and is cast there."""
    state = bridge(flat, model)
    dst = model.state_dict()
    with torch.no_grad():
        for key, value in state.items():
            dst[key].copy_(value.to(dst[key].device).to(dst[key].dtype))
    return model
