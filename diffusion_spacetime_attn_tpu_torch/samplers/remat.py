"""Per-evaluation rematerialization for the samplers, port of the JAX
package's `samplers/remat.py`.

`remat=True` wraps each UNet evaluation in
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`: its
activations are dropped after the forward and recomputed in the backward,
so a differentiated 50-step chain holds O(1) evaluations of activations.
The wrapped function may close over tensors that require grad (the blend
weights), whose gradients then flow through the recomputation.  Where no
graph is recorded (no_grad, inference_mode) the evaluation runs as it is:
checkpointing only changes what a backward keeps.  `remat=False` is the
identity.  The JAX package's selective policies ("dots", "dots_nb") have no
counterpart and raise.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def maybe_remat(eps_fn, remat):
    if not remat:
        return eps_fn
    if remat is not True:
        raise NotImplementedError(
            f"remat policy {remat!r}: the PyTorch port checkpoints whole UNet evaluations only")

    def remat_eps_fn(x, t, i):
        if not torch.is_grad_enabled():
            return eps_fn(x, t, i)
        return checkpoint(eps_fn, x, t, i, use_reentrant=False)

    return remat_eps_fn
