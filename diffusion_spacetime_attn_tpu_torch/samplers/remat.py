"""Per-evaluation rematerialization for the samplers, port of the JAX
package's `samplers/remat.py`.

`remat` accepts:
  False       — no checkpointing: the identity.
  True        — each UNet evaluation under
                `torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`:
                its activations are dropped after the forward and recomputed
                in the backward, so a differentiated 50-step chain holds O(1)
                evaluations of activations.
  a policy    — selective checkpointing
                (`torch.utils.checkpoint.create_selective_checkpoint_contexts`):
                the named matmul outputs are kept from the forward, and the
                recompute replays them instead of computing them again,
                trading memory for backward work.  "dots" keeps every matmul
                (`mm`, `addmm`, `bmm`, `baddbmm`: JAX's `dots_saveable`);
                "dots_nb" the matmuls without batch dims (`mm`, `addmm`: the
                projections, JAX's `dots_with_no_batch_dims_saveable`).
                Convolutions are recomputed under both, as in JAX.  The CUDA
                kernels are not aten ops: under every policy they run again
                in the recompute, as under `True`.

The wrapped function may close over tensors that require grad (the blend
weights), whose gradients then flow through the recomputation.  Where no
graph is recorded (no_grad, inference_mode) the evaluation runs as it is:
checkpointing only changes what a backward keeps.  Any other value raises.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

_aten = torch.ops.aten
_NO_BATCH_DOTS = (_aten.mm.default, _aten.addmm.default)
POLICIES = {
    "dots": _NO_BATCH_DOTS + (_aten.bmm.default, _aten.baddbmm.default),
    "dots_nb": _NO_BATCH_DOTS,
}


def maybe_remat(eps_fn, remat):
    if not remat:
        return eps_fn
    if remat is True:
        kwargs = {}
    elif isinstance(remat, str) and remat in POLICIES:
        kwargs = {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                                  list(POLICIES[remat]))}
    else:
        raise ValueError(f"remat {remat!r}: True, False or one of the policies "
                         f"{sorted(POLICIES)}")

    def remat_eps_fn(x, t, i):
        if not torch.is_grad_enabled():
            return eps_fn(x, t, i)
        return checkpoint(eps_fn, x, t, i, use_reentrant=False, **kwargs)

    return remat_eps_fn
