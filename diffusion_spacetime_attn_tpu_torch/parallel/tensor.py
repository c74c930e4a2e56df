"""Megatron's two operators over a mesh's model group (tensor parallelism).

JAX's GSPMD derives the collectives of a column-parallel product followed
by a row-parallel one from the sharding annotations (`parallel/sharding.py`
there).  The port writes them out, as Megatron-LM does:

  * `copy_to_model(x)`: the identity forward; the backward all-reduces
    (sums) the cotangent over the model group.  It goes at every input that
    every model rank holds whole and feeds into a column-parallel product
    (the normed activations, a text or local context, `coef`): each rank's
    cotangent is the part from its own heads or hidden features.
  * `reduce_from_model(x)`: the all-reduce (sum) of the rank's partial
    product forward; the identity backward.  It follows every row-parallel
    product.

Both call `dist.all_reduce` on the process group (DTensor's functional
collectives crash with gloo on CUDA tensors).  `STATS` counts the
all-reduces these two issue and their bytes, forward and backward apart.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

STATS = {"fwd": 0, "fwd_bytes": 0, "bwd": 0, "bwd_bytes": 0}


def reset_stats() -> None:
    for k in STATS:
        STATS[k] = 0


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """A module's share of a model-sharded pair: `size` ranks in `group`,
    this one at `index`."""

    group: object
    size: int
    index: int


def _all_reduce(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=group)
    STATS[kind] += 1
    STATS[kind + "_bytes"] += y.numel() * y.element_size()
    return y


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, "bwd"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group, "fwd")

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    """x as it is; its cotangent summed over the model group."""
    return _CopyToModel.apply(x, split.group)


def reduce_from_model(x: torch.Tensor, split: ModelSplit) -> torch.Tensor:
    """The sum of x over the model group; its cotangent as it is."""
    return _ReduceFromModel.apply(x, split.group)
