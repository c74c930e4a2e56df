"""FSDP: weights, gradients and optimizer state sharded over the data axis;
port of the JAX package's `parallel/sharding.py` `fsdp_sharding`.

JAX shards every leaf of the train state along its largest axis that
divides by the data size and lets GSPMD gather each weight where it is
used.  The port uses PyTorch's idiom, `fully_shard` (FSDP2): each block
(`BLOCKS`: a UNet ResBlock or SpatialTransformer, a VAE resnet or attention
block, a RoBERTa layer) and then the root become one unit each, whose
parameters are DTensors sharded on dim 0; a unit's forward all-gathers its
weights and its backward reduce-scatters (averages) their gradients.  The
optimizer then holds its moments, and EMA its copies, as shards of the same
layout (`torch.optim` and `torch._foreach_*` on the local shards).

What has no counterpart, and why:
  * `fsdp_sharding`'s leaf rule (the largest divisible axis, replication of
    an indivisible leaf): FSDP2 shards dim 0 of every parameter, padding the
    last rank's shard.  The layout is not observable in results; what the
    port holds is the numbers and the per-rank state bytes (about 1/data of
    the replicated state).
  * `partition_specs` / `shard_params` (the `model` axis, tensor
    parallelism): ROADMAP A.13b.  The hand-written kernels take whole
    weights (GEGLU's fused `proj_in` holds [h | g], which a plain column
    split would separate), so the model axis needs its own design.

FSDP2 gathers a unit's parameters around its `forward` only.  A module
whose parameters are read by another method (`AutoencoderKL.encode_moments`
/ `decode` read `quant_conv` / `post_quant_conv`) has that method
registered with `register_fsdp_forward_method`; a block is always entered
through its own forward, so every kernel sees whole weights.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

import torch
from torch import nn

from .mesh import Mesh

FORWARD_METHODS = ("encode_moments", "decode")          # AutoencoderKL's; encode calls the first


def _block_types() -> tuple:
    from ..models.layers import ResBlock, SpatialTransformer
    from ..models.layout.roberta import RobertaLayer
    from ..models.vae import VAEAttnBlock, VAEResnetBlock

    return (ResBlock, SpatialTransformer, VAEResnetBlock, VAEAttnBlock, RobertaLayer)


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view of its storage), else t."""
    return t.to_local() if is_sharded(t) else t


def fsdp(module: nn.Module, mesh: Mesh, ignored: Sequence[nn.Parameter] = ()) -> nn.Module:
    """Shard `module` in place over `mesh`'s data axis: one FSDP unit per
    block, then the root; `ignored` parameters stay whole (their gradients
    are the caller's to reduce).  Returns the module."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    dmesh = mesh.device_mesh()
    ignored = set(ignored)
    blocks = _block_types()
    for m in list(module.modules()):
        if m is not module and isinstance(m, blocks):
            fully_shard(m, mesh=dmesh)
    fully_shard(module, mesh=dmesh, ignored_params=ignored or None)
    for name in FORWARD_METHODS:
        if callable(getattr(module, name, None)):
            register_fsdp_forward_method(module, name)
    return module


def state_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """The bytes this rank holds of `tensors` (a DTensor's local shard)."""
    return sum(local(t).numel() * t.element_size() for t in tensors)


def full(t):
    """The whole tensor of a DTensor (a collective: every rank calls it),
    detached; anything else as it is.  The shards are gathered with the
    process group's `all_gather`, each padded to torch.chunk's chunk size:
    DTensor's `full_tensor` takes the functional collectives, which crash
    on gloo with CUDA tensors (torch 2.11)."""
    if not is_sharded(t):
        return t
    import torch.distributed as dist

    (place,) = t.placements
    dim, n = place.dim, t.device_mesh.size()
    part = t.to_local().detach()
    per = -(-t.shape[dim] // n)
    if part.shape[dim] < per:
        pad = list(part.shape)
        pad[dim] = per - part.shape[dim]
        part = torch.cat([part, part.new_zeros(pad)], dim)
    parts = [torch.empty_like(part) for _ in range(n)]
    dist.all_gather(parts, part.contiguous(), group=t.device_mesh.get_group())
    return torch.cat(parts, dim).narrow(dim, 0, t.shape[dim])


def full_tree(tree):
    """`full` over dicts, lists and tuples (a state dict, an optimizer's)."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tree(v) for v in tree)
    return full(tree)


def shard_like(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """`whole` laid out as the DTensor `like` (its placements on its mesh),
    each rank taking its own chunk without communication; a plain `like`
    gets `whole` on its device."""
    if not is_sharded(like):
        return whole.to(device=like.device, dtype=like.dtype)
    from torch.distributed.tensor import DTensor, Shard

    (place,) = like.placements
    if not isinstance(place, Shard):
        raise ValueError(f"shard_like: placement {place}")
    mesh = like.device_mesh
    n, me = mesh.size(), mesh.get_local_rank()
    chunks = list(torch.chunk(whole.to(device=like.device, dtype=like.dtype), n, dim=place.dim))
    part = chunks[me] if me < len(chunks) else whole.narrow(place.dim, 0, 0).to(like.device)
    part = part.contiguous()
    if part.shape != like.to_local().shape:
        raise ValueError(f"shard_like: chunk {tuple(part.shape)} vs local "
                         f"{tuple(like.to_local().shape)}")
    return DTensor.from_local(part, mesh, like.placements, shape=like.shape,
                              stride=like.stride(), run_check=False)


def load_full_(module: nn.Module, state: Dict[str, torch.Tensor]) -> None:
    """Copy whole tensors (a one-device state dict) into `module`'s
    parameters and buffers, sharded or not."""
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"load_full_: missing {missing[:5]}")
    with torch.no_grad():
        for k, t in own.items():
            local(t).copy_(local(shard_like(state[k], t)))


def shard_views(params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Plain tensors aliasing each parameter's local storage (a DTensor's
    local shard, else the parameter itself), for a `torch.optim` optimizer:
    it then runs fused on the card and its ops skip DTensor's dispatch."""
    return [local(p.detach()) for p in params]


def bind_grads_(views: Sequence[torch.Tensor], params: Sequence[torch.Tensor]) -> None:
    """Point each view at its parameter's current local storage and its
    local gradient (None where the parameter has none): call before the
    optimizer over `views` steps."""
    for v, p in zip(views, params):
        v.data = local(p.detach())
        v.grad = None if p.grad is None else local(p.grad)


def moments(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor],
            views: Sequence[torch.Tensor]) -> List:
    """(parameter, tensor) for each per-parameter tensor of the state of
    `opt` over `views = shard_views(params)` (Adam's moments): this rank's
    shard of its parameter's layout."""
    return [(p, t) for p, v in zip(params, views) for t in opt.state.get(v, {}).values()
            if torch.is_tensor(t) and t.dim() > 0]


def _layout_as(t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A local shard `t` of parameter `p`'s layout as a DTensor like `p`;
    t itself when p is whole."""
    if not is_sharded(p):
        return t
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, p.device_mesh, p.placements, shape=p.shape, stride=p.stride(),
                              run_check=False)


def _per_param(state: dict, params: Sequence[torch.Tensor], shape_of, fn) -> dict:
    """`fn(v, p)` on every per-parameter tensor of a `torch.optim` state dict
    (a tensor of `shape_of(p)`, not a scalar like Adam's step count)."""
    out = {}
    for idx, st in state["state"].items():
        p = params[int(idx)]
        out[idx] = {k: (fn(v, p) if torch.is_tensor(v) and v.dim() > 0
                        and tuple(v.shape) == tuple(shape_of(p)) else v)
                    for k, v in st.items()}
    return {"state": out, "param_groups": state["param_groups"]}


def optimizer_state_full(opt: torch.optim.Optimizer, params: Sequence[torch.Tensor]) -> dict:
    """The state dict of an optimizer over `shard_views(params)` with whole
    tensors (FSDP shards gathered: a collective), as one device's."""
    return _per_param(opt.state_dict(), params, lambda p: local(p).shape,
                      lambda v, p: full(_layout_as(v, p)))


def optimizer_state_like(whole: dict, params: Sequence[torch.Tensor]) -> dict:
    """A state dict of whole tensors (one device's, or
    `optimizer_state_full`'s) with each per-parameter tensor cut to this
    rank's shard of its parameter, for the optimizer over
    `shard_views(params)`."""
    return _per_param(whole, params, lambda p: p.shape,
                      lambda v, p: local(shard_like(v, p)))


def grad_norm_sq(grads: Sequence[torch.Tensor], mesh: Optional[Mesh]) -> torch.Tensor:
    """Σ‖g‖² over `grads`: a sharded gradient's local shards summed over the
    ranks, a whole (replicated) one counted once."""
    import torch.distributed as dist

    sharded = [local(g) for g in grads if is_sharded(g)]
    whole = [g for g in grads if not is_sharded(g)]
    total = torch.zeros((), dtype=torch.float32, device=local(grads[0]).device)
    if sharded:
        part = torch.stack(torch._foreach_norm(sharded)).float().pow(2).sum()
        if mesh is not None:
            dist.all_reduce(part)
        total = total + part
    if whole:
        total = total + torch.stack(torch._foreach_norm(whole)).float().pow(2).sum()
    return total
