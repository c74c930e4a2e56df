"""Parameter sharding over the mesh; port of the JAX package's
`parallel/sharding.py`: Megatron tensor parallelism over the model axis
(`partition_specs`, `shard_params`) and FSDP over the data axis
(`fsdp_sharding`).

**The model axis.**  JAX annotates the parameters (`partition_specs`: the
first linear of each attention and MLP pair column-parallel, the second
row-parallel, everything else replicated) and GSPMD partitions the program.
The port does the same split by hand: `shard_params(module, mesh)` slices
each pair's weights in place to this rank's share and marks the owning
module (`model_split`), whose forward then computes its share and joins the
ranks with `parallel/tensor.py`'s `copy_to_model` (at the pair's input) and
`reduce_from_model` (after the row-parallel product, before its bias).  The
pairs are the UNet's attention (`to_q`, `to_k`, `to_v` | `to_out`) and GEGLU
MLP (`proj_in` | `proj_out`), and the CLIP towers' attention (`q_proj`,
`k_proj`, `v_proj` | `out_proj`) and MLP (`fc1` | `fc2`).  PyTorch's
`Linear.weight` is [out, in]: "column" slices its rows (and the bias with
them), "row" its columns (the bias stays whole and is added once, after
the reduce).  Where the port differs from GSPMD:

  * heads-aligned: rank m holds heads [m·H/M, (m+1)·H/M) of q, k and v and
    the matching input columns of the output projection, so every attention
    kernel runs unchanged on the rank's heads.
  * GEGLU's fused `proj_in` holds [h | g]; rank m takes [h_m | g_m] (rows
    m·F/M.. of h and F + m·F/M.. of g), not JAX's contiguous column block,
    which at M = 2 gives rank 0 all of h and rank 1 all of g (GSPMD
    reshards that; the kernel cannot take it).  The GEGLU kernel runs with
    a zero b2 and no residual; b2 and the residual are added on every rank
    after the reduce, so their cotangents reach every rank.
  * the collectives are explicit: one all-reduce per pair in the forward
    (its `reduce_from_model`; three per transformer block), and in the
    backward one per input taken whole that needs a gradient (the block's
    three normed inputs, and coef at a controlled cross-attention).
  * demotion: where JAX's `constrain` demotes a dimension that the model
    axis does not divide to None, the port keeps the whole pair on every
    rank (heads % M, F % M, and F/M % 8 for the bf16 GEGLU kernel).

`partition_specs` gives each parameter's spec in the torch layout, by the
rules alone as JAX's does; `shard_params` applies them where they divide;
`model_state_dict` / `model_grads` gather the whole tensors back (for
checkpoints and the tests).

**The data axis (FSDP).**  JAX shards every leaf of the train state along
its largest axis that divides by the data size and lets GSPMD gather each
weight where it is used.  The port uses PyTorch's idiom, `fully_shard`
(FSDP2) over the data group: each block (`BLOCKS`: a UNet ResBlock or
SpatialTransformer, a VAE resnet or attention block, a RoBERTa layer) and
then the root become one unit each, whose parameters are DTensors sharded
on dim 0; a unit's forward all-gathers its weights and its backward
reduce-scatters (averages) their gradients.  The optimizer then holds its
moments, and EMA its copies, as shards of the same layout (`torch.optim`
and `torch._foreach_*` on the local shards).  `fsdp_sharding`'s leaf rule
(the largest divisible axis, replication of an indivisible leaf) has no
counterpart: FSDP2 shards dim 0 of every parameter, padding the last
rank's shard.  The layout is not observable in results; what the port
holds is the numbers and the per-rank state bytes (about 1/data of the
replicated state).  The trainers replicate over the model axis, as JAX's
do.

FSDP2 gathers a unit's parameters around its `forward` only.  A module
whose parameters are read by another method (`AutoencoderKL.encode_moments`
/ `decode` read `quant_conv` / `post_quant_conv`) has that method
registered with `register_fsdp_forward_method`; a block is always entered
through its own forward, so every kernel sees whole weights.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from .mesh import Mesh
from .tensor import ModelSplit

COLUMN, ROW = ("model", None), (None, "model")
_HALVES = "halves"      # GEGLU's proj_in: column-parallel within each of [h | g]


def _pair(m: nn.Module) -> Optional[Tuple[int, Dict[str, str]]]:
    """(the units the model axis splits, {child: "column" | "row" |
    "halves"}) of a module that owns a Megatron pair, else None."""
    from ..models.clip import CLIPMLP, CLIPAttention
    from ..models.layers import CrossAttention, GEGLUFeedForward

    if isinstance(m, CrossAttention):
        return m.heads, {"to_q": "column", "to_k": "column", "to_v": "column", "to_out": "row"}
    if isinstance(m, CLIPAttention):
        return m.heads, {"q_proj": "column", "k_proj": "column", "v_proj": "column",
                         "out_proj": "row"}
    if isinstance(m, GEGLUFeedForward):
        return m.proj_out.in_features, {"proj_in": _HALVES, "proj_out": "row"}
    if isinstance(m, CLIPMLP):
        return m.fc2.in_features, {"fc1": "column", "fc2": "row"}
    return None


def _splits(m: nn.Module, units: int, size: int) -> bool:
    """Whether the pair of `m` (`units` heads or hidden features) splits over
    `size` model ranks: units % size, and for the bf16 GEGLU kernel a
    per-rank width that is a multiple of 8 (`ops/cuda_geglu.geglu_design`)."""
    from ..models.layers import GEGLUFeedForward

    if units % size:
        return False
    if isinstance(m, GEGLUFeedForward) and m.fused and m.dtype == torch.bfloat16:
        return (units // size) % 8 == 0
    return True


def _pair_params(module: nn.Module):
    """(parameter name, kind, owner) of each weight, and each column
    bias, of every Megatron pair in `module`."""
    for name, m in module.named_modules():
        pair = _pair(m)
        if pair is None:
            continue
        for child, kind in pair[1].items():
            pre = f"{name}.{child}" if name else child
            yield pre + ".weight", kind, m
            if kind != "row" and getattr(m, child).bias is not None:
                yield pre + ".bias", kind, m


def partition_specs(module: nn.Module) -> Dict[str, tuple]:
    """{parameter name: spec} in the torch layout, by the rules alone (as
    JAX's `partition_specs`, which does not look at divisibility): a
    column-parallel weight ("model", None) and its bias ("model",), a
    row-parallel weight (None, "model"), everything else () (replicated,
    the row-parallel biases too)."""
    specs = {name: () for name, _ in module.named_parameters()}
    for name, kind, _ in _pair_params(module):
        specs[name] = ROW if kind == "row" else COLUMN if name.endswith("weight") else ("model",)
    return specs


def _cut(kind: str) -> Tuple[int, int]:
    """(dim, halves) of a pair parameter of `kind`: rows of a column weight
    (and its bias), columns of a row weight, each half of [h | g] apart."""
    return (1 if kind == "row" else 0), (2 if kind == _HALVES else 1)


def _take(t: torch.Tensor, dim: int, halves: int, size: int, index: int) -> torch.Tensor:
    """Rank `index`'s share of t along dim: block `index` of `size` in each
    of its `halves` equal halves, concatenated."""
    return torch.cat([h.chunk(size, dim)[index] for h in t.chunk(halves, dim)], dim)


def model_sharded(module: nn.Module) -> Dict[str, Tuple[int, int, ModelSplit]]:
    """{parameter name: (dim, halves, split)} of every parameter of `module`
    that `shard_params` cut: along dim, block split.index of split.size in
    each of its `halves` equal halves."""
    return {name: (*_cut(kind), m.model_split)
            for name, kind, m in _pair_params(module) if m.model_split is not None}


def shard_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Slice every Megatron pair of `module` (whole weights, equal on every
    rank) in place to this rank's share over `mesh`'s model axis and mark
    its owner (`model_split`); a pair the model axis does not divide stays
    whole.  A no-op where model is 1 or the module is sharded already.
    Returns the module."""
    if mesh.model == 1:
        return module
    split = ModelSplit(mesh.model_group, mesh.model, mesh.model_index)
    owners: Dict[nn.Module, list] = {}
    for name, kind, m in _pair_params(module):
        owners.setdefault(m, []).append((name, kind))
    with torch.no_grad():
        for m, params in owners.items():
            if m.model_split is not None or not _splits(m, _pair(m)[0], mesh.model):
                continue
            for name, kind in params:
                path, attr = name.rsplit(".", 1)
                lin = module.get_submodule(path)
                p = getattr(lin, attr)
                setattr(lin, attr, nn.Parameter(
                    _take(p, *_cut(kind), mesh.model, mesh.model_index).contiguous(),
                    requires_grad=p.requires_grad))
                lin.out_features, lin.in_features = lin.weight.shape
            m.model_split = split
    return module


def model_shard(module: nn.Module, name: str, whole: torch.Tensor) -> torch.Tensor:
    """This rank's share of `whole`, a tensor shaped as the unsharded
    parameter `name` of `module` (a gradient or a weight of one device), as
    `shard_params` cut the parameter; `whole` itself for a parameter the
    model axis leaves whole."""
    sharded = model_sharded(module)
    if name not in sharded:
        return whole
    dim, halves, split = sharded[name]
    return _take(whole, dim, halves, split.size, split.index)


def _gather_model(t: torch.Tensor, dim: int, halves: int, split: ModelSplit) -> torch.Tensor:
    import torch.distributed as dist

    parts = [torch.empty_like(t) for _ in range(split.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=split.group)
    return torch.cat([p.chunk(halves, dim)[h] for h in range(halves) for p in parts], dim)


def model_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """`module`'s state dict with every model-sharded tensor gathered whole
    (a collective over the model group: every rank calls it), detached."""
    sharded = model_sharded(module)
    return {k: (_gather_model(v, *sharded[k]) if k in sharded else v.detach())
            for k, v in module.state_dict(keep_vars=True).items()}


def model_grads(module: nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: its whole gradient} of every parameter with one,
    gathered as `model_state_dict`."""
    sharded = model_sharded(module)
    return {k: (_gather_model(p.grad, *sharded[k]) if k in sharded else p.grad.detach())
            for k, p in module.named_parameters() if p.grad is not None}


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
    """Shard `module` in place over `mesh`'s data axis (this rank's data
    group): one FSDP unit per block, then the root; `ignored` parameters
    stay whole (their gradients are the caller's to reduce).  Returns the
    module."""
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
            dist.all_reduce(part, group=mesh.data_group)
        total = total + part
    if whole:
        total = total + torch.stack(torch._foreach_norm(whole)).float().pow(2).sum()
    return total
