"""The ('data', 'model') mesh over `torch.distributed`; port of the JAX
package's `parallel/mesh.py`.

JAX runs one process over a `Mesh(('data', 'model'))` of devices, and GSPMD
inserts the collectives.  The port runs one process per device (a rank), as
`torchrun --nproc-per-node N` starts them, and its collectives are explicit.
The ranks are laid out as JAX lays out its devices (`grid.reshape(data,
model)`): rank `d·model + m` sits at data coordinate d and model
coordinate m.

  * `data`: prompts, images or database rows.  A rank holds the rows of its
    data coordinate; the model ranks of one data group hold the same rows
    and draw the same noise.  Parameters are replicated over it (or
    FSDP-sharded, `parallel/sharding.py`), gradients averaged over it.
  * `model`: Megatron tensor parallelism inside the UNet's transformer
    blocks and the CLIP towers (`parallel/sharding.py` `shard_params`,
    `parallel/tensor.py`): each rank computes its share of the attention
    heads and of the MLP's hidden features, and an all-reduce over the
    model group after each pair joins them (another in the backward).
    Everything else is replicated over the model axis and computed on
    every model rank.

Every rank creates every data group and every model group (`dist.new_group`,
in the same order); `Mesh.data_group` is this rank's data group (None where
data is 1: the data axis then needs no collective), `Mesh.model_group` its
model group (None where model is 1).  With model 1 the data group is the
whole world.

The backend is the caller's: `nccl` for one CUDA device per rank (the
default), `gloo` where the caller asks for it (CPU ranks, or several ranks
on one card, which NCCL refuses).  `make_mesh` joins the process group
that `init_process_group` already made, or makes it from torchrun's
environment (`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`,
`MASTER_PORT`) or from a store the caller hands in.  Nothing falls back to
one process: a missing rendezvous raises.

JAX's `data_sharding` / `shard_batch` become `rows` / `shard_batch` (the
rows of a batch at this rank's data coordinate, which must divide by
`data`), its `replicate` a broadcast from rank 0, and the host's
`np.asarray` of a sharded array `gather_rows` (every data coordinate's rows
in global order).  JAX draws a step's noise for the whole batch from one
key, so `global_rows` / `normal_rows` draw for the global batch and keep
this rank's rows.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils import prng

@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a ('data', 'model') mesh over the default process
    group: the axis sizes, this rank (global), its data and model
    coordinates, its data and model groups and the device it computes on.
    A Mesh made by hand (no groups) serves where no collective runs."""

    data: int
    model: int = 1
    rank: int = 0
    backend: str = ""
    device: torch.device = torch.device("cpu")
    data_index: int = 0
    model_index: int = 0
    data_group: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)
    model_group: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def devices(self) -> int:
        """data·model: every device of the mesh (JAX's `mesh.devices.size`)."""
        return self.data * self.model

    @property
    def writer(self) -> bool:
        """The one rank that writes files: data and model coordinates 0."""
        return self.data_index == 0 and self.model_index == 0

    def device_mesh(self):
        """The `torch.distributed` DeviceMesh of the data axis (FSDP's): this
        rank's data group."""
        from torch.distributed.device_mesh import DeviceMesh

        if self.data_group is None:
            raise ValueError("FSDP shards over the data axis, and this mesh has data=1")
        return DeviceMesh.from_group(self.data_group, self.device.type)

    def model_row(self) -> "Mesh":
        """This rank's data group's row of the mesh as a (1, model) mesh: its
        model ranks, no data axis."""
        return dataclasses.replace(self, data=1, data_index=0, data_group=None)


def check_mesh(mesh: Optional[Mesh], who: str) -> Optional[Mesh]:
    """`mesh` as a trainer or engine takes it: None or a Mesh."""
    if mesh is None:
        return None
    if not isinstance(mesh, Mesh):
        raise TypeError(f"{who}: mesh must be a parallel.mesh.Mesh, got {type(mesh).__name__}")
    return mesh


def make_mesh(data: Optional[int] = None, model: int = 1, backend: str = "nccl",
              device=None, store=None, rank: Optional[int] = None,
              world_size: Optional[int] = None, timeout_s: float = 600.0) -> Mesh:
    """The mesh over the process group, made here if there is none yet.

    data=None takes the world size over model; data·model must equal it
    (one rank per device, rank d·model + m at coordinates (d, m)).
    `backend`: "nccl" (one CUDA device per rank, cuda:LOCAL_RANK unless
    `device` says otherwise) or "gloo" (`device` "cpu" or a CUDA device;
    default "cpu").  Without a group the rendezvous is `store` (a
    `torch.distributed.Store`, with `rank` and `world_size`) or torchrun's
    environment; collectives time out after `timeout_s`."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}, not {backend!r}")
    else:
        timeout = datetime.timedelta(seconds=timeout_s)
        if store is not None:
            if rank is None or world_size is None:
                raise ValueError("make_mesh(store=...) needs rank and world_size")
            dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                    timeout=timeout)
        else:
            missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                       if k not in os.environ]
            if missing:
                raise RuntimeError(f"make_mesh: no process group and no rendezvous (set by "
                                   f"torchrun; missing {missing}, or pass store=)")
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
    world, me = dist.get_world_size(), dist.get_rank()
    if model < 1 or world % model:
        raise ValueError(f"model={model} over {world} ranks")
    data = world // model if data is None else data
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} over {world} ranks: one rank per device")
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", me)))
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("nccl carries CUDA tensors: give each rank a CUDA device")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {me}: device {device} asked for and no CUDA device")
        torch.cuda.set_device(device)
    data_group, model_group = dist.group.WORLD, None
    if model > 1:       # every rank makes every group, in the same order
        data_groups = [dist.new_group([d * model + m for d in range(data)])
                       for m in range(model)]
        model_groups = [dist.new_group([d * model + m for m in range(model)])
                        for d in range(data)]
        data_group = data_groups[me % model] if data > 1 else None
        model_group = model_groups[me // model]
    return Mesh(data=data, model=model, rank=me, backend=backend, device=device,
                data_index=me // model, model_index=me % model, data_group=data_group,
                model_group=model_group)


def rows(mesh: Mesh, n: int) -> slice:
    """This rank's rows of a batch of n (JAX's `data_sharding` on axis 0):
    those of its data coordinate."""
    if n % mesh.data:
        raise ValueError(f"batch {n} not divisible by the mesh's data axis ({mesh.data})")
    per = n // mesh.data
    return slice(mesh.data_index * per, (mesh.data_index + 1) * per)


def global_rows(mesh: Optional[Mesh], b: int) -> Tuple[int, slice]:
    """(the global batch's size, this rank's slice of it) for a rank that
    holds b rows; without a mesh (b, all of them).  A draw for the global
    batch sliced so gives each rank JAX's values for its rows."""
    if mesh is None:
        return b, slice(0, b)
    n = b * mesh.data
    return n, rows(mesh, n)


def normal_rows(key: np.ndarray, like: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """`prng.normal(key)` drawn for the global batch of a rank holding
    `like`'s rows, this rank's rows of it, on like's device in its dtype
    (drawn in float32); without a mesh `prng.normal_like(key, like)`."""
    n, mine = global_rows(mesh, like.shape[0])
    z = prng.normal(key, (n, *like.shape[1:]))[mine]
    return torch.from_numpy(np.ascontiguousarray(z)).to(device=like.device, dtype=like.dtype)


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of every tensor or array in `tree` (leading axis),
    for tensors, numpy arrays, NamedTuples, dicts, lists and tuples; None
    and scalars pass through."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return tree[rows(mesh, tree.shape[0])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(shard_batch(mesh, v) for v in tree))
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    return tree


def replicate(mesh: Mesh, tree):
    """Rank 0's values of every tensor in `tree` (a module's parameters and
    buffers, or tensors), broadcast in place through flat buckets; returns
    `tree`."""
    tensors = list(tree.state_dict().values()) if isinstance(tree, torch.nn.Module) else \
        [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]
    with torch.no_grad():
        for chunk, flat in _flat_buckets(tensors):
            dist.broadcast(flat, src=0)
            _unflatten_(chunk, flat)
    return tree


def _flat_buckets(tensors, bucket_elems: int = 1 << 26):
    """(tensors, one flat copy of them) per bucket of at most `bucket_elems`
    elements of one dtype: one collective per bucket, not per tensor."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        start = 0
        while start < len(group):
            end, n = start, 0
            while end < len(group) and (n == 0 or n + group[end].numel() <= bucket_elems):
                n += group[end].numel()
                end += 1
            yield group[start:end], torch.cat([t.reshape(-1) for t in group[start:end]])
            start = end


def _unflatten_(chunk, flat) -> None:
    offset = 0
    for t in chunk:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _leaves(tree) -> List:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every data coordinate's rows of x (equal leading sizes), concatenated
    in data order on every rank: the global batch."""
    if mesh.data_group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.data)]
    dist.all_gather(parts, x, group=mesh.data_group)
    return torch.cat(parts)


def all_reduce_(tensors: Iterable[torch.Tensor], mesh: Mesh, op: str = "avg") -> None:
    """Sum (op "sum") or average (op "avg") each tensor over the data axis,
    in place, through flat buckets (gloo has no AVG: the sum is divided by
    the rank count).  The model ranks of a data group hold equal values of
    a replicated tensor and their own shard of a model-sharded one: each
    reduces over its data group."""
    if op not in ("sum", "avg"):
        raise ValueError(op)
    if mesh.data_group is None:
        return
    for chunk, flat in _flat_buckets(tensors):
        dist.all_reduce(flat, group=mesh.data_group)
        if op == "avg":
            flat.div_(mesh.data)
        _unflatten_(chunk, flat)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) over `group` whose backward is the all_reduce(SUM) of
    the cotangents: the gradient of a statistic that every rank's loss
    reads."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def mean_over_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean over the data axis of x (each rank's statistic over an
    equal number of rows), differentiable: the global-batch statistic."""
    if mesh.data_group is None:
        return x
    return _SumOverRanks.apply(x, mesh.data_group) / mesh.data


def metrics_mean(metrics: dict, mesh: Optional[Mesh]) -> dict:
    """Scalar metrics averaged over the data axis (each rank's mean over an
    equal number of rows: the global batch's)."""
    if mesh is None or not metrics or mesh.data_group is None:
        return metrics
    keys = sorted(metrics)
    flat = torch.stack([metrics[k].detach().float().reshape(()) for k in keys])
    dist.all_reduce(flat, group=mesh.data_group)
    flat = flat / mesh.data
    return {k: flat[i] for i, k in enumerate(keys)}


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        dist.barrier()


def mesh_from_env(backend: str, cpu: bool) -> Optional[Mesh]:
    """The scripts' data mesh: None in a one-process run, else a mesh over
    torchrun's ranks on `backend`, each rank on the CPU (`cpu`, gloo only)
    or on cuda:LOCAL_RANK (modulo the visible cards, so gloo ranks can
    share one card)."""
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:       # torchrun sets it
        return None
    if cpu and backend != "gloo":
        raise SystemExit("--cpu ranks need --backend gloo")
    if cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank (pass --cpu --backend gloo)")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    return make_mesh(backend=backend, device=device)


def add_mesh_args(ap) -> None:
    """The scripts' `--backend` flag."""
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                    help="the process group's backend under torchrun (nccl: one card per "
                         "rank; gloo: CPU ranks with --cpu, or ranks sharing a card)")
