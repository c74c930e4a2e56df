"""Layout-predictor trainer: two parameter groups, Bert LR schedules,
checkpoints and resume; port of the JAX package's
`training/layout_trainer.py` (reference `trainer/Pretrain.py`: two Adam
optimizers, encoder max-lr 1e-6 and bbox head 4e-5,
`coco_seq2seq_v9_ablation_4.yaml:50-63`, each with a BertScheduler; loss =
Σ hinge + 0.1·GMM-NLL; checkpoints every 10 epochs and on the best
validation, `Pretrain.py:101-114`; resume, `Pretrain.py:392-411`).

`Optimizer` is what `make_optimizer` builds in JAX, optax's
`apply_if_finite(chain(clip_by_global_norm, multi_transform({encoder:
adam(bert), head: adam(bert)})), max_consecutive_errors=100)`, on
`torch.optim.Adam` (b1 0.9, b2 0.999, eps 1e-8) with one parameter group
each: a parameter is "head" when its top-level name is `head`
(`_param_group`), else "encoder".  Each group's schedule is called with the
count of updates applied before this one, as optax does.  A step whose
gradients hold a NaN or an infinity is skipped (parameters and moments as
they were, the count not advanced) and counted; after more than
`MAX_CONSECUTIVE_ERRORS` skips in a row the step is applied anyway.

The trainer's `train_step(params, opt_state, batch)` has JAX's signature:
`params` is the `LayoutPredictor` module, `opt_state` its `Optimizer`;
both are updated in place and returned.  Checkpoints are `torch.save` files
read back with `weights_only=True`; `restore_checkpoint` also reads the JAX
trainer's orbax `step_<n>/` (`training/jax_checkpoints.py`: both groups'
Adam moments and counts, apply_if_finite's counters).  As in
JAX, the backward is not wrapped in the reference's bare try/except
(`Pretrain.py:262-266`).

Over a data mesh (`create(mesh=...)`; JAX `layout_trainer.py:74-117`) each
rank takes the rows of its data coordinate of the global batch (a model
axis replicates the step).  The loss is a sum over the
batch, so the global loss and its gradient are the sums over the ranks
(each rank's loss is scaled by the rank count before the gradients are
averaged).  `fsdp=True` shards the predictor and the two groups' Adam
moments (`parallel/sharding.py`); the finiteness check and the clip's
norm are taken over the whole gradient.  JAX shards only with `fsdp` and
a mesh (a mesh alone compiles the one-device step); the port's mesh alone
is data-parallel with replicated state, the same global step.  `fsdp`
without a mesh is ignored, as in JAX.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import LayoutConfig, LayoutTrainConfig
from ..models.layout.gmm_head import sample_xy
from ..models.layout.model import LayoutPredictor
from ..parallel.mesh import Mesh, all_reduce_, barrier, check_mesh, replicate
from ..parallel.sharding import (
    bind_grads_,
    full_tree,
    fsdp as fully_shard_module,
    is_sharded,
    load_full_,
    local,
    optimizer_state_full,
    optimizer_state_like,
    shard_views,
)
from .jax_checkpoints import is_orbax_dir, layout_checkpoint, read_on_rank0
from .ldm_trainer import clip_by_global_norm_
from .losses import LayoutBatch, _take, layout_total_loss
from .schedules import bert_schedule

GROUPS = ("encoder", "head")
MAX_CONSECUTIVE_ERRORS = 100       # apply_if_finite's limit in JAX's make_optimizer


def _param_group(name: str) -> str:
    """The optimizer group of a parameter ("a.b.c" state-dict name)."""
    return "head" if name.split(".")[0] == "head" else "encoder"


class Optimizer:
    """`make_optimizer`'s transformation over `model`'s parameters.
    `update()` takes the gradients in each parameter's `.grad` and returns
    True when it applied them.  Adam runs on the parameters' local storage
    (`shard_views`), fused on the card."""

    def __init__(self, cfg: LayoutTrainConfig, model: nn.Module, skip_nonfinite: bool = True,
                 mesh: Optional[Mesh] = None):
        self.cfg, self.mesh = cfg, mesh
        groups: Dict[str, List[torch.Tensor]] = {g: [] for g in GROUPS}
        for name, p in model.named_parameters():
            groups[_param_group(name)].append(p)
        self.params = [p for g in GROUPS for p in groups[g]]
        self.views = shard_views(self.params)
        views = dict(zip(map(id, self.params), self.views))
        fused = all(v.device.type == "cuda" for v in self.views)
        self.adam = torch.optim.Adam(
            [{"params": [views[id(p)] for p in groups[g]], "name": g}
             for g in GROUPS if groups[g]], lr=0.0,
            betas=(0.9, 0.999), eps=1e-8, fused=fused or None, foreach=None if fused else True)
        max_lr = {"encoder": cfg.encoder_max_lr, "head": cfg.head_max_lr}
        self.schedules = {g: bert_schedule(max_lr[g], 1e-8, cfg.warmup_steps, cfg.hold_steps,
                                           cfg.decay_steps) for g in GROUPS}
        self.max_errors = MAX_CONSECUTIVE_ERRORS if skip_nonfinite else None
        self.count = 0             # updates applied (optax's inner adam count)
        self.notfinite_count = 0   # non-finite gradients in a row
        self.total_notfinite = 0
        self.last_finite = True

    def update(self) -> bool:
        grads = [p.grad for p in self.params]
        if self.max_errors is not None:
            ok = torch.stack([torch.isfinite(local(g)).all() for g in grads]).all().float()
            if self.mesh is not None:
                import torch.distributed as dist

                dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            finite = bool(ok)
            self.last_finite = finite
            self.notfinite_count = 0 if finite else self.notfinite_count + 1
            self.total_notfinite += 0 if finite else 1
            if not (finite or self.notfinite_count > self.max_errors):
                return False
        clip_by_global_norm_(grads, self.cfg.grad_clip_norm, self.mesh)
        for group in self.adam.param_groups:
            group["lr"] = float(self.schedules[group["name"]](self.count))
        bind_grads_(self.views, self.params)
        self.adam.step()
        for v in self.views:
            v.grad = None
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        """Whole tensors (FSDP shards gathered: a collective)."""
        return {"adam": optimizer_state_full(self.adam, self.params), "count": self.count,
                "notfinite_count": self.notfinite_count,
                "total_notfinite": self.total_notfinite, "last_finite": self.last_finite}

    def load_state_dict(self, sd: Dict) -> None:
        self.adam.load_state_dict(optimizer_state_like(sd["adam"], self.params))
        self.count, self.notfinite_count = int(sd["count"]), int(sd["notfinite_count"])
        self.total_notfinite, self.last_finite = int(sd["total_notfinite"]), bool(sd["last_finite"])


def make_optimizer(cfg: LayoutTrainConfig, params: nn.Module,
                   skip_nonfinite: bool = True, mesh: Optional[Mesh] = None) -> Optimizer:
    return Optimizer(cfg, params, skip_nonfinite, mesh)


@dataclasses.dataclass
class LayoutTrainer:
    cfg: LayoutConfig
    train_cfg: LayoutTrainConfig
    mesh: Optional[Mesh] = None
    fsdp: bool = False

    @classmethod
    def create(cls, cfg: LayoutConfig, train_cfg: LayoutTrainConfig, params=None,
               mesh=None, fsdp: bool = False) -> "LayoutTrainer":
        mesh = check_mesh(mesh, "LayoutTrainer")
        return cls(cfg, train_cfg, mesh,
                   fsdp and mesh is not None and mesh.data_group is not None)

    def init_state(self, params: LayoutPredictor) -> Optimizer:
        """The optimizer over `params`, which become trainable (with a mesh,
        rank 0's weights, sharded under fsdp)."""
        params.train().requires_grad_(True)
        if self.mesh is not None:
            replicate(self.mesh, params)
            if self.fsdp:
                fully_shard_module(params, self.mesh)
        return make_optimizer(self.train_cfg, params, mesh=self.mesh)

    def loss_fn(self, params: LayoutPredictor, batch: LayoutBatch):
        gmm = params(batch.tokens, batch.object_pos)
        loss, metrics = layout_total_loss(gmm, batch, gmm_weight=self.train_cfg.gmm_loss_weight,
                                          margin=self.train_cfg.hinge_margin,
                                          k=self.cfg.gmm_components)
        return loss, metrics, gmm

    def train_step(self, params: LayoutPredictor, opt_state: Optimizer, batch: LayoutBatch):
        """One step -> (params, opt_state, loss, metrics), both updated in
        place.  With a mesh, `batch` is this rank's rows of the global batch
        (`parallel.mesh.shard_batch`); the loss and metrics are the global
        batch's sums."""
        mesh = self.mesh
        batch = LayoutBatch(*batch).to(local(params.head.xy_bivariate.weight).device)
        for p in opt_state.params:
            p.grad = None
        loss, metrics, _ = self.loss_fn(params, batch)
        if mesh is None:
            loss.backward()
        else:
            (loss * mesh.data).backward()     # averaged below: the sum over the ranks
            all_reduce_([p.grad for p in opt_state.params if p.grad is not None
                         and not is_sharded(p.grad)], mesh)
        opt_state.update()
        for p in opt_state.params:
            p.grad = None
        out = {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}
        if mesh is not None:
            all_reduce_(list(out.values()), mesh, op="sum")
        loss = out.pop("loss")
        return params, opt_state, loss, out

    @torch.no_grad()
    def eval_step(self, params: LayoutPredictor, batch: LayoutBatch):
        """-> (loss, metrics): the loss terms, `mean_center_dist` (the greedy
        centers' distance to the absolute targets, the xy analogue of the
        reference's val mIoU) and `rel_satisfied` (the share of valid
        relations the greedy centers satisfy at margin 0; y grows down)."""
        batch = LayoutBatch(*batch).to(params.head.xy_bivariate.weight.device)
        loss, metrics, gmm = self.loss_fn(params, batch)
        k = self.cfg.gmm_components
        xy = sample_xy(_take(gmm, batch.abs_idx), greedy_component=True, k=k)
        dist = torch.linalg.vector_norm(xy - batch.abs_xy, dim=-1)
        n = torch.clamp(batch.abs_valid.sum(), min=1.0)
        metrics = dict(metrics, mean_center_dist=torch.sum(dist * batch.abs_valid) / n)
        xy_all = sample_xy(gmm, greedy_component=True, k=k)               # [B, L, 2]
        p1, p2 = _take(xy_all, batch.rel_idx[..., 0]), _take(xy_all, batch.rel_idx[..., 1])
        diffs = torch.stack([p1[..., 1] - p2[..., 1],    # above: y1 < y2
                             p2[..., 1] - p1[..., 1],    # below
                             p1[..., 0] - p2[..., 0],    # left of: x1 < x2
                             p2[..., 0] - p1[..., 0]],   # right of
                            dim=-1)
        d = torch.gather(diffs, -1, batch.rel_type.long()[..., None])[..., 0]
        nrel = torch.clamp(batch.rel_valid.sum(), min=1.0)
        metrics["rel_satisfied"] = torch.sum((d < 0).float() * batch.rel_valid) / nrel
        return loss, metrics

    # ---- checkpoints (torch.save) ----
    @staticmethod
    def checkpoint_path(ckpt_dir: str, step: int) -> str:
        return os.path.join(ckpt_dir, f"step_{step}.pt")

    def save_checkpoint(self, ckpt_dir: str, step: int, params: LayoutPredictor,
                        opt_state: Optimizer, extra=None) -> None:
        """Whole tensors; with a mesh every rank calls it and rank 0 writes."""
        d = {"params": full_tree(params.state_dict()), "opt_state": opt_state.state_dict(),
             "extra": extra or {}}
        if self.mesh is None or self.mesh.writer:
            os.makedirs(ckpt_dir, exist_ok=True)
            torch.save(d, self.checkpoint_path(ckpt_dir, step))
        barrier(self.mesh)

    def restore_checkpoint(self, ckpt_dir: str, step: int, params: LayoutPredictor,
                           opt_state: Optimizer) -> Tuple[LayoutPredictor, Optimizer]:
        """Load step `step` into `params` and `opt_state` and return them:
        the port's `step_<n>.pt`, else JAX's orbax `step_<n>/` (over a mesh
        rank 0 reads it)."""
        path = self.checkpoint_path(ckpt_dir, step)
        jax_dir = os.path.join(ckpt_dir, f"step_{step}")
        if not os.path.isfile(path) and is_orbax_dir(jax_dir):
            d = read_on_rank0(self.mesh, lambda: layout_checkpoint(jax_dir, params, opt_state))
        else:
            d = torch.load(path, map_location="cpu", weights_only=True)
        load_full_(params, d["params"])
        opt_state.load_state_dict(d["opt_state"])
        return params, opt_state


def train_loop(trainer: LayoutTrainer, params: LayoutPredictor, batches, val_batches=None,
               ckpt_dir: Optional[str] = None, log_every: int = 100, logger=None):
    """An epoch-free loop over an iterable of LayoutBatch -> (params, history)."""
    opt_state = trainer.init_state(params)
    history = {"loss": []}
    for step, batch in enumerate(batches):
        params, opt_state, loss, metrics = trainer.train_step(params, opt_state, batch)
        if step % log_every == 0:
            msg = f"step {step}: loss {float(loss):.4f} " + " ".join(
                f"{k}={float(v):.4f}" for k, v in metrics.items())
            (logger.info if logger else print)(msg)
        history["loss"].append(float(loss))
    if val_batches is not None:
        vals = [float(trainer.eval_step(params, b)[0]) for b in val_batches]
        history["val_loss"] = float(np.mean(np.asarray(vals, np.float32)))
    if ckpt_dir:
        trainer.save_checkpoint(ckpt_dir, len(history["loss"]), params, opt_state)
    return params, history
