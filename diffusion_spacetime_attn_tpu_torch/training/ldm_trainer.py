"""LDM training: train the latent-diffusion UNet itself.  Port of the JAX
package's `training/ldm_trainer.py`, the reference's Lightning trainer
(`main.py`) and the loss / EMA machinery of `ldm/models/diffusion/ddpm.py`:

  * `lvlb_weights`: `DDPM.register_schedule`'s VLB weights (`ddpm.py:148-169`);
  * `p_losses`: `LatentDiffusion.p_losses` (`ddpm.py:1030-1062`) with the
    uniform timestep draw of `DDPM.forward` (`ddpm.py:323-326`); t and the
    noise come from JAX's keys (`utils/prng.py` `split`, `randint`,
    `normal`), so a step on the CPU can be held against JAX's;
  * `ema_decay`: LitEma's ramp min(decay, (1+step)/(10+step));
  * `Optimizer`: what `make_optimizer` builds in JAX, optax's
    `MultiSteps(chain(clip_by_global_norm, adamw(schedule)))`, on
    `torch.optim.AdamW` (b1 0.9, b2 0.999, eps 1e-8; decoupled decay on every
    leaf, biases and norms included).  The global-norm clip runs before
    Adam; the schedule is called with the count of updates applied before
    this one, as optax does; k micro-gradients are averaged (Welford, as
    optax) and applied on the k-th call, while the state's `step`, and with
    it EMA's ramp, advances on every call;
  * `learn_logvar` trains the [T] logvar in the same optimizer.

The state holds the trained module itself (`params`): the step updates it
in place and returns the state, so callers rebind as in JAX.

Over a data mesh (`LDMTrainer(mesh=...)`, `parallel/mesh.py`; JAX's
`Mesh(('data',))` step, `ldm_trainer.py:215-307` there) each rank takes its
rows of the global batch; t and the noise are drawn for the global batch
from the one key and each rank takes its rows (threefry's bits depend on
the shape), so a rank's rows see JAX's draws.  The loss is a batch mean, so
the gradients are averaged over the data axis (all-reduced, or
reduce-scattered under FSDP), and the learning rate scales by the device
count data·model as `scaled_lr` says.  A model axis replicates the step.
`fsdp=True` shards the module with `fully_shard` over the data group
(`parallel/sharding.py`): AdamW's moments, the accumulation buffers and the
EMA copies are shards of the same layout, and the global-norm clip sums the
shards' squared norms over the ranks.  `save` / `restore` use the port's
own format, `torch.save` of whole tensors (gathered; rank 0 writes) read
back with `weights_only=True`, so a mesh run's checkpoint loads on one
device and back.  `restore` also reads the JAX trainer's orbax
`step_<n>/` directory (`training/jax_checkpoints.py`: params, EMA, logvar,
step, AdamW's moments and count, MultiSteps' accumulators and mini-step);
over a mesh rank 0 reads it and the state is sharded as from a port file.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import LDMTrainConfig, ScheduleConfig
from ..ops.schedule import DiffusionSchedule, make_beta_schedule, q_sample
from ..parallel.mesh import (
    Mesh,
    all_reduce_,
    barrier,
    check_mesh,
    global_rows,
    metrics_mean,
    normal_rows,
    replicate,
)
from ..parallel.sharding import (
    bind_grads_,
    full_tree,
    fsdp as fully_shard_module,
    grad_norm_sq,
    is_sharded,
    load_full_,
    local,
    optimizer_state_full,
    optimizer_state_like,
    shard_like,
    shard_views,
)
from ..utils import prng
from .jax_checkpoints import is_orbax_dir, ldm_checkpoint, read_on_rank0
from .schedules import lambda_linear_schedule, warmup_cosine_schedule2


def lvlb_weights(cfg: ScheduleConfig, parameterization: str = "eps",
                 v_posterior: float = 0.0) -> np.ndarray:
    """Per-timestep VLB weights (reference `ddpm.py:148-169`), float32 [T]."""
    betas = make_beta_schedule(cfg)
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    posterior_variance = ((1.0 - v_posterior) * betas * (1.0 - ac_prev) / (1.0 - ac)
                          + v_posterior * betas)
    if parameterization == "eps":
        # w[0] is 0/0 in the reference, which patches it to w[1] (ddpm.py:160-167)
        denom = 2.0 * posterior_variance * alphas * (1.0 - ac)
        w = betas ** 2 / np.where(denom == 0.0, 1.0, denom)
    elif parameterization == "x0":
        w = 0.5 * np.sqrt(ac) / (2.0 * 1.0 - ac)
    else:
        raise ValueError(parameterization)
    w[0] = w[1]
    if not np.isfinite(w).all():
        raise FloatingPointError("lvlb_weights: non-finite weight")
    return w.astype(np.float32)


def scaled_lr(cfg: LDMTrainConfig, batch_size: int, num_devices: int) -> float:
    """`main.py:686`'s rule lr = accum × ndev × batch × base_lr (batch per
    device)."""
    if not cfg.scale_lr:
        return cfg.base_lr
    return cfg.accum_steps * num_devices * batch_size * cfg.base_lr


def lr_multiplier(cfg: LDMTrainConfig):
    """The LambdaLR multiplier of `cfg.lr_schedule` as a function of the
    update count, or None for "none"."""
    if cfg.lr_schedule == "none":
        return None
    if cfg.lr_schedule not in ("lambda_linear", "warmup_cosine"):
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    make = lambda_linear_schedule if cfg.lr_schedule == "lambda_linear" else warmup_cosine_schedule2
    return make([cfg.lr_warmup_steps], [cfg.lr_f_min], [cfg.lr_f_max], [cfg.lr_f_start],
                [cfg.lr_cycle_steps])


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         mesh: Optional[Mesh] = None) -> None:
    """optax's `clip_by_global_norm` in place: g unchanged while the global
    norm is below max_norm, else (g / norm) · max_norm; 0 = off.  With
    FSDP-sharded gradients the squared norms of the shards are summed over
    `mesh`'s ranks first."""
    if not max_norm:
        return
    norm = torch.sqrt(grad_norm_sq(grads, mesh))
    if bool(norm < max_norm):
        return
    grads = [local(g) for g in grads]
    torch._foreach_div_(grads, norm.to(grads[0].device))
    torch._foreach_mul_(grads, max_norm)


class Optimizer:
    """optax's `MultiSteps(chain(clip_by_global_norm(c), adamw(lr · mult(count),
    weight_decay)), k)` over `params` (`make_optimizer` in JAX).  `update()`
    takes the gradients in each parameter's `.grad`; it returns True when it
    applied an update (every k-th call).  AdamW and the accumulation run on
    the parameters' local storage (`shard_views`: an FSDP-sharded
    parameter's local shard), fused on the card; `mesh` sums the clip's
    squared norms over the ranks."""

    def __init__(self, cfg: LDMTrainConfig, lr: float, params: List[torch.Tensor],
                 mesh: Optional[Mesh] = None):
        self.cfg, self.lr, self.params, self.mesh = cfg, lr, list(params), mesh
        self.mult = lr_multiplier(cfg)
        self.views = shard_views(self.params)
        fused = all(v.device.type == "cuda" for v in self.views)
        self.adamw = torch.optim.AdamW(self.views, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=cfg.weight_decay, fused=fused or None,
                                       foreach=None if fused else True)
        self.count = 0        # updates applied (optax's inner count)
        self.mini_step = 0    # micro-batches accumulated towards the next one
        self.acc: Optional[List[torch.Tensor]] = None
        if cfg.accum_steps > 1:
            self.acc = [torch.zeros_like(p) for p in self.params]

    def update(self) -> bool:
        grads = [p.grad for p in self.params]
        if self.acc is not None:
            acc = [local(a) for a in self.acc]
            d = torch._foreach_sub([local(g) for g in grads], acc)
            torch._foreach_div_(d, float(self.mini_step + 1))
            torch._foreach_add_(acc, d)
            self.mini_step += 1
            if self.mini_step < self.cfg.accum_steps:
                return False
            self.mini_step = 0
            for g, a in zip(grads, acc):
                local(g).copy_(a)
            torch._foreach_zero_(acc)
        clip_by_global_norm_(grads, self.cfg.grad_clip_norm, self.mesh)
        lr = self.lr if self.mult is None else self.lr * float(self.mult(self.count))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        bind_grads_(self.views, self.params)
        self.adamw.step()
        for v in self.views:
            v.grad = None
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        """Whole tensors (FSDP shards gathered: a collective)."""
        return {"adamw": optimizer_state_full(self.adamw, self.params), "count": self.count,
                "mini_step": self.mini_step, "acc": full_tree(self.acc)}

    def load_state_dict(self, sd: Dict) -> None:
        """From whole tensors (a one-device or a mesh run's `state_dict`)."""
        self.adamw.load_state_dict(optimizer_state_like(sd["adamw"], self.params))
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        if self.acc is not None:
            for a, b in zip(self.acc, sd["acc"]):
                local(a).copy_(local(shard_like(b, a)))


def make_optimizer(cfg: LDMTrainConfig, lr: float, params,
                   mesh: Optional[Mesh] = None) -> Optimizer:
    return Optimizer(cfg, lr, params, mesh)


@dataclasses.dataclass
class LDMTrainState:
    """What the reference persists per checkpoint; `params` is the trained
    module (the eps model), updated in place."""

    params: nn.Module
    opt_state: Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]]   # None when cfg.use_ema is off
    logvar: torch.Tensor                            # [T]; trained when cfg.learn_logvar
    step: int


def init_state(cfg: LDMTrainConfig, schedule_cfg: ScheduleConfig, params: nn.Module,
               lr: float, mesh: Optional[Mesh] = None) -> LDMTrainState:
    """The state over `params` (the module to train, float32 parameters;
    FSDP-sharded ones give a sharded EMA and optimizer state)."""
    dev = local(next(params.parameters())).device
    logvar = torch.full((schedule_cfg.num_train_timesteps,), cfg.logvar_init,
                        dtype=torch.float32, device=dev)
    trainable = list(params.parameters())
    if cfg.learn_logvar:
        logvar.requires_grad_(True)
        trainable.append(logvar)
    ema = None
    if cfg.use_ema:
        ema = {k: p.detach().clone() for k, p in params.named_parameters()}
    return LDMTrainState(params=params, opt_state=make_optimizer(cfg, lr, trainable, mesh),
                         ema_params=ema, logvar=logvar, step=0)


def ema_decay(step: int, decay: float) -> np.float32:
    """LitEma's warm-up ramp (`ldm/modules/ema.py:24`), in float32 as JAX."""
    s = np.float32(step)
    return np.minimum(np.float32(decay), (np.float32(1.0) + s) / (np.float32(10.0) + s))


def p_losses(cfg: LDMTrainConfig, schedule: DiffusionSchedule, lvlb_w: torch.Tensor,
             eps_model, logvar: torch.Tensor, x0: torch.Tensor, context,
             rng: np.ndarray, mesh: Optional[Mesh] = None) -> Tuple[torch.Tensor, dict]:
    """One loss evaluation (reference `ddpm.py:1030-1062` + `:323-326`).
    eps_model(x_noisy, t, context) -> model output; x0: scaled latents
    [B, H, W, C] (with `mesh`, this rank's rows of the global batch); rng: a
    JAX key.  The loss is the mean over x0's rows."""
    dev = x0.device
    n, mine = global_rows(mesh, x0.shape[0])
    t_rng, n_rng = prng.split(rng)
    t_np = prng.randint(t_rng, (n,), 0, schedule.alphas_cumprod.shape[0])[mine]
    t = torch.from_numpy(np.ascontiguousarray(t_np)).to(dev)
    noise = normal_rows(n_rng, x0, mesh)
    x_noisy = q_sample(schedule, x0, t, noise)
    model_out = eps_model(x_noisy, t, context).float()

    target = noise if cfg.parameterization == "eps" else x0
    err = model_out - target.float()
    per_sample = (err.abs() if cfg.loss_type == "l1" else err ** 2).mean(
        dim=tuple(range(1, x0.ndim)))                      # [B]
    ti = t.long()
    logvar_t = logvar[ti]
    loss_gamma = per_sample / torch.exp(logvar_t) + logvar_t
    loss = cfg.l_simple_weight * loss_gamma.mean()
    loss_vlb = (lvlb_w[ti] * per_sample).mean()
    loss = loss + cfg.original_elbo_weight * loss_vlb
    metrics = {"loss": loss.detach(), "loss_simple": per_sample.mean().detach(),
               "loss_vlb": loss_vlb.detach()}
    if cfg.learn_logvar:
        metrics["loss_gamma"] = loss_gamma.mean().detach()
        metrics["logvar"] = logvar.mean().detach()
    return loss, metrics


def make_gradients(cfg: LDMTrainConfig, schedule_cfg: ScheduleConfig,
                   schedule: DiffusionSchedule, eps_model, mesh: Optional[Mesh] = None):
    """(state, x0, context, rng) -> (loss, metrics) with each trainable
    tensor's `.grad` holding the global batch's gradient: over `mesh`, the
    mean over the ranks (FSDP's reduce-scatter for sharded parameters, an
    all-reduce for the others); the metrics are the global batch's."""
    lvlb = torch.from_numpy(lvlb_weights(schedule_cfg, cfg.parameterization))

    def gradients(state: LDMTrainState, x0, context, rng):
        opt = state.opt_state
        for p in opt.params:
            p.grad = None
        loss, metrics = p_losses(cfg, schedule, lvlb.to(x0.device), eps_model, state.logvar,
                                 x0, context, rng, mesh)
        loss.backward()
        if mesh is not None:
            all_reduce_([p.grad for p in opt.params if p.grad is not None
                         and not is_sharded(p.grad)], mesh)
        return loss.detach(), metrics_mean(metrics, mesh)

    return gradients


def make_train_step(cfg: LDMTrainConfig, schedule_cfg: ScheduleConfig,
                    schedule: DiffusionSchedule, eps_model, mesh: Optional[Mesh] = None,
                    gradients=None):
    """The step (state, x0, context, rng) -> (state, metrics); eps_model is
    the state's module, called as eps_model(x, t, context).  The learning
    rate is the state's optimizer's (`init_state`).  With `mesh`, x0 and
    context are this rank's rows of the global batch.  `gradients`:
    `make_gradients`' function for these arguments, made here when None."""
    if gradients is None:
        gradients = make_gradients(cfg, schedule_cfg, schedule, eps_model, mesh)

    def step(state: LDMTrainState, x0, context, rng):
        opt = state.opt_state
        _, metrics = gradients(state, x0, context, rng)
        opt.update()
        if state.ema_params is not None:
            d = ema_decay(state.step, cfg.ema_decay)
            params = dict(state.params.named_parameters())
            names = list(state.ema_params)
            # e·d + (1 − d)·p, the weight 1 − d in float32 as in JAX
            torch._foreach_lerp_([local(state.ema_params[k]) for k in names],
                                 [local(params[k].detach()) for k in names],
                                 float(np.float32(1) - d))
        for p in opt.params:
            p.grad = None
        state.step += 1
        return state, metrics

    return step


@dataclasses.dataclass
class LDMTrainer:
    """The step plus checkpointing (`main.py`'s Trainer, ModelCheckpoint and
    resume).  `mesh`: a `parallel.mesh.Mesh` over whose data axis the batch
    is split, each rank passing the rows of its data coordinate; the model
    axis replicates (its ranks compute their data group's step whole, as
    JAX's trainer does, `ldm_trainer.py:241-251` there).  `fsdp` (with a
    mesh) shards the module, the optimizer state and EMA over the data
    group; a data axis of 1 leaves nothing to shard, and the module stays
    whole.  The module is sharded, or rank 0's weights broadcast, when the
    trainer is built.  The learning rate counts data·model devices, as
    JAX's `scaled_lr` counts `mesh.devices.size`."""

    cfg: LDMTrainConfig
    schedule_cfg: ScheduleConfig
    schedule: DiffusionSchedule
    eps_model: nn.Module                # (x, t, context) -> out; the trained module
    mesh: Optional[Mesh] = None
    ckpt_dir: Optional[str] = None
    fsdp: bool = False
    params_root: Optional[nn.Module] = None   # the submodule JAX's params tree maps to

    def __post_init__(self):
        self.mesh = check_mesh(self.mesh, "LDMTrainer")
        if self.fsdp and self.mesh is None:
            raise ValueError("LDMTrainer: fsdp requires a mesh")
        self.fsdp = self.fsdp and self.mesh.data_group is not None
        if self.mesh is not None:
            if self.fsdp:
                fully_shard_module(self.eps_model, self.mesh)
            else:
                replicate(self.mesh, self.eps_model)
        self.lr = scaled_lr(self.cfg, self.cfg.batch_size,
                            1 if self.mesh is None else self.mesh.devices)
        self._gradients = make_gradients(self.cfg, self.schedule_cfg, self.schedule,
                                         self.eps_model, self.mesh)
        self._step = make_train_step(self.cfg, self.schedule_cfg, self.schedule,
                                     self.eps_model, self.mesh, self._gradients)

    def init(self) -> LDMTrainState:
        return init_state(self.cfg, self.schedule_cfg, self.eps_model, self.lr, self.mesh)

    def train_step(self, state: LDMTrainState, x0, context, rng):
        """One call (an optimizer update every `accum_steps` calls); updates
        the state in place and returns it with the metrics.  With a mesh, x0
        and context are this rank's rows (`parallel.mesh.shard_batch`)."""
        return self._step(state, x0, context, rng)

    def gradients(self, state: LDMTrainState, x0, context, rng):
        """The step's loss and metrics, the reduced gradients left in each
        trainable tensor's `.grad`, nothing updated."""
        return self._gradients(state, x0, context, rng)

    def _path(self, step: int) -> str:
        if not self.ckpt_dir:
            raise ValueError("LDMTrainer: ckpt_dir not set")
        return os.path.join(self.ckpt_dir, f"step_{step}.pt")

    def save(self, state: LDMTrainState, step: int) -> None:
        """Whole tensors: with a mesh every rank calls it (FSDP's gather) and
        rank 0 writes."""
        path = self._path(step)
        d = {"params": full_tree(state.params.state_dict()),
             "opt": state.opt_state.state_dict(), "ema": full_tree(state.ema_params),
             "logvar": state.logvar.detach(), "step": state.step}
        if self.mesh is None or self.mesh.writer:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            torch.save(d, path)
        barrier(self.mesh)

    def restore(self, step: int, like: LDMTrainState) -> LDMTrainState:
        """Load step `step` into `like` (a state from `init`) and return it;
        a checkpoint of a one-device or a mesh run, sharded or not: the
        port's `step_<n>.pt`, else JAX's orbax `step_<n>/`."""
        path = self._path(step)
        jax_dir = os.path.join(self.ckpt_dir, f"step_{step}")
        if not os.path.isfile(path) and is_orbax_dir(jax_dir):
            d = read_on_rank0(self.mesh, lambda: ldm_checkpoint(
                jax_dir, self.cfg, self.eps_model, like.opt_state, self.params_root))
        else:
            d = torch.load(path, map_location="cpu", weights_only=True)
        load_full_(like.params, d["params"])
        with torch.no_grad():
            if like.ema_params is not None:
                for k, v in like.ema_params.items():
                    local(v).copy_(local(shard_like(d["ema"][k], v)))
            like.logvar.copy_(d["logvar"])
        like.opt_state.load_state_dict(d["opt"])
        like.step = int(d["step"])
        return like
