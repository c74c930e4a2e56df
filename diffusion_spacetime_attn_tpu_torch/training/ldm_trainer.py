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
in place and returns the state, so callers rebind as in JAX.  One device:
`LDMTrainer(mesh=...)` and `fsdp=True` raise (ROADMAP A.13).  `save` /
`restore` use the port's own format, `torch.save` of plain tensors read
back with `weights_only=True`; JAX's orbax steps are ROADMAP A.15.
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
from ..utils import prng
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


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax's `clip_by_global_norm` in place: g unchanged while the global
    norm is below max_norm, else (g / norm) · max_norm; 0 = off."""
    if not max_norm:
        return
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if bool(norm < max_norm):
        return
    torch._foreach_div_(grads, norm)
    torch._foreach_mul_(grads, max_norm)


class Optimizer:
    """optax's `MultiSteps(chain(clip_by_global_norm(c), adamw(lr · mult(count),
    weight_decay)), k)` over `params` (`make_optimizer` in JAX).  `update()`
    takes the gradients in each parameter's `.grad`; it returns True when it
    applied an update (every k-th call)."""

    def __init__(self, cfg: LDMTrainConfig, lr: float, params: List[torch.Tensor]):
        self.cfg, self.lr, self.params = cfg, lr, list(params)
        self.mult = lr_multiplier(cfg)
        fused = all(p.device.type == "cuda" for p in self.params)
        self.adamw = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
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
            d = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(d, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, d)
            self.mini_step += 1
            if self.mini_step < self.cfg.accum_steps:
                return False
            self.mini_step = 0
            for p, a in zip(self.params, self.acc):
                p.grad = a.clone()
            torch._foreach_zero_(self.acc)
            grads = [p.grad for p in self.params]
        clip_by_global_norm_(grads, self.cfg.grad_clip_norm)
        lr = self.lr if self.mult is None else self.lr * float(self.mult(self.count))
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.count += 1
        return True

    def state_dict(self) -> Dict:
        return {"adamw": self.adamw.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, sd: Dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.count, self.mini_step = int(sd["count"]), int(sd["mini_step"])
        if self.acc is not None:
            for a, b in zip(self.acc, sd["acc"]):
                a.copy_(b)


def make_optimizer(cfg: LDMTrainConfig, lr: float, params) -> Optimizer:
    return Optimizer(cfg, lr, params)


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
               lr: float) -> LDMTrainState:
    """The state over `params` (the module to train, float32 parameters)."""
    dev = next(params.parameters()).device
    logvar = torch.full((schedule_cfg.num_train_timesteps,), cfg.logvar_init,
                        dtype=torch.float32, device=dev)
    trainable = list(params.parameters())
    if cfg.learn_logvar:
        logvar.requires_grad_(True)
        trainable.append(logvar)
    ema = None
    if cfg.use_ema:
        ema = {k: p.detach().clone() for k, p in params.named_parameters()}
    return LDMTrainState(params=params, opt_state=make_optimizer(cfg, lr, trainable),
                         ema_params=ema, logvar=logvar, step=0)


def ema_decay(step: int, decay: float) -> np.float32:
    """LitEma's warm-up ramp (`ldm/modules/ema.py:24`), in float32 as JAX."""
    s = np.float32(step)
    return np.minimum(np.float32(decay), (np.float32(1.0) + s) / (np.float32(10.0) + s))


def p_losses(cfg: LDMTrainConfig, schedule: DiffusionSchedule, lvlb_w: torch.Tensor,
             eps_model, logvar: torch.Tensor, x0: torch.Tensor, context,
             rng: np.ndarray) -> Tuple[torch.Tensor, dict]:
    """One loss evaluation (reference `ddpm.py:1030-1062` + `:323-326`).
    eps_model(x_noisy, t, context) -> model output; x0: scaled latents
    [B, H, W, C]; rng: a JAX key."""
    B, dev = x0.shape[0], x0.device
    t_rng, n_rng = prng.split(rng)
    t_np = prng.randint(t_rng, (B,), 0, schedule.alphas_cumprod.shape[0])
    t = torch.from_numpy(t_np).to(dev)
    noise = torch.from_numpy(prng.normal(n_rng, tuple(x0.shape))).to(device=dev, dtype=x0.dtype)
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


def make_train_step(cfg: LDMTrainConfig, schedule_cfg: ScheduleConfig,
                    schedule: DiffusionSchedule, eps_model):
    """The step (state, x0, context, rng) -> (state, metrics); eps_model is
    the state's module, called as eps_model(x, t, context).  The learning
    rate is the state's optimizer's (`init_state`)."""
    lvlb = torch.from_numpy(lvlb_weights(schedule_cfg, cfg.parameterization))

    def step(state: LDMTrainState, x0, context, rng):
        opt = state.opt_state
        for p in opt.params:
            p.grad = None
        loss, metrics = p_losses(cfg, schedule, lvlb.to(x0.device), eps_model, state.logvar,
                                 x0, context, rng)
        loss.backward()
        opt.update()
        if state.ema_params is not None:
            d = ema_decay(state.step, cfg.ema_decay)
            params = dict(state.params.named_parameters())
            names = list(state.ema_params)
            # e·d + (1 − d)·p, the weight 1 − d in float32 as in JAX
            torch._foreach_lerp_([state.ema_params[k] for k in names],
                                 [params[k].detach() for k in names], float(np.float32(1) - d))
        for p in opt.params:
            p.grad = None
        state.step += 1
        return state, metrics

    return step


@dataclasses.dataclass
class LDMTrainer:
    """The step plus checkpointing (`main.py`'s Trainer, ModelCheckpoint and
    resume).  One device: a mesh or fsdp raises (ROADMAP A.13)."""

    cfg: LDMTrainConfig
    schedule_cfg: ScheduleConfig
    schedule: DiffusionSchedule
    eps_model: nn.Module                # (x, t, context) -> out; the trained module
    mesh: Optional[object] = None
    ckpt_dir: Optional[str] = None
    fsdp: bool = False

    def __post_init__(self):
        if self.mesh is not None or self.fsdp:
            raise NotImplementedError("LDMTrainer: the PyTorch port trains on one device; a "
                                      "mesh or FSDP is ROADMAP A.13")
        self.lr = scaled_lr(self.cfg, self.cfg.batch_size, 1)
        self._step = make_train_step(self.cfg, self.schedule_cfg, self.schedule,
                                     self.eps_model)

    def init(self) -> LDMTrainState:
        return init_state(self.cfg, self.schedule_cfg, self.eps_model, self.lr)

    def train_step(self, state: LDMTrainState, x0, context, rng):
        """One call (an optimizer update every `accum_steps` calls); updates
        the state in place and returns it with the metrics."""
        return self._step(state, x0, context, rng)

    def _path(self, step: int) -> str:
        if not self.ckpt_dir:
            raise ValueError("LDMTrainer: ckpt_dir not set")
        return os.path.join(self.ckpt_dir, f"step_{step}.pt")

    def save(self, state: LDMTrainState, step: int) -> None:
        path = self._path(step)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        torch.save({"params": state.params.state_dict(), "opt": state.opt_state.state_dict(),
                    "ema": state.ema_params, "logvar": state.logvar.detach(),
                    "step": state.step}, path)

    def restore(self, step: int, like: LDMTrainState) -> LDMTrainState:
        """Load step `step` into `like` (a state from `init`) and return it."""
        d = torch.load(self._path(step), map_location="cpu", weights_only=True)
        with torch.no_grad():
            like.params.load_state_dict(d["params"])
            if like.ema_params is not None:
                for k, v in like.ema_params.items():
                    v.copy_(d["ema"][k])
            like.logvar.copy_(d["logvar"])
        like.opt_state.load_state_dict(d["opt"])
        like.step = int(d["step"])
        return like
