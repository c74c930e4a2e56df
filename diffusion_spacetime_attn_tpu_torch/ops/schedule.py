"""DDPM / DDIM schedule math (reference `ldm/modules/diffusionmodules/util.py:21-77`).

All host math is float64 numpy; the results become float32 tensors once, so
the port's schedule equals the JAX package's bit for bit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import ScheduleConfig


def make_beta_schedule(cfg: ScheduleConfig) -> np.ndarray:
    """CompVis "linear" schedule: linear in sqrt-beta space."""
    if cfg.schedule == "linear":
        return np.linspace(cfg.linear_start ** 0.5, cfg.linear_end ** 0.5,
                           cfg.num_train_timesteps, dtype=np.float64) ** 2
    if cfg.schedule == "sqrt_linear":
        return np.linspace(cfg.linear_start, cfg.linear_end,
                           cfg.num_train_timesteps, dtype=np.float64)
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def make_ddim_timesteps(num_steps: int, num_train_timesteps: int) -> np.ndarray:
    """Uniform step selection shifted by +1: [1, 21, ..., 981] for 50/1000."""
    c = num_train_timesteps // num_steps
    steps = np.asarray(list(range(0, num_train_timesteps, c)))[:num_steps]
    return steps + 1


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Per-step constants in loop order (i = 0 is the noisiest step, t=981)."""

    num_steps: int
    timesteps: torch.Tensor       # [S] int32
    timesteps_next: torch.Tensor  # [S] int32, t of the following position
    alphas: torch.Tensor          # alpha_cumprod at t
    alphas_prev: torch.Tensor
    sqrt_one_minus_alphas: torch.Tensor
    sigmas: torch.Tensor
    alphas_cumprod: torch.Tensor  # [T]
    betas: torch.Tensor           # [T]


def make_schedule(cfg: ScheduleConfig, num_steps: int, eta: float = 0.0,
                  device="cpu") -> DiffusionSchedule:
    betas = make_beta_schedule(cfg)
    alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
    ddim_ts = make_ddim_timesteps(num_steps, cfg.num_train_timesteps)
    ddim_alphas = alphas_cumprod[ddim_ts]
    ddim_alphas_prev = np.asarray(
        [alphas_cumprod[0]] + alphas_cumprod[ddim_ts[:-1]].tolist())
    ddim_sigmas = eta * np.sqrt((1 - ddim_alphas_prev) / (1 - ddim_alphas)
                                * (1 - ddim_alphas / ddim_alphas_prev))
    order = np.arange(num_steps)[::-1]
    ts_loop = ddim_ts[order]
    ts_next = np.concatenate([ts_loop[1:], ts_loop[-1:]])

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def i32(x):
        return torch.tensor(np.asarray(x, np.int32), device=device)

    return DiffusionSchedule(
        num_steps=num_steps,
        timesteps=i32(ts_loop),
        timesteps_next=i32(ts_next),
        alphas=f32(ddim_alphas[order]),
        alphas_prev=f32(ddim_alphas_prev[order]),
        sqrt_one_minus_alphas=f32(np.sqrt(1.0 - ddim_alphas)[order]),
        sigmas=f32(ddim_sigmas[order]),
        alphas_cumprod=f32(alphas_cumprod),
        betas=f32(betas),
    )


def q_sample(schedule: DiffusionSchedule, x0: torch.Tensor, t: torch.Tensor,
             noise: torch.Tensor) -> torch.Tensor:
    """Forward diffusion q(x_t | x_0) per row at timesteps t [B] (reference
    `ddpm.py` q_sample)."""
    ac = schedule.alphas_cumprod.to(x0.device)
    t = t.to(device=x0.device, dtype=torch.long)
    shape = (-1,) + (1,) * (x0.ndim - 1)
    return (torch.sqrt(ac)[t].reshape(shape) * x0
            + torch.sqrt(1.0 - ac)[t].reshape(shape) * noise)
