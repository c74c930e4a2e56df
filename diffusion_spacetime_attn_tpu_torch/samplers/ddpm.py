"""Ancestral DDPM sampler over the full train schedule, port of the JAX
package's `samplers/ddpm.py` (reference `ldm/models/diffusion/ddpm.py:219-262`,
the posterior at `ddpm.py:140-157`; what the reference's
`scripts/sample_diffusion.py` "vanilla" mode runs).

x_{t−1} = coef1(t)·x̂₀ + coef2(t)·x_t + 1[t > 0]·exp(½ logvar(t))·z, with
x̂₀ = √(1/ᾱ_t)·x_t − √(1/ᾱ_t − 1)·ε, clipped to [−1, 1] with
`clip_denoised`.  The per-step constants are float64 numpy made float32, as
in the JAX function; step i (t = T−1−i) draws z from `split(rng, T)[i]`
(`utils/prng.py`).  `eps_fn(x, t, i)` is the samplers' interface.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import ScheduleConfig
from ..ops.schedule import make_beta_schedule
from ..utils import prng
from .plms import EpsFn
from .remat import maybe_remat


def ddpm_sample(eps_fn: EpsFn, x_T: torch.Tensor, schedule_cfg: ScheduleConfig,
                rng: np.ndarray, clip_denoised: bool = False, v_posterior: float = 0.0,
                remat=True) -> torch.Tensor:
    eps_fn = maybe_remat(eps_fn, remat)
    betas = make_beta_schedule(schedule_cfg)
    T = betas.shape[0]
    alphas = 1.0 - betas
    ac = np.cumprod(alphas)
    ac_prev = np.append(1.0, ac[:-1])
    posterior_variance = ((1.0 - v_posterior) * betas * (1.0 - ac_prev) / (1.0 - ac)
                          + v_posterior * betas)
    order = np.arange(T)[::-1]

    def f32(a):
        return torch.tensor(np.asarray(a[order], np.float32), device=x_T.device)

    sqrt_recip_ac = f32(np.sqrt(1.0 / ac))
    sqrt_recipm1_ac = f32(np.sqrt(1.0 / ac - 1.0))
    coef1 = f32(betas * np.sqrt(ac_prev) / (1.0 - ac))
    coef2 = f32((1.0 - ac_prev) * np.sqrt(alphas) / (1.0 - ac))
    sigma = torch.exp(0.5 * f32(np.log(np.maximum(posterior_variance, 1e-20))))
    rngs = prng.split(rng, T)
    x = x_T
    for i, t in enumerate(order.tolist()):
        e = eps_fn(x, t, i)
        x0 = sqrt_recip_ac[i] * x - sqrt_recipm1_ac[i] * e
        if clip_denoised:
            x0 = torch.clamp(x0, -1.0, 1.0)
        x = coef1[i] * x0 + coef2[i] * x
        if t > 0:
            x = x + sigma[i] * prng.normal_like(rngs[i], x)
    return x
