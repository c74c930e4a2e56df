"""DDIM sampler, port of the JAX package's `samplers/ddim.py` (reference
`ldm/models/diffusion/ddim.py`, stock CompVis).

x_{i+1} = √ᾱ_prev · x̂₀ + √(1 − ᾱ_prev − σ²) · ε (+ σ·z), with
x̂₀ = (x − √(1 − ᾱ)·ε) / √ᾱ and σ from the schedule's eta (`sched.sigmas`;
0 for the default eta = 0, which is deterministic).  One UNet evaluation per
step, `eps_fn(x, t, i)` with the loop position i; `remat=True` checkpoints
each evaluation (`samplers/remat.py`).

The stochastic term takes its z from a `torch.Generator`.  JAX draws it from
`jax.random.split` of an rng key, whose bits this generator does not
reproduce, so only eta = 0 equals the JAX chain.  The inpainting arguments
of the JAX function (`mask`, `x0`, `start_step`) are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops.schedule import DiffusionSchedule
from .plms import EpsFn
from .remat import maybe_remat


def ddim_sample(eps_fn: EpsFn, x_T: torch.Tensor, sched: DiffusionSchedule,
                generator: Optional[torch.Generator] = None, remat=True) -> torch.Tensor:
    eps_fn = maybe_remat(eps_fn, remat)
    ts = [int(t) for t in sched.timesteps.tolist()]
    x = x_T
    for i in range(sched.num_steps):
        e = eps_fn(x, ts[i], i)
        a_prev, sigma = sched.alphas_prev[i], sched.sigmas[i]
        pred_x0 = (x - sched.sqrt_one_minus_alphas[i] * e) / torch.sqrt(sched.alphas[i])
        x = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev - sigma ** 2) * e
        if generator is not None:
            z = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
            x = x + sigma * z
    return x
