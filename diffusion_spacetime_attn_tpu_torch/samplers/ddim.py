"""DDIM sampler, port of the JAX package's `samplers/ddim.py` (reference
`ldm/models/diffusion/ddim.py`, stock CompVis).

x_{i+1} = √ᾱ_prev · x̂₀ + √(1 − ᾱ_prev − σ²) · ε (+ σ·z), with
x̂₀ = (x − √(1 − ᾱ)·ε) / √ᾱ and σ from the schedule's eta (`sched.sigmas`;
0 for the default eta = 0, which is deterministic).  One UNet evaluation per
step, `eps_fn(x, t, i)` with the loop position i; `remat=True` checkpoints
each evaluation (`samplers/remat.py`).

Noise comes from JAX keys (`utils/prng.py`), as in the JAX function:
`split(rng, 2S)` laid out as [2, S] keys, `[0, i]` for step i's σ·z (only
when `rng` is given) and `[1, i]` for the inpainting re-noise (from
`PRNGKey(0)` when `rng` is None).  `mask` / `x0` (inpainting): before each
evaluation the region where mask = 1 is replaced by q_sample(x0, t_i) (the
reference's `plms.py:232-235`).  `start_step` (img2img): the loop runs
i = start_step .. S−1 from an x_T the caller noised to timestep[start_step],
and `eps_fn` gets the loop position i.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.schedule import DiffusionSchedule, q_sample
from ..utils import prng
from .plms import EpsFn
from .remat import maybe_remat


def ddim_sample(eps_fn: EpsFn, x_T: torch.Tensor, sched: DiffusionSchedule,
                rng: Optional[np.ndarray] = None, remat=True,
                mask: Optional[torch.Tensor] = None, x0: Optional[torch.Tensor] = None,
                start_step: int = 0) -> torch.Tensor:
    eps_fn = maybe_remat(eps_fn, remat)
    S = sched.num_steps
    stochastic = rng is not None
    if mask is not None and x0 is None:
        raise ValueError("x0 required with mask")
    if stochastic or mask is not None:
        rngs = prng.split(prng.PRNGKey(0) if rng is None else rng, 2 * S).reshape(2, S, 2)
    ts = [int(t) for t in sched.timesteps.tolist()]
    x = x_T
    for i in range(start_step, S):
        if mask is not None:
            t = torch.full((x.shape[0],), ts[i], dtype=torch.long, device=x.device)
            noise = prng.normal_like(rngs[1, i], x)
            x = q_sample(sched, x0, t, noise) * mask + (1.0 - mask) * x
        e = eps_fn(x, ts[i], i)
        a_prev, sigma = sched.alphas_prev[i], sched.sigmas[i]
        pred_x0 = (x - sched.sqrt_one_minus_alphas[i] * e) / torch.sqrt(sched.alphas[i])
        x = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev - sigma ** 2) * e
        if stochastic:
            x = x + sigma * prng.normal_like(rngs[0, i], x)
    return x
