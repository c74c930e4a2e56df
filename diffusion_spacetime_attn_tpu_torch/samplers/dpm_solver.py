"""DPM-Solver++ (1M / 2M multistep, data prediction), port of the JAX
package's `samplers/dpm_solver.py` (reference
`ldm/models/diffusion/dpm_solver/{sampler,dpm_solver}.py`).

With λ = log(α/σ) per schedule position and h_i = λ_target − λ_current:

  * x̂₀ = (x − σ·ε) / α from one UNet evaluation per step;
  * first order: x ← (σ_t/σ_s)·x − α_t·(e^(−h) − 1)·D with D = x̂₀ (step 0
    always; every step at order 1, which equals DDIM at eta 0);
  * second order from step 1: D = (1 + 1/2r)·x̂₀ − (1/2r)·x̂₀_prev with
    r = h_{i−1}/h_i;
  * `lower_order_final` drops the last update to first order when the chain
    has fewer than 15 steps (reference `dpm_solver.py:1094`).

`remat=True` checkpoints each evaluation (`samplers/remat.py`).
"""
from __future__ import annotations

import torch

from ..ops.schedule import DiffusionSchedule
from .plms import EpsFn
from .remat import maybe_remat


def dpm_solver_sample(eps_fn: EpsFn, x_T: torch.Tensor, sched: DiffusionSchedule,
                      order: int = 2, remat=True, lower_order_final: bool = True) -> torch.Tensor:
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    eps_fn = maybe_remat(eps_fn, remat)
    S = sched.num_steps
    ts = [int(t) for t in sched.timesteps.tolist()]
    # alpha / sigma / lambda at the current state (loop order) and the target
    a_cur, s_cur = torch.sqrt(sched.alphas), torch.sqrt(1.0 - sched.alphas)
    a_tgt, s_tgt = torch.sqrt(sched.alphas_prev), torch.sqrt(1.0 - sched.alphas_prev)
    h = torch.log(a_tgt / s_tgt) - torch.log(a_cur / s_cur)     # > 0 while denoising

    def x0_pred(x, i):
        return (x - s_cur[i] * eps_fn(x, ts[i], i)) / a_cur[i]

    def first_order(x, d, i):
        return (s_tgt[i] / s_cur[i]) * x - a_tgt[i] * (torch.exp(-h[i]) - 1.0) * d

    x0_prev = x0_pred(x_T, 0)
    x = first_order(x_T, x0_prev, 0)
    drop_final = lower_order_final and S < 15
    for i in range(1, S):
        x0 = x0_pred(x, i)
        if order == 1 or (drop_final and i == S - 1):
            d = x0
        else:
            r = h[i - 1] / h[i]
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
        x = first_order(x, d, i)
        x0_prev = x0
    return x
