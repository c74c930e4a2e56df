"""PLMS (pseudo linear multistep) sampler, forward only.

Port of the JAX package's `samplers/plms.py` (reference
`ldm/models/diffusion/plms.py:296-358`): a pseudo-improved-Euler first step
(two model evaluations, both at loop position 0), then Adams-Bashforth of
order 2, 3 and 4 over the eps history.  `eps_fn(x, t, i)` takes the loop
position i so per-step control weights reach the model.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..ops.schedule import DiffusionSchedule

EpsFn = Callable[[torch.Tensor, int, int], torch.Tensor]


def _x_prev(x, e, a_t, a_prev, sqrt_one_minus_at):
    """DDIM/PLMS update with sigma = 0."""
    pred_x0 = (x - sqrt_one_minus_at * e) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1.0 - a_prev) * e


def plms_sample(eps_fn: EpsFn, x_T: torch.Tensor, sched: DiffusionSchedule) -> torch.Tensor:
    S = sched.num_steps
    ts = [int(t) for t in sched.timesteps.tolist()]
    ts_next = [int(t) for t in sched.timesteps_next.tolist()]
    al, al_prev, s1m = sched.alphas, sched.alphas_prev, sched.sqrt_one_minus_alphas

    e0 = eps_fn(x_T, ts[0], 0)
    x_mid = _x_prev(x_T, e0, al[0], al_prev[0], s1m[0])
    e0_next = eps_fn(x_mid, ts_next[0], 0)
    x = _x_prev(x_T, (e0 + e0_next) / 2.0, al[0], al_prev[0], s1m[0])

    zeros = torch.zeros_like(e0)
    o1, o2, o3 = e0, zeros, zeros  # eps_{i-1}, eps_{i-2}, eps_{i-3}
    for i in range(1, S):
        e = eps_fn(x, ts[i], i)
        order = min(i, 3) - 1
        if order == 0:
            e_prime = (3.0 * e - o1) / 2.0
        elif order == 1:
            e_prime = (23.0 * e - 16.0 * o1 + 5.0 * o2) / 12.0
        else:
            e_prime = (55.0 * e - 59.0 * o1 + 37.0 * o2 - 9.0 * o3) / 24.0
        x = _x_prev(x, e_prime, al[i], al_prev[i], s1m[i])
        o1, o2, o3 = e, o1, o2
    return x
