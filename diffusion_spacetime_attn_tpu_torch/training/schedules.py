"""LR schedules, port of the JAX package's `training/schedules.py`: plain
functions of the step, float32 arithmetic as JAX's (numpy scalars or
arrays in, float32 out).

  * `bert_schedule`: the layout trainer's BertScheduler (reference
    `trainer/scheduler.py:86-131`): linear warmup from 0.1·max_lr, hold,
    linear decay, floored at min_lr;
  * `warmup_cosine_schedule`: LambdaWarmUpCosineScheduler
    (`ldm/lr_scheduler.py:4-33`);
  * `warmup_cosine_schedule2` / `lambda_linear_schedule`: the cycled
    LambdaWarmUpCosineScheduler2 / LambdaLinearScheduler
    (`ldm/lr_scheduler.py:36-98`), multipliers of the base lr.
"""
from __future__ import annotations

import numpy as np


def _f32(step) -> np.ndarray:
    return np.asarray(step, np.float32)


def bert_schedule(max_lr: float, min_lr: float, warmup_steps: float, hold_steps: float,
                  decay_steps: float):
    warmup_steps, hold_steps = float(warmup_steps), float(hold_steps)
    decay_steps = max(float(decay_steps), 1.0)

    def schedule(step):
        t = _f32(step) + np.float32(1.0)  # the reference counts before it reads
        warm = 0.1 * max_lr + (0.9 * max_lr / max(warmup_steps, 1.0)) * t
        decay = max_lr - (t - (warmup_steps + hold_steps)) * (max_lr / decay_steps)
        lr = np.where(t < warmup_steps, warm,
                      np.where(t < warmup_steps + hold_steps, np.float32(max_lr), decay))
        return np.maximum(lr, np.float32(min_lr)).astype(np.float32)

    return schedule


def warmup_cosine_schedule(warm_up_steps: float, lr_min: float, lr_max: float,
                           lr_start: float, max_decay_steps: float):
    """Linear warmup lr_start → lr_max, then half-cosine decay to lr_min (a
    multiplier of base lr 1.0, as in the reference)."""
    w = max(float(warm_up_steps), 1.0)
    d = max(float(max_decay_steps) - w, 1.0)

    def schedule(step):
        n = _f32(step)
        warm = (lr_max - lr_start) / w * n + lr_start
        t = np.minimum((n - w) / d, np.float32(1.0))
        cos = lr_min + 0.5 * (lr_max - lr_min) * (1.0 + np.cos(t * np.float32(np.pi)))
        return np.where(n < w, warm, cos).astype(np.float32)

    return schedule


def _cycled(warm_up_steps, f_min, f_max, f_start, cycle_lengths, cosine: bool):
    """Per-cycle warmup, then cosine or linear decay; the cycle found by the
    cumulative lengths."""
    k = len(cycle_lengths)
    if not len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start) == k:
        raise ValueError("one warm-up, f_min, f_max and f_start per cycle")
    cum = np.cumsum([0] + list(cycle_lengths))

    def schedule(step):
        n0 = _f32(step)
        out = np.zeros_like(n0)
        done = np.zeros(n0.shape, bool)
        for c in range(k):
            inside = n0 <= cum[c + 1] if c < k - 1 else np.ones(n0.shape, bool)
            n = n0 - np.float32(cum[c])
            w = max(float(warm_up_steps[c]), 1.0)
            warm = (f_max[c] - f_start[c]) / w * n + f_start[c]
            if cosine:
                t = np.minimum((n - w) / max(cycle_lengths[c] - w, 1.0), np.float32(1.0))
                dec = f_min[c] + 0.5 * (f_max[c] - f_min[c]) * (1.0 + np.cos(t * np.float32(np.pi)))
            else:
                dec = f_min[c] + (f_max[c] - f_min[c]) * (cycle_lengths[c] - n) / cycle_lengths[c]
            f = np.where(n < w, warm, dec)
            out = np.where(inside & ~done, f, out).astype(np.float32)
            done = done | inside
        return out

    return schedule


def warmup_cosine_schedule2(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """LambdaWarmUpCosineScheduler2 (`ldm/lr_scheduler.py:36-78`)."""
    return _cycled(warm_up_steps, f_min, f_max, f_start, cycle_lengths, True)


def lambda_linear_schedule(warm_up_steps, f_min, f_max, f_start, cycle_lengths):
    """LambdaLinearScheduler (`ldm/lr_scheduler.py:81-98`), the SD training
    configs' scheduler: linear warmup, then linear decay per cycle."""
    return _cycled(warm_up_steps, f_min, f_max, f_start, cycle_lengths, False)
