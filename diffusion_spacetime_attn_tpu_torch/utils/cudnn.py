"""cuDNN's deterministic algorithms for a block of work.

`torch.backends.cudnn.flags(...)` also sets `allow_tf32` (True unless
passed), so a float32 convolution inside it runs in TF32 whatever the caller
chose.  `deterministic()` sets only `benchmark` off and `deterministic` on,
and restores both after.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def deterministic():
    cudnn = torch.backends.cudnn
    prev = (cudnn.benchmark, cudnn.deterministic)
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = prev
