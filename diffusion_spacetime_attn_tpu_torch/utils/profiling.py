"""Profiling and structured logging; port of the JAX package's
`utils/profiling.py`: `trace`, `annotate`, `timed`, `JsonLogger`,
`get_logger`, over `torch.profiler` where JAX's use `jax.profiler`.

`KERNEL_FAMILIES` / `kernel_family` group device kernels by name, the
grouping `scripts/analyze_trace.py` and `chip_smoke.py` print.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/dsta_trace") -> Iterator[str]:
    """Capture a torch.profiler trace of the block: CPU activity and, where
    a card is present, CUDA activity (kernels, copies).  At exit a Chrome
    trace goes to the path this yields, inside `log_dir` (Perfetto or
    chrome://tracing view it; `scripts/analyze_trace.py` tabulates it)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"dsta_{os.getpid()}_{time.time_ns()}.pt.trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
    finally:
        prof.stop()
        prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named span inside a trace (`torch.profiler.record_function`)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def timed(name: str, sink=None) -> Iterator[None]:
    """Wall-clock span; where the process has used CUDA, it waits for the
    card at exit, so the span covers the work queued inside it."""
    t0 = time.perf_counter()
    yield
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    (sink or print)(f"[timed] {name}: {dt * 1000:.1f}ms")


class JsonLogger:
    """One JSON object per event: {"event", "time", **fields}, appended to
    `path` (stdout without one) and flushed per line."""

    def __init__(self, path: Optional[str] = None):
        self.f = open(path, "a") if path else sys.stdout

    def log(self, event: str, **fields):
        rec = {"event": event, "time": time.time(), **fields}
        self.f.write(json.dumps(rec) + "\n")
        self.f.flush()

    def close(self):
        if self.f is not sys.stdout:
            self.f.close()


def get_logger(name: str = "dsta") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


# device kernels by family: a kernel joins the first family one of whose
# substrings its lower-cased name holds, else "other"
KERNEL_FAMILIES = [
    ("flash_fwd", ("flash_fwd_",)), ("flash_bwd", ("flash_bwd_",)),
    ("mha_fwd", ("mha_fwd_",)), ("spacetime_fwd", ("spacetime_fwd_",)),
    ("spacetime_bwd", ("spacetime_bwd_",)),
    ("geglu_fwd", ("geglu_gate", "geglu_out", "geglu_partial")),
    ("geglu_bwd", ("geglu_dgate", "geglu_dx_out", "geglu_dx_partial")),
    ("geglu_sum_slices", ("sum_slices",)),
    ("convolution", ("conv", "implicit", "cudnn", "fprop", "dgrad", "wgrad")),
    ("matmul", ("gemm", "cutlass", "cublas", "nvjet", "xmma")),
    ("softmax", ("softmax",)), ("norm", ("norm",)),
    ("optimizer", ("adam", "multi_tensor")),    # AdamW, EMA's lerp (training)
]


def kernel_family(name: str) -> str:
    low = name.lower()
    return next((fam for fam, keys in KERNEL_FAMILIES if any(k in low for k in keys)), "other")
