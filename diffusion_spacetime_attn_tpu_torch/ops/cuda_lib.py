"""Build and load the port's CUDA kernels (`csrc/*.cu`) as one shared library.

The sources have a plain C interface and are compiled with `nvcc` for
`sm_90a`, one process per source started together, then linked into one
`.so` that `ctypes` loads.  The library is built at first use into
`_build/` inside the package (listed in `.gitignore`) under a name that
carries a hash of the sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  Nothing is built when this module is
imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (see each source's extern "C").
SIGNATURES = {
    "dsta_mha_fwd": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "dsta_spacetime_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _F, _P],
    "dsta_geglu_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "dsta_geglu_chunks": [_I, _I, _I],
    "dsta_spacetime_bwd": [_I] + [_P] * 15 + [_I] * 6 + [_F, _P],
    "dsta_geglu_dx": [_I] + [_P] * 7 + [_I] * 3 + [_P],
    "dsta_flash_fwd": [_I] + [_P] * 5 + [_I] * 5 + [_P],
    "dsta_flash_bwd": [_I] + [_P] * 9 + [_I] * 5 + [_F, _P],
}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_state: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile every source (in parallel) and link the library; returns
    {"path", "seconds", "ptxas"} with the compiler's register / shared
    memory / spill report per kernel."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libdsta_kernels_{_digest()}.so"
    log = lib.with_suffix(".ptxas.txt")
    if lib.exists() and log.exists():
        return {"path": str(lib), "seconds": 0.0, "ptxas": log.read_text()}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        report, objs, failed = [], [], []
        for src, obj, p in procs:  # wait for every compiler before raising
            out, _ = p.communicate()
            report.append(f"== {src.name}\n{out}")
            objs.append(str(obj))
            if p.returncode != 0:
                failed.append(f"nvcc failed on {src.name}:\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp_lib), *objs],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log.write_text("".join(report))
        os.replace(tmp_lib, lib)
    return {"path": str(lib), "seconds": time.perf_counter() - t0,
            "ptxas": log.read_text()}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use.  A failed build is
    raised again on every later call, without compiling again."""
    with _lock:
        if "error" in _state:
            raise RuntimeError("the CUDA kernels failed to build") from _state["error"]
        if "lib" not in _state:
            try:
                info = build()
            except Exception as e:
                _state["error"] = e
                raise
            lib = ctypes.CDLL(info["path"])
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _state["lib"] = lib
        return _state["lib"]


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Every tensor on one CUDA device and contiguous; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
