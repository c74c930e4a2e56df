"""ctypes binding of the C++ BPE core (`native/bpe.cpp`); port of the JAX
package's `utils/native_bpe.py`.

The same merge loop and GPT-2 pre-tokenization as `tokenizer.GPT2Tokenizer`
(the tests hold the two equal).  The source is compiled at first use with
`g++ -O2 -fPIC -std=c++17 -shared` into the package's `_build/` (listed in
`.gitignore`), under a name that carries a hash of the source and flags, so
an edited source is rebuilt.  A missing compiler or a failed build raises
`NativeBuildError`, which `make_roberta_tokenizer` answers with the Python
core.  Nothing is built when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List

from .tokenizer import _RobertaIds, read_gpt2_files

SOURCE = Path(__file__).resolve().parents[2] / "native" / "bpe.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]

_locks: dict = {}
_state: dict = {}


class NativeBuildError(RuntimeError):
    """The C++ core could not be compiled or loaded."""


def compile_shared(source: Path, name: str) -> Path:
    """Compile one C++ source into `_build/lib<name>_<hash>.so` unless this
    source and these flags are built already; returns the library's path.
    The host decoders (`utils/{jpeg,zstd,lzw,webp,ccitt,bcn}.py`) are built
    the same way and loaded through `load_shared`."""
    if not source.is_file():
        raise NativeBuildError(f"no source {source}")
    digest = hashlib.sha256(" ".join(FLAGS).encode() + source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}_{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = Path(tmp) / lib.name
        try:
            r = subprocess.run(["g++", *FLAGS, "-o", str(out), str(source)],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"g++ did not run: {e}") from e
        if r.returncode != 0:
            raise NativeBuildError(f"g++ failed on {source}:\n{r.stderr}")
        os.replace(out, lib)      # atomic: concurrent builders load a whole file
    return lib


def build() -> Path:
    """Compile the BPE core unless this source and these flags are built
    already; returns the library's path."""
    return compile_shared(SOURCE, "bpe")


def load_shared(state: dict, source: Path, name: str, what: str,
                signatures: dict) -> ctypes.CDLL:
    """The library `compile_shared(source, name)` builds, loaded with its
    functions' `signatures` ({function: (restype, argtypes)}) and kept in
    the caller's `state`; a failed build is raised again ("`what` failed to
    build") on every later call without compiling again.  Each library has
    its own lock, so different libraries build side by side."""
    with _locks.setdefault(name, threading.Lock()):
        if "error" in state:
            raise NativeBuildError(f"{what} failed to build") from state["error"]
        if "lib" not in state:
            try:
                lib = ctypes.CDLL(str(compile_shared(source, name)))
            except (NativeBuildError, OSError) as e:
                state["error"] = e
                raise NativeBuildError(str(e)) from e
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            state["lib"] = lib
        return state["lib"]


def load_library() -> ctypes.CDLL:
    """The loaded core, built on first use; a failed build is raised again on
    every later call without compiling again."""
    return load_shared(_state, SOURCE, "bpe", "the native BPE core", {
        "bpe_create": (ctypes.c_void_p, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
                                         ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32]),
        "bpe_encode": (ctypes.c_int32, [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]),
        "bpe_free": (None, [ctypes.c_void_p])})


class NativeBPE(_RobertaIds):
    """Byte-level BPE encoder backed by the C++ core."""

    core = "native"

    def __init__(self, vocab: dict, merges: List[tuple]):
        self._lib = load_library()
        tokens = list(vocab)
        ids = (ctypes.c_int32 * len(tokens))(*[vocab[t] for t in tokens])
        self._h = self._lib.bpe_create("\n".join(tokens).encode("utf-8"), ids, len(tokens),
                                       "\n".join(f"{a} {b}" for a, b in merges).encode("utf-8"),
                                       len(merges))

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str, id_map=None) -> "NativeBPE":
        """id_map: {gpt2_id: target_id} applied to the vocab (missing -> 3),
        so the core emits the target ids directly."""
        return cls(*read_gpt2_files(vocab_path, merges_path, id_map))

    def _raw(self, text: str) -> List[int]:
        data = text.encode("utf-8")
        cap = max(len(data), 1)            # each id covers at least one byte
        buf = (ctypes.c_int32 * cap)()
        n = self._lib.bpe_encode(self._h, data, buf, cap)
        return list(buf[:n])

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.bpe_free(self._h)
