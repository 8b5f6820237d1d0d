"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``csrc/`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). Libraries
land in ``build/torch_kernels/`` beside the package, named by a digest of the
source and the flags, so an edited source builds anew and an unchanged one is
reused. Nothing is built when a module is imported: the first launch (or
:func:`build`) does it.

:func:`build` and :func:`load` hold one lock, so threads that first reach a
kernel together (a server's handler threads, a batching worker) build it
once: the second waits for the first and finds the library built. Each
build writes a temporary file named by process and thread and moves it into
place, so processes sharing the build directory never load a half-written
library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

#: Kernel library name -> source, relative to the package.
SOURCES: dict[str, str] = {
    "gru_seq": "csrc/gru_seq.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[tuple, ctypes.CDLL] = {}
_lock = threading.RLock()


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the CUDA toolkit")


def library_path(name: str, extra: tuple[str, ...] = ()) -> Path:
    src = (_PKG / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS + tuple(extra)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=None, extra: tuple[str, ...] = ()) -> dict[str, dict]:
    """Build the named kernel libraries (all by default) that are not built
    yet, one ``nvcc`` process per source, all started together. `extra` are
    further ``nvcc`` flags (e.g. ``-DOCRS_GRU_PROFILE``); a library built with
    them is a file of its own. Returns
    ``{name: {"seconds": s, "log": ptxas output}}`` for the ones built."""
    names = list(SOURCES) if names is None else list(names)
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            out = library_path(name, extra)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}-{threading.get_ident()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp), str(_PKG / SOURCES[name])]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp, out, time.perf_counter())
        built = {}
        for name, (proc, tmp, out, t0) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
            os.replace(tmp, out)
            built[name] = {"seconds": time.perf_counter() - t0, "log": log}
        return built


def load(name: str, extra: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The kernel library `name` (with the `extra` flags), built first if needed."""
    key = (name, tuple(extra))
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            build([name], extra)
            lib = _loaded[key] = ctypes.CDLL(str(library_path(name, extra)))
        return lib
