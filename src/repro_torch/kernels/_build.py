"""Building the hand-written kernels from the sources in the checkout.

CUDA C++ sources under ``csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  Triton kernels compile just in time; their cache is pointed
into the same build directory, so a run reads and writes nothing outside
the checkout.  Both happen at first use, never at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
CSRC = pathlib.Path(__file__).resolve().parent / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()                      # guards _NAME_LOCKS
_NAME_LOCKS: dict[str, threading.Lock] = {}   # one build per library


def build_dir() -> pathlib.Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def triton_setup() -> None:
    """Point Triton's home and compile cache into the build directory (call
    before the first ``import triton`` of a process)."""
    os.environ.setdefault("TRITON_HOME", str(build_dir()))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_dir() / "triton"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def cuda_library(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile ``csrc/<sources>`` into ``build/kernels/lib<name>-<hash>.so``
    (once per content of the sources and the ``csrc/*.cuh`` headers) and
    load it.  The ptxas report (registers, shared memory, spills) is kept
    beside it as ``<name>.log``."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:      # libraries of other names build at the same time
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        paths = [CSRC / s for s in sources]
        h = hashlib.sha256()
        for p in paths + sorted(CSRC.glob("*.cuh")):   # with the headers
            h.update(p.read_bytes())
        out = build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"
        if not out.exists():
            tmp = out.with_suffix(".so.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(p) for p in paths)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            (build_dir() / f"{name}.log").write_text(
                " ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib


def build_log(name: str) -> str:
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""
