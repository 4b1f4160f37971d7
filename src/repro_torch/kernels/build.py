"""Build and load the hand-written CUDA kernels (``repro_torch/csrc/*.cu``).

No counterpart in the reference (Pallas kernels need no build step).  Each
source compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its
own shared library with a plain C interface, loaded with :mod:`ctypes` —
route (b): no PyTorch headers, so a build takes seconds.  Libraries go to
``build/kernels/`` at the root of the checkout, named by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads as it is.  :func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import time, and nothing falls back: a missing
``nvcc`` or a failed compile raises.
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

__all__ = ["SOURCES", "build_all", "library", "source_path"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
#: build outputs: ``<checkout>/build/kernels`` (listed in .gitignore).
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
SOURCES = ("rmsnorm", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def source_path(name: str) -> Path:
    return CSRC / f"{name}.cu"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, proc: subprocess.Popen, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source_path(name)} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all() -> float:
    """Compile every kernel source that has no up-to-date library, one
    ``nvcc`` per source, all started together.  Returns the seconds spent
    (0.0 when everything was built already)."""
    t0 = time.perf_counter()
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pending = [(n, *_start(n)) for n in SOURCES if not _lib_path(n).exists()]
        for name, proc, tmp, out in pending:
            _finish(name, proc, tmp, out)
    return time.perf_counter() - t0 if pending else 0.0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        out = _lib_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            _finish(name, *_start(name))
        lib = _loaded[name] = ctypes.CDLL(str(out))
        return lib
