"""Build and load the port's CUDA kernels.

Each source in csrc/ is compiled by nvcc for Hopper (sm_90a) into a shared
library with a plain C interface and loaded with ctypes: no PyTorch headers,
so a build takes seconds, not minutes. Libraries go to _build/ (listed in
.gitignore), named by a hash of the source, the shared headers (csrc/*.cuh)
and the flags, so a source is rebuilt only when one of them changes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def _lib_path(name: str) -> Path:
    """The library's path, named by a hash of the source, every shared
    header in csrc/ (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library is current; returns the
    compiler's output ("" when nothing was built). Raises RuntimeError with
    that output when nvcc fails."""
    lib = _lib_path(name)
    if lib.exists():
        return ""
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}")
    os.replace(tmp, lib)
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
        return lib
