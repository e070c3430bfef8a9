"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel is one ``csrc/*.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``ops/.build/``, keyed
by a hash of the source and the flags so that an edited source rebuilds.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, ".build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# every kernel of the port: name -> source under csrc/
KERNELS = ("fused_mha", "channel_moments", "cam_accumulate", "lamb_update", "tail_backward")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        f"nvcc not found (looked on PATH and in {cuda_home}/bin; set "
        "CUDA_HOME): the port's CUDA kernels are built from source at first use"
    )


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for one kernel; returns (Popen, tmp, final) or None when
    the library is already built."""
    final = _lib_path(name)
    if os.path.exists(final):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{final}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, final


def _finish_build(name: str, job) -> None:
    proc, tmp, final = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, final)  # atomic: a reader never sees a half-written .so


def build(names: Iterable[str] = KERNELS) -> None:
    """Build the named kernels, one nvcc process each, all started together."""
    with _lock:
        names = list(names)
        jobs = [(n, _start_build(n)) for n in names]
        for n, job in jobs:
            if job is not None:
                _finish_build(n, job)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = ctypes.CDLL(_lib_path(name))
                _loaded[name] = lib
    return lib
