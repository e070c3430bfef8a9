"""Native (C++) host-side loader kernels, built at first use.

A copy of ``semantic_abstraction_tpu/native`` for the port (the port
imports nothing of the JAX package). ``loader_kernels.cc`` is the same
source; it builds with ``g++ -O3 -ffp-contract=off`` into
``native/.build/loader_kernels-<hash>.so``, keyed by a hash of the source
and the flags. Each process compiles to a name of
its own (``<lib>.<pid>.tmp``) and renames it into place, so processes that
build at once (test workers, loader processes) never write one file
together.

Without a compiler the numpy twins in ``data/transforms.py`` run instead,
and the first failed build says so with a ``RuntimeWarning``.
``-ffp-contract=off`` keeps the masks' double arithmetic bit for bit that
of their numpy twins; the gathers copy bytes. ``weighted_sample`` draws the
same distribution as its numpy twin by another algorithm (alias method /
Efraimidis-Spirakis keys), so its indices depend on whether the library
built, as in the JAX package.

Python surface:
- ``available()`` -> bool
- ``weighted_sample(rng, probs, k, replace)``
- ``bounds_mask(pts, bounds)`` / ``frustum_mask(pts, depth_shape, pose, intr)``
- ``gather_rows(src, idx)`` / ``gather_axis1(src, idx)``
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "loader_kernels.cc")
BUILD_DIR = os.path.join(_HERE, ".build")
# No -fopenmp: the source's row gathers return from inside their OpenMP
# loops, which g++ refuses under -fopenmp, so the JAX package's OpenMP
# attempt always fails and its library is the single-threaded build that
# these flags give.
# -ffp-contract=off: the mask kernels promise bit-identical doubles to their
# numpy twins; GCC's default contraction would fuse the camera transform's
# multiply-adds into FMAs, which round differently and could flip a
# boundary pixel's frustum membership against the numpy path
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC",
             "-std=c++17")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"loader_kernels-{digest.hexdigest()[:16]}.so")


def _compile(lib_path: str) -> Optional[str]:
    """Build ``lib_path`` through a temporary name of this process; None on
    success, else the compiler's last complaint."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *CXX_FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, text=True, timeout=120)
    except subprocess.CalledProcessError as e:
        err = e.stderr.strip()[-2000:] or f"g++ exit {e.returncode}"
    except (FileNotFoundError, subprocess.TimeoutExpired) as e:
        err = str(e)
    else:
        os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
        return None
    if os.path.exists(tmp):
        os.remove(tmp)
    return err


def _build_and_load() -> Optional[ctypes.CDLL]:
    lib_path = _lib_path()
    if not os.path.exists(lib_path):
        err = _compile(lib_path)
        if err is not None:
            warnings.warn(f"native loader kernels unavailable, the numpy twins run "
                          f"instead: {err}", RuntimeWarning, stacklevel=3)
            return None
    try:
        lib = ctypes.CDLL(lib_path)
    except OSError as e:
        warnings.warn(f"native loader kernels failed to load, the numpy twins run "
                      f"instead: {e}", RuntimeWarning, stacklevel=3)
        return None
    return _declare(lib)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.weighted_sample_without_replacement.restype = ctypes.c_int
    lib.weighted_sample_without_replacement.argtypes = [
        ctypes.c_int64, ctypes.c_int64, f64p, f64p, i64p,
    ]
    lib.weighted_sample_alias.restype = ctypes.c_int
    lib.weighted_sample_alias.argtypes = [
        ctypes.c_int64, ctypes.c_int64, f64p, ctypes.c_double, f64p, i64p,
    ]
    lib.bounds_mask_f32.restype = ctypes.c_int
    lib.bounds_mask_f32.argtypes = [ctypes.c_int64, f32p, f64p, f64p, u8p]
    lib.frustum_mask_f32.restype = ctypes.c_int
    lib.frustum_mask_f32.argtypes = [
        ctypes.c_int64, f32p, f64p, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int64, ctypes.c_int64,
        u8p,
    ]
    for fn_name, ctype in _GATHER_FNS.values():
        fn = getattr(lib, fn_name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.POINTER(ctype), i64p, ctypes.POINTER(ctype)]
    lib.gather_axis1_f32.restype = ctypes.c_int
    lib.gather_axis1_f32.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f32p, i64p, f32p,
    ]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    with _LOCK:
        if not _TRIED:
            _LIB = _build_and_load()
            _TRIED = True
    return _LIB


def available() -> bool:
    return _lib() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def weighted_sample(rng: np.random.RandomState, probs: np.ndarray, k: int,
                    replace: bool) -> np.ndarray:
    """k indices drawn with weights ``probs`` from ``rng``'s uniforms;
    ValueError when a draw without replacement is infeasible."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("native kernels unavailable")
    probs = np.ascontiguousarray(probs, np.float64)
    n = len(probs)
    out = np.empty(k, np.int64)
    if not replace:
        # count the positives before drawing uniforms: the infeasible case
        # (the caller's replace=True retry) then costs no n-uniform draw
        if int(np.count_nonzero(probs > 0)) < k:
            raise ValueError(
                f"cannot draw {k} without replacement from the "
                "positive-weight entries"
            )
        uniforms = rng.random_sample(n)
        rc = lib.weighted_sample_without_replacement(
            n, k, _ptr(probs, ctypes.c_double), _ptr(uniforms, ctypes.c_double),
            _ptr(out, ctypes.c_int64),
        )
        if rc != 0:
            raise ValueError(
                f"cannot draw {k} without replacement from the "
                "positive-weight entries"
            )
        return out
    wsum = float(probs.sum())
    if wsum <= 0:
        raise ValueError("probabilities sum to zero")
    u = rng.random_sample(k)
    rc = lib.weighted_sample_alias(
        n, k, _ptr(probs, ctypes.c_double), ctypes.c_double(wsum),
        _ptr(u, ctypes.c_double), _ptr(out, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError("sampling failed")
    return out


def bounds_mask(pts: np.ndarray, bounds: np.ndarray) -> Optional[np.ndarray]:
    """(N, 3) float32 points -> inclusive in-bounds bool mask, or None when
    the native path does not apply (the caller then runs numpy)."""
    lib = _lib()
    if lib is None or pts.dtype != np.float32 or pts.ndim != 2 \
            or pts.shape[1] != 3:
        return None
    pts = np.ascontiguousarray(pts)
    b = np.ascontiguousarray(np.asarray(bounds, np.float64))
    out = np.empty(len(pts), np.uint8)
    lib.bounds_mask_f32(
        len(pts), _ptr(pts, ctypes.c_float), _ptr(b[0], ctypes.c_double),
        _ptr(b[1], ctypes.c_double), _ptr(out, ctypes.c_uint8),
    )
    return out.view(bool)


def frustum_mask(pts: np.ndarray, depth_shape, cam_pose: np.ndarray,
                 cam_intr: np.ndarray) -> Optional[np.ndarray]:
    """(N, 3) float32 world points -> frustum-membership bool mask (the
    double arithmetic of ``check_pts_in_frustum_np``, bit for bit), or None
    when the native path does not apply."""
    lib = _lib()
    if lib is None or pts.dtype != np.float32 or pts.ndim != 2 \
            or pts.shape[1] != 3:
        return None
    pts = np.ascontiguousarray(pts)
    inv = np.linalg.inv(np.asarray(cam_pose, dtype=np.float64))
    inv_rt = np.ascontiguousarray(inv[:3, :4])
    intr = np.asarray(cam_intr, np.float64)
    h, w = depth_shape
    out = np.empty(len(pts), np.uint8)
    lib.frustum_mask_f32(
        len(pts), _ptr(pts, ctypes.c_float), _ptr(inv_rt, ctypes.c_double),
        ctypes.c_double(intr[0, 0]), ctypes.c_double(intr[1, 1]),
        ctypes.c_double(intr[0, 2]), ctypes.c_double(intr[1, 2]),
        int(h), int(w), _ptr(out, ctypes.c_uint8),
    )
    return out.view(bool)


_GATHER_FNS = {
    np.dtype(np.float32): ("gather_rows_f32", ctypes.c_float),
    np.dtype(np.float64): ("gather_rows_f64", ctypes.c_double),
    np.dtype(np.int32): ("gather_rows_i32", ctypes.c_int32),
    np.dtype(np.int64): ("gather_rows_i64", ctypes.c_int64),
    np.dtype(np.uint8): ("gather_rows_u8", ctypes.c_uint8),
}


def gather_rows(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """src (N, ...) rows at idx (K,) -> (K, ...); numpy for other dtypes."""
    lib = _lib()
    src = np.ascontiguousarray(src)
    if lib is None or src.dtype not in _GATHER_FNS:
        return src[idx]
    fn_name, ctype = _GATHER_FNS[src.dtype]
    n = src.shape[0]
    d = int(np.prod(src.shape[1:])) if src.ndim > 1 else 1
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty((len(idx),) + src.shape[1:], src.dtype)
    rc = getattr(lib, fn_name)(
        n, d, len(idx), _ptr(src, ctype), _ptr(idx, ctypes.c_int64), _ptr(out, ctype),
    )
    if rc != 0:
        raise IndexError("gather index out of range")
    return out


def gather_axis1(src: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """src (P, N, ...) at idx (K,) along axis 1 -> (P, K, ...)."""
    lib = _lib()
    src = np.ascontiguousarray(src)
    if lib is None or src.dtype != np.float32 or src.ndim < 2:
        return src[:, idx]
    p, n = src.shape[:2]
    c = int(np.prod(src.shape[2:])) if src.ndim > 2 else 1
    idx = np.ascontiguousarray(idx, np.int64)
    out = np.empty((p, len(idx)) + src.shape[2:], src.dtype)
    rc = lib.gather_axis1_f32(
        p, n, c, len(idx),
        _ptr(src, ctypes.c_float), _ptr(idx, ctypes.c_int64),
        _ptr(out, ctypes.c_float),
    )
    if rc != 0:
        raise IndexError("gather index out of range")
    return out
