"""ctypes bindings for the native C++ robust estimator
(roma_torch/native/ransac.cpp).

The shared library is built on first use with g++ through
roma_torch/native/Makefile into the repository's build/native/ (plain C ABI
+ ctypes, no binding dependency); make rebuilds it when a source is newer.
Callers that want a fallback catch the build error themselves:
benchmarks/pose_backends.py does, once.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_PATH = BUILD_DIR / "libransac.so"
_lib = None


def _build() -> None:
    subprocess.run(
        ["make", "-C", str(NATIVE_DIR), f"OUT={BUILD_DIR}"],
        check=True,
        capture_output=True,
    )


def load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    _build()
    lib = ctypes.CDLL(str(LIB_PATH))
    lib.estimate_essential_ransac_v2.restype = ctypes.c_int
    lib.estimate_essential_ransac_v2.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # p0
        ctypes.POINTER(ctypes.c_double),  # p1
        ctypes.c_int,                     # n
        ctypes.c_double,                  # threshold
        ctypes.c_int,                     # max_iters
        ctypes.c_int,                     # solver: 0 = 8pt, 1 = 5pt
        ctypes.c_int,                     # scoring: 0 = msac, 1 = magsac
        ctypes.c_uint64,                  # seed
        ctypes.POINTER(ctypes.c_double),  # E out (9)
        ctypes.POINTER(ctypes.c_double),  # R out (9)
        ctypes.POINTER(ctypes.c_double),  # t out (3)
        ctypes.POINTER(ctypes.c_uint8),   # inliers out (n)
    ]
    _lib = lib
    return lib


def estimate_essential_ransac_native(
    p0: np.ndarray,
    p1: np.ndarray,
    threshold: float,
    max_iters: int = 1000,
    solver: str = "5pt",
    scoring: str = "magsac",
    seed: int = 0,
):
    """K-normalized correspondences -> (E, R, t, inliers) or None."""
    lib = load_library()
    p0 = np.ascontiguousarray(p0, np.float64)
    p1 = np.ascontiguousarray(p1, np.float64)
    if p0.shape != p1.shape or p0.ndim != 2 or p0.shape[1] != 2:
        raise ValueError(f"expected two (n, 2) point sets, got {p0.shape} and {p1.shape}")
    n = len(p0)
    E = np.zeros(9)
    R = np.zeros(9)
    t = np.zeros(3)
    inl = np.zeros(n, np.uint8)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    n_inl = lib.estimate_essential_ransac_v2(
        dptr(p0), dptr(p1), n, float(threshold), int(max_iters),
        1 if solver == "5pt" else 0, 1 if scoring == "magsac" else 0,
        int(seed), dptr(E), dptr(R), dptr(t),
        inl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if n_inl <= 0:
        return None
    return E.reshape(3, 3), R.reshape(3, 3), t, inl.astype(bool)


def estimate_pose_cpp(kpts0, kpts1, K0, K1, norm_thresh, conf=0.99999, seed=0,
                      solver="5pt", scoring="magsac"):
    """Benchmark-backend contract: pixels in, (R, t, inliers) out."""
    if len(kpts0) < (5 if solver == "5pt" else 8):
        return None
    q0 = (kpts0 - K0[None, :2, 2]) @ np.linalg.inv(K0[:2, :2]).T
    q1 = (kpts1 - K1[None, :2, 2]) @ np.linalg.inv(K1[:2, :2]).T
    ret = estimate_essential_ransac_native(
        q0, q1, norm_thresh, solver=solver, scoring=scoring, seed=seed
    )
    if ret is None:
        return None
    _E, R, t, inl = ret
    return R, t[:, None], inl
