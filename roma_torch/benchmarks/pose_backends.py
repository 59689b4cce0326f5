"""Two-view pose estimation backends for the benchmark harnesses.

"cv2": OpenCV E-matrix + recoverPose, the reference protocol's estimator,
the default where OpenCV is installed so AUC numbers compare directly with
published ones.
"native": the C++ estimator (roma_torch/native/ransac.cpp): 5-point Nistér
minimal solver + MAGSAC-style marginalized scoring + LO, the same solver
family as cv2.findEssentialMat / PoseLib; "auto" takes it where OpenCV is
missing (a GPU host without OpenCV); falls back to "numpy" if the build
fails.
"numpy": the vectorized-numpy estimator (roma_torch.estimation), the same
5-point + MAGSAC pipeline.
"""

from __future__ import annotations

import threading

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - host dependent
    cv2 = None

from roma_torch.estimation.essential import estimate_pose as _estimate_pose_numpy

# The C++ build/bind happens once, lazily, on the first native-backend call
# (an import-time build would run the compiler for every importer). The
# outcome, the bound function or the bind error, is memoized: "bind once,
# warn once, fall back to numpy", while per-call estimator exceptions
# propagate, so a C++ fault cannot hide inside benchmark numbers.
_NATIVE_BIND: list | None = None  # [fn | None, Exception | None]
_NATIVE_BIND_LOCK = threading.Lock()


def bind_native():
    """[estimate_pose_cpp | None, bind error | None], built and bound once.

    Double-checked lock: the batched harness calls this from its worker
    pool, and the interpreter lock is released during the build's
    subprocess; without the lock, concurrent first calls race the build and
    can memoize a half-written library's load error, silently moving the
    whole eval to the numpy backend."""
    global _NATIVE_BIND
    if _NATIVE_BIND is None:
        with _NATIVE_BIND_LOCK:
            if _NATIVE_BIND is None:
                try:
                    from roma_torch.estimation.native import estimate_pose_cpp, load_library

                    load_library()  # build + bind (make is a no-op when built)
                    _NATIVE_BIND = [estimate_pose_cpp, None]
                except Exception as e:  # noqa: BLE001 - build-environment dependent; memoized
                    _NATIVE_BIND = [None, e]
    return _NATIVE_BIND


def estimate_pose_cv2(kpts0, kpts1, K0, K1, norm_thresh, conf=0.99999):
    """Reference-protocol pose estimation via OpenCV: K-normalize,
    findEssentialMat at norm_thresh, recoverPose over all E candidates, keep
    the candidate with most inliers."""
    if len(kpts0) < 5:
        return None
    q0 = (kpts0 - K0[None, :2, 2]) @ np.linalg.inv(K0[:2, :2]).T
    q1 = (kpts1 - K1[None, :2, 2]) @ np.linalg.inv(K1[:2, :2]).T
    E, mask = cv2.findEssentialMat(q0, q1, np.eye(3), threshold=norm_thresh, prob=conf)
    if E is None:
        return None
    best = None
    best_inliers = 0
    for Ei in np.split(E, len(E) / 3):
        n, R, t, _ = cv2.recoverPose(Ei, q0, q1, np.eye(3), 1e9, mask=mask)
        if n > best_inliers:
            best_inliers = n
            best = (R, t, mask.ravel() > 0)
    return best


def estimate_pose_numpy(kpts0, kpts1, K0, K1, norm_thresh, conf=0.99999):
    # deterministic given the inputs: the protocol's repetition variance
    # comes from the harness's (seeded) shuffles, not estimator entropy
    return _estimate_pose_numpy(
        kpts0, kpts1, K0, K1, norm_thresh, rng=np.random.default_rng(0)
    )


def estimate_pose_native(kpts0, kpts1, K0, K1, norm_thresh, conf=0.99999):
    """C++ 5-point + MAGSAC + LO; numpy fallback if the build is missing
    (estimator errors at call time propagate)."""
    fn, err = bind_native()
    if fn is None:
        import warnings

        warnings.warn(
            f"native C++ estimator unavailable ({err!r}); using the numpy backend",
            RuntimeWarning,
            stacklevel=2,
        )
        return estimate_pose_numpy(kpts0, kpts1, K0, K1, norm_thresh, conf)
    return fn(kpts0, kpts1, K0, K1, norm_thresh, conf)


def get_pose_backend(name: str = "auto"):
    if name == "cv2" or (name == "auto" and cv2 is not None):
        if cv2 is None:
            raise RuntimeError("cv2 backend requested but OpenCV is unavailable")
        return estimate_pose_cv2
    if name == "numpy":
        return estimate_pose_numpy
    return estimate_pose_native
