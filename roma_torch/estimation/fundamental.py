"""Fundamental-matrix estimation (uncalibrated two-view geometry).

Replaces cv2.findFundamentalMat USAC_ACCURATE / USAC_MAGSAC
(romatch/utils/utils.py:54-76, demo/demo_fundamental.py:32-34):
batched 7-point minimal solver (det(F1 + lambda F2) = 0 cubic, all roots) for
hypotheses + normalized 8-point for the LO re-fit, MAGSAC-style
sigma-marginalized scoring, in the vectorized RANSAC core.

`estimate_pose_uncalibrated` mirrors the reference wrapper
(utils/utils.py:54-76): F-RANSAC in pixels -> E = K1^T F K0 -> cheirality
pose recovery on K-normalized points.
"""

from __future__ import annotations

import numpy as np

from roma_torch.estimation.essential import (
    _eight_point,
    recover_pose,
    sampson_sq,
)
from roma_torch.estimation.ransac import RansacResult, ransac


def fundamental_8pt(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    return _eight_point(p0, p1, essential=False)


def fundamental_7pt(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Batched 7-point minimal solver: (S, 7, 2) x2 -> (M, 3, 3).

    The 7 epipolar rows leave a 2-dim nullspace F = F1 + lambda F2;
    det(F1 + lambda F2) = 0 is a cubic whose coefficients are recovered from
    4 determinant evaluations (Vandermonde), and whose roots come from
    batched companion-matrix eigenvalues — 1 to 3 real solutions/sample."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    ones = np.ones_like(x0)
    A = np.stack(
        [x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], axis=-1
    )  # (S, 7, 9)
    _, _, vt = np.linalg.svd(A, full_matrices=True)
    F1 = vt[:, 7].reshape(-1, 3, 3)
    F2 = vt[:, 8].reshape(-1, 3, 3)

    # cubic coefficients of det(F1 + t F2) from evaluations at t in {0,1,-1,2}
    ts = np.array([0.0, 1.0, -1.0, 2.0])
    evals = np.stack(
        [np.linalg.det(F1 + t * F2) for t in ts], axis=-1
    )  # (S, 4)
    V = np.vander(ts, 4)  # columns t^3, t^2, t, 1
    coeffs = evals @ np.linalg.inv(V).T  # (S, 4): [c3, c2, c1, c0]

    models = []
    c3 = coeffs[:, 0]
    cubic = np.abs(c3) > 1e-14 * np.maximum(1.0, np.abs(coeffs).max(axis=1))
    # companion matrices for the cubic samples
    if np.any(cubic):
        cc = coeffs[cubic] / coeffs[cubic, :1]
        comp = np.zeros((len(cc), 3, 3))
        comp[:, 1, 0] = 1.0
        comp[:, 2, 1] = 1.0
        comp[:, :, 2] = -cc[:, [3, 2, 1]]
        lam = np.linalg.eigvals(comp)  # (s, 3)
        real = np.abs(lam.imag) < 1e-9 * (1.0 + np.abs(lam.real))
        src = np.flatnonzero(cubic)
        si, ri = np.nonzero(real)
        t = lam[si, ri].real
        F = F1[src[si]] + t[:, None, None] * F2[src[si]]
        models.append(F)
    # degenerate-to-quadratic/linear samples: the cubic's leading term
    # vanished, so a robust root is not recoverable — keep F1 itself as the
    # hypothesis (its det is near 0 for these near-degenerate samples)
    if not np.all(cubic):
        models.append(F1[~cubic])
    if len(models) == 0:
        return np.zeros((0, 3, 3))
    F = np.concatenate(models, axis=0)
    nrm = np.linalg.norm(F, axis=(1, 2), keepdims=True)
    return F / np.maximum(nrm, 1e-12)


def estimate_fundamental_ransac(
    p0: np.ndarray,
    p1: np.ndarray,
    threshold_px: float,
    max_iters: int = 10000,
    solver: str = "7pt",
    scoring: str = "magsac",
    rng: np.random.Generator | None = None,
) -> RansacResult | None:
    """Pixel correspondences -> F + inliers (7-point + MAGSAC by default)."""
    if solver == "7pt":
        hyp, k = fundamental_7pt, 7
    else:
        hyp, k = fundamental_8pt, 8
    return ransac(
        solver=hyp,
        residual=sampson_sq,
        pts0=p0,
        pts1=p1,
        sample_size=k,
        threshold=threshold_px,
        max_iters=max_iters,
        scoring=scoring,
        lo_solver=fundamental_8pt,
        rng=rng,
    )


def estimate_pose_uncalibrated(
    kpts0: np.ndarray,
    kpts1: np.ndarray,
    K0: np.ndarray,
    K1: np.ndarray,
    norm_thresh: float,
    max_iters: int = 10000,
    rng: np.random.Generator | None = None,
):
    """Uncalibrated pose (reference utils/utils.py:54-76): F-RANSAC on pixel
    correspondences at `norm_thresh * mean focal` pixels, E = K1^T F K0,
    cheirality pose recovery. Returns (R, t, inlier_mask) or None."""
    if len(kpts0) < 8:
        return None
    # the reference passes ransac_thr = norm_thresh scaled back to pixels via
    # the mean focal (utils.py:60-64 uses normalize=False: threshold in px)
    res = estimate_fundamental_ransac(
        kpts0, kpts1, norm_thresh, max_iters=max_iters, rng=rng
    )
    if res is None:
        return None
    F = res.model
    E = K1.T @ F @ K0
    # pose recovery needs K-normalized image points
    q0 = (kpts0 - K0[None, :2, 2]) @ np.linalg.inv(K0[:2, :2]).T
    q1 = (kpts1 - K1[None, :2, 2]) @ np.linalg.inv(K1[:2, :2]).T
    # project E to the essential manifold before decomposition
    U, s, Vt = np.linalg.svd(E)
    sm = (s[0] + s[1]) / 2
    E = U @ np.diag([sm, sm, 0.0]) @ Vt
    R, t, ngood = recover_pose(E, q0, q1, res.inliers)
    if R is None or ngood == 0:
        return None
    return R, t[:, None], res.inliers
