"""Trajectory metrics: Umeyama alignment + absolute trajectory error (ATE).

The port's copy of the JAX package's `sfm/metrics.py` (numpy, unchanged).
"""

from __future__ import annotations

import numpy as np


def align_umeyama(
    est: np.ndarray, gt: np.ndarray, with_scale: bool = True
) -> tuple[float, np.ndarray, np.ndarray]:
    """Least-squares similarity aligning est -> gt (camera centers, (N, 3)).

    Returns (scale, R, t) with gt ~= scale * R @ est + t."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    cov = G.T @ E / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (E * E).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / var_e) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def absolute_trajectory_error(
    est_centers: np.ndarray, gt_centers: np.ndarray, with_scale: bool = True
) -> dict:
    """RMSE/mean/median ATE after similarity alignment."""
    s, R, t = align_umeyama(est_centers, gt_centers, with_scale)
    aligned = (s * (R @ est_centers.T)).T + t
    err = np.linalg.norm(aligned - gt_centers, axis=-1)
    return {
        "ate_rmse": float(np.sqrt((err**2).mean())),
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
        "scale": s,
    }
