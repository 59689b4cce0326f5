"""Essential-matrix estimation + pose recovery (cv2-free).

Replaces the reference's OpenCV calls (utils/utils.py:31-52:
findEssentialMat + recoverPose): batched normalized 8-point solver inside the
vectorized RANSAC core, Sampson scoring, SVD decomposition into the four
(R, t) candidates, and cheirality voting via batched DLT triangulation.
Operates on K-normalized image coordinates, like the reference protocol
(it normalizes with inv(K[:2,:2]) before calling OpenCV).
"""

from __future__ import annotations

import numpy as np

from roma_torch.estimation.ransac import RansacResult, ransac


def _hartley_normalize(pts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(S, k, 2) -> normalized points + (S, 3, 3) transforms."""
    mean = pts.mean(axis=1, keepdims=True)
    d = np.linalg.norm(pts - mean, axis=-1).mean(axis=1)
    s = np.sqrt(2.0) / np.maximum(d, 1e-12)
    T = np.zeros((len(pts), 3, 3))
    T[:, 0, 0] = s
    T[:, 1, 1] = s
    T[:, 2, 2] = 1.0
    T[:, :2, 2] = -s[:, None] * mean[:, 0]
    return (pts - mean) * s[:, None, None], T


def _eight_point(p0: np.ndarray, p1: np.ndarray, essential: bool) -> np.ndarray:
    """Batched normalized 8-point: (S, k>=8, 2) x2 -> (S, 3, 3) F or E."""
    n0, T0 = _hartley_normalize(p0)
    n1, T1 = _hartley_normalize(p1)
    x0, y0 = n0[..., 0], n0[..., 1]
    x1, y1 = n1[..., 0], n1[..., 1]
    ones = np.ones_like(x0)
    # epipolar constraint rows: x1^T F x0 = 0
    A = np.stack(
        [x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], axis=-1
    )  # (S, k, 9)
    # nullspace via eigh(A^T A): a full SVD of (S, k, 9) materializes
    # (k, k) U factors — 4096^2 per LO refit — where the 9x9 Gram is enough
    G = np.einsum("ski,skj->sij", A, A)
    _, vecs = np.linalg.eigh(G)
    F = vecs[..., 0].reshape(-1, 3, 3)
    if not essential:
        # rank-2 enforcement in the normalized frame (standard Hartley 8-pt);
        # rank is preserved by the denormalizing transforms
        U, S, Vt = np.linalg.svd(F)
        S_fix = S.copy()
        S_fix[:, 2] = 0.0
        F = U @ (S_fix[..., None] * Vt)
    # denormalize: F = T1^T F_n T0
    F = np.swapaxes(T1, -1, -2) @ F @ T0
    if essential:
        # project to the essential manifold AFTER denormalization — the
        # Hartley transforms do not preserve the sigma1 == sigma2 structure
        U, S, Vt = np.linalg.svd(F)
        s = (S[:, 0] + S[:, 1]) / 2
        S_fix = np.stack([s, s, np.zeros_like(s)], axis=-1)
        return U @ (S_fix[..., None] * Vt)
    return F / np.maximum(np.abs(F[:, 2:3, 2:3]), 1e-12)


def essential_8pt(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    return _eight_point(p0, p1, essential=True)


def sampson_sq(F: np.ndarray, p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """(M, 3, 3), (N, 2), (N, 2) -> (M, N) squared Sampson distances.

    Matmul-shaped (BLAS (M*3, 3) @ (3, N)) rather than einsum over a
    materialized (M, N, 3): ~4x faster at benchmark sizes (M=256, N=5000)."""
    x0 = np.concatenate([p0, np.ones((len(p0), 1))], axis=-1).T  # (3, N)
    x1 = np.concatenate([p1, np.ones((len(p1), 1))], axis=-1).T
    Fx0 = F @ x0                                # (M, 3, N)
    Ftx1 = F.transpose(0, 2, 1) @ x1            # (M, 3, N)
    e = (x1[None] * Fx0).sum(axis=1)            # x1^T F x0, (M, N)
    denom = Fx0[:, 0] ** 2 + Fx0[:, 1] ** 2 + Ftx1[:, 0] ** 2 + Ftx1[:, 1] ** 2
    return e**2 / np.maximum(denom, 1e-12)


def decompose_essential(E: np.ndarray) -> list[tuple[np.ndarray, np.ndarray]]:
    """E -> the 4 (R, t) candidates (t unit-norm)."""
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def triangulate(R: np.ndarray, t: np.ndarray, p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """DLT triangulation, cams P0=[I|0], P1=[R|t]; returns (N, 3) points."""
    P0 = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    P1 = np.concatenate([R, t[:, None]], axis=1)
    n = len(p0)
    A = np.empty((n, 4, 4))
    A[:, 0] = p0[:, 0, None] * P0[2] - P0[0]
    A[:, 1] = p0[:, 1, None] * P0[2] - P0[1]
    A[:, 2] = p1[:, 0, None] * P1[2] - P1[0]
    A[:, 3] = p1[:, 1, None] * P1[2] - P1[1]
    _, _, vt = np.linalg.svd(A)
    X = vt[:, -1]
    return X[:, :3] / np.where(np.abs(X[:, 3:]) < 1e-12, 1e-12, X[:, 3:])


def recover_pose(
    E: np.ndarray, p0: np.ndarray, p1: np.ndarray, mask: np.ndarray | None = None,
    max_points: int = 512,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Cheirality vote over the 4 decompositions (cv2.recoverPose equivalent)."""
    sel = np.flatnonzero(mask) if mask is not None else np.arange(len(p0))
    if len(sel) > max_points:
        sel = sel[:: max(1, len(sel) // max_points)]
    q0, q1 = p0[sel], p1[sel]
    best = (-1, None, None)
    for R, t in decompose_essential(E):
        X = triangulate(R, t, q0, q1)
        z0 = X[:, 2]
        z1 = (R @ X.T + t[:, None])[2]
        good = int(np.sum((z0 > 0) & (z1 > 0) & (z0 < 50) & (z1 < 50)))
        if good > best[0]:
            best = (good, R, t)
    return best[1], best[2], best[0]


def estimate_essential_ransac(
    p0: np.ndarray,
    p1: np.ndarray,
    threshold: float,
    max_iters: int = 1000,
    solver: str = "5pt",
    scoring: str = "magsac",
    rng: np.random.Generator | None = None,
) -> RansacResult | None:
    """K-normalized correspondences -> E + inliers.

    solver "5pt" (default): Nistér/Stewenius minimal solver — 5 inliers per
    sample, matching cv2.findEssentialMat (reference utils.py:39); "8pt":
    the normalized 8-point. LO always re-fits with the (non-minimal)
    8-point on inliers. scoring "magsac" (sigma-marginalized) or "msac"."""
    if solver == "5pt":
        from roma_torch.estimation.fivepoint import essential_5pt

        hyp, k = essential_5pt, 5
    else:
        hyp, k = essential_8pt, 8
    return ransac(
        solver=hyp,
        residual=sampson_sq,
        pts0=p0,
        pts1=p1,
        sample_size=k,
        threshold=threshold,
        max_iters=max_iters,
        scoring=scoring,
        lo_solver=essential_8pt,
        rng=rng,
    )


def estimate_pose(
    kpts0: np.ndarray,
    kpts1: np.ndarray,
    K0: np.ndarray,
    K1: np.ndarray,
    norm_thresh: float,
    max_iters: int = 1000,
    solver: str = "5pt",
    scoring: str = "magsac",
    rng: np.random.Generator | None = None,
):
    """Reference-protocol pose estimation (utils/utils.py:31-52) without cv2.

    kpts in pixels; K-normalizes, runs E-RANSAC at norm_thresh (5-point
    minimal solver + MAGSAC-style scoring by default, like the reference's
    cv2.findEssentialMat), recovers (R, t) by cheirality.
    Returns (R, t, inlier_mask) or None.
    """
    if len(kpts0) < max(5 if solver == "5pt" else 8, 5):
        return None
    q0 = (kpts0 - K0[None, :2, 2]) @ np.linalg.inv(K0[:2, :2]).T
    q1 = (kpts1 - K1[None, :2, 2]) @ np.linalg.inv(K1[:2, :2]).T
    res = estimate_essential_ransac(
        q0, q1, norm_thresh, max_iters=max_iters, solver=solver,
        scoring=scoring, rng=rng,
    )
    if res is None:
        return None
    R, t, ngood = recover_pose(res.model, q0, q1, res.inliers)
    if R is None or ngood == 0:
        return None
    return R, t[:, None], res.inliers
