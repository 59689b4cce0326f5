"""Homography estimation (HPatches benchmark path).

Replaces cv2.findHomography RANSAC
(romatch/benchmarks/hpatches_sequences_homog_benchmark.py:80-87):
batched 4-point DLT in the vectorized RANSAC core, scored by forward
transfer error.
"""

from __future__ import annotations

import numpy as np

from roma_torch.estimation.ransac import RansacResult, ransac


def homography_dlt(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Batched DLT: (S, k>=4, 2) x2 -> (S, 3, 3), H mapping p0 -> p1."""
    S, k, _ = p0.shape
    x, y = p0[..., 0], p0[..., 1]
    u, v = p1[..., 0], p1[..., 1]
    zeros = np.zeros_like(x)
    ones = np.ones_like(x)
    r1 = np.stack([-x, -y, -ones, zeros, zeros, zeros, u * x, u * y, u], axis=-1)
    r2 = np.stack([zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], axis=-1)
    A = np.concatenate([r1, r2], axis=1)  # (S, 2k, 9)
    _, _, vt = np.linalg.svd(A)
    H = vt[:, -1].reshape(-1, 3, 3)
    return H / np.where(np.abs(H[:, 2:3, 2:3]) < 1e-12, 1e-12, H[:, 2:3, 2:3])


def transfer_error_sq(H: np.ndarray, p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """(M, 3, 3), (N, 2), (N, 2) -> (M, N) squared forward transfer errors."""
    x0 = np.concatenate([p0, np.ones((len(p0), 1))], axis=-1)
    Hx = np.einsum("mij,nj->mni", H, x0)
    proj = Hx[..., :2] / np.where(np.abs(Hx[..., 2:]) < 1e-12, 1e-12, Hx[..., 2:])
    return np.sum((proj - p1[None]) ** 2, axis=-1)


def estimate_homography_ransac(
    p0: np.ndarray,
    p1: np.ndarray,
    threshold_px: float = 2.0,
    max_iters: int = 2000,
    rng: np.random.Generator | None = None,
) -> RansacResult | None:
    return ransac(
        solver=homography_dlt,
        residual=transfer_error_sq,
        pts0=p0,
        pts1=p1,
        sample_size=4,
        threshold=threshold_px,
        max_iters=max_iters,
        rng=rng,
    )
