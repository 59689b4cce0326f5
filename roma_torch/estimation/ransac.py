"""Vectorized RANSAC core.

The reference delegates robust estimation to OpenCV C++
(findEssentialMat/findFundamentalMat/findHomography, utils/utils.py:31-76)
and PoseLib. Here it is a first-class, fully-batched component: all minimal
samples are drawn at once, all candidate models solved as one batched linear-
algebra call, and hypotheses are scored against all correspondences with
matmul-shaped residual evaluations (chunked over models so a 10-root minimal
solver at thousands of iterations stays within memory).

Two scoring modes:
- "msac": truncated squared residual (OpenCV's USAC default family).
- "magsac": sigma-marginalized truncated quadratic — the MAGSAC idea
  (Barath et al.) of scoring without committing to one inlier threshold,
  implemented by numerical marginalization: the truncated-quadratic loss
  min(r^2, tau_j^2)/tau_j^2 is averaged over K sigma levels tau_j spanning
  (0, threshold]. Models whose inliers are tight at many noise scales win
  over models that only pass at the loosest threshold.

A local-optimization (LO) step re-fits on the best hypothesis's inliers
(the core of LO-RANSAC), scored with the same rho.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass
class RansacResult:
    model: np.ndarray
    inliers: np.ndarray          # bool (N,)
    score: float
    num_iters: int


def _rho(r2: np.ndarray, t2: float, scoring: str, levels: int = 8) -> np.ndarray:
    """(M, N) squared residuals -> (M,) scores (lower better)."""
    if scoring == "msac":
        return np.sum(np.minimum(r2, t2), axis=1)
    if scoring == "magsac":
        # sigma-marginalized truncated quadratic, tau_j = threshold * j/K
        taus2 = t2 * (np.arange(1, levels + 1) / levels) ** 2
        s = np.zeros(r2.shape[0])
        for tj2 in taus2:
            s += np.sum(np.minimum(r2, tj2), axis=1) / (tj2 * levels)
        return s
    raise ValueError(f"unknown scoring {scoring!r}")


def ransac(
    solver: Callable[[np.ndarray, np.ndarray], np.ndarray],
    residual: Callable[[np.ndarray, np.ndarray, np.ndarray], np.ndarray],
    pts0: np.ndarray,
    pts1: np.ndarray,
    sample_size: int,
    threshold: float,
    max_iters: int = 2000,
    confidence: float = 0.99999,
    lo_iters: int = 2,
    lo_sample_max: int = 4096,
    scoring: str = "msac",
    model_chunk: int = 256,
    lo_solver: Callable[[np.ndarray, np.ndarray], np.ndarray] | None = None,
    rng: np.random.Generator | None = None,
) -> RansacResult | None:
    """Batched hypothesize-and-verify.

    solver: (S, k, 2), (S, k, 2) minimal samples -> (M, 3, 3) candidate models
      (M may exceed S when a minimal problem has multiple roots).
    residual: (M, 3, 3), (N, 2), (N, 2) -> (M, N) squared residuals.
    lo_solver: non-minimal solver for the LO re-fit (e.g. 8-point when the
      hypothesis solver is the 5-point minimal); defaults to `solver`.
    """
    lo_solver = lo_solver or solver
    rng = rng or np.random.default_rng(0)
    n = len(pts0)
    if n < sample_size:
        return None

    t2 = threshold * threshold
    best_model = None
    best_score = np.inf
    best_inliers = None
    drawn = 0
    needed = max_iters
    block = min(max_iters, 128)
    # adaptive RANSAC: draw hypothesis samples in blocks (keeps the batched
    # solve/score shape), update the needed-iteration bound from the best
    # inlier ratio after each block, stop early when satisfied
    while drawn < min(max_iters, needed):
        m = min(block, max_iters - drawn)
        idx = np.stack(
            [rng.choice(n, sample_size, replace=False) for _ in range(m)]
        )
        drawn += m
        models = solver(pts0[idx], pts1[idx])
        if models is None or len(models) == 0:
            continue
        improved = False
        for lo in range(0, len(models), model_chunk):
            chunk = models[lo : lo + model_chunk]
            scores = _rho(residual(chunk, pts0, pts1), t2, scoring)
            j = int(np.argmin(scores))
            if scores[j] < best_score:
                best_score = float(scores[j])
                best_model = chunk[j]
                improved = True
        if improved:
            best_inliers = residual(best_model[None], pts0, pts1)[0] < t2
            needed = adaptive_num_iters(
                best_inliers.mean(), sample_size, confidence
            )
    if best_model is None:
        return None

    # local optimization: iterated re-fit on inliers
    for _ in range(lo_iters):
        ni = int(best_inliers.sum())
        if ni <= sample_size:
            break
        sel = np.flatnonzero(best_inliers)
        if ni > lo_sample_max:
            sel = rng.choice(sel, lo_sample_max, replace=False)
        refit = lo_solver(pts0[None, sel], pts1[None, sel])
        if refit is None or len(refit) == 0:
            break
        r2_lo = residual(refit, pts0, pts1)
        s_lo = _rho(r2_lo, t2, scoring)
        j = int(np.argmin(s_lo))
        if s_lo[j] < best_score:
            best_score = float(s_lo[j])
            best_model = refit[j]
            best_inliers = r2_lo[j] < t2
        else:
            break

    return RansacResult(best_model, best_inliers, best_score, drawn)


def adaptive_num_iters(inlier_ratio: float, sample_size: int, confidence: float) -> int:
    """Draws for `confidence` of one all-inlier sample, as the JAX package
    counts them; where eps**sample_size is below float64's resolution at 1
    (an inlier ratio under ~0.5% for 7-point samples) no finite count is
    enough, and the JAX formula divides by a zero log (ROADMAP C13): the
    count is then unbounded (the caller's `max_iters` stops the loop)."""
    eps = max(inlier_ratio, 1e-3)
    denom = np.log(max(1 - eps**sample_size, 1e-12))
    if denom == 0.0:
        return np.iinfo(np.int64).max
    return int(np.ceil(np.log(1 - confidence) / denom))
