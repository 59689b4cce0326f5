"""Global pose-graph initialization from pairwise relative poses.

Net-new subsystem (SURVEY §2.5): the two-view estimator gives relative
(R_ij, t_ij-direction); this module chains them into global camera poses:

- rotation averaging: chordal relaxation — stack the linear constraints
  R_j = R_ij R_i into a sparse least-squares system over the 3x3 entries,
  take the smallest eigenvectors, project each block onto SO(3).
- translation averaging: with rotations fixed, each pair constrains the
  baseline direction; solve the standard least-squares on
  || (I - d d^T)(c_j - c_i) ||^2 with unit-scale gauge fixing.

All dense-linear-algebra on numpy (host); problem sizes here are
n_cams x {9, 3} — tiny next to the BA that follows.

The port's copy of the JAX package's `sfm/pose_graph.py` (numpy, unchanged).
"""

from __future__ import annotations

import numpy as np


def project_to_so3(M: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(M)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1.0]) @ Vt
    return R


def rotation_averaging(
    n_cams: int,
    edges: list[tuple[int, int, np.ndarray]],
    anchor: int = 0,
) -> np.ndarray:
    """edges: (i, j, R_ij) with R_ij taking cam-i coords to cam-j coords.

    Returns (n_cams, 3, 3) world->cam rotations with cam `anchor` = I.
    Chordal: minimize sum ||R_j - R_ij R_i||_F^2 over stacked 3x3 blocks via
    the null-space (smallest eigenvectors) of the connection Laplacian.
    """
    n = 3 * n_cams
    A = np.zeros((n, n))
    for i, j, R_ij in edges:
        # ||R_j - R_ij R_i||^2 contributions (block Laplacian)
        ii, jj = 3 * i, 3 * j
        A[ii : ii + 3, ii : ii + 3] += np.eye(3)
        A[jj : jj + 3, jj : jj + 3] += np.eye(3)
        A[jj : jj + 3, ii : ii + 3] += -R_ij
        A[ii : ii + 3, jj : jj + 3] += -R_ij.T
    w, V = np.linalg.eigh(A)
    # the 3 smallest eigenvectors span the stacked rotations (up to a global
    # 3x3 mixing); each camera block is that mixing times its rotation
    basis = V[:, :3]  # (3n, 3)
    blocks = basis.reshape(n_cams, 3, 3)
    # fix the gauge with the anchor camera
    G = blocks[anchor]
    Rs = np.stack([project_to_so3(b @ np.linalg.inv(G)) for b in blocks])
    # anchor exactly identity
    R0 = Rs[anchor]
    return np.einsum("nij,kj->nik", Rs, R0)


def translation_averaging(
    n_cams: int,
    rotations: np.ndarray,
    edges: list[tuple[int, int, np.ndarray]],
    anchor: int = 0,
) -> np.ndarray:
    """edges: (i, j, t_ij) — the relative translation of the world2cam chain
    T_j = [R_ij | t_ij] T_i, i.e. t_ij = t_j - R_ij t_i (scale ambiguous per
    edge). Returns camera centers c (n_cams, 3) with gauge: c[anchor]=0 and
    unit mean baseline.

    Direction-only formulation with per-edge scale variables, which makes the
    problem LINEAR in (centers, scales) jointly:

        min_{c, s}  sum_e || (c_j - c_i) - s_e d_e ||^2
        s.t. c_anchor = 0,  sum_e s_e = n_edges  (scale gauge)

    — one least-squares solve, exact for noise-free cycle-pinned graphs.
    Scales of bridge (tree) edges are direction-unobservable and settle at
    the gauge value; downstream triangulation + BA resolves them from shared
    points.
    """
    dirs = []
    for i, j, t_ij in edges:
        d = -(rotations[j].T @ t_ij)
        nrm = np.linalg.norm(d)
        dirs.append((i, j, d / max(nrm, 1e-12)))

    ne = len(dirs)
    nc = 3 * n_cams
    A = np.zeros((3 * ne + 1, nc + ne))
    for e, (i, j, d) in enumerate(dirs):
        r = 3 * e
        A[r : r + 3, 3 * j : 3 * j + 3] = np.eye(3)
        A[r : r + 3, 3 * i : 3 * i + 3] = -np.eye(3)
        A[r : r + 3, nc + e] = -d
    # scale gauge row: sum of edge scales = ne
    A[-1, nc:] = 1.0
    b = np.zeros(3 * ne + 1)
    b[-1] = float(ne)
    keep = np.ones(nc + ne, bool)
    keep[3 * anchor : 3 * anchor + 3] = False
    sol, *_ = np.linalg.lstsq(A[:, keep], b, rcond=None)
    full = np.zeros(nc + ne)
    full[keep] = sol
    c = full[:nc].reshape(n_cams, 3)
    base = np.mean([np.linalg.norm(c[j] - c[i]) for i, j, _ in dirs])
    return c / max(base, 1e-12)


def centers_to_translations(rotations: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """world2cam t = -R c."""
    return -np.einsum("nij,nj->ni", rotations, centers)
