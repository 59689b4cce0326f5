"""Batched 5-point essential-matrix minimal solver (Nistér/Stewenius).

The reference protocol's `cv2.findEssentialMat` is the 5-point solver
(romatch/utils/utils.py:39); an 8-point stand-in's 8-sample minimal draws
collapse at low inlier ratios. This solver is formulated for batch
execution: all S minimal samples are
solved simultaneously with stacked linear algebra (SVD nullspaces, one
batched 10x10 solve, one batched 10x10 eigendecomposition), so the RANSAC
loop stays a handful of numpy calls.

Method (Stewenius et al., "Recent developments on direct relative
orientation", ISPRS 2006 — the action-matrix variant):

1. The 5 epipolar constraints give a 4-dim nullspace: E = x E1 + y E2 +
   z E3 + E4.
2. det(E) = 0 and the trace constraint 2 E Eᵀ E - tr(E Eᵀ) E = 0 give 10
   cubic equations in (x, y, z). Their coefficients are computed here by
   *generic polynomial arithmetic* over exponent tuples (no hand-derived
   coefficient tables to get wrong).
3. Gauss-Jordan elimination of the 10 degree-3 leading monomials yields the
   action matrix of multiplication-by-x on the quotient-ring basis
   [x², xy, xz, y², yz, z², x, y, z, 1]; its eigenvectors evaluate the
   basis at the (up to 10) roots.
"""

from __future__ import annotations

import numpy as np

# quotient-ring basis (columns 10..19 of the constraint matrix)
_BASIS = [
    (2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
    (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0),
]
# leading degree-3 monomials eliminated by the reduction (columns 0..9)
_LEADING = [
    (3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
    (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3),
]
_COLS = {e: i for i, e in enumerate(_LEADING + _BASIS)}


def _pmul(p: dict, q: dict) -> dict:
    out: dict = {}
    for ea, ca in p.items():
        for eb, cb in q.items():
            e = (ea[0] + eb[0], ea[1] + eb[1], ea[2] + eb[2])
            out[e] = out[e] + ca * cb if e in out else ca * cb
    return out


def _padd(*ps: dict) -> dict:
    out: dict = {}
    for p in ps:
        for e, c in p.items():
            out[e] = out[e] + c if e in out else c
    return out


def _pscale(p: dict, s: float) -> dict:
    return {e: c * s for e, c in p.items()}


def _nullspace_basis(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """(S, 5, 2) x2 -> (S, 4, 3, 3) nullspace basis of the epipolar rows."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    ones = np.ones_like(x0)
    A = np.stack(
        [x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], axis=-1
    )  # (S, 5, 9)
    _, _, vt = np.linalg.svd(A, full_matrices=True)
    return vt[:, 5:9].reshape(-1, 4, 3, 3)


def _constraint_matrix(Eb: np.ndarray) -> np.ndarray:
    """(S, 4, 3, 3) basis -> (S, 10, 20) cubic-constraint coefficients."""
    S = Eb.shape[0]

    # E entries as degree-1 polynomials in (x, y, z)
    unit = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
    E = [[{unit[b]: Eb[:, b, i, j] for b in range(4)} for j in range(3)]
         for i in range(3)]

    eqs: list[dict] = []

    # det(E) = 0
    det = _padd(
        _pmul(E[0][0], _padd(_pmul(E[1][1], E[2][2]),
                             _pscale(_pmul(E[1][2], E[2][1]), -1.0))),
        _pscale(_pmul(E[0][1], _padd(_pmul(E[1][0], E[2][2]),
                                     _pscale(_pmul(E[1][2], E[2][0]), -1.0))), -1.0),
        _pmul(E[0][2], _padd(_pmul(E[1][0], E[2][1]),
                             _pscale(_pmul(E[1][1], E[2][0]), -1.0))),
    )
    eqs.append(det)

    # 2 E Eᵀ E - tr(E Eᵀ) E = 0 (9 equations)
    EEt = [[_padd(*[_pmul(E[i][k], E[j][k]) for k in range(3)])
            for j in range(3)] for i in range(3)]
    tr = _padd(EEt[0][0], EEt[1][1], EEt[2][2])
    for i in range(3):
        for j in range(3):
            lhs = _padd(*[_pmul(EEt[i][k], E[k][j]) for k in range(3)])
            eqs.append(_padd(_pscale(lhs, 2.0), _pscale(_pmul(tr, E[i][j]), -1.0)))

    M = np.zeros((S, 10, 20))
    for r, eq in enumerate(eqs):
        for e, c in eq.items():
            M[:, r, _COLS[e]] = c
    return M


def essential_5pt(p0: np.ndarray, p1: np.ndarray) -> np.ndarray:
    """Batched minimal solve: (S, 5, 2) x2 K-normalized points ->
    (M, 3, 3) essential matrices (all real roots of all samples, unit
    Frobenius norm). Degenerate samples are dropped."""
    p0 = np.asarray(p0, np.float64)
    p1 = np.asarray(p1, np.float64)
    Eb = _nullspace_basis(p0, p1)
    M = _constraint_matrix(Eb)

    A, B = M[:, :, :10], M[:, :, 10:]
    # drop samples whose leading 10x10 block is numerically singular
    ok = np.abs(np.linalg.det(A)) > 1e-16
    if not np.any(ok):
        return np.zeros((0, 3, 3))
    Eb, A, B = Eb[ok], A[ok], B[ok]
    G = np.linalg.solve(A, B)  # (S, 10, 10): leading = -G @ basis

    # action matrix of multiplication by x on _BASIS
    S = G.shape[0]
    Ax = np.zeros((S, 10, 10))
    # x * [x², xy, xz, y², yz, z²] = [x³, x²y, x²z, xy², xyz, xz²] = leading 0..5
    Ax[:, 0:6, :] = -G[:, 0:6, :]
    # x * x = x² (basis 0), x * y = xy (1), x * z = xz (2), x * 1 = x (6)
    Ax[:, 6, 0] = 1.0
    Ax[:, 7, 1] = 1.0
    Ax[:, 8, 2] = 1.0
    Ax[:, 9, 6] = 1.0

    lam, vec = np.linalg.eig(Ax)  # (S, 10), (S, 10, 10)
    real = np.abs(lam.imag) < 1e-8 * (1.0 + np.abs(lam.real))
    # evaluate (x, y, z) = (v[6], v[7], v[8]) / v[9]
    v = vec.transpose(0, 2, 1)  # (S, root, basis)
    w = v[..., 9]
    good = real & (np.abs(w) > 1e-12)
    if not np.any(good):
        return np.zeros((0, 3, 3))
    sel_s, sel_r = np.nonzero(good)
    vv = v[sel_s, sel_r].real
    x = vv[:, 6] / vv[:, 9]
    y = vv[:, 7] / vv[:, 9]
    z = vv[:, 8] / vv[:, 9]

    Ebs = Eb[sel_s]  # (R, 4, 3, 3)
    E = (
        x[:, None, None] * Ebs[:, 0]
        + y[:, None, None] * Ebs[:, 1]
        + z[:, None, None] * Ebs[:, 2]
        + Ebs[:, 3]
    )
    nrm = np.linalg.norm(E, axis=(1, 2), keepdims=True)
    return E / np.maximum(nrm, 1e-12)
