"""Bundle adjustment with Schur-complement reduction, in PyTorch.

The port of the JAX package's `sfm/bundle_adjust.py`, function for
function. Levenberg-Marquardt over camera poses (axis-angle + translation,
world2cam) and 3D points, with the camera system solved through the Schur
complement

  H = [U  W; W^T V],   S = U - W V^-1 W^T   (reduced camera system)

either matrix-free (S's matvec is per-observation segment sums:
u_k = W_k^T x[cam_k]; s_p = V_p^-1 sum_{k in p} u_k; y[cam_k] -= W_k s_p)
or dense. A segment sum is `index_add_` into a zeroed tensor.

Jacobians are exact: `torch.func.vmap(torch.func.jacfwd(_residual))`, as
the JAX package's vmapped jacfwd.

Dtypes are explicit, as the JAX package's are under its `enable_x64`
scope: the per-observation work is float32, the device drivers' Schur
residuals and refinement float64. The algorithm is the JAX package's
(float32 Cholesky of the Jacobi-scaled dense system with float64 iterative
refinement; closed-form 3x3 factors; float32 CG with float64 refinement),
not a direct float64 solve, so that the port computes the same numbers.

Distribution (`mesh`): each rank holds its contiguous slice of the padded
observation axis (padding carries mask 0); cameras and points are
replicated; every per-camera and per-point segment sum, and the cost, is
summed over the mesh's group (`all_reduce`). The JAX package's sharding
constraints on per-camera and per-point state are placement only: the
replicated state computes the same numbers.

The device drivers read nothing back inside an LM iteration: the
factorisations are the `_ex` variants, accept/reject, the NaN guard and
lambda are device tensors, and the refilter cadence is a Python check on
the iteration index. They read the cost back once at the end, and once a
chunk with `iters_per_launch`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from roma_torch.device import resolve_device

F32, F64 = torch.float32, torch.float64


# ---------------------------------------------------------------------------
# se3 / projection
# ---------------------------------------------------------------------------

def _skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3).

    R = I + a [v]x + b [v]x^2 with a = sin(t)/t, b = (1-cos t)/t^2 and
    Taylor branches selected by the double-where trick: differentiable and
    NaN-free at v = 0, where camera 0 sits by gauge. The identity takes the
    input's dtype, so a float32 rotation never promotes."""
    # (..., 1), never 0-d: under torch.func.jacfwd a `where` of 0-d duals
    # returns float64 tangents
    t2 = torch.sum(rvec * rvec, -1, keepdim=True)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)  # keeps the exact branch NaN-free
    t = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2s)
    K = _skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + a[..., None] * K + b[..., None] * (K @ K)


def project(cam: torch.Tensor, K: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """cam (..., 6) = [rvec, t] world2cam; K (..., 3, 3); X (..., 3) -> pixel (..., 2)."""
    R = rodrigues(cam[..., :3])
    Xc = (R @ X[..., None])[..., 0] + cam[..., 3:]
    x = (K @ Xc[..., None])[..., 0]
    return x[..., :2] / torch.clamp(x[..., 2:], min=1e-8)


def _residual(cam, X, uv_n):
    """Reprojection residual in NORMALIZED camera coordinates (one
    observation: cam (6,), X (3,), uv_n (2,)). Pixel-unit residuals give the
    Gauss-Newton system a condition number of ~focal^2 * geometry, which
    breaks fp32 CG; in normalized units the Jacobian entries are O(1)."""
    R = rodrigues(cam[:3])
    Xc = R @ X + cam[3:]
    return Xc[:2] / torch.clamp(Xc[2], min=1e-8) - uv_n


_res_jac = torch.func.vmap(torch.func.jacfwd(_residual, argnums=(0, 1)))
_res_vec = torch.func.vmap(_residual)


class BAProblem(NamedTuple):
    """Static-shape BA problem, tensors on one device. The observation axis
    is what a mesh splits."""

    cameras: torch.Tensor      # (n_cams, 6) [rvec, tvec] world2cam, float32
    points: torch.Tensor       # (n_pts, 3) float32
    intrinsics: torch.Tensor   # (n_cams, 3, 3) float32
    cam_idx: torch.Tensor      # (n_obs,) int64
    pt_idx: torch.Tensor       # (n_obs,) int64
    uv: torch.Tensor           # (n_obs, 2) pixel observations, float32
    mask: torch.Tensor         # (n_obs,) 1.0 valid / 0.0 padding

    @classmethod
    def from_arrays(cls, cameras, points, intrinsics, cam_idx, pt_idx, uv, mask=None,
                    device=None) -> "BAProblem":
        """From arrays (numpy or tensors) on `device` (default: the GPU;
        raises without one unless given "cpu"); `mask` defaults to ones."""
        dev = resolve_device(device)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                   dtype=dtype).to(dev)

        uv = t(uv, F32)
        return cls(cameras=t(cameras, F32), points=t(points, F32),
                   intrinsics=t(intrinsics, F32), cam_idx=t(cam_idx, torch.int64),
                   pt_idx=t(pt_idx, torch.int64), uv=uv,
                   mask=torch.ones(len(uv), dtype=F32, device=dev) if mask is None
                   else t(mask, F32))

    def pad_obs(self, multiple: int) -> "BAProblem":
        """The observation axis padded to a multiple of `multiple` (index 0,
        uv 0, mask 0), as the JAX package pads to its mesh."""
        pad = (-len(self.uv)) % multiple
        if not pad:
            return self
        z = lambda a: torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])  # noqa: E731
        return self._replace(cam_idx=z(self.cam_idx), pt_idx=z(self.pt_idx),
                             uv=z(self.uv), mask=z(self.mask))

    def obs_shard(self, rank: int, world: int) -> "BAProblem":
        """Rank `rank`'s contiguous slice of the observation axis (which
        must split evenly over `world`)."""
        n = len(self.uv)
        if n % world:
            raise ValueError(f"{n} observations do not split over {world} ranks; pad_obs first")
        s = slice(rank * n // world, (rank + 1) * n // world)
        return self._replace(cam_idx=self.cam_idx[s], pt_idx=self.pt_idx[s], uv=self.uv[s],
                             mask=self.mask[s])


def _group(mesh):
    """The process group of a mesh (a DeviceMesh over the ranks), or None."""
    return None if mesh is None else mesh.get_group()


def _local(p: BAProblem, mesh) -> BAProblem:
    """This rank's share of a problem that every rank holds whole."""
    if mesh is None:
        return p
    return p.obs_shard(mesh.get_local_rank(), mesh.size())


def _allsum(x: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _index_add_(out: torch.Tensor, idx: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """out[idx[k]] += data[k]. On the GPU `index_add_` sums with float
    atomics, in an order that changes from run to run; under
    `torch.use_deterministic_algorithms(True)` the sorted `index_put_`
    accumulation instead, in a fixed order."""
    if out.is_cuda and torch.are_deterministic_algorithms_enabled():
        return out.index_put_((idx,), data, accumulate=True)
    return out.index_add_(0, idx, data)


def segment_sum(data: torch.Tensor, idx: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """sum of `data` rows by `idx` into `n` rows (`jax.ops.segment_sum`),
    summed over `group`'s ranks when one is given."""
    out = _index_add_(data.new_zeros((n,) + data.shape[1:]), idx, data)
    return _allsum(out, group)


def _robust_weight(r2: torch.Tensor, delta: float) -> torch.Tensor:
    """Huber IRLS weight on squared residual norms."""
    r = torch.sqrt(r2 + 1e-12)
    return torch.where(r <= delta, torch.ones_like(r), delta / r)


def _normalized_obs(p: BAProblem):
    """(uv_n, focal): observations in normalized camera coords; `focal` maps
    normalized residual magnitudes back to pixels (for Huber thresholds)."""
    Ks = p.intrinsics[p.cam_idx]
    fx, fy = Ks[:, 0, 0], Ks[:, 1, 1]
    cx, cy = Ks[:, 0, 2], Ks[:, 1, 2]
    uv_n = torch.stack([(p.uv[:, 0] - cx) / fx, (p.uv[:, 1] - cy) / fy], -1)
    return uv_n, 0.5 * (fx + fy)


def _build_blocks(p: BAProblem, huber_delta: float):
    """Robustly weighted residuals (n_obs, 2) and Jacobians (n_obs, 2, 6),
    (n_obs, 2, 3), dead rows exactly zero."""
    cams = p.cameras[p.cam_idx]
    Xs = p.points[p.pt_idx]
    uv_n, focal = _normalized_obs(p)
    r = _res_vec(cams, Xs, uv_n)
    Jc, Jp = _res_jac(cams, Xs, uv_n)
    # masked observations can carry inf residuals (points at the camera
    # plane, gated out by filter_observations): mask with `where`, never
    # `* mask` (0 * inf = NaN)
    live = p.mask > 0
    # near-camera-plane points give ~1e16 Jacobian entries: finite, but their
    # outer products make the float64 Schur blocks numerically indefinite;
    # legit normalized-unit Jacobians are O(1/depth)
    jmax = torch.maximum(Jc.abs().amax(dim=(1, 2)), Jp.abs().amax(dim=(1, 2)))
    live = live & torch.isfinite(jmax) & (jmax < 1e6)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    r = torch.where(live[:, None], r, zero)
    Jc = torch.where(live[:, None, None], Jc, zero)
    Jp = torch.where(live[:, None, None], Jp, zero)
    # clamp: near-camera-plane points overflow float32 squared-pixel residuals
    r2_px = torch.clamp(torch.sum(r * r, -1) * focal * focal, max=1e12)
    w = torch.where(live, _robust_weight(r2_px, huber_delta), zero)
    sw = torch.sqrt(w)[:, None]
    return r * sw, Jc * sw[..., None], Jp * sw[..., None]


def _ba_cost(p: BAProblem, huber_delta: float, group=None) -> torch.Tensor:
    """Robust cost in squared PIXELS (the reported metric), a 0-d tensor."""
    cams = p.cameras[p.cam_idx]
    Xs = p.points[p.pt_idx]
    uv_n, focal = _normalized_obs(p)
    r = _res_vec(cams, Xs, uv_n)
    live = p.mask > 0
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    r = torch.where(live[:, None], r, zero)  # NaN-safe masking (see _build_blocks)
    r2_px = torch.clamp(torch.sum(r * r, -1) * focal * focal, max=1e12)
    w = torch.where(live, _robust_weight(r2_px, huber_delta), zero)
    return _allsum(torch.sum(w * r2_px), group)


def _diag_clamp(M: torch.Tensor, floor: float = 1e-8) -> torch.Tensor:
    """diag(M) as damping matrices, floored for never-observed blocks."""
    return torch.diag_embed(torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1), min=floor))


def _normal_blocks(p: BAProblem, huber_delta: float, group=None):
    """(U, V, W, g_c, g_p): the Gauss-Newton blocks, U, V, g_c, g_p summed
    over `group`; W per observation."""
    n_cams, n_pts = p.cameras.shape[0], p.points.shape[0]
    r, Jc, Jp = _build_blocks(p, huber_delta)
    g_c = segment_sum(torch.einsum("kij,ki->kj", Jc, r), p.cam_idx, n_cams, group)
    g_p = segment_sum(torch.einsum("kij,ki->kj", Jp, r), p.pt_idx, n_pts, group)
    U = segment_sum(torch.einsum("kia,kib->kab", Jc, Jc), p.cam_idx, n_cams, group)
    V = segment_sum(torch.einsum("kia,kib->kab", Jp, Jp), p.pt_idx, n_pts, group)
    W = torch.einsum("kia,kib->kab", Jc, Jp)
    return U, V, W, g_c, g_p


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., a, b) x (..., b) -> (..., a)."""
    return torch.einsum("...ab,...b->...a", A, x)


def _mtv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched transposed product (..., a, b)^T x (..., a) -> (..., b)."""
    return torch.einsum("...ab,...a->...b", A, x)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)


def ba_step(p: BAProblem, lam, n_cg: int = 50, huber_delta: float = 1e9, group=None):
    """One damped Gauss-Newton (LM) step via matrix-free Schur CG (`n_cg`
    Jacobi(U)-preconditioned iterations), or with `n_cg == 0` the dense
    reduced camera system solved directly, all in float32. `group`: the
    observation axis of `p` is this rank's share (see
    `make_distributed_ba_step`).

    Returns (delta_cams (n_cams, 6), delta_points (n_pts, 3), cost)."""
    n_cams, n_pts = p.cameras.shape[0], p.points.shape[0]
    dev = p.cameras.device
    lam = torch.as_tensor(lam, dtype=F32, device=dev)
    U, V, W, g_c, g_p = _normal_blocks(p, huber_delta, group)
    # Marquardt damping: scale by each block's own diagonal so lambda is
    # unit-free (plain lam*I swamps the normalized-unit Hessian)
    U = U + lam * _diag_clamp(U) + 1e-10 * torch.eye(6, dtype=U.dtype, device=dev)
    V = V + lam * _diag_clamp(V) + 1e-10 * torch.eye(3, dtype=V.dtype, device=dev)
    V_inv = torch.linalg.inv_ex(V)[0]

    def schur_matvec(x):  # x (n_cams, 6)
        y = _mv(U, x)
        su = segment_sum(_mtv(W, x[p.cam_idx]), p.pt_idx, n_pts, group)
        s = _mv(V_inv, su)
        return y - segment_sum(_mv(W, s[p.pt_idx]), p.cam_idx, n_cams, group)

    # rhs b = -(g_c - W V^-1 g_p)
    s_g = _mv(V_inv, g_p)
    coup = segment_sum(_mv(W, s_g[p.pt_idx]), p.cam_idx, n_cams, group)
    b = -(g_c - coup)

    if n_cg == 0:
        # dense reduced camera system: S = U_embed - D D^T with
        # D[p] = scatter_c(W_k L_p^-T)
        L = torch.linalg.cholesky_ex(V)[0]
        # C_k = W_k L_p^-T: solve L_p C^T = W_k^T
        Ct = torch.linalg.solve_triangular(L[p.pt_idx], W.transpose(-1, -2), upper=False)
        D = _index_add_(torch.zeros((n_pts * n_cams, 6, 3), dtype=F32, device=dev),
                        p.pt_idx * n_cams + p.cam_idx, Ct.transpose(-1, -2))
        Dm = _allsum(D, group).reshape(n_pts, n_cams * 6, 3)
        A = Dm.permute(1, 0, 2).reshape(n_cams * 6, n_pts * 3)
        S = -(A @ A.T)
        S = S.reshape(n_cams, 6, n_cams, 6)
        ar = torch.arange(n_cams, device=dev)
        S[ar, :, ar, :] += U
        S = S.reshape(n_cams * 6, n_cams * 6)
        delta_c = torch.linalg.solve_ex(S, b.reshape(-1))[0].reshape(n_cams, 6)
    else:
        # Jacobi-preconditioned CG (matrix-free; the distributed path)
        U_diag_inv = torch.linalg.inv_ex(U)[0]
        x = torch.zeros_like(b)
        rr = b
        z = _mv(U_diag_inv, b)
        pdir = z
        for _ in range(n_cg):
            Ap = schur_matvec(pdir)
            rz = _dot(rr, z)
            alpha = rz / torch.clamp(_dot(pdir, Ap), min=1e-12)
            x = x + alpha * pdir
            r_new = rr - alpha * Ap
            z_new = _mv(U_diag_inv, r_new)
            beta = _dot(r_new, z_new) / torch.clamp(rz, min=1e-12)
            rr, z, pdir = r_new, z_new, z_new + beta * pdir
        delta_c = x

    # back-substitute points: delta_p = -V^-1 (g_p + W^T delta_c)
    wtd = segment_sum(_mtv(W, delta_c[p.cam_idx]), p.pt_idx, n_pts, group)
    delta_p = -_mv(V_inv, g_p + wtd)
    return delta_c, delta_p, _ba_cost(p, huber_delta, group)


def make_distributed_ba_step(mesh, n_cg: int = 50, huber_delta: float = 1e9):
    """`ba_step` with the observation axis split over `mesh` (a DeviceMesh
    over the ranks of torch.distributed; every rank calls the step with the
    whole problem, padded to a multiple of the mesh): each rank linearises
    its share, and the segment sums and the cost are summed over the mesh's
    group. Cameras and points are replicated; so are the results."""
    def step(p: BAProblem, lam):
        return ba_step(_local(p, mesh), lam, n_cg=n_cg, huber_delta=huber_delta,
                       group=_group(mesh))

    return step


# ---------------------------------------------------------------------------
# host driver: float64 Schur solve in numpy
# ---------------------------------------------------------------------------

@torch.no_grad()
def _ba_blocks(p: BAProblem, huber_delta: float = 1e9):
    """Block extraction (on the problem's device) for the host-precision
    Schur solve."""
    return _normal_blocks(p, huber_delta)


def _host_schur_solve(U, V, W, g_c, g_p, cam_idx, pt_idx, lam, fix_first_cam=True):
    """Exact damped GN step in float64 on host. The reduced camera system has
    cond ~1e9 (gauge + mixed units), beyond fp32 — the LM driver solves it at
    full precision; sizes are (6 n_cams)^2."""
    U = U.astype(np.float64)
    V = V.astype(np.float64)
    W = W.astype(np.float64)
    g_c = g_c.astype(np.float64)
    g_p = g_p.astype(np.float64)
    nc, npt = len(U), len(V)
    U = U + lam * np.stack([np.diag(np.maximum(np.diag(u), 1e-8)) for u in U])
    V = V + lam * np.stack([np.diag(np.maximum(np.diag(v), 1e-8)) for v in V])
    V = 0.5 * (V + np.transpose(V, (0, 2, 1)))
    # PSD projection: V is PSD by construction only up to rounding of its own
    # magnitude (near-plane points give ~1e10 entries); clamp eigenvalues so
    # the Cholesky below is unconditionally valid. Zero-observation points
    # get eps*I (their g_p is 0, so delta_p stays 0).
    evals, evecs = np.linalg.eigh(V)
    floor = 1e-8 + 1e-9 * np.maximum(evals[:, -1], 0.0)
    evals = np.maximum(evals, floor[:, None])
    V = np.einsum("pab,pb,pcb->pac", evecs, evals, evecs)
    if fix_first_cam:
        # pin the gauge INSIDE the system — zeroing the delta after solving a
        # coupled system injects inconsistency into every other update
        U[0] += 1e10 * np.eye(6)
    V_inv = np.linalg.inv(V)
    # dense S via per-point scatter of C = W L^-T  (C L^T = W  <=>  L C^T = W^T)
    L = np.linalg.cholesky(V)
    C = np.linalg.solve(L[pt_idx], np.transpose(W, (0, 2, 1))).transpose(0, 2, 1)
    D = np.zeros((npt, nc, 6, 3))
    np.add.at(D, (pt_idx, cam_idx), C)
    Dm = D.reshape(npt, nc * 6, 3)
    S = -np.einsum("pax,pbx->ab", Dm, Dm)
    for c in range(nc):
        S[6 * c : 6 * c + 6, 6 * c : 6 * c + 6] += U[c]
    s_g = np.einsum("pab,pb->pa", V_inv, g_p)
    coup = np.zeros((nc, 6))
    np.add.at(coup, cam_idx, np.einsum("kab,kb->ka", W, s_g[pt_idx]))
    b = -(g_c - coup)
    delta_c = np.linalg.solve(S, b.reshape(-1)).reshape(nc, 6)
    wtd = np.zeros((npt, 3))
    np.add.at(wtd, pt_idx, np.einsum("kab,ka->kb", W, delta_c[cam_idx]))
    delta_p = -np.einsum("pab,pb->pa", V_inv, g_p + wtd)
    return delta_c, delta_p


def reprojection_errors_px(p: BAProblem) -> tuple[torch.Tensor, torch.Tensor]:
    """(per-observation reprojection error in px, cheirality ok flags)."""
    cams = p.cameras[p.cam_idx]
    Xs = p.points[p.pt_idx]
    uv_n, focal = _normalized_obs(p)
    Rs = rodrigues(cams[:, :3])
    Xc = torch.einsum("kij,kj->ki", Rs, Xs) + cams[:, 3:]
    r = Xc[:, :2] / torch.clamp(Xc[:, 2:], min=1e-8) - uv_n
    err_px = torch.linalg.vector_norm(r, dim=-1) * focal
    return err_px, Xc[:, 2] > 1e-3


@torch.no_grad()
def filter_observations(
    p: BAProblem, max_err_px: float, keep_quantile: float | None = None
) -> BAProblem:
    """Zero the mask of observations whose CURRENT reprojection error exceeds
    the gate or whose point sits behind its camera (static shapes: the gate
    is the mask, nothing is resized). Outlier tracks otherwise dominate the
    robust cost linearly (w*r^2 = delta*r) and stall LM.

    `keep_quantile` loosens the gate to at least that quantile of the
    currently-valid errors, linearly interpolated between the bracketing
    order statistics of the VALID entries only (invalid ones sort to +inf
    and the rank is taken within the valid count), on the device."""
    err_px, in_front = reprojection_errors_px(p)
    gate = max_err_px
    if keep_quantile is not None:
        n = err_px.shape[0]
        valid = (p.mask > 0) & in_front & torch.isfinite(err_px)
        n_valid = torch.sum(valid)
        sorted_err = torch.sort(torch.where(valid, err_px, torch.full_like(err_px, torch.inf)))[0]
        pos = keep_quantile * torch.clamp(n_valid - 1, min=0).to(err_px.dtype)
        rank = torch.clamp(pos.to(torch.int64), 0, n - 1)
        rank_hi = torch.clamp(torch.minimum(rank + 1, n_valid - 1), 0, n - 1)
        frac = pos - rank.to(pos.dtype)
        # index by 1-element tensors: a 0-d index would read it back to the host
        lo, hi = (sorted_err.index_select(0, r.reshape(1))[0] for r in (rank, rank_hi))
        q_interp = lo * (1 - frac) + hi * frac
        q = torch.where(n_valid > 0, q_interp, torch.full_like(q_interp, max_err_px))
        gate = torch.clamp(q, min=max_err_px)
    keep = (err_px < gate) & in_front
    return p._replace(mask=p.mask * keep.to(p.mask.dtype))


def bundle_adjust(
    problem: BAProblem,
    iters: int = 20,
    lam0: float = 1e-4,
    huber_delta: float = 1e9,
    fix_first_cam: bool = True,
    max_err_px: float | None = None,
    refilter_every: int = 10,
    verbose: bool = False,
):
    """LM driver: residual/Jacobian blocks on the problem's device, the
    exact float64 Schur solve on the host (numpy), one readback an
    iteration. Returns (optimized problem, final robust cost in px^2)."""
    p = problem
    if max_err_px is not None:
        # generous initial gate (keep ~90% of currently-valid observations),
        # tightened to max_err_px at the periodic refilters below
        p = filter_observations(p, max_err_px, keep_quantile=0.9)
    lam = lam0
    cam_idx = p.cam_idx.cpu().numpy()
    pt_idx = p.pt_idx.cpu().numpy()
    with torch.no_grad():
        cost = float(_ba_cost(p, huber_delta))
        for it in range(iters):
            if max_err_px is not None and it > 0 and it % refilter_every == 0:
                # re-admit observations that became consistent, drop new outliers
                p = filter_observations(p._replace(mask=problem.mask), max_err_px)
                cost = float(_ba_cost(p, huber_delta))
            U, V, W, g_c, g_p = [a.cpu().numpy() for a in _ba_blocks(p, huber_delta)]
            dc, dp = _host_schur_solve(U, V, W, g_c, g_p, cam_idx, pt_idx, lam, fix_first_cam)
            if fix_first_cam:
                dc[0] = 0.0  # exactly zero the (already ~zero) pinned block
            dev = p.cameras.device
            cand = p._replace(
                cameras=p.cameras + torch.as_tensor(dc, dtype=F32).to(dev),
                points=p.points + torch.as_tensor(dp, dtype=F32).to(dev),
            )
            new_cost = float(_ba_cost(cand, huber_delta))
            if new_cost < cost:
                p, cost = cand, new_cost
                lam = max(lam * 0.3, 1e-10)
            else:
                lam = min(lam * 5.0, 1e6)
            if verbose:
                print(f"BA it {it}: cost {cost:.6g} lam {lam:.2e}")
    return p, cost


# ---------------------------------------------------------------------------
# device driver: float32 work, float64 refinement, no readback
# ---------------------------------------------------------------------------

def _chol3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form lower Cholesky of batched SPD 3x3 (the JAX package's
    elementwise form, which its float64 TPU path needs; kept for the same
    numbers)."""
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    tiny = 1e-30
    l11 = torch.sqrt(torch.clamp(a11, min=tiny))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.clamp(a22 - l21 * l21, min=tiny))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a33 - l31 * l31 - l32 * l32, min=tiny))
    z = torch.zeros_like(l11)
    return torch.stack([
        torch.stack([l11, z, z], -1),
        torch.stack([l21, l22, z], -1),
        torch.stack([l31, l32, l33], -1),
    ], -2)


def _inv3_spd(A: torch.Tensor) -> torch.Tensor:
    """Closed-form (adjugate) inverse of batched symmetric 3x3."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    ca = d * f - e * e
    cb = c * e - b * f
    cc = b * e - c * d
    det = a * ca + b * cb + c * cc
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    cd = a * f - c * c
    ce = b * c - a * e
    cf = a * d - b * b
    inv = torch.stack([
        torch.stack([ca, cb, cc], -1),
        torch.stack([cb, cd, ce], -1),
        torch.stack([cc, ce, cf], -1),
    ], -2)
    return inv / det[..., None, None]


def _pin_first_cam(U: torch.Tensor) -> torch.Tensor:
    """Pin the gauge INSIDE the system: zeroing the delta after solving a
    coupled system injects inconsistency into every other update."""
    pin = torch.zeros_like(U)
    pin[0] = 1e10 * torch.eye(6, dtype=U.dtype, device=U.device)
    return U + pin


def _dense_schur_solve_f64(U, V, W, g_c, g_p, cam_idx, pt_idx, fix_first_cam, group=None,
                           n_refine=4):
    """Damped-GN camera/point deltas via a dense reduced camera system on
    the device: the per-observation work (U, V, W, the D scatter and its
    Gram matrix) in float32, the ill-conditioned part (cond(S) ~1e9: gauge
    pin + mixed units) in float64: the (6 n_cams)^2 system is Jacobi-scaled,
    factorized ONCE by a float32 Cholesky, and corrected by `n_refine`
    (four) float64 iterative-refinement sweeps (the JAX package's
    algorithm, whose TPU has no float64 factorization; `n_refine=0` is the
    float32 solve alone). `_host_schur_solve` is the test oracle.
    `group`: the observation axis is this rank's share; D and the segment
    sums are summed over it."""
    n_cams, n_pts = U.shape[0], V.shape[0]
    dev = U.device
    if fix_first_cam:
        U = _pin_first_cam(U)
    # V: PSD up to fp32 segment-sum rounding; a relative diagonal floor
    # dominates that rounding so the factorization is valid. Zero-observation
    # points get eps*I (their g_p is 0, so delta_p stays 0).
    Vd = V.to(F64)
    Vd = 0.5 * (Vd + Vd.transpose(-1, -2))
    vmax = torch.clamp(torch.diagonal(Vd, dim1=-2, dim2=-1).amax(-1), min=0.0)
    Vd = Vd + (1e-8 + 1e-6 * vmax)[:, None, None] * torch.eye(3, dtype=F64, device=dev)
    L = _chol3(Vd)
    V_inv = _inv3_spd(Vd)
    # dense S via per-point scatter of C = W L^-T (float32)
    Ct = torch.linalg.solve_triangular(L[pt_idx].to(F32), W.transpose(-1, -2), upper=False)
    D = _index_add_(torch.zeros((n_pts * n_cams, 6, 3), dtype=F32, device=dev),
                    pt_idx * n_cams + cam_idx, Ct.transpose(-1, -2))
    A = _allsum(D, group).reshape(n_pts, n_cams * 6, 3).permute(1, 0, 2).reshape(
        n_cams * 6, n_pts * 3)
    S = -(A @ A.T).to(F64)
    S = S.reshape(n_cams, 6, n_cams, 6)
    ar = torch.arange(n_cams, device=dev)
    S[ar, :, ar, :] += U.to(F64)
    S = S.reshape(n_cams * 6, n_cams * 6)
    # rhs b = -(g_c - W V^-1 g_p)
    s_g = _mv(V_inv, g_p.to(F64))
    coup = segment_sum(_mv(W.to(F64), s_g[pt_idx]), cam_idx, n_cams, group)
    b = -(g_c.to(F64) - coup).reshape(-1)
    # Jacobi scaling, float32 factorization, float64 iterative refinement
    d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-12))
    Ssc = S / (d[:, None] * d[None, :]) + 1e-10 * torch.eye(n_cams * 6, dtype=F64, device=dev)
    b_sc = b / d
    Lc = torch.linalg.cholesky_ex(Ssc.to(F32))[0]

    def solve32(r):
        y = torch.linalg.solve_triangular(Lc, r.to(F32)[:, None], upper=False)
        y = torch.linalg.solve_triangular(Lc.T, y, upper=True)
        return y[:, 0].to(F64)

    x = solve32(b_sc)
    for _ in range(n_refine):
        x = x + solve32(b_sc - Ssc @ x)
    delta_c = (x / d).reshape(n_cams, 6)
    # back-substitute points: delta_p = -V^-1 (g_p + W^T delta_c)
    wtd = segment_sum(_mtv(W.to(F64), delta_c[cam_idx]), pt_idx, n_pts, group)
    delta_p = -_mv(V_inv, g_p.to(F64) + wtd)
    return delta_c.to(F32), delta_p.to(F32)


def _cg_schur_solve(U, V, W, g_c, g_p, cam_idx, pt_idx, fix_first_cam,
                    n_inner=60, n_outer=3, group=None, x0=None):
    """Matrix-free Schur-complement camera solve at bounded memory: O(n_obs)
    work and storage, no (n_pts, n_cams) scatter and no (6 n_cams)^2 dense
    system, so it scales past the dense driver's few-hundred-camera ceiling.

    An float32 inner CG preconditioned with the EXACT block diagonal of S
    (block-Jacobi of the reduced system, point-elimination term included,
    which is what makes float32 CG converge at BA conditioning), wrapped in
    a float64 iterative-refinement outer loop whose residuals use float64
    segment-sum matvecs. `group`: the observation axis is this rank's share
    (the JAX package's sharding constraints become these sums; per-camera
    and per-point state is replicated).

    `x0`: optional warm start (the previous LM iteration's delta), kept only
    if it reduces the residual (near convergence the previous delta can be
    a worse guess than zero)."""
    n_cams, n_pts = U.shape[0], V.shape[0]
    dev = U.device
    if fix_first_cam:
        U = _pin_first_cam(U)
    # V: symmetrize + relative diagonal floor (mirrors the dense path), then
    # closed-form SPD inverse per 3x3 block
    Vs = 0.5 * (V + V.transpose(-1, -2))
    vmax = torch.clamp(torch.diagonal(Vs, dim1=-2, dim2=-1).amax(-1), min=0.0)
    Vs = Vs + (1e-8 + 1e-6 * vmax)[:, None, None] * torch.eye(3, dtype=Vs.dtype, device=dev)
    V_inv = _inv3_spd(Vs)

    def schur_matvec(x, U_, W_, Vi_):
        y = _mv(U_, x)
        su = segment_sum(_mtv(W_, x[cam_idx]), pt_idx, n_pts, group)
        s = _mv(Vi_, su)
        return y - segment_sum(_mv(W_, s[pt_idx]), cam_idx, n_cams, group)

    # exact block diagonal of S (one obs per (cam, pt) pair in SfM tracks):
    # S_cc = U_c - sum_{k: cam_k = c} W_k V_{p(k)}^-1 W_k^T
    WVi = torch.einsum("kab,kbc->kac", W, V_inv[pt_idx])
    Sd = U - segment_sum(torch.einsum("kac,kdc->kad", WVi, W), cam_idx, n_cams, group)
    Sd = 0.5 * (Sd + Sd.transpose(-1, -2))
    dmax = torch.clamp(torch.diagonal(Sd, dim1=-2, dim2=-1).amax(-1), min=0.0)
    Sd = Sd + (1e-7 + 1e-6 * dmax)[:, None, None] * torch.eye(6, dtype=Sd.dtype, device=dev)
    P_inv = torch.linalg.inv_ex(Sd)[0]

    def pcg(rhs):
        """Jacobi(S)-preconditioned CG in float32, fixed n_inner iterations."""
        rhs32 = rhs.to(F32)
        x = torch.zeros_like(rhs32)
        rr = rhs32
        z = _mv(P_inv, rhs32)
        pdir = z
        one = torch.ones((), dtype=F32, device=dev)
        for _ in range(n_inner):
            Ap = schur_matvec(pdir, U, W, V_inv)
            rz = _dot(rr, z)
            denom = _dot(pdir, Ap)
            alpha = rz / torch.where(denom == 0, one, denom)
            x = x + alpha * pdir
            r_new = rr - alpha * Ap
            z_new = _mv(P_inv, r_new)
            beta = _dot(r_new, z_new) / torch.where(rz == 0, one, rz)
            rr, z, pdir = r_new, z_new, z_new + beta * pdir
        return x

    U64, W64, Vi64 = U.to(F64), W.to(F64), V_inv.to(F64)
    # rhs b = -(g_c - W V^-1 g_p), float64
    s_g = _mv(Vi64, g_p.to(F64))
    coup = segment_sum(_mv(W64, s_g[pt_idx]), cam_idx, n_cams, group)
    b = -(g_c.to(F64) - coup)
    if x0 is None:
        x = torch.zeros_like(b)
    else:
        xw = x0.to(F64)
        r0 = b - schur_matvec(xw, U64, W64, Vi64)
        use = torch.sum(r0 * r0) < torch.sum(b * b)
        x = torch.where(use, xw, torch.zeros_like(xw))
    for _ in range(n_outer):
        resid = b - schur_matvec(x, U64, W64, Vi64)
        x = x + pcg(resid).to(F64)
    delta_c = x.to(F32)
    # back-substitute points: delta_p = -V^-1 (g_p + W^T delta_c)
    wtd = segment_sum(_mtv(W64, x[cam_idx]), pt_idx, n_pts, group)
    delta_p = (-_mv(Vi64, g_p.to(F64) + wtd)).to(F32)
    return delta_c, delta_p


def _lm_iteration(p, lam, cost, huber_delta, fix_first_cam, solver="dense", group=None,
                  dc_prev=None):
    """One accept/reject LM iteration on device tensors (no readback).
    `dc_prev` warm-starts the CG camera solve with the previous iteration's
    delta (returned alongside the new state)."""
    U, V, W, g_c, g_p = _normal_blocks(p, huber_delta, group)
    U = U + lam * _diag_clamp(U)
    V = V + lam * _diag_clamp(V)
    if solver == "cg":
        dc, dp = _cg_schur_solve(U, V, W, g_c, g_p, p.cam_idx, p.pt_idx, fix_first_cam,
                                 group=group, x0=dc_prev)
    else:
        dc, dp = _dense_schur_solve_f64(U, V, W, g_c, g_p, p.cam_idx, p.pt_idx,
                                        fix_first_cam, group=group)
    if fix_first_cam:
        dc = torch.cat([torch.zeros_like(dc[:1]), dc[1:]])  # exactly zero the pinned block
    # NaN guard: a failed factorization must reject, not poison the state
    bad = ~(torch.isfinite(dc).all() & torch.isfinite(dp).all())
    dc = torch.where(bad, torch.zeros_like(dc), dc)
    dp = torch.where(bad, torch.zeros_like(dp), dp)
    cand = p._replace(cameras=p.cameras + dc, points=p.points + dp)
    new_cost = _ba_cost(cand, huber_delta, group)
    accept = (new_cost < cost) & ~bad
    p = p._replace(cameras=torch.where(accept, cand.cameras, p.cameras),
                   points=torch.where(accept, cand.points, p.points))
    cost = torch.where(accept, new_cost, cost)
    lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-10), torch.clamp(lam * 5.0, max=1e6))
    return p, lam, cost, dc


@torch.no_grad()
def bundle_adjust_device(
    problem: BAProblem,
    iters: int = 30,
    lam0: float = 1e-4,
    huber_delta: float = 1e9,
    fix_first_cam: bool = True,
    max_err_px: float | None = None,
    refilter_every: int = 10,
    mesh=None,
    solver: str = "dense",
    iters_per_launch: int | None = None,
):
    """Device-resident LM: linearize -> Schur step (dense float64-refined or
    CG) -> accept/reject -> periodic outlier refilter, every iteration on
    the problem's device with no readback.

    `mesh`: a DeviceMesh over the ranks of torch.distributed (every rank
    calls this with the whole problem): the initial quantile filter runs on
    the whole problem, then each rank keeps its slice of the observation
    axis (padded to the mesh with mask 0) and the segment sums and the cost
    are summed over the mesh's group; cameras and points stay replicated.

    `solver`: "dense" (exact float64-refined Schur: best under ~300 cams;
    O(n_pts * n_cams) memory) or "cg" (matrix-free block-Jacobi(S) CG with
    float64 refinement: O(n_obs) memory, the at-scale path;
    `bundle_adjust_cg_device` is this with solver="cg").

    `iters_per_launch`: read the cost back after every this many
    iterations (a host barrier a chunk, as the JAX package's bounded
    launches hand their carry through the host); the iterations and the
    refilter cadence (keyed on the global iteration) are unchanged.

    Returns (optimized problem with this rank's observation slice, final
    robust cost in px^2)."""
    if solver not in ("dense", "cg"):
        raise ValueError(f"solver must be 'dense' or 'cg', got {solver!r}")
    p = problem
    if max_err_px is not None:
        p = filter_observations(p, max_err_px, keep_quantile=0.9)
    full_mask = problem.mask
    group = _group(mesh)
    if mesh is not None:
        world, rank = mesh.size(), mesh.get_local_rank()
        p = p.pad_obs(world).obs_shard(rank, world)
        full_mask = problem.pad_obs(world).obs_shard(rank, world).mask
    lam = torch.full((), lam0, dtype=F32, device=p.cameras.device)
    cost = _ba_cost(p, huber_delta, group)
    dc = torch.zeros_like(p.cameras)
    for it in range(iters):
        if max_err_px is not None and it > 0 and it % refilter_every == 0:
            p = filter_observations(p._replace(mask=full_mask), max_err_px)
            cost = _ba_cost(p, huber_delta, group)
        p, lam, cost, dc = _lm_iteration(p, lam, cost, huber_delta, fix_first_cam,
                                         solver=solver, group=group,
                                         dc_prev=dc if solver == "cg" else None)
        if iters_per_launch is not None and (it + 1) % iters_per_launch == 0:
            float(cost)  # the chunk's readback barrier
    return p, float(cost)


def bundle_adjust_cg_device(problem: BAProblem, **kwargs):
    """`bundle_adjust_device` with the matrix-free CG solver: the at-scale
    path, O(n_obs) memory."""
    kwargs["solver"] = "cg"
    return bundle_adjust_device(problem, **kwargs)


@torch.no_grad()
def triangulate_tracks(
    cameras: np.ndarray,
    intrinsics: np.ndarray,
    cam_idx: np.ndarray,
    pt_idx: np.ndarray,
    uv: np.ndarray,
    n_pts: int,
    device=None,
) -> np.ndarray:
    """Multiview midpoint triangulation via segment ops, in float32 on
    `device` (default: the GPU): per point, solves
    (sum_k I - d_k d_k^T) X = sum_k (I - d_k d_k^T) c_k
    where d_k are the world-frame observation rays. Returns numpy."""
    dev = resolve_device(device)
    cam_idx = torch.as_tensor(np.asarray(cam_idx), dtype=torch.int64).to(dev)
    pt_idx = torch.as_tensor(np.asarray(pt_idx), dtype=torch.int64).to(dev)
    cams = torch.as_tensor(np.asarray(cameras), dtype=F32).to(dev)[cam_idx]
    Ks = torch.as_tensor(np.asarray(intrinsics), dtype=F32).to(dev)[cam_idx]
    uv = torch.as_tensor(np.asarray(uv), dtype=F32).to(dev)
    Rs = rodrigues(cams[:, :3])
    centers = -torch.einsum("kij,ki->kj", Rs, cams[:, 3:])
    ray_cam = torch.einsum("kij,kj->ki", torch.linalg.inv_ex(Ks)[0],
                           torch.cat([uv, torch.ones_like(uv[:, :1])], -1))
    d = torch.einsum("kji,kj->ki", Rs, ray_cam)  # R^T x: cam ray -> world
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    eye = torch.eye(3, dtype=F32, device=dev)
    P_k = eye[None] - torch.einsum("ki,kj->kij", d, d)
    A = segment_sum(P_k, pt_idx, n_pts)
    b = segment_sum(torch.einsum("kij,kj->ki", P_k, centers), pt_idx, n_pts)
    X = torch.linalg.solve_ex(A + 1e-9 * eye, b[..., None])[0][..., 0]
    return X.cpu().numpy()
