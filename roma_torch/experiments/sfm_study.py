"""Studies of the device bundle adjustment on the SfM study's worlds
(`sfm_scale.make_world`, the JAX study's seeds): how exact one LM step's
camera solve is, and how the 30th LM iterate moves with the observation
order (ROADMAP C11).

    python -m roma_torch.experiments.sfm_study step --cams 1000 --pts 100000 \\
        --obs-per-cam 1200 --solvers cg --lams 1e-4,1e-3,1e-2,1e-1
    python -m roma_torch.experiments.sfm_study orders --cams 100 --pts 10000 --orders 5
    python -m roma_torch.experiments.sfm_study orders --cams 1000 --pts 100000 \\
        --obs-per-cam 1200 --solver cg --orders 1 --points jax_points.npy
    python -m roma_torch.experiments.sfm_study start --cams 1000 --pts 100000 \\
        --obs-per-cam 1200 --points jax_points.npy

`step`: from the study's state before its first LM iteration (the
pose-graph init, points triangulated, observations gated at 20 px with
the 0.9 quantile), one LM candidate step at each lambda, by each device
solver (`_dense_schur_solve_f64`, `_cg_schur_solve`) as the device driver
calls it ("refined") and with its float64 refinement taken away
("float32": no refinement sweep; one inner CG), against
`schur_oracle_f64`, the same damped system assembled and solved in
float64. Each row: the camera delta's relative L2 distance from the
oracle's, and the robust cost after the candidate step beside the
oracle's. `orders`: the 30-iteration device driver on the given
observation order and on permutations of it, with index_add_'s atomics
and under torch.use_deterministic_algorithms, from the device's own
triangulation or from given start points (`--points`: the JAX package's
own, which `tests/test_torch_sfm_cli.py points` writes). Both print one
JSON object a row; on the GPU, after the card's name and power limit.
`start`: the start state (the observations the gate keeps, the cost),
beside the one from `--points` (how far apart the points are). `--device
cpu` runs them on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

import numpy as np
import torch

from roma_torch.experiments import sfm_scale
from roma_torch.sfm.bundle_adjust import (
    F64,
    BAProblem,
    _ba_cost,
    _cg_schur_solve,
    _dense_schur_solve_f64,
    _diag_clamp,
    _normal_blocks,
    bundle_adjust_device,
    filter_observations,
)
from roma_torch.sfm.metrics import absolute_trajectory_error

DEVICE = None  # the GPU
BA = dict(huber_delta=3.0, max_err_px=20.0)  # the study's robust kernel and gate


def study_problem(cams: int, pts: int, obs_per_cam: int | None = None, device=None):
    """(world, the BA problem on `device`, ATE after the pose-graph init):
    the study's world and initialisation, as `sfm_scale.main` builds them."""
    world = sfm_scale.make_world(cams, pts, obs_per_cam=obs_per_cam)
    init = sfm_scale.noisy_pose_graph_init(world, np.random.default_rng(0))
    ate_init = absolute_trajectory_error(init[1], world["centers"])
    return world, sfm_scale.initial_problem(world, init, device), ate_init


def schur_oracle_f64(U, V, W, g_c, g_p, cam_idx, pt_idx, fix_first_cam=True,
                     pairs_per_chunk: int = 1 << 20):
    """(delta_c, delta_p) in float64 of the damped system that the device
    solves target (the same first-camera pin and point-block floor), with
    S = U - sum_p sum_{k, l in p} W_k V_p^-1 W_l^T assembled exactly from
    the observation pairs of each point and solved by a float64 Cholesky of
    its Jacobi scaling. O(pairs) work, (6 n_cams)^2 memory."""
    n_cams, n_pts = U.shape[0], V.shape[0]
    dev = U.device
    U, V, W, g_c, g_p = (t.to(F64) for t in (U, V, W, g_c, g_p))
    if fix_first_cam:
        U = U.clone()
        U[0] += 1e10 * torch.eye(6, dtype=F64, device=dev)
    V = 0.5 * (V + V.transpose(-1, -2))
    vmax = torch.clamp(torch.diagonal(V, dim1=-2, dim2=-1).amax(-1), min=0.0)
    V = V + (1e-8 + 1e-6 * vmax)[:, None, None] * torch.eye(3, dtype=F64, device=dev)
    V_inv = torch.linalg.inv(V)
    live = torch.nonzero(W.flatten(1).abs().amax(1) > 0)[:, 0]
    order = live[torch.argsort(pt_idx[live], stable=True)]
    pt_s = pt_idx[order]
    counts = torch.bincount(pt_s, minlength=n_pts)
    start = torch.cumsum(counts, 0) - counts
    M = torch.einsum("kab,kbc->kac", W[order], V_inv[pt_s])  # W_k V_p^-1, sorted rows
    Wt = W[order].transpose(-1, -2)
    cam_s = cam_idx[order]
    reps = counts[pt_s]  # each sorted row pairs with every row of its point
    cum = torch.cumsum(reps, 0)
    blocks = torch.zeros((n_cams * n_cams, 6, 6), dtype=F64, device=dev)
    a = 0
    while a < len(order):
        b = int(torch.searchsorted(cum, cum[a] - reps[a] + pairs_per_chunk, right=True))
        b = max(b, a + 1)
        rows = torch.arange(a, b, device=dev)
        r = reps[a:b]
        ii = torch.repeat_interleave(rows, r)
        first = torch.repeat_interleave(torch.cumsum(r, 0) - r, r)
        jj = start[pt_s[ii]] + torch.arange(len(ii), device=dev) - first
        blocks.index_add_(0, cam_s[ii] * n_cams + cam_s[jj], -(M[ii] @ Wt[jj]))
        a = b
    S = blocks.reshape(n_cams, n_cams, 6, 6).permute(0, 2, 1, 3).reshape(6 * n_cams, 6 * n_cams)
    S = S + torch.block_diag(*U)
    S = 0.5 * (S + S.T)
    coup = torch.zeros_like(g_c).index_add_(
        0, cam_idx, torch.einsum("kab,kb->ka", W, (V_inv @ g_p[..., None])[..., 0][pt_idx]))
    b_vec = -(g_c - coup).reshape(-1)
    d = torch.sqrt(torch.clamp(torch.diagonal(S), min=1e-300))
    L, info = torch.linalg.cholesky_ex(S / (d[:, None] * d[None, :]))
    if int(info) != 0:
        raise RuntimeError(f"schur_oracle_f64: the float64 Cholesky failed (info {int(info)})")
    delta_c = (torch.cholesky_solve((b_vec / d)[:, None], L)[:, 0] / d).reshape(n_cams, 6)
    wtd = torch.zeros_like(g_p).index_add_(
        0, pt_idx, torch.einsum("kab,ka->kb", W, delta_c[cam_idx]))
    delta_p = -(V_inv @ (g_p + wtd)[..., None])[..., 0]
    return delta_c, delta_p


@contextlib.contextmanager
def scatter_mode(mode: str):
    """"atomics": index_add_ as it is; "deterministic": under
    torch.use_deterministic_algorithms(True) (the sorted scatter)."""
    torch.use_deterministic_algorithms(mode == "deterministic")
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def damped_blocks(p: BAProblem, lam: float, huber_delta: float):
    """(U, V, W, g_c, g_p) damped by `lam` as `_lm_iteration` damps them."""
    U, V, W, g_c, g_p = _normal_blocks(p, huber_delta)
    lam_t = torch.full((), lam, dtype=U.dtype, device=U.device)
    return U + lam_t * _diag_clamp(U), V + lam_t * _diag_clamp(V), W, g_c, g_p


def candidate_cost(p: BAProblem, dc, dp, huber_delta: float) -> float:
    dc = torch.cat([torch.zeros_like(dc[:1]), dc[1:]]).to(p.cameras.dtype)
    return float(_ba_cost(p._replace(cameras=p.cameras + dc,
                                     points=p.points + dp.to(p.points.dtype)), huber_delta))


def solve(blocks, p: BAProblem, solver: str, variant: str):
    """One device solve of `blocks`: "refined" as the device driver calls
    it, "float32" without its float64 refinement."""
    U, V, W, g_c, g_p = blocks
    if solver == "cg":
        kw = {} if variant == "refined" else {"n_outer": 1}
        return _cg_schur_solve(U, V, W, g_c, g_p, p.cam_idx, p.pt_idx, True, **kw)
    kw = {} if variant == "refined" else {"n_refine": 0}
    return _dense_schur_solve_f64(U, V, W, g_c, g_p, p.cam_idx, p.pt_idx, True, **kw)


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    """|x - ref| / |ref| over the free cameras (camera 0 is pinned)."""
    x, ref = x[1:].to(F64), ref[1:].to(F64)
    return float(torch.linalg.vector_norm(x - ref) / torch.linalg.vector_norm(ref))


def step_errors(p: BAProblem, lams, solvers=("dense", "cg"), modes=("atomics",),
                huber_delta: float = BA["huber_delta"]) -> list[dict]:
    """For each lambda and scatter mode, the damped blocks once, the
    oracle's candidate step on them and each solver's, both variants, on
    the same blocks (see the module docstring). `p` is the gated problem
    the LM starts from."""
    rows = []
    for lam in lams:
        for mode in modes:
            with scatter_mode(mode):
                blocks = damped_blocks(p, lam, huber_delta)
            dc_o, dp_o = schur_oracle_f64(*blocks, p.cam_idx, p.pt_idx)
            with scatter_mode(mode):
                got = {s: {v: solve(blocks, p, s, v) for v in ("refined", "float32")}
                       for s in solvers}
            cost_o = candidate_cost(p, dc_o, dp_o, huber_delta)
            for solver in solvers:
                row = {"lam": lam, "solver": solver, "mode": mode, "oracle_cost": cost_o}
                for v, (dc, dp) in got[solver].items():
                    row[v] = {"dc_rel_l2": rel_l2(dc, dc_o),
                              "cost": candidate_cost(p, dc, dp, huber_delta)}
                rows.append(row)
    return rows


def start_state(problem: BAProblem) -> BAProblem:
    """The problem as the device driver's first LM iteration sees it."""
    return filter_observations(problem, BA["max_err_px"], keep_quantile=0.9)


def start_summary(p: BAProblem, given: BAProblem | None = None) -> dict:
    """The start state of `p` (its own triangulation): the observations the
    gate keeps and the robust cost there; beside `given` (the same problem
    from other start points): quantiles of the points' largest coordinate
    difference (finite ones), and how many gate decisions differ."""
    s = start_state(p)
    out = {"kept": int((s.mask > 0).sum()), "cost": float(_ba_cost(s, BA["huber_delta"])),
           "nan_points": int(torch.isnan(p.points).any(1).sum())}
    if given is not None:
        g = start_state(given)
        d = (p.points - given.points).abs().amax(1)
        d = d[torch.isfinite(d)].double()
        q = torch.tensor([0.5, 0.9, 0.99, 1.0], dtype=d.dtype, device=d.device)
        out["given"] = {"kept": int((g.mask > 0).sum()),
                        "cost": float(_ba_cost(g, BA["huber_delta"])),
                        "gate_differs": int((g.mask != s.mask).sum()),
                        "equal_points": int((d == 0).sum()),
                        "point_diff_quantiles_50_90_99_100": torch.quantile(d, q).tolist()}
    return out


def permuted(p: BAProblem, perm: torch.Tensor) -> BAProblem:
    return p._replace(cam_idx=p.cam_idx[perm], pt_idx=p.pt_idx[perm], uv=p.uv[perm],
                      mask=p.mask[perm])


def orders(world, base: BAProblem, solver: str, n_orders: int, iters: int = 30,
           modes=("atomics", "deterministic")) -> list[dict]:
    """The device driver (`iters` LM iterations, Huber 3 px, gate 20 px) on
    the given observation order and on `n_orders - 1` permutations of it
    (numpy default_rng(1), one after another), in each scatter mode: ATE
    rmse / median and the robust cost of each run."""
    rng, n, rows = np.random.default_rng(1), len(world["uv"]), []
    for k in range(n_orders):
        perm = torch.from_numpy(np.arange(n) if k == 0 else rng.permutation(n))
        p = permuted(base, perm.to(base.cam_idx.device))
        for mode in modes:
            with scatter_mode(mode):
                out, cost = bundle_adjust_device(p, iters=iters, solver=solver, **BA)
            ate = absolute_trajectory_error(sfm_scale.camera_centers(out.cameras),
                                            world["centers"])
            rows.append({"order": "given order" if k == 0 else f"permutation {k - 1}",
                         "mode": mode, "ate": [ate["ate_rmse"], ate["ate_median"]],
                         "cost": cost})
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("study", choices=["step", "orders", "start"])
    ap.add_argument("--cams", type=int, default=100)
    ap.add_argument("--pts", type=int, default=10000)
    ap.add_argument("--obs-per-cam", type=int, default=None)
    ap.add_argument("--solvers", default="dense,cg", help="step: the solvers compared")
    ap.add_argument("--lams", default="1e-4,1e-3,1e-2,1e-1", help="step: the lambdas")
    ap.add_argument("--solver", default="dense", choices=["dense", "cg"], help="orders")
    ap.add_argument("--orders", type=int, default=5, help="orders: the observation orders")
    ap.add_argument("--iters", type=int, default=30, help="orders: LM iterations")
    ap.add_argument("--points", default=None,
                    help="orders: start from these points (an (n_pts, 3) .npy) instead of "
                         "the device's own triangulation; start: compare with them")
    ap.add_argument("--modes", default=None,
                    help="scatter modes, of atomics,deterministic (default: both on the "
                         "GPU; atomics on the CPU, where index_add_ is in order)")
    ap.add_argument("--device", default=DEVICE)
    args = ap.parse_args(argv)
    world, problem, _ = study_problem(args.cams, args.pts, args.obs_per_cam, args.device)
    given = None
    if args.points is not None:
        given = problem._replace(points=torch.from_numpy(
            np.load(args.points).astype(np.float32)).to(problem.points.device))
    on_gpu = problem.cameras.is_cuda
    modes = (args.modes.split(",") if args.modes else
             ["atomics", "deterministic"] if on_gpu else ["atomics"])
    if on_gpu:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    if args.study == "step":
        rows = step_errors(start_state(problem), [float(x) for x in args.lams.split(",")],
                           args.solvers.split(","), modes)
    elif args.study == "orders":
        rows = orders(world, given or problem, args.solver, args.orders, args.iters, modes)
    else:
        rows = [start_summary(problem, given)]
    for r in rows:
        print(json.dumps(r), flush=True)
    return rows


if __name__ == "__main__":
    main()
