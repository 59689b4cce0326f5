"""SfM at scale: a synthetic world of cameras on a ring around a box of
points, observed with 0.5 px noise and 10% outliers; ATE after a noisy
pose-graph initialisation and after bundle adjustment, plus a timing of
one distributed `ba_step` on one rank and on every rank of the mesh.

    python -m roma_torch.experiments.sfm_scale --cams 100 --pts 10000 --device-driver
    python -m roma_torch.experiments.sfm_scale --cams 1000 --pts 100000 \\
        --obs-per-cam 1200 --device-driver --solver cg --skip-scaling
    torchrun --nproc_per_node 4 -m roma_torch.experiments.sfm_scale \\
        --device-driver --shard 4

The port of the JAX package's experiments/sfm_scale.py, with its flags
but `--tpu`, which has no meaning here (the port runs on the GPU, or on
the CPU when `DEVICE` is "cpu"). `make_world`, `noisy_pose_graph_init`
and `rot_xyz` are copies with the same numpy seeds, so the worlds and the
pose-graph initialisations are the JAX study's, bit for bit. `--shard N`
splits the observation axis over the N ranks of torch.distributed (run
under torchrun; N must be the world size), and the scaling sweep times
one rank against the whole mesh. Only rank 0 prints.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from roma_torch.parallel.mesh import initialize_distributed, make_mesh
from roma_torch.sfm.bundle_adjust import (
    BAProblem,
    bundle_adjust,
    bundle_adjust_device,
    make_distributed_ba_step,
    rodrigues,
    triangulate_tracks,
)
from roma_torch.sfm.metrics import absolute_trajectory_error
from roma_torch.sfm.pose_graph import (
    centers_to_translations,
    rotation_averaging,
    translation_averaging,
)
from roma_torch.sfm.reconstruction import _rvec_from_R

DEVICE = None  # the GPU


def rot_xyz(a, b, c):
    Rx = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    Rz = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def make_world(n_cams, n_pts, seed=0, noise_px=0.5, outlier_frac=0.1,
               obs_per_cam=None):
    rng = np.random.default_rng(seed)
    K = np.array([[600.0, 0, 480], [0, 600.0, 320], [0, 0, 1]], np.float32)
    X = rng.uniform([-8, -5, 10], [8, 5, 30], (n_pts, 3))
    Rs, cs = [], []
    for i in range(n_cams):
        th = 2 * np.pi * i / n_cams
        # orbiting ring trajectory, cameras looking inward-ish
        c = np.array([10 * np.sin(th), 1.5 * np.sin(2.3 * th), 10 - 10 * np.cos(th)])
        R = rot_xyz(0.05 * np.sin(3 * th), -th * 0.35, 0.03 * np.cos(2 * th))
        Rs.append(R)
        cs.append(c)
    cam_idx, pt_idx, uv = [], [], []
    for ci in range(n_cams):
        R, c = Rs[ci], cs[ci]
        t = -R @ c
        Xc = X @ R.T + t
        x = Xc @ K.T
        px = x[:, :2] / np.maximum(x[:, 2:], 1e-6)
        vis = (Xc[:, 2] > 1.0) & (px[:, 0] > 0) & (px[:, 0] < 960) & \
              (px[:, 1] > 0) & (px[:, 1] < 640)
        sel = np.flatnonzero(vis)
        if obs_per_cam is not None and len(sel) > obs_per_cam:
            sel = rng.choice(sel, obs_per_cam, replace=False)
        obs = px[sel] + rng.normal(0, noise_px, (len(sel), 2))
        n_out = int(outlier_frac * len(sel))
        if n_out:
            out_rows = rng.choice(len(sel), n_out, replace=False)
            obs[out_rows] = rng.uniform([0, 0], [960, 640], (n_out, 2))
        cam_idx.append(np.full(len(sel), ci))
        pt_idx.append(sel)
        uv.append(obs)
    return {
        "K": K, "X": X, "Rs": np.stack(Rs), "centers": np.stack(cs),
        "cam_idx": np.concatenate(cam_idx).astype(np.int32),
        "pt_idx": np.concatenate(pt_idx).astype(np.int32),
        "uv": np.concatenate(uv).astype(np.float32),
    }


def noisy_pose_graph_init(world, rng, rot_noise_deg=1.5, dir_noise=0.03):
    """Simulated two-view estimates on a ring+chords graph -> averaging."""
    n = len(world["Rs"])
    edges_R, edges_t = [], []

    def rel(i, j):
        R = world["Rs"][j] @ world["Rs"][i].T
        c_j_in_i = world["Rs"][i] @ (world["centers"][j] - world["centers"][i])
        t = -R @ c_j_in_i  # t of j relative to i, in j frame
        return R, t / np.linalg.norm(t)

    for i in range(n):
        for j in ((i + 1) % n, (i + 5) % n, (i + 11) % n):
            if i == j:
                continue
            R, t = rel(i, j)
            dR = rot_xyz(*rng.normal(0, np.deg2rad(rot_noise_deg), 3))
            dt = rng.normal(0, dir_noise, 3)
            t = t + dt
            edges_R.append((i, j, dR @ R))
            edges_t.append((i, j, t / np.linalg.norm(t)))
    Rs = rotation_averaging(n, edges_R)
    centers = translation_averaging(n, Rs, edges_t)
    ts = centers_to_translations(Rs, centers)
    return Rs, centers, ts


def initial_problem(world, init, device=None) -> BAProblem:
    """The study's BA problem: the pose-graph initialisation `init`
    (`noisy_pose_graph_init`'s (Rs, centers, ts)), points triangulated from
    it, every observation valid."""
    n_cams, n_pts = len(world["Rs"]), len(world["X"])
    Rs0, _, ts0 = init
    cameras = np.concatenate(
        [np.stack([_rvec_from_R(R) for R in Rs0]), ts0], -1
    ).astype(np.float32)
    Ks = np.stack([world["K"]] * n_cams)
    X0 = triangulate_tracks(cameras, Ks, world["cam_idx"], world["pt_idx"], world["uv"], n_pts,
                            device=device)
    return BAProblem.from_arrays(cameras, X0.astype(np.float32), Ks.astype(np.float32),
                                 world["cam_idx"], world["pt_idx"], world["uv"], device=device)


def camera_centers(cameras: torch.Tensor) -> np.ndarray:
    Rs = rodrigues(cameras[:, :3]).cpu().numpy()
    return -np.einsum("nij,ni->nj", Rs, cameras[:, 3:].cpu().numpy())


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    """Runs the study; returns {"n_obs", "ate_init", "ate_ba" (the metrics'
    dicts), "cost", "ba_s", "scaling": {ranks: ms a ba_step}}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--cams", type=int, default=100)
    ap.add_argument("--pts", type=int, default=10000)
    ap.add_argument("--ba-iters", type=int, default=30)
    ap.add_argument(
        "--device-driver", action="store_true",
        help="use bundle_adjust_device (LM on the device, float64-refined "
             "solve) instead of the host-float64 driver",
    )
    ap.add_argument(
        "--shard", type=int, default=0,
        help="with --device-driver: split the observation axis over the N "
             "ranks of torch.distributed (torchrun; N = the world size)",
    )
    ap.add_argument(
        "--solver", default="dense", choices=["dense", "cg"],
        help="device-driver camera solve: exact dense float64-refined Schur, "
             "or matrix-free block-Jacobi(S) CG + float64 refinement (O(n_obs) "
             "memory: the 1k-cam path)",
    )
    ap.add_argument(
        "--skip-scaling", action="store_true",
        help="skip the distributed ba_step timing sweep",
    )
    ap.add_argument(
        "--iters-per-launch", type=int, default=None,
        help="read the cost back every N LM iterations (the same iterates)",
    )
    ap.add_argument(
        "--obs-per-cam", type=int, default=None,
        help="cap observations per camera (keeps the 1k-cam world at ~1M "
             "obs instead of full-visibility tens of millions)",
    )
    args = ap.parse_args(argv)
    rank, world_size = initialize_distributed(DEVICE)
    mesh = make_mesh(DEVICE)
    if args.shard and args.shard != world_size:
        raise SystemExit(f"--shard {args.shard}: run under torchrun with {args.shard} ranks "
                         f"(the world size is {world_size})")
    say = print if rank == 0 else (lambda *a, **k: None)

    world = make_world(args.cams, args.pts, obs_per_cam=args.obs_per_cam)
    n_obs = len(world["uv"])
    say(f"world: {args.cams} cams, {args.pts} pts, {n_obs} obs (0.5 px noise, 10% outliers)")

    init = noisy_pose_graph_init(world, np.random.default_rng(0))
    ate_init = absolute_trajectory_error(init[1], world["centers"])
    say(f"ATE after pose-graph init: rmse {ate_init['ate_rmse']:.4f} "
        f"median {ate_init['ate_median']:.4f} (scene diameter ~20)")

    problem = initial_problem(world, init, DEVICE)
    dev = problem.cameras.device
    _sync(dev)
    t0 = time.perf_counter()
    if args.device_driver:
        refined, cost = bundle_adjust_device(
            problem, iters=args.ba_iters, huber_delta=3.0, max_err_px=20.0,
            mesh=mesh if args.shard else None, solver=args.solver,
            iters_per_launch=args.iters_per_launch,
        )
    else:
        refined, cost = bundle_adjust(problem, iters=args.ba_iters, huber_delta=3.0,
                                      max_err_px=20.0)
    ba_s = time.perf_counter() - t0
    ate_ba = absolute_trajectory_error(camera_centers(refined.cameras), world["centers"])
    say(f"ATE after BA ({args.ba_iters} LM iters, Huber 3px, {ba_s:.1f}s): "
        f"rmse {ate_ba['ate_rmse']:.4f} median {ate_ba['ate_median']:.4f} "
        f"robust cost {cost:.3f} px^2")
    out = {"n_obs": n_obs, "ate_init": ate_init, "ate_ba": ate_ba, "cost": cost, "ba_s": ba_s,
           "scaling": {}}

    if args.skip_scaling:
        return out
    # distributed ba_step: one rank alone, then every rank of the mesh
    padded = problem.pad_obs(world_size)
    for n_dev, m in ((1, None), (world_size, mesh))[: 2 if mesh is not None else 1]:
        step = make_distributed_ba_step(m, n_cg=40, huber_delta=3.0)
        step(padded, 1e-4)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(3):
            step(padded, 1e-4)
            _sync(dev)
        dt = (time.perf_counter() - t0) / 3
        out["scaling"][n_dev] = dt * 1e3
        say(f"distributed ba_step on {n_dev} rank(s): {dt * 1e3:.0f} ms "
            f"({n_obs} obs, 40 CG iters)")
    return out


if __name__ == "__main__":
    main()
