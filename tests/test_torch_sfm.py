"""The port's SfM (`roma_torch/sfm/`) against the JAX package's, on the CPU.

First the counterpart of each of tests/test_sfm.py's 15 tests, with its
worlds (`test_sfm.make_world`), its seeds and its bounds; the three sharded
ones run on two gloo ranks (this file run as a script, `python
tests/test_torch_sfm.py RANK WORLD PORT OUT PROBLEMS`, started once for the module)
against one process (the parent makes their problems and hands them over).
Then parity with the JAX functions on the same inputs,
each test stating its tolerance.
"""

import importlib
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (ROOT, os.path.dirname(os.path.abspath(__file__))):
    if p not in sys.path:
        sys.path.insert(0, p)

from roma_torch.sfm.bundle_adjust import (  # noqa: E402
    BAProblem,
    ba_step,
    bundle_adjust,
    bundle_adjust_device,
    make_distributed_ba_step,
    project,
    rodrigues,
    triangulate_tracks,
)
from roma_torch.sfm.metrics import absolute_trajectory_error, align_umeyama  # noqa: E402
from roma_torch.sfm.pose_graph import rotation_averaging, translation_averaging  # noqa: E402
from roma_torch.sfm.reconstruction import _rvec_from_R, reconstruct  # noqa: E402
from roma_torch.sfm.tracks import TrackBuilder  # noqa: E402
from roma_torch.utils.geometry import angle_error_mat  # noqa: E402

TB = importlib.import_module("roma_torch.sfm.bundle_adjust")
WORKER_TIMEOUT_S = 120
THREADS = 2


def make_world(**kw):
    import test_sfm

    return test_sfm.make_world(**kw)


def cams_to_param(cams):
    return np.stack([np.concatenate([_rvec_from_R(R), t]) for R, t in cams]).astype(np.float32)


def centers_of(cameras) -> np.ndarray:
    cams = torch.as_tensor(np.asarray(cameras))
    Rs = rodrigues(cams[:, :3]).numpy()
    return -np.einsum("nji,nj->ni", Rs, cams[:, 3:].numpy())


def perturbed(noise_px=0.0, seed=1, cam_sigma=0.01, pt_sigma=0.05, fix_gauge=True, **kw):
    """tests/test_sfm.py's perturbed problem: (world, cams0, X0)."""
    w = make_world(noise_px=noise_px, **kw)
    cams_gt = cams_to_param(w["cams"])
    rng = np.random.default_rng(seed)
    cams0 = cams_gt + rng.normal(0, cam_sigma, cams_gt.shape).astype(np.float32)
    if fix_gauge:
        cams0[0] = cams_gt[0]
    X0 = w["X"].astype(np.float32) + rng.normal(0, pt_sigma, w["X"].shape).astype(np.float32)
    return w, cams0, X0


def problem(w, cams0, X0, pad_to=1) -> BAProblem:
    n_obs = len(w["uv"])
    pad = (-n_obs) % pad_to
    return BAProblem.from_arrays(
        cams0, X0, np.tile(w["K"], (len(cams0), 1, 1)),
        np.pad(w["cam_idx"], (0, pad)), np.pad(w["pt_idx"], (0, pad)),
        np.pad(w["uv"], ((0, pad), (0, 0))), np.pad(np.ones(n_obs, np.float32), (0, pad)),
        device="cpu")


def jax_problem(p: BAProblem):
    import jax.numpy as jnp

    return jax_ba().BAProblem(*[jnp.asarray(a.numpy().astype(np.int32) if not a.is_floating_point()
                                      else a.numpy()) for a in p])


def small_sharded():
    """test_distributed_ba_matches_single_device's and
    test_ba_device_driver_sharded_matches_replicated's problem (padded to 8)."""
    w, cams0, X0 = perturbed(noise_px=0.5, seed=2, cam_sigma=0.005, pt_sigma=0.02,
                             fix_gauge=False, n_cams=4, n_pts=100)
    return problem(w, cams0, X0, pad_to=8)


def small_sharded_exact():
    """test_distributed_ba_matches_single_device's (noise-free) problem."""
    w, cams0, X0 = perturbed(noise_px=0.0, seed=2, cam_sigma=0.005, pt_sigma=0.02,
                             fix_gauge=False, n_cams=4, n_pts=100)
    return problem(w, cams0, X0, pad_to=8)


def large_sharded():
    """test_ba_cg_sharded_matches_replicated's problem: 16 cams, 1500 pts."""
    w, cams0, X0 = perturbed(noise_px=0.5, seed=3, cam_sigma=0.005, pt_sigma=0.02,
                             fix_gauge=False, n_cams=16, n_pts=1500)
    return problem(w, cams0, X0, pad_to=8)


LAM = 1e-3


def sharded_problems() -> dict:
    return {"step": small_sharded_exact(), "cg": large_sharded(), "dense": small_sharded()}


def sharded_results(problems: dict, mesh=None) -> dict:
    """The three sharded computations on `sharded_problems()`, through
    `mesh` (None: one process)."""
    step = make_distributed_ba_step(mesh) if mesh is not None else \
        (lambda p, lam: ba_step(p, lam))
    dc, dp, c = step(problems["step"], torch.tensor(LAM))
    _, cost_cg = bundle_adjust_device(problems["cg"], iters=6, solver="cg", mesh=mesh)
    _, cost_dense = bundle_adjust_device(problems["dense"], iters=8, mesh=mesh)
    return {"step": (dc, dp, float(c)), "cg": cost_cg, "dense": cost_dense}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """(`sharded_results` on two gloo ranks, each a process of its own: the
    ranks' results; `sharded_results` in this process, computed while the
    ranks run)."""
    d = tmp_path_factory.mktemp("sfm_ranks")
    port = str(_free_port())
    outs = [d / f"rank{r}.pt" for r in range(2)]
    # the worlds come from the JAX test module; the ranks load them and skip importing JAX
    problems = sharded_problems()
    torch.save({k: tuple(p) for k, p in problems.items()}, d / "problems.pt")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), "2", port, str(outs[r]),
                               str(d / "problems.pt")],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    old = torch.get_num_threads()
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        torch.set_num_threads(THREADS)
        ref = sharded_results(problems)
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, out.decode()[-3000:]
    finally:
        torch.set_num_threads(old)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(o, weights_only=True) for o in outs], ref


# ---------------------------------------------------------------------------
# counterparts of tests/test_sfm.py
# ---------------------------------------------------------------------------

def test_rodrigues_roundtrip(rng):
    for _ in range(10):
        v = rng.normal(0, 1, 3).astype(np.float32)
        R = rodrigues(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        np.testing.assert_allclose(_rvec_from_R(R), v, atol=1e-4)


def test_project_matches_numpy():
    w = make_world(n_cams=2)
    R, t = w["cams"][1]
    cam = np.concatenate([_rvec_from_R(R), t]).astype(np.float32)
    X = w["X"][0].astype(np.float32)
    px = project(torch.from_numpy(cam), torch.from_numpy(w["K"]), torch.from_numpy(X)).numpy()
    ref = w["K"] @ (R @ X + t)
    np.testing.assert_allclose(px, ref[:2] / ref[2], atol=1e-3)


def test_rotation_averaging_exact():
    w = make_world()
    edges = []
    for i in range(len(w["cams"]) - 1):
        edges.append((i, i + 1, w["cams"][i + 1][0] @ w["cams"][i][0].T))
    edges.append((0, 3, w["cams"][3][0] @ w["cams"][0][0].T))
    Rs = rotation_averaging(len(w["cams"]), edges)
    for i, (R_gt, _) in enumerate(w["cams"]):
        assert angle_error_mat(Rs[i], R_gt) < 1e-4


def test_translation_averaging_recovers_centers():
    w = make_world()
    n = len(w["cams"])
    Rs = np.stack([R for R, _ in w["cams"]])
    edges = []
    for i, j in [(i, i + 1) for i in range(n - 1)] + [(0, 2), (1, 3), (2, 4), (3, 5)]:
        Ri, ti = w["cams"][i]
        Rj, tj = w["cams"][j]
        edges.append((i, j, tj - (Rj @ Ri.T) @ ti))
    centers = translation_averaging(n, Rs, edges)
    gt_centers = np.stack([-R.T @ t for R, t in w["cams"]])
    res = absolute_trajectory_error(centers, gt_centers)
    assert res["ate_rmse"] < 1e-3, res


def _recovered(out_cams, w):
    gt_centers = np.stack([-R.T @ t for R, t in w["cams"]])
    return absolute_trajectory_error(centers_of(out_cams), gt_centers, with_scale=False)


def test_ba_recovers_from_perturbation():
    w, cams0, X0 = perturbed()
    out, cost = bundle_adjust(problem(w, cams0, X0), iters=15)
    assert cost < 1e-4, cost
    ate = _recovered(out.cameras, w)
    assert ate["ate_rmse"] < 1e-3, ate


def test_distributed_ba_matches_single_device(sharded):
    ranks, ref = sharded
    dc1, dp1, c1 = ref["step"]
    for r in ranks:
        dc2, dp2, c2 = r["step"]
        np.testing.assert_allclose(c1, c2, rtol=1e-5)
        np.testing.assert_allclose(dc1.numpy(), dc2.numpy(), atol=1e-4)
        np.testing.assert_allclose(dp1.numpy(), dp2.numpy(), atol=1e-4)


def test_triangulate_tracks_exact():
    w = make_world()
    cams = cams_to_param(w["cams"])
    X = triangulate_tracks(cams, np.tile(w["K"], (len(cams), 1, 1)), w["cam_idx"], w["pt_idx"],
                           w["uv"], len(w["X"]), device="cpu")
    sel = np.bincount(w["pt_idx"], minlength=len(w["X"])) >= 2
    assert np.median(np.linalg.norm(X[sel] - w["X"][sel], axis=-1)) < 1e-3


def test_track_builder_merges_pairs():
    tb = TrackBuilder(cell_px=2.0)
    tb.add_matches(0, 1, np.array([[10.0, 10.0]]), np.array([[50.0, 52.0]]))
    tb.add_matches(1, 2, np.array([[50.4, 52.2]]), np.array([[90.0, 91.0]]))
    tracks = tb.build(min_length=3)
    assert len(tracks) == 1
    assert set(tracks[0].obs) == {0, 1, 2}


def test_umeyama_alignment(rng):
    X = rng.normal(0, 1, (50, 3))
    R_gt = rodrigues(torch.tensor([0.2, -0.1, 0.3], dtype=torch.float64)).numpy()
    Y = 2.5 * X @ R_gt.T + np.array([1.0, -2.0, 0.5])
    s, R, _ = align_umeyama(X, Y)
    assert abs(s - 2.5) < 1e-6
    np.testing.assert_allclose(R, R_gt, atol=1e-6)
    assert absolute_trajectory_error(X, Y)["ate_rmse"] < 1e-6


def reconstruct_matches():
    """test_reconstruct_end_to_end's exact matches: (world, matches)."""
    w = make_world(n_cams=5, n_pts=400, seed=4, noise_px=0.0)
    n, K = len(w["cams"]), w["K"]
    matches = {}
    for i in range(n):
        for j in range(i + 1, min(i + 3, n)):
            (Ri, ti), (Rj, tj) = w["cams"][i], w["cams"][j]
            Xi, Xj = w["X"] @ Ri.T + ti, w["X"] @ Rj.T + tj
            pi = (Xi @ K.T)[:, :2] / (Xi @ K.T)[:, 2:]
            pj = (Xj @ K.T)[:, :2] / (Xj @ K.T)[:, 2:]
            vis = ((pi > 0).all(-1) & (pi < [640, 480]).all(-1)
                   & (pj > 0).all(-1) & (pj < [640, 480]).all(-1))
            matches[(i, j)] = (pi[vis].astype(np.float64), pj[vis].astype(np.float64))
    return w, matches


def test_reconstruct_end_to_end():
    w, matches = reconstruct_matches()
    n = len(w["cams"])
    rec = reconstruct(matches, np.tile(w["K"], (n, 1, 1)).astype(np.float32), n, ba_iters=15,
                      device="cpu")
    gt_centers = np.stack([-R.T @ t for R, t in w["cams"]])
    ate = absolute_trajectory_error(rec.centers, gt_centers)
    assert ate["ate_rmse"] < 0.02, ate
    assert set(rec.timings) == {"pose", "averaging", "tracks", "ba"}


def test_ba_device_driver_recovers_from_perturbation():
    w, cams0, X0 = perturbed()
    out, cost = bundle_adjust_device(problem(w, cams0, X0), iters=15)
    assert cost < 1e-4, cost
    ate = _recovered(out.cameras, w)
    assert ate["ate_rmse"] < 1e-3, ate


def test_ba_cg_solver_matches_dense_quality():
    w, cams0, X0 = perturbed()
    out, cost = bundle_adjust_device(problem(w, cams0, X0), iters=15, solver="cg")
    assert cost < 1e-4, cost
    ate = _recovered(out.cameras, w)
    assert ate["ate_rmse"] < 1e-3, ate


def test_ba_cg_sharded_matches_replicated(sharded):
    """CG path, 16 cams / 1500 pts: two gloo ranks (the observation axis
    split, segment sums all-reduced) == one process."""
    ranks, ref = sharded
    for r in ranks:
        np.testing.assert_allclose(ref["cg"], r["cg"], rtol=1e-3)


def test_ba_device_driver_sharded_matches_replicated(sharded):
    ranks, ref = sharded
    for r in ranks:
        np.testing.assert_allclose(ref["dense"], r["dense"], rtol=1e-3)


def test_ba_device_chunked_launches_match_single():
    """iters_per_launch (a readback every 4 iterations) gives the single
    run's result, across a refilter boundary (the cadence keys on the
    global iteration)."""
    w, cams0, X0 = perturbed(noise_px=0.5, seed=5)
    prob = problem(w, cams0, X0)
    kw = dict(iters=9, solver="cg", max_err_px=20.0, refilter_every=4)
    out1, cost1 = bundle_adjust_device(prob, **kw)
    out2, cost2 = bundle_adjust_device(prob, **kw, iters_per_launch=4)
    np.testing.assert_allclose(cost2, cost1, rtol=1e-6)
    np.testing.assert_allclose(out2.cameras.numpy(), out1.cameras.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# parity with the JAX package's functions
# ---------------------------------------------------------------------------

def jax_ba():
    """The JAX package's bundle_adjust module, imported on use: the gloo
    workers (this file as a script) import no JAX."""
    return importlib.import_module("roma_tpu.sfm.bundle_adjust")


def test_rodrigues_and_its_jacobian_match_jax(rng):
    """At 0 (camera 0's gauge) and at 8 random rvecs: R within 1e-6, the
    jacfwd Jacobian within 1e-5, both finite at 0."""
    JB = jax_ba()
    import jax
    import jax.numpy as jnp

    for v in [np.zeros(3, np.float32)] + [rng.normal(0, 1, 3).astype(np.float32)
                                          for _ in range(8)]:
        Rj = np.asarray(JB.rodrigues(jnp.asarray(v)))
        Rt = rodrigues(torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(Rt, Rj, atol=1e-6)
        Jj = np.asarray(jax.jacfwd(JB.rodrigues)(jnp.asarray(v)))
        Jt = torch.func.jacfwd(rodrigues)(torch.from_numpy(v)).numpy()
        assert Jt.dtype == np.float32 and np.isfinite(Jt).all()
        np.testing.assert_allclose(Jt, Jj, atol=1e-5)


def _with_dead_rows():
    """The 6-cam world, noisy, with 5 points moved onto camera 0's image
    plane (camera 0 is the identity, so exactly onto it) far off its axis
    (inf residuals) and their observations masked out."""
    w, cams0, X0 = perturbed(noise_px=0.5)
    p = problem(w, cams0, X0)
    assert not p.cameras[0].any()
    dead = np.flatnonzero(w["cam_idx"] == 0)[:5]
    pts = w["pt_idx"][dead]
    points = p.points.clone()
    points[pts] = torch.tensor([3e31, 3e31, 0.0])
    mask = p.mask.clone()
    mask[torch.from_numpy(np.isin(w["pt_idx"], pts))] = 0.0
    return p._replace(points=points, mask=mask), dead


def test_build_blocks_and_cost_match_jax():
    """r, Jc, Jp within 1e-5 of max|.| (float32 Jacobians of the same
    formulas), dead rows (inf residuals masked out) exactly zero on both
    sides; the robust cost within 1e-5 relative."""
    JB = jax_ba()
    p, dead = _with_dead_rows()
    pj = jax_problem(p)
    assert not np.isfinite(TB._res_vec(*[a[dead] for a in (p.cameras[p.cam_idx],
                                                          p.points[p.pt_idx],
                                                          TB._normalized_obs(p)[0])]).numpy()).all()
    for huber in (1e9, 3.0):
        for got, ref in zip(TB._build_blocks(p, huber), JB._build_blocks(pj, huber)):
            got, ref = got.numpy(), np.asarray(ref)
            assert np.isfinite(got).all() and not got[dead].any() and not ref[dead].any()
            np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
        np.testing.assert_allclose(float(TB._ba_cost(p, huber)), float(JB._ba_cost(pj, huber)),
                                   rtol=1e-5)


def test_filter_observations_matches_jax():
    """The same mask bit for bit, with and without keep_quantile, from the
    perturbed 6-cam world with 0.5 px noise and 5 points on a camera plane."""
    JB = jax_ba()
    p, _ = _with_dead_rows()
    pj = jax_problem(p)
    for gate, q in ((2.0, None), (2.0, 0.9), (0.5, 0.5), (50.0, 0.9)):
        got = TB.filter_observations(p, gate, keep_quantile=q).mask.numpy()
        ref = np.asarray(JB.filter_observations(pj, gate, keep_quantile=q).mask)
        np.testing.assert_array_equal(got, ref)
        assert 0 < got.sum() < len(got)


@pytest.mark.parametrize("n_cg", [50, 0])
def test_ba_step_matches_jax(n_cg):
    """One LM step (lambda 1e-3): the cost within 1e-5 relative; the step
    is a float32 solve of a system with its 7-dimensional gauge free
    (cond ~1e9), so its deltas agree only within 1e-2 of their largest
    entry (the gauge-near directions; measured 4.7e-3), and the cost after
    each side's step within 1e-4 relative (measured 1.1e-5)."""
    JB = jax_ba()
    w, cams0, X0 = perturbed(noise_px=0.5)
    p = problem(w, cams0, X0)
    dc, dp, c = ba_step(p, torch.tensor(LAM), n_cg=n_cg)
    dcj, dpj, cj = JB.ba_step(jax_problem(p), np.float32(LAM), n_cg=n_cg)
    np.testing.assert_allclose(float(c), float(cj), rtol=1e-5)
    for got, ref in ((dc, dcj), (dp, dpj)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-2 * np.abs(ref).max())
    after = [float(TB._ba_cost(p._replace(cameras=p.cameras + torch.tensor(np.asarray(a)),
                                          points=p.points + torch.tensor(np.asarray(b))), 1e9))
             for a, b in ((dc, dp), (dcj, dpj))]
    assert after[0] < float(c)
    np.testing.assert_allclose(after[0], after[1], rtol=1e-4)


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_device_schur_solves_match_host_and_jax(solver):
    """The device solves' deltas on the damped blocks of the noisy 6-cam
    world, against the JAX function's (run under its x64 scope): within
    1e-3 of the largest entry (measured: dense 1.6e-4, the float32 Gram
    matrix and Cholesky summing in another order; CG 0, bit-equal). Against
    the host float64 oracle (`_host_schur_solve`): no further than the JAX
    function (1.05x its distance; both floor V relatively, where the oracle
    floors its eigenvalues: 3.3e-3 of the largest entry), and the cost after
    the step within 1e-4 relative of the oracle's."""
    JB = jax_ba()
    import jax
    import jax.numpy as jnp

    w, cams0, X0 = perturbed(noise_px=0.5)
    p = problem(w, cams0, X0)
    U, V, W, g_c, g_p = TB._ba_blocks(p)
    lam = 1e-3
    Ud, Vd = U + lam * TB._diag_clamp(U), V + lam * TB._diag_clamp(V)
    host = TB._host_schur_solve(*[a.numpy() for a in (U, V, W, g_c, g_p)],
                                w["cam_idx"], w["pt_idx"], lam)
    fn_t = TB._dense_schur_solve_f64 if solver == "dense" else TB._cg_schur_solve
    fn_j = JB._dense_schur_solve_f64 if solver == "dense" else JB._cg_schur_solve
    got = [g.numpy() for g in fn_t(Ud, Vd, W, g_c, g_p, p.cam_idx, p.pt_idx, True)]
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        args = [jnp.asarray(a.numpy()) for a in (Ud, Vd, W, g_c, g_p)]
        ref = [np.asarray(r) for r in
               fn_j(*args, jnp.asarray(w["cam_idx"]), jnp.asarray(w["pt_idx"]), True)]
    for g, h, r in zip(got, host, ref):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, r, atol=1e-3 * np.abs(r).max())
        assert np.abs(g - h).max() <= 1.05 * np.abs(r - h).max() + 1e-7

    def after(dc, dp):
        return float(TB._ba_cost(p._replace(cameras=p.cameras + torch.tensor(dc, dtype=torch.float32),
                                            points=p.points + torch.tensor(dp, dtype=torch.float32)),
                                 1e9))

    np.testing.assert_allclose(after(*got), after(*host), rtol=1e-4)


def test_triangulate_tracks_matches_jax():
    """Noisy observations: the port's points within 1e-4 of the largest
    coordinate of the JAX function's (float32 solves of the same 3x3 normal
    equations, which two rays with a short baseline make ill-conditioned;
    measured 1.7e-5)."""
    JB = jax_ba()
    w = make_world(noise_px=0.5)
    cams = cams_to_param(w["cams"])
    Ks = np.tile(w["K"], (len(cams), 1, 1))
    args = (cams, Ks, w["cam_idx"], w["pt_idx"], w["uv"], len(w["X"]))
    got = triangulate_tracks(*args, device="cpu")
    ref = JB.triangulate_tracks(*args)
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("driver", ["host", "dense", "cg"])
def test_ba_drivers_match_jax(driver):
    """4 LM iterations (Huber 3 px, gate 20 px, refilter every 2) on the
    noisy 6-cam world: the final cost within 1e-3 relative and the cameras
    within 1e-3 of their largest parameter of the JAX driver's (float32
    linearisations through four solves; measured 1.6e-4 with the device
    drivers, 3e-6 with the host one)."""
    JB = jax_ba()
    w, cams0, X0 = perturbed(noise_px=0.5, seed=5)
    p = problem(w, cams0, X0)
    kw = dict(iters=4, huber_delta=3.0, max_err_px=20.0, refilter_every=2)
    if driver == "host":
        (out, cost), (outj, costj) = bundle_adjust(p, **kw), JB.bundle_adjust(jax_problem(p), **kw)
    else:
        out, cost = bundle_adjust_device(p, solver=driver, **kw)
        outj, costj = JB.bundle_adjust_device(jax_problem(p), solver=driver, **kw)
    assert cost < float(TB._ba_cost(p, 3.0))
    np.testing.assert_allclose(cost, costj, rtol=1e-3)
    ref = np.asarray(outj.cameras)
    np.testing.assert_allclose(out.cameras.numpy(), ref, atol=1e-3 * np.abs(ref).max())


def test_reconstruct_matches_jax():
    """test_reconstruct_end_to_end's matches through both pipelines: ATE
    below the JAX test's 0.02 on both, the port's camera centers within
    1e-3 of JAX's and its cost within 1e-3 px^2 + 1e-3 relative."""
    JR = importlib.import_module("roma_tpu.sfm.reconstruction")
    w, matches = reconstruct_matches()
    n = len(w["cams"])
    Ks = np.tile(w["K"], (n, 1, 1)).astype(np.float32)
    rec = reconstruct(matches, Ks, n, ba_iters=6, device="cpu")
    ref = JR.reconstruct(matches, Ks, n, ba_iters=6)
    gt_centers = np.stack([-R.T @ t for R, t in w["cams"]])
    for r in (rec, ref):
        assert absolute_trajectory_error(r.centers, gt_centers)["ate_rmse"] < 0.02
    np.testing.assert_allclose(rec.centers, ref.centers, atol=1e-3)
    np.testing.assert_allclose(rec.cost, ref.cost, rtol=1e-3, atol=1e-3)


def test_numpy_modules_are_the_jax_packages(rng):
    """rotation_averaging, translation_averaging, TrackBuilder and
    align_umeyama: bit-equal to the JAX package's copies on random inputs."""
    from roma_tpu.sfm import metrics as jm, pose_graph as jp, tracks as jt

    n = 7
    Rs = [rodrigues(torch.from_numpy(rng.normal(0, 1, 3))).numpy() for _ in range(n)]
    edges_R = [(i, j, Rs[j] @ Rs[i].T) for i in range(n) for j in range(i + 1, min(i + 3, n))]
    edges_t = [(i, j, rng.normal(0, 1, 3)) for i, j, _ in edges_R]
    np.testing.assert_array_equal(rotation_averaging(n, edges_R), jp.rotation_averaging(n, edges_R))
    Ravg = jp.rotation_averaging(n, edges_R)
    np.testing.assert_array_equal(translation_averaging(n, Ravg, edges_t),
                                  jp.translation_averaging(n, Ravg, edges_t))
    X, Y = rng.normal(0, 1, (30, 3)), rng.normal(0, 1, (30, 3))
    for a, b in zip(align_umeyama(X, Y), jm.align_umeyama(X, Y)):
        np.testing.assert_array_equal(a, b)
    got, ref = TrackBuilder(cell_px=3.0), jt.TrackBuilder(cell_px=3.0)
    for i in range(4):
        ka, kb = rng.uniform(0, 40, (60, 2)), rng.uniform(0, 40, (60, 2))
        got.add_matches(i, i + 1, ka, kb)
        ref.add_matches(i, i + 1, ka, kb)
    assert [t.obs for t in got.build()] == [t.obs for t in ref.build()]


if __name__ == "__main__":
    from roma_torch.parallel import mesh as pmesh

    rank, world, port, out, problems = sys.argv[1:]
    torch.set_num_threads(THREADS)
    os.environ.update(RANK=rank, WORLD_SIZE=world, MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    assert pmesh.initialize_distributed("cpu") == (int(rank), int(world))
    try:
        problems = {k: BAProblem(*p) for k, p in torch.load(problems, weights_only=True).items()}
        torch.save(sharded_results(problems, pmesh.make_mesh("cpu")), out)
    finally:
        torch.distributed.destroy_process_group()
