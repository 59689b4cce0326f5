"""The port's two SfM CLIs on the CPU (`DEVICE = "cpu"` by monkeypatch, as
tests/test_torch_cli.py does):

- `sfm_reconstruct` on 6 rendered images of the two-plane world along
  tests/test_sfm.py's curved trajectory, its matcher replaced by
  `chip_smoke.ExactWarpMatcher` (the exact warps, sampled and converted
  by Tiny RoMa's own `sample` and `to_pixel_coordinates`): the `.npz`
  written and finite, and the trajectory within the JAX end-to-end test's
  ATE bound (0.02);
- `sfm_scale --cams 12 --pts 400 --device-driver --solver cg
  --skip-scaling` against the JAX package's CLI (experiments/sfm_scale.py)
  run on the same world: the same world and pose-graph initialisation bit
  for bit, the printed ATE after BA within 1% and the robust cost within
  1e-4 relative (measured: 0.6% and 4e-6; the cost valley is flat along
  the trajectory, so float32 rounding moves the cameras more than the cost).
"""

import contextlib
import importlib
import io
import json
import os
import re
import runpy
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from roma_torch.experiments import sfm_reconstruct, sfm_scale  # noqa: E402
from roma_torch.sfm.metrics import absolute_trajectory_error  # noqa: E402

BA_LINE = re.compile(r"ATE after BA .*: rmse ([\d.]+) median ([\d.]+) robust cost ([\d.]+) px\^2")


def test_sfm_reconstruct_cli(tmp_path, monkeypatch, capsys):
    torch.set_num_threads(2)
    scene = cs.write_sfm_scene(tmp_path, n=6, hw=(240, 320))
    monkeypatch.setattr(sfm_reconstruct, "DEVICE", "cpu")
    monkeypatch.setattr(sfm_reconstruct, "tiny_roma_v1_outdoor",
                        lambda device=None: cs.ExactWarpMatcher(scene, 2, device))
    out = tmp_path / "rec.npz"
    res = sfm_reconstruct.main(["--images", str(scene["images"]), "--window", "2",
                                "--num_matches", "500", "--intrinsics", str(scene["intrinsics"]),
                                "--gt_trajectory", str(scene["gt_trajectory"]),
                                "--out", str(out)])
    assert sorted(res["matches"]) == [(i, j) for i in range(6) for j in range(i + 1, min(i + 3, 6))]
    assert all(n == 500 for n in res["matches"].values())
    saved = np.load(out)
    assert set(saved.files) == {"rotations", "translations", "points", "centers"}
    assert all(np.isfinite(saved[k]).all() for k in saved.files)
    assert saved["rotations"].shape == (6, 3, 3) and len(saved["points"]) > 100
    ate = absolute_trajectory_error(saved["centers"], scene["centers"])
    assert ate["ate_rmse"] < 0.02, ate
    assert '"ate_rmse"' in capsys.readouterr().out


def test_sfm_scale_cli_matches_the_jax_cli(monkeypatch, capsys):
    torch.set_num_threads(2)
    argv = ["--cams", "12", "--pts", "400", "--device-driver", "--solver", "cg",
            "--skip-scaling"]
    jax_study = runpy.run_path(os.path.join(ROOT, "experiments", "sfm_scale.py"))
    w_jax, w = jax_study["make_world"](12, 400), sfm_scale.make_world(12, 400)
    assert all(np.array_equal(w_jax[k], w[k]) for k in w)
    for a, b in zip(jax_study["noisy_pose_graph_init"](w_jax, np.random.default_rng(0)),
                    sfm_scale.noisy_pose_graph_init(w, np.random.default_rng(0))):
        np.testing.assert_array_equal(a, b)

    monkeypatch.setattr(sfm_scale, "DEVICE", "cpu")
    res = sfm_scale.main(argv)
    got = tuple(map(float, BA_LINE.search(capsys.readouterr().out).groups()))
    assert got == pytest.approx((res["ate_ba"]["ate_rmse"], res["ate_ba"]["ate_median"],
                                 res["cost"]), abs=1e-3)
    assert res["ate_ba"]["ate_rmse"] < res["ate_init"]["ate_rmse"]
    # the JAX CLI's computation (its functions, its BA arguments), through
    # the order study's code at one order
    (row,) = study_orders(12, 400, solver="cg", orders=1, sides=("jax",))
    np.testing.assert_allclose(got[:2], row["jax"][:2], rtol=1e-2)
    np.testing.assert_allclose(got[2], row["jax"][2], rtol=1e-4)


def test_one_step_study_matches_jax_and_the_oracle():
    """`sfm_study step` on the CPU beside the JAX package's solves from the
    same start state (`study_step`), at lambda 0.1, as chip_smoke.py gates
    the card: each refined camera delta within 1e-6 (relative L2) of the
    float64 oracle's, JAX's too, the float32 solve alone not; the costs
    after the step within 1e-6 of each other."""
    from roma_torch.experiments import sfm_study

    torch.set_num_threads(2)
    (jax_row,) = study_step(16, 1500, lams=(0.1,), solvers=("cg", "dense"))
    rows = sfm_study.main(["step", "--cams", "16", "--pts", "1500", "--lams", "0.1",
                           "--device", "cpu"])
    assert [r["solver"] for r in rows] == ["dense", "cg"]
    for r in rows:
        jax_solve = jax_row[r["solver"]]
        assert r["refined"]["dc_rel_l2"] <= 1e-6 < r["float32"]["dc_rel_l2"], r
        assert jax_solve["dc_rel_l2"] <= 1e-6, jax_row
        assert r["refined"]["cost"] == pytest.approx(jax_solve["cost"], rel=1e-6)
        assert r["oracle_cost"] == pytest.approx(jax_row["oracle_cost"], rel=1e-6)


def test_sfm_study_orders_cli():
    """`sfm_study orders` on the CPU, 2 orders x 2 scatter modes, 8 LM
    iterations: finite, below the start's cost; on the CPU index_add_ sums
    in order, so the two modes are bit-equal."""
    from roma_torch.experiments import sfm_study

    torch.set_num_threads(2)
    rows = sfm_study.main(["orders", "--cams", "12", "--pts", "400", "--orders", "2",
                           "--iters", "8", "--modes", "atomics,deterministic",
                           "--device", "cpu"])
    assert [(r["order"], r["mode"]) for r in rows] == [
        (o, m) for o in ("given order", "permutation 0") for m in ("atomics", "deterministic")]
    _, problem, _ = sfm_study.study_problem(12, 400, None, "cpu")
    start = float(sfm_study._ba_cost(sfm_study.start_state(problem), sfm_study.BA["huber_delta"]))
    for r in rows:
        assert np.isfinite(r["ate"]).all() and r["cost"] < start, r
    assert rows[0]["cost"] == rows[1]["cost"] and rows[2]["cost"] == rows[3]["cost"]


def jax_points(world, problem) -> np.ndarray:
    """The JAX package's triangulation of the study's tracks from the
    problem's cameras, as its CLI starts (float32)."""
    js = runpy.run_path(os.path.join(ROOT, "experiments", "sfm_scale.py"))
    return np.asarray(js["triangulate_tracks"](
        problem.cameras.numpy(), problem.intrinsics.numpy(), world["cam_idx"],
        world["pt_idx"], world["uv"], len(world["X"])), np.float32)


def study_orders(cams: int, pts: int, obs_per_cam=None, solver: str = "dense", orders: int = 5,
                 iters: int = 30, sides=("jax", "port")) -> list[dict]:
    """For the study's world in its given observation order and in
    `orders - 1` permutations of it (numpy default_rng(1), one after
    another), the JAX package's device BA and the port's on the CPU (the
    study's arguments), each from its own float32 triangulation, as each
    CLI starts (ROADMAP C11): each row's "jax" and "port" readings are ATE
    rmse, ATE median and the robust cost. `sides`: which of the two to
    run."""
    import jax.numpy as jnp

    from roma_torch.experiments import sfm_study

    JB = importlib.import_module("roma_tpu.sfm.bundle_adjust")
    world, base, _ = sfm_study.study_problem(cams, pts, obs_per_cam, "cpu")
    X0j = jax_points(world, base)
    port = (sfm_study.orders(world, base, solver, orders, iters, modes=("atomics",))
            if "port" in sides else [])
    rng = np.random.default_rng(1)
    n = len(world["uv"])
    rows = []
    for k in range(orders):
        perm = np.arange(n) if k == 0 else rng.permutation(n)
        row = {"order": "given order" if k == 0 else f"permutation {k - 1}"}
        if port:
            row["port"] = [*port[k]["ate"], port[k]["cost"]]
        rows.append(row)
        if "jax" not in sides:
            continue
        pj = JB.BAProblem(
            cameras=jnp.asarray(base.cameras.numpy()), points=jnp.asarray(X0j),
            intrinsics=jnp.asarray(base.intrinsics.numpy()),
            cam_idx=jnp.asarray(world["cam_idx"][perm]), pt_idx=jnp.asarray(world["pt_idx"][perm]),
            uv=jnp.asarray(world["uv"][perm]), mask=jnp.ones(n, jnp.float32))
        outj, costj = JB.bundle_adjust_device(pj, iters=iters, solver=solver, **sfm_study.BA)
        cj = np.asarray(outj.cameras)
        Rj = np.stack([np.asarray(JB.rodrigues(jnp.asarray(c[:3]))) for c in cj])
        atej = absolute_trajectory_error(-np.einsum("nij,ni->nj", Rj, cj[:, 3:]), world["centers"])
        row["jax"] = [atej["ate_rmse"], atej["ate_median"], float(costj)]
    return rows


def study_step(cams: int, pts: int, obs_per_cam=None, lams=(1e-4, 1e-3, 1e-2, 1e-1),
               solvers=("cg",)) -> list[dict]:
    """The JAX side of `roma_torch.experiments.sfm_study step`: from the
    study's gated start state, one LM candidate step of the JAX package's
    device solves (`_cg_schur_solve`, `_dense_schur_solve_f64`, under its
    float64 scope) at each lambda, held to `sfm_study.schur_oracle_f64` of
    the JAX package's own blocks: the camera delta's relative L2 distance
    and the robust cost after the step beside the oracle's (ROADMAP C11)."""
    import jax
    import jax.numpy as jnp

    from roma_torch.experiments import sfm_study

    JB = importlib.import_module("roma_tpu.sfm.bundle_adjust")
    _, problem, _ = sfm_study.study_problem(cams, pts, obs_per_cam, "cpu")
    p = sfm_study.start_state(problem)
    pj = JB.BAProblem(*[jnp.asarray(t.numpy()) for t in p])
    rows = []
    with jax.enable_x64(True), jax.default_matmul_precision("highest"):
        r, Jc, Jp = JB._build_blocks(pj, 3.0)
        seg = jax.ops.segment_sum
        g_c = seg(jnp.einsum("kij,ki->kj", Jc, r), pj.cam_idx, cams)
        g_p = seg(jnp.einsum("kij,ki->kj", Jp, r), pj.pt_idx, pts)
        U0 = seg(jnp.einsum("kia,kib->kab", Jc, Jc), pj.cam_idx, cams)
        V0 = seg(jnp.einsum("kia,kib->kab", Jp, Jp), pj.pt_idx, pts)
        W = jnp.einsum("kia,kib->kab", Jc, Jp)
        solve = {s: jax.jit(JB._cg_schur_solve if s == "cg" else JB._dense_schur_solve_f64,
                            static_argnums=(7,)) for s in solvers}
        for lam in lams:
            lam32 = jnp.float32(lam)
            U, V = U0 + lam32 * JB._diag_clamp(U0), V0 + lam32 * JB._diag_clamp(V0)
            blocks = [torch.from_numpy(np.array(t)) for t in (U, V, W, g_c, g_p)]
            dc_o, dp_o = sfm_study.schur_oracle_f64(*blocks, p.cam_idx, p.pt_idx)
            row = {"lam": lam, "oracle_cost": sfm_study.candidate_cost(p, dc_o, dp_o, 3.0)}
            for solver in solvers:
                dc, dp = (torch.from_numpy(np.array(t)) for t in
                          solve[solver](U, V, W, g_c, g_p, pj.cam_idx, pj.pt_idx, True))
                row[solver] = {"dc_rel_l2": sfm_study.rel_l2(dc, dc_o),
                               "cost": sfm_study.candidate_cost(p, dc, dp, 3.0)}
            rows.append(row)
    return rows


if __name__ == "__main__":
    # PYTHONPATH=. python tests/test_torch_sfm_cli.py step 1000 100000 1200 [cg,dense]
    # PYTHONPATH=. python tests/test_torch_sfm_cli.py orders 100 10000 [obs_per_cam solver
    #     orders]
    # PYTHONPATH=. python tests/test_torch_sfm_cli.py points 1000 100000 1200 OUT.npy
    # ("-" for no obs_per_cam)
    import jax

    jax.config.update("jax_platforms", "cpu")
    mode, a = sys.argv[1], sys.argv[2:]
    size = (int(a[0]), int(a[1]), int(a[2]) if len(a) > 2 and a[2] != "-" else None)
    if mode == "step":
        out = study_step(*size, solvers=tuple(a[3].split(",")) if len(a) > 3 else ("cg",))
    elif mode == "orders":
        out = study_orders(*size, a[3] if len(a) > 3 else "dense", int(a[4]) if len(a) > 4 else 5)
    else:
        from roma_torch.experiments import sfm_study

        world, problem, _ = sfm_study.study_problem(*size, "cpu")
        np.save(a[3], jax_points(world, problem))
        out = []
    for row in out:
        print(json.dumps(row), flush=True)
