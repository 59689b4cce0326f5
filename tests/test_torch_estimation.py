"""The port's geometry pose helpers, robust estimators, native RANSAC and
pose backends against the JAX package's, on the same seeded numpy inputs.

The estimators are numpy copies whose RNG is the caller's
`np.random.Generator`, so each is held equal to 1e-12 (the same float64
operations in the same order give the same bits; the bound leaves room for
nothing else). The native library is the same C++ source built into the
port's build/native/: the same inlier mask, and R, t to 1e-9. The
epipolar distances work on tensors (float32 here) and are held to 1e-6."""

import numpy as np
import pytest
import torch

import roma_tpu.estimation as jest
import roma_tpu.estimation.essential as jess
import roma_tpu.estimation.homography as jhom
import roma_tpu.utils.geometry as jgeo
import roma_torch.estimation as pest
import roma_torch.estimation.essential as tess
import roma_torch.estimation.homography as thom
import roma_torch.utils.geometry as tgeo
from roma_torch.benchmarks import pose_backends as tpb
from test_estimation import synthetic_pair

EXACT = 1e-12
NATIVE_TOL = 1e-9
K = np.array([[800.0, 0, 400], [0, 800.0, 300], [0, 0, 1]])


def _equal(got, ref, tol=EXACT):
    if ref is None or got is None:
        assert got is None and ref is None
        return
    if hasattr(ref, "model"):  # RansacResult
        _equal(got.model, ref.model, tol)
        np.testing.assert_array_equal(got.inliers, ref.inliers)
        assert abs(got.score - ref.score) <= tol and got.num_iters == ref.num_iters
        return
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _equal(g, r, tol)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=0, atol=tol)


def _pixels(x):
    return x @ K[:2, :2].T + K[:2, 2]


def test_pose_helpers_equal_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        R1, R2 = (np.linalg.qr(rng.standard_normal((3, 3)))[0] for _ in range(2))
        t1, t2 = rng.standard_normal(3), rng.standard_normal(3)
        _equal(tgeo.compute_relative_pose(R1, t1, R2, t2),
               jgeo.compute_relative_pose(R1, t1, R2, t2))
        T = np.concatenate([R2, t2[:, None]], 1)
        _equal(tgeo.compute_pose_error(T, R1, t1), jgeo.compute_pose_error(T, R1, t1))
        _equal(tgeo.angle_error_mat(R1, R2), jgeo.angle_error_mat(R1, R2))
        _equal(tgeo.angle_error_vec(t1, t2), jgeo.angle_error_vec(t1, t2))
    errs = rng.uniform(0, 30, 200)
    _equal(tgeo.pose_auc(errs, [5, 10, 20]), jgeo.pose_auc(errs, [5, 10, 20]))
    _equal(tgeo.pose_auc([0.0, 0.0], [5, 10]), [1.0, 1.0])


def test_epipolar_distances_equal_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    pts1 = rng.uniform(-1, 1, (2, 20, 2)).astype(np.float32)
    pts2 = rng.uniform(-1, 1, (2, 20, 2)).astype(np.float32)
    F = rng.standard_normal((2, 3, 3)).astype(np.float32)
    lines = rng.standard_normal((2, 20, 3)).astype(np.float32)
    got = tgeo.signed_point_line_distance(torch.from_numpy(pts1), torch.from_numpy(lines))
    ref = jgeo.signed_point_line_distance(jnp.asarray(pts1), jnp.asarray(lines))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    got = tgeo.signed_left_to_right_epipolar_distance(
        torch.from_numpy(pts1), torch.from_numpy(pts2), torch.from_numpy(F))
    ref = jgeo.signed_left_to_right_epipolar_distance(
        jnp.asarray(pts1), jnp.asarray(pts2), jnp.asarray(F))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_minimal_and_linear_solvers_equal_jax():
    x0, x1, R, t = synthetic_pair(n=60, noise=1e-3, seed=5)
    _equal(pest.essential_8pt(x0[None, :16], x1[None, :16]),
           jest.essential_8pt(x0[None, :16], x1[None, :16]))
    five = np.stack([x0[:5], x0[5:10]]), np.stack([x1[:5], x1[5:10]])
    _equal(pest.essential_5pt(*five), jest.essential_5pt(*five))
    seven = x0[None, :7] * 300, x1[None, :7] * 300
    _equal(pest.fundamental_7pt(*seven), jest.fundamental_7pt(*seven))
    _equal(pest.fundamental_8pt(x0[None, :12], x1[None, :12]),
           jest.fundamental_8pt(x0[None, :12], x1[None, :12]))
    _equal(pest.homography_dlt(x0[None, :4], x1[None, :4]),
           jest.homography_dlt(x0[None, :4], x1[None, :4]))
    E = jess.essential_8pt(x0[None], x1[None])[0]
    _equal(pest.decompose_essential(E), jest.decompose_essential(E))
    _equal(tess.sampson_sq(E[None], x0, x1), jess.sampson_sq(E[None], x0, x1))
    _equal(tess.triangulate(R, t, x0, x1), jess.triangulate(R, t, x0, x1))
    _equal(tess.recover_pose(E, x0, x1), jess.recover_pose(E, x0, x1))
    H = jhom.homography_dlt(x0[None, :8], x1[None, :8])
    _equal(thom.transfer_error_sq(H, x0, x1), jhom.transfer_error_sq(H, x0, x1))


@pytest.mark.parametrize("solver,scoring", [("5pt", "magsac"), ("8pt", "msac")])
def test_essential_ransac_and_pose_equal_jax(solver, scoring):
    x0, x1, _, _ = synthetic_pair(n=300, outlier_frac=0.3, noise=1e-4, seed=2)
    kw = dict(threshold=1e-2, max_iters=200, solver=solver, scoring=scoring)
    _equal(pest.estimate_essential_ransac(x0, x1, rng=np.random.default_rng(4), **kw),
           jest.estimate_essential_ransac(x0, x1, rng=np.random.default_rng(4), **kw))
    k0, k1 = _pixels(x0), _pixels(x1)
    pkw = dict(norm_thresh=1e-2, max_iters=200, solver=solver, scoring=scoring)
    _equal(pest.estimate_pose(k0, k1, K, K, rng=np.random.default_rng(9), **pkw),
           jest.estimate_pose(k0, k1, K, K, rng=np.random.default_rng(9), **pkw))


def test_fundamental_homography_and_uncalibrated_equal_jax():
    x0, x1, _, _ = synthetic_pair(n=300, outlier_frac=0.2, noise=1e-4, seed=3)
    k0, k1 = _pixels(x0), _pixels(x1)
    _equal(pest.estimate_fundamental_ransac(k0, k1, 1.0, max_iters=300,
                                             rng=np.random.default_rng(1)),
           jest.estimate_fundamental_ransac(k0, k1, 1.0, max_iters=300,
                                            rng=np.random.default_rng(1)))
    _equal(pest.estimate_pose_uncalibrated(k0, k1, K, K, 1.0, max_iters=300,
                                            rng=np.random.default_rng(2)),
           jest.estimate_pose_uncalibrated(k0, k1, K, K, 1.0, max_iters=300,
                                           rng=np.random.default_rng(2)))
    H = np.array([[1.1, 0.05, 12.0], [-0.03, 0.95, -7.0], [1e-4, 2e-5, 1.0]])
    p0 = np.random.default_rng(6).uniform(0, 600, (200, 2))
    p1h = np.c_[p0, np.ones(200)] @ H.T
    p1 = p1h[:, :2] / p1h[:, 2:]
    p1[:50] = np.random.default_rng(7).uniform(0, 600, (50, 2))
    _equal(pest.estimate_homography_ransac(p0, p1, 2.0, rng=np.random.default_rng(3)),
           jest.estimate_homography_ransac(p0, p1, 2.0, rng=np.random.default_rng(3)))


def test_exports_equal_jax():
    assert set(n for n in dir(pest) if not n.startswith("_")) - {"native"} == set(
        n for n in dir(jest) if not n.startswith("_")) - {"native"}


@pytest.fixture(scope="module")
def libs():
    import roma_tpu.estimation.native as jnative
    import roma_torch.estimation.native as tnative

    tnative.load_library()
    jnative.load_library()
    return tnative, jnative


@pytest.mark.parametrize("solver,scoring,outliers", [("5pt", "magsac", 0.3),
                                                     ("8pt", "msac", 0.2)])
def test_native_library_equals_jax(libs, solver, scoring, outliers):
    """The port's build of the same C++ source: same inliers, R and t."""
    tnative, jnative = libs
    assert tnative.LIB_PATH != jnative._LIB_PATH
    x0, x1, R, t = synthetic_pair(n=500, outlier_frac=outliers, noise=1e-4, seed=11)
    kw = dict(threshold=1e-2, max_iters=500, solver=solver, scoring=scoring, seed=3)
    got = tnative.estimate_essential_ransac_native(x0, x1, **kw)
    ref = jnative.estimate_essential_ransac_native(x0, x1, **kw)
    np.testing.assert_array_equal(got[3], ref[3])
    _equal(got[:3], ref[:3], NATIVE_TOL)
    assert jgeo.angle_error_mat(got[1], R) < 0.5
    k0, k1 = _pixels(x0), _pixels(x1)
    _equal(tnative.estimate_pose_cpp(k0, k1, K, K, 1e-2),
           jnative.estimate_pose_cpp(k0, k1, K, K, 1e-2), NATIVE_TOL)
    rng = np.random.default_rng(0)
    assert tnative.estimate_essential_ransac_native(
        rng.normal(size=(4, 2)), rng.normal(size=(4, 2)), 1e-2) is None


def test_native_rejects_mismatched_point_sets(libs):
    with pytest.raises(ValueError, match="point sets"):
        libs[0].estimate_essential_ransac_native(np.zeros((10, 2)), np.zeros((9, 2)), 1e-2)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_pose_backends_equal_jax(backend):
    import roma_tpu.benchmarks.pose_backends as jpb

    x0, x1, _, _ = synthetic_pair(n=400, outlier_frac=0.25, noise=1e-4, seed=8)
    k0, k1 = _pixels(x0), _pixels(x1)
    got = tpb.get_pose_backend(backend)(k0, k1, K, K, 1e-2)
    ref = jpb.get_pose_backend(backend)(k0, k1, K, K, 1e-2)
    _equal(got, ref, NATIVE_TOL if backend == "native" else EXACT)
    if backend == "native":
        fn, err = tpb.bind_native()
        assert err is None and fn.__module__ == "roma_torch.estimation.native"


def test_native_bind_is_once_under_concurrent_first_calls(monkeypatch):
    """The double-checked lock: eight threads racing the first bind build
    and bind once, and all see the same bound function."""
    import sys
    import threading

    calls = []
    monkeypatch.setattr(tpb, "_NATIVE_BIND", None)
    real = sys.modules["roma_torch.estimation.native"].load_library

    def counting():
        calls.append(1)
        return real()

    monkeypatch.setattr(sys.modules["roma_torch.estimation.native"], "load_library", counting)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = [None] * 8
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(i, tpb.bind_native()[0]))
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(calls) == 1 and out[0] is not None and all(o is out[0] for o in out)
