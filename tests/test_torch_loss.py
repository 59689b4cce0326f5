"""The training losses, JAX vs the port, on the CPU in float32: the GT warp
from depth and pose (`get_gt_warp`), full RoMa's `robust_loss` with each
of its metrics, Tiny RoMa's `tiny_robust_loss` and `corr_volume_nll`, on
the same random corresps and `tests/test_train.py::make_batch`-style
batches (noisy depth with holes, a small rotation). Tolerance 1e-5,
relative to each value (absolute for the warp, in normalized units);
the validity masks must agree exactly."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.utils.geometry import get_gt_warp as j_get_gt_warp
from roma_torch.losses import robust_loss as tloss
from roma_torch.utils.geometry import get_gt_warp

# the JAX package's losses/__init__ exports the function under the module's name
jloss = importlib.import_module("roma_tpu.losses.robust_loss")
TOL = 1e-5


def make_batch(rng, b=2, h=64, w=64):
    K = np.array([[80.0, 0, w / 2], [0, 80.0, h / 2], [0, 0, 1]], np.float32)
    T = np.eye(4, dtype=np.float32)
    a = 0.05
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[0, 3] = 0.05

    def depth():
        d = (2.0 + 0.3 * rng.uniform(-1, 1, (b, h, w))).astype(np.float32)
        d[:, : h // 8] = 0.0  # no depth: invalid
        return d

    return {
        "im_A": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "im_B": rng.uniform(0, 1, (b, h, w, 3)).astype(np.float32),
        "im_A_depth": depth(), "im_B_depth": depth(),
        "T_1to2": np.tile(T, (b, 1, 1)),
        "K1": np.tile(K, (b, 1, 1)), "K2": np.tile(K, (b, 1, 1)),
    }


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, ref, what, tol=TOL):
    got, ref = float(got), float(ref)
    assert np.isfinite(got) and abs(got - ref) <= tol * max(1.0, abs(ref)), f"{what}: {got} vs {ref}"


@pytest.mark.parametrize("hw", [(64, 64), (14, 14), (28, 20)])
def test_get_gt_warp_matches_jax(hw):
    batch = make_batch(np.random.default_rng(0))
    args = [batch[k] for k in ("im_A_depth", "im_B_depth", "T_1to2", "K1", "K2")]
    x2_j, prob_j = j_get_gt_warp(*args, H=hw[0], W=hw[1])
    x2, prob = get_gt_warp(*(torch.from_numpy(a) for a in args), H=hw[0], W=hw[1])
    assert x2.dtype == torch.float32 and tuple(x2.shape) == (2, *hw, 2)
    np.testing.assert_array_equal(prob.numpy(), np.asarray(prob_j))
    assert 0.2 < float(prob.mean()) < 0.95
    np.testing.assert_allclose(x2.numpy(), np.asarray(x2_j), rtol=0, atol=TOL)


def _full_corresps(rng, batch, b=2, h=112, w=112, res=8):
    """Random corresps for scales 16 ... 1: flows near the GT warp (so the
    hierarchical gate keeps some pixels and drops others), certainty
    logits, and at scale 16 anchor logits over an 8 x 8 grid."""
    out = {}
    tb = _t(batch)
    for s in (16, 8, 4, 2, 1):
        hs, ws = (h // 14, w // 14) if s == 16 else (h // s, w // s)
        gt, _ = get_gt_warp(tb["im_A_depth"], tb["im_B_depth"], tb["T_1to2"], tb["K1"],
                            tb["K2"], H=hs, W=ws)
        flow = gt.numpy() + rng.normal(0, 0.02 * s / 8, gt.shape).astype(np.float32)
        out[s] = {"flow": flow.astype(np.float32),
                  "certainty": rng.normal(0, 2, (b, hs, ws, 1)).astype(np.float32)}
    out[16]["gm_cls"] = rng.normal(0, 3, (b, h // 14, w // 14, res * res)).astype(np.float32)
    out[16]["gm_certainty"] = rng.normal(0, 2, (b, h // 14, w // 14, 1)).astype(np.float32)
    return out


def _both(corresps):
    j = {s: {k: jnp.asarray(v) for k, v in d.items()} for s, d in corresps.items()}
    t = {s: {k: torch.from_numpy(v) for k, v in d.items()} for s, d in corresps.items()}
    return j, t


def test_robust_loss_and_metrics_match_jax():
    rng = np.random.default_rng(1)
    batch = make_batch(rng, h=112, w=112)
    jc, tc = _both(_full_corresps(rng, batch))
    cfg_j = jloss.RobustLossConfig(alpha=0.5, c=1e-4, local_dist={1: 4, 2: 4, 4: 8, 8: 8},
                                   cls_res=8)
    cfg_t = tloss.RobustLossConfig(alpha=0.5, c=1e-4, local_dist={1: 4, 2: 4, 4: 8, 8: 8},
                                   cls_res=8)
    loss_j, m_j = jloss.robust_loss(jc, batch, cfg_j)
    loss, m = tloss.robust_loss(tc, _t(batch), cfg_t)
    assert set(m) == set(m_j) and "gm_cls_loss_16" in m and len(m) == 12
    for k in m_j:
        _close(m[k], m_j[k], k)
    _close(loss, loss_j, "total")


def test_tiny_robust_loss_and_corr_volume_match_jax():
    rng = np.random.default_rng(2)
    b, h, w = 2, 64, 64
    batch = make_batch(rng, b, h, w)
    # the InfoNCE needs mutual-nearest GT pairs on the 8 x 8 grid: image B
    # is image A's camera (identity pose), with holes in one depth map
    batch["T_1to2"] = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    batch["im_B_depth"] = np.full_like(batch["im_B_depth"], 2.0)
    tb = _t(batch)
    corresps = {}
    for s in (8, 4):
        hs, ws = h // s, w // s
        gt, _ = get_gt_warp(tb["im_A_depth"], tb["im_B_depth"], tb["T_1to2"], tb["K1"],
                            tb["K2"], H=hs, W=ws)
        corresps[s] = {
            "flow": (gt.numpy() + rng.normal(0, 0.01, gt.shape)).astype(np.float32),
            "certainty": rng.normal(0, 2, (b, hs, ws, 1)).astype(np.float32)}
    L = (h // 8) * (w // 8)
    corresps[8]["corr_volume"] = rng.normal(0, 1, (b, L, L)).astype(np.float32)
    jc, tc = _both(corresps)
    loss_j, m_j = jloss.tiny_robust_loss(jc, batch)
    loss, m = tloss.tiny_robust_loss(tc, tb)
    assert set(m) == set(m_j) and float(m["corr_volume_loss_8"]) > 0
    for k in m_j:
        _close(m[k], m_j[k], k)
    _close(loss, loss_j, "total")

    # corr_volume_nll alone, the backward warp from the inverse pose
    gt_f, _ = get_gt_warp(tb["im_A_depth"], tb["im_B_depth"], tb["T_1to2"], tb["K1"], tb["K2"],
                          H=8, W=8)
    gt_b, _ = get_gt_warp(tb["im_B_depth"], tb["im_A_depth"], torch.linalg.inv(tb["T_1to2"]),
                          tb["K2"], tb["K1"], H=8, W=8)
    cv = corresps[8]["corr_volume"]
    ref = jloss.corr_volume_nll(jloss.RobustLossConfig(), jnp.asarray(cv),
                                jnp.asarray(gt_f.numpy()), jnp.asarray(gt_b.numpy()), (8, 8))
    got = tloss.corr_volume_nll(tloss.RobustLossConfig(), torch.from_numpy(cv), gt_f, gt_b, (8, 8))
    assert float(got) > 0
    _close(got, ref, "corr_volume_nll")


def test_regression_terms_match_jax():
    rng = np.random.default_rng(3)
    gt = rng.uniform(-1, 1, (2, 9, 11, 2)).astype(np.float32)
    prob = (rng.uniform(0, 1, (2, 9, 11)) > 0.3).astype(np.float32)
    flow = (gt + rng.normal(0, 0.05, gt.shape)).astype(np.float32)
    cert = rng.normal(0, 3, (2, 9, 11, 1)).astype(np.float32)
    cfg_j, cfg_t = jloss.RobustLossConfig(alpha={4: 0.15}), tloss.RobustLossConfig(alpha={4: 0.15})
    ref = jloss.regression_terms(cfg_j, gt, prob, flow, cert, 4)
    got = tloss.regression_terms(cfg_t, *(torch.from_numpy(a) for a in (gt, prob, flow, cert)), 4)
    for a, b, what in zip(got, ref, ("certainty", "regression")):
        _close(a, b, what)


def test_loss_config_defaults_match_jax():
    import dataclasses

    assert dataclasses.asdict(tloss.RobustLossConfig()) == dataclasses.asdict(
        jloss.RobustLossConfig())
