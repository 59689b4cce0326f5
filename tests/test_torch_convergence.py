"""Training-convergence proof for the port (tests/test_convergence.py's, on
the port alone): the loss decreases and the model learns a warp, not just
"one step changes the parameters".

Setup as the JAX package's: a fronto-parallel textured plane seen by two
cameras separated by a pure x-translation, so the GT dense warp is a
constant disparity of 6 px at 64x64. The port's whole training stack
(TinyRoma in train mode -> tiny_robust_loss -> clip -> AdamW), float32 on
the CPU from the port's own initialisation (seed 0), must overfit this
single pair until the dense end-point error at the fine scale is < 1 px.
"""

import numpy as np
import pytest
import torch

from roma_torch.config import TinyRomaConfig, TrainConfig
from roma_torch.losses.robust_loss import RobustLossConfig, tiny_robust_loss
from roma_torch.models.zoo import build_model
from roma_torch.train.train import make_tiny_train_state, make_train_step

H = W = 64
FX = 64.0
PLANE_D = 4.0
SHIFT_PX = 6  # disparity = FX * tx / d


def _textured_pair() -> dict:
    """im_B is im_A shifted left by SHIFT_PX (integer: no resampling)."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (H, W + SHIFT_PX, 3)).astype(np.float32)
    for ax in (0, 1):
        base = 0.6 * base + 0.2 * (np.roll(base, 1, ax) + np.roll(base, -1, ax))
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -SHIFT_PX * PLANE_D / FX
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1]], np.float32)
    depth = np.full((H, W), PLANE_D, np.float32)
    batch = {"im_A": base[:, :W], "im_B": base[:, SHIFT_PX:], "im_A_depth": depth,
             "im_B_depth": depth, "T_1to2": T, "K1": K, "K2": K}
    return {k: torch.from_numpy(np.ascontiguousarray(v))[None] for k, v in batch.items()}


def _fine_epe_px(model, batch) -> float:
    """Mean end-point error at scale 4 in pixels (eval mode), away from the
    left border that B does not see."""
    with torch.no_grad():
        flow = model.eval()(batch["im_A"], batch["im_B"])[4]["flow"][0].numpy()
    model.train()
    h4, w4 = flow.shape[:2]
    gx, gy = np.meshgrid(np.linspace(-1 + 1 / w4, 1 - 1 / w4, w4),
                         np.linspace(-1 + 1 / h4, 1 - 1 / h4, h4), indexing="xy")
    gt_x = gx - 2 * SHIFT_PX / W
    valid = gt_x > -1 + 2 * SHIFT_PX / W
    return float(np.mean(np.hypot(flow[..., 0] - gt_x, flow[..., 1] - gy)[valid]) * W / 2)


@pytest.mark.slow
def test_tiny_roma_overfits_synthetic_scene():
    batch = _textured_pair()
    model = build_model(TinyRomaConfig(match_dim=64, fine_match_dim=32, dtype="float32"), 0)
    # small model, aggressive LR for a single-pair overfit (the JAX test's)
    state = make_tiny_train_state(TrainConfig(batch_size=1, lr_decoder=2e-3, grad_clip=1.0),
                                  model=model, trainable="all", device="cpu")
    step = make_train_step(tiny_robust_loss, RobustLossConfig(
        ce_weight=0.01, alpha={4: 0.15, 8: 0.15}, c=1e-4, local_dist={4: 4},
        epe_mask_prob_th=0.001, corr_volume_weight=1.0))
    assert _fine_epe_px(state.model, batch) > 5.0  # random init is far off

    losses = []
    for _ in range(500):
        state, metrics = step(state, batch)
        losses.append(float(metrics["total_loss"]))
    first, last = float(np.median(losses[:20])), float(np.median(losses[-20:]))
    assert last < 0.85 * first, (first, last)
    assert _fine_epe_px(state.model, batch) < 1.0
