"""Multi-scale robust matching losses (full RoMa and Tiny RoMa), a port of
the JAX package's ``losses/robust_loss.py``: pure functions of
(corresps, batch) returning (scalar loss, metrics dict), masked means
instead of boolean indexing, GT warps recomputed per scale from depth.

- generalized Charbonnier regression on the end-point error, masked to
  confident GT (prob > 0.99): cs^a ((epe/cs)^2 + 1)^(a/2), cs = c * scale;
- BCE on certainty logits against GT validity;
- full variant: cross-entropy over the cls_res^2 anchor grid at the coarse
  scale (nearest-anchor label), and hierarchical locality gating: scales
  <= local_largest_scale are supervised only where the previous scale's
  EPE (nearest-resized) was already small;
- tiny variant: per-scale locality gate on its own EPE, certainty target
  zeroed where EPE > scale * epe_mask_prob_th, and the dual-softmax
  InfoNCE on the correlation volume at mutual-nearest GT pairs.

Corresps and batches are channels-last, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from roma_torch.ops.corr import coord_grid
from roma_torch.ops.resize import interpolate_nearest
from roma_torch.utils.geometry import get_gt_warp


@dataclasses.dataclass(frozen=True)
class RobustLossConfig:
    ce_weight: float = 0.01
    alpha: Mapping[int, float] | float = 0.5
    c: float = 1e-4
    local_dist: Mapping[int, float] = dataclasses.field(default_factory=dict)
    local_largest_scale: int = 8
    epe_mask_prob_th: float | None = None
    corr_volume_weight: float = 1.0
    corr_volume_inv_temp: float = 10.0
    cls_res: int = 64
    relative_depth_error_threshold: float = 0.05


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    m = mask.float()
    return (x * m).sum() / (m.sum() + eps)


def _bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def _alpha_for(cfg: RobustLossConfig, scale: int) -> float:
    return cfg.alpha[scale] if isinstance(cfg.alpha, Mapping) else cfg.alpha


def regression_terms(cfg: RobustLossConfig, gt_warp, prob, flow, certainty, scale: int,
                     gt_cert=None):
    """(certainty BCE mean, Charbonnier regression mean over prob > 0.99)."""
    epe = torch.linalg.norm(flow - gt_warp, dim=-1)
    ce = _bce_with_logits(certainty[..., 0], gt_cert if gt_cert is not None else prob).mean()
    a = _alpha_for(cfg, scale)
    cs = cfg.c * scale
    reg = cs**a * ((epe / cs) ** 2 + 1.0) ** (a / 2)
    return ce, _masked_mean(reg, prob > 0.99)


def corr_volume_nll(cfg: RobustLossConfig, cv, gt_warp_fwd, gt_warp_bwd, hw):
    """Dual-softmax InfoNCE at mutual-nearest GT pairs. cv: (B, L_A, L_B)
    target-major volume; mutual pairs by nearest-anchor snapping of the
    forward warp against the B grid and the backward warp against the A
    grid, both within 0.01 normalized units."""
    h, w = hw
    L = h * w
    grid = coord_grid(h, w, device=cv.device).reshape(L, 2)
    fa = gt_warp_fwd.reshape(-1, L, 2)
    fb = gt_warp_bwd.reshape(-1, L, 2)
    d_b = torch.linalg.norm(fa[:, :, None, :] - grid[None, None, :, :], dim=-1)
    d_a = torch.linalg.norm(grid[None, :, None, :] - fb[:, None, :, :], dim=-1)
    is_nn_b = d_b == d_b.amin(dim=-1, keepdim=True)
    is_nn_a = d_a == d_a.amin(dim=-2, keepdim=True)
    mnn = is_nn_b & is_nn_a & (d_b < 0.01) & (d_a < 0.01)
    logits = cfg.corr_volume_inv_temp * cv.float()
    nll = -torch.log_softmax(logits, dim=-2) - torch.log_softmax(logits, dim=-1)
    return _masked_mean(nll, mnn)


def _gt_for_scale(batch: Mapping[str, Any], h: int, w: int, cfg: RobustLossConfig):
    return get_gt_warp(batch["im_A_depth"], batch["im_B_depth"], batch["T_1to2"],
                       batch["K1"], batch["K2"], H=h, W=w,
                       relative_depth_error_threshold=cfg.relative_depth_error_threshold)


def tiny_robust_loss(
    corresps: Mapping[int, Mapping[str, torch.Tensor]],
    batch: Mapping[str, Any],
    cfg: RobustLossConfig = RobustLossConfig(
        alpha={4: 0.15, 8: 0.15}, local_dist={4: 4}, epe_mask_prob_th=0.001
    ),
):
    """Tiny-RoMa training loss over {8: ..., 4: ...} corresps."""
    tot = 0.0
    metrics: dict[str, torch.Tensor] = {}
    for scale in sorted(corresps.keys(), reverse=True):
        sc = corresps[scale]
        flow, certainty = sc["flow"], sc["certainty"]
        b, h, w, _ = flow.shape
        gt_warp, prob = _gt_for_scale(batch, h, w, cfg)

        epe = torch.linalg.norm(flow - gt_warp, dim=-1)
        if scale in cfg.local_dist:
            prob = prob * (epe < (2 / 512) * cfg.local_dist[scale] * scale)
        gt_cert = prob
        if cfg.epe_mask_prob_th is not None:
            gt_cert = prob * (epe < scale * cfg.epe_mask_prob_th)

        ce, reg = regression_terms(cfg, gt_warp, prob, flow, certainty, scale, gt_cert)
        tot = tot + cfg.ce_weight * ce + reg
        metrics[f"certainty_loss_{scale}"] = ce
        metrics[f"regression_loss_{scale}"] = reg

        if "corr_volume" in sc:
            gt_bwd, _ = get_gt_warp(
                batch["im_B_depth"], batch["im_A_depth"], torch.linalg.inv(batch["T_1to2"]),
                batch["K2"], batch["K1"], H=h, W=w,
                relative_depth_error_threshold=cfg.relative_depth_error_threshold)
            nce = corr_volume_nll(cfg, sc["corr_volume"], gt_warp, gt_bwd, (h, w))
            tot = tot + cfg.corr_volume_weight * nce
            metrics[f"corr_volume_loss_{scale}"] = nce
    return tot, metrics


def robust_loss(
    corresps: Mapping[int, Mapping[str, torch.Tensor]],
    batch: Mapping[str, Any],
    cfg: RobustLossConfig = RobustLossConfig(
        alpha=0.5, c=1e-4, local_dist={1: 4, 2: 4, 4: 8, 8: 8}
    ),
):
    """Full-RoMa training loss over {16, 8, 4, 2, 1} corresps. The coarse
    scale carries `gm_cls` (B, H, W, cls_res^2) anchor logits and
    `gm_certainty`; finer scales regress. Hierarchical gate: at scales <=
    local_largest_scale, GT prob is zeroed where the previous (coarser)
    scale's EPE exceeded local_dist[scale] * scale * (2/512)."""
    tot = 0.0
    metrics: dict[str, torch.Tensor] = {}
    prev_epe = None
    for scale in sorted(corresps.keys(), reverse=True):
        sc = corresps[scale]
        flow, certainty = sc["flow"], sc["certainty"]
        b, h, w, _ = flow.shape
        gt_warp, prob = _gt_for_scale(batch, h, w, cfg)

        if cfg.local_largest_scale >= scale and prev_epe is not None:
            gate = interpolate_nearest(prev_epe[..., None], (h, w))[..., 0]
            prob = prob * (gate < (2 / 512) * cfg.local_dist[scale] * scale)

        if "gm_cls" in sc:
            gm_cls, gm_cert = sc["gm_cls"], sc["gm_certainty"]
            res = cfg.cls_res
            G = coord_grid(res, res, device=gm_cls.device).reshape(res * res, 2)
            # nearest-anchor GT label per pixel
            d = torch.linalg.norm(gt_warp[..., None, :] - G, dim=-1)
            gt_label = d.argmin(dim=-1)
            logp = torch.log_softmax(gm_cls.float(), dim=-1)
            ce_cls = -torch.gather(logp, -1, gt_label[..., None])[..., 0]
            cls_loss = _masked_mean(ce_cls, prob > 0.99)
            cert_loss = _bce_with_logits(gm_cert[..., 0], prob).mean()
            tot = tot + cfg.ce_weight * cert_loss + cls_loss
            metrics[f"gm_cls_loss_{scale}"] = cls_loss
            metrics[f"gm_certainty_loss_{scale}"] = cert_loss

        ce, reg = regression_terms(cfg, gt_warp, prob, flow, certainty, scale)
        tot = tot + cfg.ce_weight * ce + reg
        metrics[f"certainty_loss_{scale}"] = ce
        metrics[f"regression_loss_{scale}"] = reg

        prev_epe = torch.linalg.norm(flow - gt_warp, dim=-1).detach()
    return tot, metrics
