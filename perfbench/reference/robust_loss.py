"""Full RoMa's training loss, plain PyTorch, as upstream's `RobustLosses`
(`romatch/losses/robust_loss.py`, arXiv:2305.15404) computes it from the
per-scale maps and the dataset contract (images, depths, T_1to2, K1, K2).

For each scale s from coarsest to finest, at the scale's (h, w):
- the ground-truth warp of A's pixel centres and its validity from depth
  and pose (`gt_warp`: bilinear depth lookup, unproject with K1, move by
  T_1to2, project with K2; valid where A's depth is nonzero, the target
  lies inside B (0 < x < w - 1, 0 < y < h - 1 in pixels) and B's depth
  there agrees within `relative_depth_error_threshold`);
- at s <= local_largest_scale, validity is kept only where the previous
  scale's end-point error (nearest-exact resize) is under
  local_dist[s] * s * 2 / 512;
- at the coarsest scale, the anchors' cross-entropy (label: the nearest of
  the cls_res^2 anchor centres to the GT warp) over valid pixels (prob >
  0.99) and the BCE of `gm_certainty` against validity;
- everywhere, the BCE of `certainty` against validity and the generalised
  Charbonnier cs^a ((epe / cs)^2 + 1)^(a / 2), cs = c * s, over valid
  pixels;
- total = sum over scales of ce_weight * (certainty BCEs) + the others.
Means over valid pixels divide by (count + 1e-8).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.common import grid
from perfbench.reference.roma import anchors


def _lookup(depth: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear depth at normalised (B, L, 2) points, zero outside."""
    return F.grid_sample(depth[:, None].float(), xy[:, :, None].float(), mode="bilinear",
                         padding_mode="zeros", align_corners=False)[:, 0, :, 0]


def gt_warp(batch: dict, h: int, w: int, thresh: float) -> tuple[torch.Tensor, torch.Tensor]:
    """A's (h, w) pixel centres warped into B, (B, h, w, 2) normalised, and
    their validity (B, h, w) as 0 / 1."""
    d1, d2 = batch["im_A_depth"].float(), batch["im_B_depth"].float()
    B, H1, W1 = d1.shape
    H2, W2 = d2.shape[1:]
    xy = grid(h, w, d1.device).reshape(1, h * w, 2).expand(B, -1, -1)
    z1 = _lookup(d1, xy)
    px = torch.stack([(xy[..., 0] + 1) * W1 / 2, (xy[..., 1] + 1) * H1 / 2, torch.ones_like(z1)], -1)
    cam1 = torch.linalg.inv(batch["K1"].float()) @ (px * z1[..., None]).transpose(1, 2)
    T = batch["T_1to2"].float()
    cam2 = T[:, :3, :3] @ cam1 + T[:, :3, 3:]
    proj = (batch["K2"].float() @ cam2).transpose(1, 2)
    px2 = proj[..., :2] / (proj[..., 2:] + 1e-4)
    inside = ((px2[..., 0] > 0) & (px2[..., 0] < W2 - 1)
              & (px2[..., 1] > 0) & (px2[..., 1] < H2 - 1))
    xy2 = torch.stack([2 * px2[..., 0] / W2 - 1, 2 * px2[..., 1] / H2 - 1], -1)
    z2 = _lookup(d2, xy2)
    consistent = ((z2 - cam2[:, 2]) / z2).abs() < thresh
    valid = (z1 != 0) & inside & consistent
    return xy2.reshape(B, h, w, 2), valid.float().reshape(B, h, w)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return (x * m).sum() / (m.sum() + 1e-8)


def robust_loss(corresps: dict, batch: dict, cfg: dict) -> tuple[torch.Tensor, dict]:
    """(total, {term: value}) with the terms named as the port's metrics
    name them: gm_cls_loss_16, gm_certainty_loss_16, certainty_loss_<s>,
    regression_loss_<s>. `cfg` is the configuration's "loss" entry."""
    a, c, ce_w = cfg["alpha"], cfg["c"], cfg["ce_weight"]
    local = {int(k): v for k, v in cfg["local_dist"].items()}
    total, terms, prev_epe = 0.0, {}, None
    for s in sorted(corresps, reverse=True):
        out = corresps[s]
        flow, cert = out["flow"], out["certainty"]
        _, h, w, _ = flow.shape
        gt, prob = gt_warp(batch, h, w, cfg["relative_depth_error_threshold"])
        if prev_epe is not None and s <= cfg["local_largest_scale"]:
            near = F.interpolate(prev_epe[:, None], size=(h, w), mode="nearest-exact")[:, 0]
            prob = prob * (near < (2 / 512) * local[s] * s)
        if "gm_cls" in out:
            cls = out["gm_cls"].float()
            res = round(cls.shape[-1] ** 0.5)
            label = torch.cdist(gt.reshape(gt.shape[0], -1, 2), anchors(res, cls.device)[None],
                                compute_mode="donot_use_mm_for_euclid_dist")
            label = label.argmin(-1).reshape(prob.shape)
            ce = F.cross_entropy(cls.permute(0, 3, 1, 2), label, reduction="none")
            terms[f"gm_cls_loss_{s}"] = _masked_mean(ce, prob > 0.99)
            terms[f"gm_certainty_loss_{s}"] = F.binary_cross_entropy_with_logits(
                out["gm_certainty"][..., 0].float(), prob)
            total = total + ce_w * terms[f"gm_certainty_loss_{s}"] + terms[f"gm_cls_loss_{s}"]
        epe = (flow - gt).norm(dim=-1)
        cs = c * s
        reg = cs ** a * ((epe / cs) ** 2 + 1) ** (a / 2)
        terms[f"certainty_loss_{s}"] = F.binary_cross_entropy_with_logits(cert[..., 0].float(), prob)
        terms[f"regression_loss_{s}"] = _masked_mean(reg, prob > 0.99)
        total = total + ce_w * terms[f"certainty_loss_{s}"] + terms[f"regression_loss_{s}"]
        prev_epe = epe.detach()
    return total, terms
