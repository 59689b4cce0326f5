"""Grids, coordinate conversions and classification-grid -> flow decoding.

Conventions: normalized image coords (x, y) in [-1, 1] with pixel centers at
+-(1 - 1/n); pixel coords x_px = (x + 1) * W / 2; flows channels-last.
"""

from __future__ import annotations

import numpy as np
import torch

from roma_torch.ops.corr import coord_grid


def get_grid(b: int, h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Normalized (x, y) coordinate grid, shape (b, h, w, 2)."""
    return coord_grid(h, w, device=device, dtype=dtype).expand(b, h, w, 2)


def normalized_to_pixel(coords, h: int, w: int):
    """[-1+1/n, 1-1/n] -> [0.5, n-0.5] pixel centers; numpy or torch."""
    xp = np if isinstance(coords, np.ndarray) else torch
    return xp.stack(
        (w * (coords[..., 0] + 1) / 2, h * (coords[..., 1] + 1) / 2), -1
    )


def _anchor_grid(res: int, device=None) -> torch.Tensor:
    """(res*res, 2) anchor coordinates, row-major over (y, x)."""
    lin = torch.linspace(-1 + 1 / res, 1 - 1 / res, res, device=device)
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(res * res, 2)


def cls_to_flow_refine(cls: torch.Tensor) -> torch.Tensor:
    """Sub-anchor refined decoding: softmax over the res^2 anchors, take the
    mode and its 4 neighbours (x-1, x+1, y-1, y+1 on the anchor grid) and
    return their probability-weighted mean coordinate.
    (B, H, W, C) -> (B, H, W, 2)."""
    C = cls.shape[-1]
    res = round(C**0.5)
    G = _anchor_grid(res, device=cls.device)
    p = torch.softmax(cls.float(), dim=-1)
    mode = torch.argmax(p, dim=-1)
    idx = torch.stack([mode - 1, mode, mode + 1, mode - res, mode + res], dim=-1)
    idx = idx.clamp(0, C - 1)
    neigh_p = torch.gather(p, -1, idx)
    neigh_c = G[idx]  # (..., 5, 2)
    flow = (neigh_p[..., None] * neigh_c).sum(dim=-2)
    return flow / neigh_p.sum(dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# depth-consistent GT warp (training supervision)
# ---------------------------------------------------------------------------

def warp_kpts(kpts0, depth0, depth1, T_0to1, K0, K1,
              relative_depth_error_threshold: float = 0.05):
    """Warp normalized kpts0 (N, L, 2) from image 0 to image 1 by depth and
    pose: bilinear depth lookup at the keypoint, unproject with K0, rigid
    transform by T_0to1 ((N, 4, 4) or (N, 3, 4)), project with K1, then
    keep (a) nonzero source depth, (b) in-bounds target, (c) relative depth
    consistency < threshold against a bilinear target-depth lookup.

    All of it is float32: the JAX package computes in float64 only when
    jax_enable_x64 is set, and in float32 otherwise (its tests' and its
    training's configuration), which is what this computes. Returns
    (valid (N, L) bool, warped kpts (N, L, 2) float32)."""
    from roma_torch.ops.grid_sample import grid_sample

    n, h, w = depth0.shape
    f32 = torch.float32
    kpts0 = kpts0.to(f32)
    kpts0_depth = grid_sample(depth0[..., None].to(f32), kpts0[:, :, None])[:, :, 0, 0]
    nonzero_mask = kpts0_depth != 0

    kpts0_px = torch.stack((w * (kpts0[..., 0] + 1) / 2, h * (kpts0[..., 1] + 1) / 2), -1)
    kpts0_h = torch.cat([kpts0_px, torch.ones_like(kpts0_px[..., :1])], -1) * kpts0_depth[..., None]
    # inv_ex: no error check, which would read the device (a host sync)
    kpts0_cam = torch.linalg.inv_ex(K0.to(f32))[0] @ kpts0_h.transpose(-1, -2)
    w_kpts0_cam = T_0to1[:, :3, :3].to(f32) @ kpts0_cam + T_0to1[:, :3, 3:4].to(f32)
    w_depth_computed = w_kpts0_cam[:, 2, :]

    w_kpts0_h = (K1.to(f32) @ w_kpts0_cam).transpose(-1, -2)  # (N, L, 3)
    w_kpts0_px = w_kpts0_h[..., :2] / (w_kpts0_h[..., 2:3] + 1e-4)

    h1, w1 = depth1.shape[1:3]
    covisible = ((w_kpts0_px[..., 0] > 0) & (w_kpts0_px[..., 0] < w1 - 1)
                 & (w_kpts0_px[..., 1] > 0) & (w_kpts0_px[..., 1] < h1 - 1))
    w_kpts0 = torch.stack((2 * w_kpts0_px[..., 0] / w1 - 1, 2 * w_kpts0_px[..., 1] / h1 - 1), -1)
    w_depth_sampled = grid_sample(depth1[..., None].to(f32), w_kpts0[:, :, None])[:, :, 0, 0]
    rel_err = ((w_depth_sampled - w_depth_computed) / w_depth_sampled).abs()
    consistent = rel_err < relative_depth_error_threshold
    return nonzero_mask & covisible & consistent, w_kpts0


def get_gt_warp(depth1, depth2, T_1to2, K1, K2, H: int, W: int,
                relative_depth_error_threshold: float = 0.05):
    """Dense GT warp + validity at (H, W): (x2 (B,H,W,2), prob (B,H,W)
    float32)."""
    B = depth1.shape[0]
    grid = get_grid(B, H, W, device=depth1.device).reshape(B, H * W, 2)
    mask, x2 = warp_kpts(grid, depth1, depth2, T_1to2, K1, K2,
                         relative_depth_error_threshold=relative_depth_error_threshold)
    return x2.reshape(B, H, W, 2), mask.float().reshape(B, H, W)


# ---------------------------------------------------------------------------
# pose errors + AUC (host-side, numpy)
# ---------------------------------------------------------------------------

def compute_relative_pose(R1, t1, R2, t2):
    """World-to-cam (R1, t1), (R2, t2) -> relative (R, t) taking cam1 to cam2."""
    R1, t1, R2, t2 = (np.asarray(a) for a in (R1, t1, R2, t2))
    rots = R2 @ R1.T
    trans = -rots @ t1 + t2
    return rots, trans


def angle_error_mat(R1, R2) -> float:
    cos = (np.trace(np.asarray(R1).T @ np.asarray(R2)) - 1) / 2
    return float(np.rad2deg(np.abs(np.arccos(np.clip(cos, -1.0, 1.0)))))


def angle_error_vec(v1, v2) -> float:
    v1, v2 = np.asarray(v1).ravel(), np.asarray(v2).ravel()
    n = np.linalg.norm(v1) * np.linalg.norm(v2)
    return float(np.rad2deg(np.arccos(np.clip(np.dot(v1, v2) / n, -1.0, 1.0))))


def compute_pose_error(T_0to1, R, t) -> tuple[float, float]:
    """Angular translation/rotation error vs a (3x4 | 4x4) GT relative pose."""
    T_0to1 = np.asarray(T_0to1)
    error_t = angle_error_vec(t, T_0to1[:3, 3])
    error_t = min(error_t, 180 - error_t)  # E-matrix sign ambiguity
    error_R = angle_error_mat(R, T_0to1[:3, :3])
    return error_t, error_R


def pose_auc(errors, thresholds) -> list[float]:
    """Trapezoid AUC of the recall-vs-error curve at each threshold (the
    reference's protocol for the Mega-1500 numbers)."""
    errors = np.sort(np.asarray(errors, dtype=np.float64))
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]
    aucs = []
    for t in thresholds:
        last_index = np.searchsorted(errors, t)
        r = np.r_[recall[:last_index], recall[last_index - 1]]
        e = np.r_[errors[:last_index], t]
        aucs.append(float(np.trapezoid(r, x=e) / t))
    return aucs


def signed_point_line_distance(point: torch.Tensor, line: torch.Tensor,
                               eps: float = 1e-9) -> torch.Tensor:
    """Signed distance from (*, N, 2|3) points to (*, N, 3) lines ax+by+c=0."""
    num = line[..., 0] * point[..., 0] + line[..., 1] * point[..., 1] + line[..., 2]
    den = torch.linalg.norm(line[..., :2], dim=-1)
    return num / (den + eps)


def signed_left_to_right_epipolar_distance(pts1: torch.Tensor, pts2: torch.Tensor,
                                           Fm: torch.Tensor) -> torch.Tensor:
    """Distance from right-image points to the epipolar lines of the
    corresponding left-image points."""
    if pts1.shape[-1] == 2:
        pts1 = torch.cat([pts1, torch.ones_like(pts1[..., :1])], dim=-1)
    line1_in_2 = pts1 @ Fm.transpose(-2, -1)
    return signed_point_line_distance(pts2, line1_in_2)
