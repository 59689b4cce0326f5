"""Matcher API utilities shared by full RoMa and Tiny RoMa: keypoint
matching through a dense warp, forward-backward consistency, warp
visualization. Channels-last at the public functions, as in the JAX
package's `models/api.py`; the reference RegressionMatcher's
`match_keypoints`, `conf_from_fb_consistency` and `visualize_warp`."""

from __future__ import annotations

import math

import numpy as np
import torch

from roma_torch.ops.corr import coord_grid
from roma_torch.ops.grid_sample import grid_sample


def match_keypoints(x_a: torch.Tensor, x_b: torch.Tensor, warp: torch.Tensor,
                    certainty: torch.Tensor, sample_thresh: float = 0.05,
                    max_dist: float = math.inf):
    """Match two sparse keypoint sets through a dense warp.

    x_a (N, 2), x_b (M, 2) normalized coordinates; warp (H, W, 4) one-sided
    (A side: pass the left half of a symmetric warp); certainty (H, W).
    Returns (inds_a, inds_b, valid): for every keypoint of A the index of its
    mutual nearest neighbour in B and whether that pair is mutual, above the
    certainty threshold and within `max_dist`. Fixed shapes (N,) with a
    validity mask, as the JAX function returns them."""
    a_to_b = grid_sample(warp[None, :, :, 2:], x_a[None, :, None, :])[0, :, 0]
    cert_a = grid_sample(certainty[None, :, :, None], x_a[None, :, None, :])[0, :, 0, 0]
    D = torch.linalg.norm(a_to_b[:, None, :] - x_b[None, :, :], dim=-1)
    row_min = D == D.min(dim=1, keepdim=True).values
    col_min = D == D.min(dim=0, keepdim=True).values
    mutual = row_min & col_min & (cert_a[:, None] > sample_thresh) & (D < max_dist)
    inds_b = torch.argmax(mutual.to(torch.uint8), dim=1)  # the first mutual match
    valid = mutual.any(dim=1)
    inds_a = torch.arange(x_a.shape[0], device=x_a.device)
    return inds_a, inds_b, valid


def conf_from_fb_consistency(flow_forward: torch.Tensor, flow_backward: torch.Tensor,
                             th: float = 2.0) -> torch.Tensor:
    """1.0 where warping forward then backward returns within `th` pixels
    (of the larger side), else 0.0. flow_*: (H, W, 2) or (B, H, W, 2)
    normalized target coordinates."""
    batched = flow_forward.ndim == 4
    if not batched:
        flow_forward, flow_backward = flow_forward[None], flow_backward[None]
    B, H, W, _ = flow_forward.shape
    th_n = 2 * th / max(H, W)
    coords = coord_grid(H, W, device=flow_forward.device).expand(B, H, W, 2)
    coords_fb = grid_sample(flow_backward, flow_forward)
    diff = torch.linalg.norm(coords - coords_fb, dim=-1)
    in_th = (diff < th_n).float()
    return in_th if batched else in_th[0]


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _pil_bilinear(im: np.ndarray, h: int, w: int) -> np.ndarray:
    from PIL import Image

    u8 = (np.clip(im, 0, 1) * 255).astype(np.uint8)
    return np.asarray(Image.fromarray(u8).resize((w, h), Image.BILINEAR), np.float32) / 255.0


def visualize_warp(warp, certainty, im_a: np.ndarray, im_b: np.ndarray,
                   symmetric: bool = True, save_path: str | None = None) -> np.ndarray:
    """Render B warped into A's frame (and A into B's for a symmetric warp),
    blended toward white where the certainty is low. warp (H, W', 4) and
    certainty (H, W') as tensors or arrays, images (H, W, 3) in [0, 1];
    returns an (H, W', 3) float array at the warp's resolution and writes
    it as a PNG to `save_path` when given."""
    warp = torch.from_numpy(_host(warp).astype(np.float32))
    certainty = _host(certainty)
    H, W2, _ = warp.shape
    W = W2 // 2 if symmetric else W2
    x_b = torch.from_numpy(_pil_bilinear(im_b, H, W))
    warp_im = grid_sample(x_b[None], warp[None, :, :W, 2:])[0].numpy()
    if symmetric:
        x_a = torch.from_numpy(_pil_bilinear(im_a, H, W))
        b_transfer = grid_sample(x_a[None], warp[None, :, W:, :2])[0].numpy()
        warp_im = np.concatenate([warp_im, b_transfer], axis=1)
    c = certainty[..., None]
    vis = c * warp_im + (1 - c) * np.ones_like(warp_im)
    if save_path is not None:
        from PIL import Image

        Image.fromarray((np.clip(vis, 0, 1) * 255).astype(np.uint8)).save(save_path)
    return vis
