"""Bilinear sampling of channels-last feature maps at normalized coordinates.

Same contract as the JAX package's `ops/grid_sample.py::grid_sample`:
features ``(B, H, W, C)``, grid ``(B, ..., 2)`` of ``(x, y)`` in [-1, 1],
align_corners=False pixel mapping ``px = (x + 1) * W / 2 - 0.5``, and zeros
(out-of-range corners contribute 0) or border padding. PyTorch's own
`F.grid_sample` computes exactly that; sampling runs in float32 so the bf16
model path and the fp32 tests share one arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_nchw(
    feat: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros"
) -> torch.Tensor:
    """(B, C, H, W) sampled at (B, Ho, Wo, 2) -> (B, C, Ho, Wo), float32
    arithmetic, output in ``feat.dtype``."""
    out = F.grid_sample(
        feat.float(), grid.float(), mode="bilinear",
        padding_mode=padding_mode, align_corners=False,
    )
    return out.to(feat.dtype)


def grid_sample(
    feat: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros"
) -> torch.Tensor:
    """Bilinear sample `feat` (B,H,W,C) at `grid` (B,...,2) -> (B,...,C)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    B = feat.shape[0]
    batch_shape = grid.shape[1:-1]
    g = grid.reshape(B, -1, 1, 2)
    out = grid_sample_nchw(feat.permute(0, 3, 1, 2), g, padding_mode)
    return out[..., 0].permute(0, 2, 1).reshape(B, *batch_shape, feat.shape[-1])
