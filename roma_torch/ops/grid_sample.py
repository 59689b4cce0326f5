"""Bilinear and nearest sampling of channels-last feature maps at normalized
coordinates.

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


def grid_sample_nearest(
    feat: torch.Tensor, grid: torch.Tensor, padding_mode: str = "zeros"
) -> torch.Tensor:
    """Nearest-neighbour sample `feat` (B,H,W,C) at `grid` (B,...,2) ->
    (B,...,C) in feat's dtype: the pixel ``floor(px + 0.5)`` of the
    align_corners=False coordinate ``px = (x + 1) * W / 2 - 0.5``, a half-pixel
    tie going up, as the JAX package's function rounds (``F.grid_sample``'s
    nearest mode rounds ties to even), read clamped to the map and zeroed
    outside it under "zeros" padding."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    B, H, W, C = feat.shape
    batch_shape = grid.shape[1:-1]
    g = grid.reshape(B, -1, 2).float()
    px = (g[..., 0] + 1.0) * (W / 2) - 0.5
    py = (g[..., 1] + 1.0) * (H / 2) - 0.5
    xi = torch.floor(px + 0.5).long()
    yi = torch.floor(py + 0.5).long()
    idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    out = torch.gather(feat.reshape(B, H * W, C), 1, idx[..., None].expand(-1, -1, C))
    if padding_mode == "zeros":
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = out * valid[..., None].to(out.dtype)
    return out.reshape(B, *batch_shape, C)
