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
