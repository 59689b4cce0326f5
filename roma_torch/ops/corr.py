"""Normalized coordinate grids."""

from __future__ import annotations

import torch


def coord_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Normalized (x, y) grid with centers at +-(1 - 1/n). Shape (h, w, 2)."""
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, device=device, dtype=dtype)
    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, device=device, dtype=dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)
