"""Gaussian kernel density estimate over match coordinates, in row tiles so
peak memory is O(tile * N) rather than O(N^2)."""

from __future__ import annotations

import torch


def kde(x: torch.Tensor, std: float = 0.1, tile: int = 2048) -> torch.Tensor:
    """Density at each row of x (N, D): sum_j exp(-||x_i - x_j||^2 / (2 std^2))."""
    x = x.float()
    inv = 1.0 / (2.0 * std * std)
    sq = (x * x).sum(-1)
    out = []
    for i in range(0, x.shape[0], tile):
        xr = x[i:i + tile]
        d2 = sq[i:i + tile, None] + sq[None, :] - 2.0 * (xr @ x.T)
        out.append(torch.exp(-d2.clamp_min(0.0) * inv).sum(-1))
    return torch.cat(out)
