"""Search-space-restricted correlation warps: vertical search limited to
+-radius rows (`banded_pos_embed`) or to the same row (`row_pos_embed`),
for roughly rectified pairs. Same functions as the JAX package's
`ops/band_corr.py`; features (B, H, W, C), warps (B, H, W, 2)."""

from __future__ import annotations

import math

import torch


def _axes(H: int, W: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    xs = torch.linspace(-1 + 1 / W, 1 - 1 / W, W, device=device)
    ys = torch.linspace(-1 + 1 / H, 1 - 1 / H, H, device=device)
    return xs, ys


def banded_pos_embed(f0: torch.Tensor, f1: torch.Tensor, radius: int) -> torch.Tensor:
    """Softmax-expectation warp over source rows [h - radius, h + radius]."""
    B, H, W, C = f0.shape
    dev = f0.device
    dys = range(-radius, radius + 1)
    # band slot dy holds source row h + dy (rolled; rows outside are masked)
    f1_band = torch.stack([torch.roll(f1, shifts=-dy, dims=1) for dy in dys], dim=2)
    rows = torch.arange(H, device=dev)[:, None] + torch.tensor(list(dys), device=dev)[None]
    valid = (rows >= 0) & (rows < H)                       # (H, k)
    s = torch.einsum("bhwc,bhkvc->bhwkv", f0.float(), f1_band.float()) / math.sqrt(C)
    s = s.masked_fill(~valid[None, :, None, :, None], float("-inf"))
    k = 2 * radius + 1
    p = torch.softmax(s.reshape(B, H, W, k * W), dim=-1).reshape(B, H, W, k, W)
    xs, ys = _axes(H, W, dev)
    ex = torch.einsum("bhwkv,v->bhw", p, xs)
    band_y = ys[:, None] + torch.arange(-radius, radius + 1, device=dev)[None] * (2 / H)
    ey = torch.einsum("bhwk,hk->bhw", p.sum(-1), band_y)
    return torch.stack([ex, ey], dim=-1)


def row_pos_embed(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """Row-only matching: each target row against its own source row."""
    B, H, W, C = f0.shape
    s = torch.einsum("bhwc,bhvc->bhwv", f0.float(), f1.float()) / math.sqrt(C)
    p = torch.softmax(s, dim=-1)
    xs, ys = _axes(H, W, f0.device)
    ex = torch.einsum("bhwv,v->bhw", p, xs)
    ey = ys[None, :, None].expand(B, H, W)
    return torch.stack([ex, ey], dim=-1)
