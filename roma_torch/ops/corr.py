"""Normalized coordinate grids, the global correlation volume and the
softmax-expectation ("pos_embed") warps of Tiny RoMa's coarse matcher.

Layouts as in the JAX package's `ops/corr.py`: features channels-last
``(B, H, W, C)``, the volume target-major ``(B, H0*W0, H1*W1)`` with the
softmax axis last, warps ``(B, L0, 2)`` in normalized coordinates. The
streaming version that never builds the volume is the correlation-softmax
kernel (`roma_torch.kernels.corr_softmax`).
"""

from __future__ import annotations

import math

import torch


def coord_grid(h: int, w: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Normalized (x, y) grid with centers at +-(1 - 1/n). Shape (h, w, 2)."""
    xs = torch.linspace(-1 + 1 / w, 1 - 1 / w, w, device=device, dtype=dtype)
    ys = torch.linspace(-1 + 1 / h, 1 - 1 / h, h, device=device, dtype=dtype)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)


def corr_volume(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """All-pairs correlation (B,H0,W0,C), (B,H1,W1,C) -> (B, H0*W0, H1*W1)
    float32: ``cv[b, i, j] = <f0[b, i], f1[b, j]> / sqrt(C)``."""
    B, H0, W0, C = f0.shape
    a = f0.reshape(B, H0 * W0, C).float()
    b = f1.reshape(B, -1, C).float()
    return torch.bmm(a, b.transpose(1, 2)) / math.sqrt(C)


def pos_embed_expectation(cv: torch.Tensor, src_hw: tuple[int, int]) -> torch.Tensor:
    """Exact softmax over all source positions, then the probability-weighted
    mean of the source grid: (B, L0, L1) -> (B, L0, 2)."""
    h1, w1 = src_hw
    grid = coord_grid(h1, w1, device=cv.device).reshape(h1 * w1, 2)
    return torch.softmax(cv.float(), dim=-1) @ grid


def pos_embed_fast(cv: torch.Tensor, src_hw: tuple[int, int], down: int = 4,
                   faithful: bool = False) -> torch.Tensor:
    """Strided low-res softmax plus one argmax channel (B, L0, 2): the
    reference inference shortcut. `faithful=True` keeps its two quirks (the
    argmax *index* as that channel's logit, and the low-res grid
    ``linspace(-1 + down/n, 1 - down/n, n // down)``); the default uses the
    max correlation value and the true strided coordinates."""
    h1, w1 = src_hw
    dev = cv.device
    grid = coord_grid(h1, w1, device=dev).reshape(h1 * w1, 2)
    if faithful:
        xs = torch.linspace(-1 + down / w1, 1 - down / w1, w1 // down, device=dev)
        ys = torch.linspace(-1 + down / h1, 1 - down / h1, h1 // down, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        grid_lr = torch.stack([gx, gy], -1).reshape(-1, 2)
    else:
        grid_lr = coord_grid(h1, w1, device=dev)[::down, ::down].reshape(-1, 2)
    idx = (torch.arange(0, h1, down, device=dev)[:, None] * w1
           + torch.arange(0, w1, down, device=dev)[None, :]).reshape(-1)
    cv32 = cv.float()
    cv_lr = cv32[:, :, idx]
    best = torch.argmax(cv32, dim=-1)
    extra = best.float() if faithful else cv32.max(dim=-1).values
    p = torch.softmax(torch.cat([cv_lr, extra[..., None]], dim=-1), dim=-1)
    return p[..., :-1] @ grid_lr + p[..., -1:] * grid[best]


def pos_embed_warp(f0: torch.Tensor, f1: torch.Tensor, exact: bool = True) -> torch.Tensor:
    """Features -> dense coarse warp (B, H0, W0, 2)."""
    B, H0, W0, _ = f0.shape
    _, H1, W1, _ = f1.shape
    fn = pos_embed_expectation if exact else pos_embed_fast
    return fn(corr_volume(f0, f1), (H1, W1)).reshape(B, H0, W0, 2)
