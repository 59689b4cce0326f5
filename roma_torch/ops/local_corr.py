"""Local-window correlation around a dense warp: the plain PyTorch version of
the local-correlation kernel (`roma_torch/kernels/local_corr.py`).

For every pixel p of f0, with (x0, y0) the integer corner below the flow
target in f1's pixel grid and (wx, wy) its fractional part:

  g[dy, dx]     = <f0s(p), f1(y0 - r + dy, x0 - r + dx)>,  dy, dx in [0, 2r+2)
  corr[dy, dx]  = w00 g[dy, dx] + w01 g[dy, dx+1]
                + w10 g[dy+1, dx] + w11 g[dy+1, dx+1],     dy, dx in [0, 2r+1)

with f0s = f0 / sqrt(C) rounded to f0's dtype and f1 read as zero outside
the image. The window offsets are whole pixels, so the (2r+1)^2 bilinear
samples share one set of weights and only (2r+2)^2 corner dots are needed.
Same contract as the JAX package's `ops/local_corr.py::local_correlation`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from roma_torch.ops.corr import coord_grid


def corner_coords(flow: torch.Tensor, H: int, W: int, radius: int):
    """Integer corner (x0, y0) and fractional weights (wx, wy) of a
    (B,H,W,2) flow, float32 arithmetic. Far out-of-range corners are
    clamped to stay out of range, so the int conversion cannot wrap."""
    gx = (flow[..., 0].float() + 1.0) * (W / 2) - 0.5
    gy = (flow[..., 1].float() + 1.0) * (H / 2) - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = gx - x0
    wy = gy - y0
    lim = 2 * radius + 4
    x0i = x0.clamp(-lim, W + lim).long()
    y0i = y0.clamp(-lim, H + lim).long()
    return x0i, y0i, wx, wy


def prescale(f0: torch.Tensor) -> torch.Tensor:
    """f0 / sqrt(C) in float32, rounded back to f0's dtype."""
    C = f0.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(C), dtype=torch.float32))
    return (f0.float() * scale.to(f0.device)).to(f0.dtype)


def local_correlation(
    f0: torch.Tensor,
    f1: torch.Tensor,
    radius: int,
    flow: torch.Tensor | None = None,
) -> torch.Tensor:
    """(B,H,W,C) x (B,H,W,C) -> (B,H,W,(2r+1)^2) float32 local cost volume,
    row-major over (dy, dx); ``flow`` (B,H,W,2) normalized, identity if None."""
    B, H, W, C = f0.shape
    r = radius
    k = 2 * r + 1
    K2 = 2 * r + 2
    if flow is None:
        flow = coord_grid(H, W, device=f0.device).expand(B, H, W, 2)
    x0i, y0i, wx, wy = corner_coords(flow, H, W, r)
    f0s = prescale(f0).float()
    # one zero pixel around f1: every clamped corner index lands on it
    f1p = F.pad(f1, (0, 0, 1, 1, 1, 1))
    bidx = torch.arange(B, device=f0.device)[:, None, None]
    # a row of 2r+2 corners at a time, their dots one batched matrix
    # product a pixel (as FlopCounterMode counts the kernel: 2 (2r+2)^2 C)
    xi = torch.stack([(x0i - r + dx).clamp(-1, W) + 1 for dx in range(K2)], -1)
    rows = []
    for dy in range(K2):
        yi = (y0i - r + dy).clamp(-1, H) + 1
        vals = f1p[bidx[..., None], yi[..., None], xi].float()  # (B, H, W, 2r+2, C)
        rows.append(torch.matmul(vals, f0s[..., None])[..., 0])
    g = torch.stack(rows, -2)
    wx = wx[..., None, None]
    wy = wy[..., None, None]
    w00 = (1 - wy) * (1 - wx)
    w01 = (1 - wy) * wx
    w10 = wy * (1 - wx)
    w11 = wy * wx
    corr = (
        w00 * g[..., :k, :k] + w01 * g[..., :k, 1:]
        + w10 * g[..., 1:, :k] + w11 * g[..., 1:, 1:]
    )
    return corr.reshape(B, H, W, k * k)
