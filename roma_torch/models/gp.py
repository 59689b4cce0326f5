"""Gaussian-process coarse global matcher at 1/16: cosine kernel
K = exp((cos_sim - 1) / T), Fourier coordinate basis cos(8 pi conv1x1(coords)),
posterior mean mu = K_xy (K_yy + sigma I)^-1 f via a Cholesky solve.

All of it is float32: the package turns TF32 off, so the Gram matrices,
the factorisation and the solves keep full float32 precision on the GPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from roma_torch.ops.corr import coord_grid


def cos_kernel(x: torch.Tensor, y: torch.Tensor, T: float, eps: float = 1e-6) -> torch.Tensor:
    """(B, N, D), (B, M, D) -> (B, N, M): exp((cos_sim - 1)/T)."""
    c = torch.einsum("bnd,bmd->bnm", x, y)
    nx = torch.linalg.norm(x, dim=-1)[..., None]
    ny = torch.linalg.norm(y, dim=-1)[:, None, :]
    c = c / (nx * ny + eps)
    return torch.exp((c - 1.0) / T)


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve via Cholesky: A (B, N, N), b (B, N, D) -> (B, N, D)."""
    L = torch.linalg.cholesky(A)
    w = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.mT, w, upper=True)


class GP(nn.Module):
    def __init__(self, gp_dim: int = 512, T: float = 0.2, sigma_noise: float = 0.1,
                 basis_gain: float = 8.0 * math.pi):
        super().__init__()
        self.gp_dim = gp_dim
        self.T = T
        self.sigma_noise = sigma_noise
        self.basis_gain = basis_gain
        self.pos_conv = nn.Conv2d(2, gp_dim, 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y: (B, H, W, C) projected feats of A and B -> posterior mean
        (B, H, W, gp_dim) of B's embedded coordinates at A's features."""
        B, H, W, C = x.shape
        L = H * W
        coords = coord_grid(H, W, device=x.device).reshape(1, L, 2)
        w = self.pos_conv.weight[:, :, 0, 0].float()
        f = torch.cos(self.basis_gain * (coords @ w.T + self.pos_conv.bias.float()))
        f = f.expand(B, L, self.gp_dim)
        xf = x.reshape(B, L, C).float()
        yf = y.reshape(B, L, C).float()
        K_yy = cos_kernel(yf, yf, self.T)
        K_xy = cos_kernel(xf, yf, self.T)
        A = K_yy + self.sigma_noise * torch.eye(L, device=x.device, dtype=torch.float32)
        z = spd_solve(A, f)
        return (K_xy @ z).reshape(B, H, W, self.gp_dim)
