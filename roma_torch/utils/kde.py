"""Gaussian kernel density estimate over match coordinates, through the
operator ``roma::kde`` (`kernels/kde.py`): on CUDA tensors one streaming
kernel that keeps no distance tile, on CPU tensors the plain version in row
tiles, so peak memory is O(tile * N) rather than O(N^2)."""

from __future__ import annotations

import torch

from roma_torch.kernels import kde as kde_kernel
from roma_torch.kernels import runtime


def kde(x: torch.Tensor, std: float = 0.1, tile: int = 2048) -> torch.Tensor:
    """Density at each row of x (N, D): sum_j exp(-||x_i - x_j||^2 / (2 std^2)).
    Through the operator: a CUDA tensor launches the kernel (float32,
    D <= 4; anything else raises), a CPU tensor takes the plain version.
    Differentiable through the plain version."""
    return runtime.with_plain_backward(lambda t: kde_kernel.op(t, std, tile),
                                       lambda t: kde_kernel.kde_plain(t, std, tile), x)
