"""Shared layer helpers.

Parameters are stored in float32 (the checkpoint layout); each layer casts
its weights to the compute dtype at call time, as the JAX package's
``param_dtype=float32, dtype=bf16`` layers do. Normalisations run in
float32.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Apply `conv` (NCHW) with input, weight and bias in `dtype`."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


def linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm (running statistics) in float32, NCHW."""
    return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in float32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


class ConvBlock(nn.Module):
    """The reference XFeat `BasicLayer`: conv (torch padding k//2, stride, no
    bias) -> BatchNorm2d(affine=False) -> ReLU, NCHW. The conv runs in the
    compute dtype, BatchNorm and ReLU in float32, and the output returns in
    the compute dtype, as the JAX package's `ConvBlock` does."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.layer = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                      padding=kernel_size // 2, bias=False),
            nn.BatchNorm2d(out_channels, affine=False),
            nn.ReLU(inplace=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(self.layer[0], x, self.dtype)
        return torch.relu(batch_norm(self.layer[1], y)).to(self.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over (H, W) of an NCHW tensor:
    torch InstanceNorm2d with affine=False (biased variance)."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)
