"""Shared layer helpers.

Parameters are stored in float32 (the checkpoint layout); each layer casts
its weights to the compute dtype at call time, as the JAX package's
``param_dtype=float32, dtype=bf16`` layers do. Normalisations run in
float32.

Training BatchNorm (`batch_norm_train`) follows the JAX package's two
conventions, neither of which is ``F.batch_norm(training=True)``'s: both
normalise with the biased batch variance E[x^2] - E[x]^2; flax's
``nn.BatchNorm(momentum=0.9)`` (VGG, the decoder's projections) tracks the
biased variance, the refiner's `DWBlock` (momentum 0.99) the unbiased one,
and both move a statistic as ``m * old + (1 - m) * batch``. Under
activation checkpointing the forward runs twice; `checkpoint` freezes the
running statistics during the recompute, so that one step moves each
statistic once, as flax's remat does. Under a data-parallel group
(`roma_torch.parallel.mesh.data_parallel`) the batch statistics are the
global batch's, as in the JAX package's sharded step; a checkpoint's
recompute enters the group its forward saw, so both passes see the same
statistics.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from roma_torch.parallel.mesh import active_group, all_reduce_sum, data_parallel


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


_STATS = threading.local()  # .frozen: a checkpoint's recompute is running


@contextlib.contextmanager
def frozen_stats():
    """Running statistics are not moved inside (a checkpoint's recompute)."""
    prev = getattr(_STATS, "frozen", False)
    _STATS.frozen = True
    try:
        yield
    finally:
        _STATS.frozen = prev


def batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor, momentum: float,
                     unbiased_running_var: bool) -> torch.Tensor:
    """Training BatchNorm in float32, NCHW: normalise with the batch mean and
    the biased batch variance max(E[x^2] - E[x]^2, 0) (the flax and DWBlock
    formulas agree but for the clip, which only a negative rounding can
    reach), then move the running statistics as ``momentum * old +
    (1 - momentum) * batch``, the variance Bessel-corrected (n / (n - 1))
    when `unbiased_running_var`; not inside `frozen_stats`. `momentum` is
    the JAX package's (flax) convention: torch's is 1 - momentum. The sums
    and the count are all-reduced (differentiably) under an active
    data-parallel group, so every rank uses the global batch's statistics."""
    y = x.float()
    axes = (0, 2, 3)
    C = y.shape[1]
    sums = torch.cat([y.sum(axes), (y * y).sum(axes),
                      y.new_full((1,), float(y.numel() // C))])
    group = active_group()
    if group is not None:
        sums = all_reduce_sum(sums, group)
    n = sums[2 * C]
    mean = sums[:C] / n
    var = (sums[C:2 * C] / n - mean * mean).clamp(min=0.0)
    if not getattr(_STATS, "frozen", False):
        with torch.no_grad():
            tracked = var * (n / (n - 1).clamp(min=1)) if unbiased_running_var else var
            bn.running_mean.copy_(momentum * bn.running_mean + (1 - momentum) * mean)
            bn.running_var.copy_(momentum * bn.running_var + (1 - momentum) * tracked)
    inv = torch.rsqrt(var + bn.eps)
    if bn.weight is not None:
        inv = inv * bn.weight
    out = (y - mean[:, None, None]) * inv[:, None, None]
    return out if bn.bias is None else out + bn.bias[:, None, None]


@contextlib.contextmanager
def _recompute(group):
    with frozen_stats(), data_parallel(group):
        yield


def checkpoint(fn, *args):
    """`fn(*args)` with its activations recomputed in backward
    (torch.utils.checkpoint, non-reentrant), the recompute inside
    `frozen_stats` (the running statistics move once, in the forward) and
    inside the data-parallel group of the forward (the backward may run on
    another thread)."""
    group = active_group()
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _recompute(group)))


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the last axis in float32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)


# the standard deviation of a unit normal truncated to [-2, 2]
# (jax.nn.initializers.variance_scaling's correction)
TRUNC_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def flax_init_(module: nn.Module) -> nn.Module:
    """Initialise every Conv2d and Linear in `module` as flax's ``nn.Conv``
    and ``nn.Dense`` defaults initialise the JAX package's layers: weights
    from ``lecun_normal`` (a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in) and zero biases, drawn from the global
    torch generator. `build_model` applies it to Tiny RoMa (ROADMAP C9:
    from PyTorch's default, kaiming-uniform with a = sqrt(5), variance
    1 / (3 fan_in) and uniform biases, Tiny RoMa trains more slowly)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / TRUNC_NORMAL_STD
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std, b=2.0 * std)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module


class ConvBlock(nn.Module):
    """The reference XFeat `BasicLayer`: conv (torch padding k//2, stride, no
    bias) -> BatchNorm2d(affine=False) -> ReLU, NCHW. The conv runs in the
    compute dtype, BatchNorm and ReLU in float32, and the output returns in
    the compute dtype, as the JAX package's `ConvBlock` does. In train mode
    BatchNorm takes the batch statistics (flax's momentum 0.9, biased
    variance tracked), as the JAX `ConvBlock` with `train=True`."""

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
        self.train(False)  # eval until model.train(), as JAX's train=False default

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv2d(self.layer[0], x, self.dtype)
        bn = self.layer[1]
        y = batch_norm_train(bn, y, 0.9, False) if self.training else batch_norm(bn, y)
        return torch.relu(y).to(self.dtype)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalisation over (H, W) of an NCHW tensor:
    torch InstanceNorm2d with affine=False (biased variance)."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps)
