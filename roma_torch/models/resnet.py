"""ResNet-50 fine-feature pyramid, the counterpart of the JAX package's
``models/resnet.py``: {1: the input, 2: the 64-channel stem, 4: 256,
8: 512, 16: 1024, 32: 2048 channels}, with replace-stride-with-dilation
per stage (the nominal keys stay 4, 8, 16, 32 where a dilation replaces a
stride), `early_exit` after 1/8 (the later stages are still built, so that a
torchvision state_dict loads whole), and frozen BatchNorm: every BatchNorm
normalises with its running statistics in float32, whatever `train()` says,
and none is ever updated (the reference's ``freeze_bn``). The stem's max
pool is torch's ``MaxPool2d(3, 2, 1)``.

The modules carry torchvision's ``resnet50`` key names (``conv1``, ``bn1``,
``layerN.M.{conv1,bn1,conv2,bn2,conv3,bn3,downsample.0,downsample.1}``), so
a torchvision state_dict loads as the reference's ``encoders.py`` loads it;
`port.resnet_state_dict_from_jax` carries the JAX package's variables. As
the JAX package's, every block of a dilated stage (its first too) takes the
stage's dilation. No shipped RoMa configuration uses it (VGG19 is the fine
encoder everywhere).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from roma_torch.models.layers import batch_norm, conv2d

# (blocks, mid channels) per stage; a stage's output has 4 * mid channels
STAGES = [(3, 64), (4, 128), (6, 256), (3, 512)]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation) -> 1x1, each followed by BatchNorm, with
    a strided 1x1 + BatchNorm projection of the input in `downsample` for a
    stage's first block."""

    def __init__(self, in_c: int, mid: int, stride: int, dilation: int, project: bool):
        super().__init__()
        out = 4 * mid
        self.conv1 = nn.Conv2d(in_c, mid, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride=stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = nn.BatchNorm2d(mid)
        self.conv3 = nn.Conv2d(mid, out, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out)
        self.downsample = (nn.Sequential(nn.Conv2d(in_c, out, 1, stride=stride, bias=False),
                                         nn.BatchNorm2d(out)) if project else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        bn = lambda m, h: batch_norm(m, h).to(dt)  # noqa: E731
        h = torch.relu(bn(self.bn1, conv2d(self.conv1, x, dt)))
        h = torch.relu(bn(self.bn2, conv2d(self.conv2, h, dt)))
        h = bn(self.bn3, conv2d(self.conv3, h, dt))
        if self.downsample is not None:
            x = bn(self.downsample[1], conv2d(self.downsample[0], x, dt))
        return torch.relu(h + x)


class ResNet50(nn.Module):
    """`dilation`: replace-stride-with-dilation flags of the last three
    stages (the reference's default (False, False, False))."""

    def __init__(self, dilation: Sequence[bool] = (False, False, False),
                 early_exit: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.early_exit = early_exit
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        in_c, dil = 64, 1
        for i, (blocks, mid) in enumerate(STAGES):
            stride = 1 if i == 0 else 2
            if i > 0 and dilation[i - 1]:
                dil *= stride
                stride = 1
            layer = [Bottleneck(in_c if j == 0 else 4 * mid, mid, stride if j == 0 else 1, dil,
                                project=j == 0) for j in range(blocks)]
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
            in_c = 4 * mid

    def forward(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        """(B, 3, H, W) -> {scale: (B, C, H / scale, W / scale)}: scale 1 is
        the input as given, the others in self.dtype."""
        dt = self.dtype
        feats: dict[int, torch.Tensor] = {1: x}
        h = conv2d(self.conv1, x, dt)
        h = torch.relu(batch_norm(self.bn1, h)).to(dt)
        feats[2] = h
        h = F.max_pool2d(h, 3, 2, 1)
        for i in range(len(STAGES)):
            h = getattr(self, f"layer{i + 1}")(h)
            feats[4 * 2 ** i] = h
            if self.early_exit and i == 1:
                break
        return feats
