"""XFeat CNN trunk (the Tiny RoMa backbone), NCHW.

Architecture per "XFeat: Accelerated Features for Lightweight Image
Matching" (CVPR'24), as Tiny RoMa consumes it: blocks 1-5, skip1 and
block_fusion, without the detection and matching heads. Channel plan:

  input: grayscale mean -> InstanceNorm
  block1: 1->4->8->8->24 (strides 1,2,1,2)            -> 1/4
  skip1:  AvgPool(4,4) + 1x1 conv 1->24               -> 1/4
  block2: 24->24->24                                  -> 1/4   (fine feats)
  block3: 24->64(s2)->64->64(1x1)                     -> 1/8
  block4: 64->64(s2)->64->64                          -> 1/16
  block5: 64->128(s2)->128->128->64(1x1)              -> 1/32
  fusion: bilinear-up block4/5 to 1/8, sum with block3,
          64->64->64(1x1 plain conv)                  -> 1/8   (coarse feats)

In train mode every ConvBlock normalises with batch statistics; the two
images of a pair go through as one batch, so the statistics cover both,
as in the JAX package.

Module names are the reference XFeat's (``block1.{i}.layer.{0,1}``,
``skip1.1``, ``block_fusion.{0,1,2}``), so its state_dict keys line up.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from roma_torch.models.layers import ConvBlock, conv2d, instance_norm
from roma_torch.ops.resize import interpolate_bilinear


class XFeatBackbone(nn.Module):
    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cb = lambda i, o, k=3, s=1: ConvBlock(i, o, k, s, dtype=dtype)
        self.block1 = nn.Sequential(cb(1, 4), cb(4, 8, s=2), cb(8, 8), cb(8, 24, s=2))
        self.skip1 = nn.Sequential(nn.AvgPool2d(4, stride=4), nn.Conv2d(1, 24, 1))
        self.block2 = nn.Sequential(cb(24, 24), cb(24, 24))
        self.block3 = nn.Sequential(cb(24, 64, s=2), cb(64, 64), cb(64, 64, k=1))
        self.block4 = nn.Sequential(cb(64, 64, s=2), cb(64, 64), cb(64, 64))
        self.block5 = nn.Sequential(cb(64, 128, s=2), cb(128, 128), cb(128, 128),
                                    cb(128, 64, k=1))
        self.block_fusion = nn.Sequential(cb(64, 64), cb(64, 64), nn.Conv2d(64, 64, 1))
        self.train(False)  # eval until model.train(), as JAX's train=False default

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(B, C, H, W) image in [0, 1] -> (fine (B, 24, H/4, W/4),
        coarse (B, 64, H/8, W/8)), both in the compute dtype."""
        dt = self.dtype
        x = instance_norm(x.float().mean(dim=1, keepdim=True)).to(dt)
        x1 = self.block1(x)
        skip = conv2d(self.skip1[1], self.skip1[0](x), dt)
        x2 = self.block2(x1 + skip)
        x3 = self.block3(x2)
        x4 = self.block4(x3)
        x5 = self.block5(x4)
        h8, w8 = x3.shape[-2:]
        up = lambda t: interpolate_bilinear(t.float().permute(0, 2, 3, 1), (h8, w8)).permute(
            0, 3, 1, 2).to(dt)
        f = self.block_fusion[1](self.block_fusion[0](x3 + up(x4) + up(x5)))
        return x2, conv2d(self.block_fusion[2], f, dt)
