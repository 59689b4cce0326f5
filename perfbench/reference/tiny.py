"""Tiny RoMa v1 (upstream `romatch/models/tiny.py`, `tiny_roma_v1_outdoor`),
plain PyTorch: the XFeat trunk, the exact softmax expectation over the
global correlation at 1/8, the coarse matcher, and the dense warp and
certainty that `match` returns (from the 1/8 result, as upstream). The fine
matcher's output never reaches them, so it is not run here.

Modules carry the upstream state-dict names (``xfeat.0.block1.{i}.layer``,
``coarse_matcher.{i}``, ``fine_matcher.{i}``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.common import Precision, bilinear, grid, sample


class ConvBlock(nn.Module):
    """conv (no bias, padding k // 2) -> BatchNorm (no affine) -> ReLU."""

    def __init__(self, c_in: int, c_out: int, k: int = 3, stride: int = 1):
        super().__init__()
        self.layer = nn.Sequential(nn.Conv2d(c_in, c_out, k, stride, k // 2, bias=False),
                                   nn.BatchNorm2d(c_out, affine=False), nn.ReLU())

    def forward(self, prec: Precision, x: torch.Tensor) -> torch.Tensor:
        bn = self.layer[1]
        y = prec.conv(x, self.layer[0])
        return torch.relu(F.batch_norm(y, bn.running_mean, bn.running_var, None, None,
                                       False, 0.0, bn.eps))


def run(prec: Precision, seq, x: torch.Tensor) -> torch.Tensor:
    for m in seq:
        x = m(prec, x)
    return x


class XFeat(nn.Module):
    def __init__(self):
        super().__init__()
        cb = ConvBlock
        self.block1 = nn.Sequential(cb(1, 4), cb(4, 8, stride=2), cb(8, 8), cb(8, 24, stride=2))
        self.skip1 = nn.Sequential(nn.AvgPool2d(4, 4), nn.Conv2d(1, 24, 1))
        self.block2 = nn.Sequential(cb(24, 24), cb(24, 24))
        self.block3 = nn.Sequential(cb(24, 64, stride=2), cb(64, 64), cb(64, 64, k=1))
        self.block4 = nn.Sequential(cb(64, 64, stride=2), cb(64, 64), cb(64, 64))
        self.block5 = nn.Sequential(cb(64, 128, stride=2), cb(128, 128), cb(128, 128),
                                    cb(128, 64, k=1))
        self.block_fusion = nn.Sequential(cb(64, 64), cb(64, 64), nn.Conv2d(64, 64, 1))

    def forward(self, prec: Precision, x: torch.Tensor):
        """(B, 3, H, W) in [0, 1] -> fine (B, 24, H/4, W/4), coarse (B, 64, H/8, W/8)."""
        x = x.mean(1, keepdim=True)
        x = (x - x.mean((2, 3), keepdim=True)) / torch.sqrt(
            x.var((2, 3), keepdim=True, unbiased=False) + 1e-5)
        x2 = run(prec, self.block2, run(prec, self.block1, x)
                 + prec.conv(F.avg_pool2d(x, 4, 4), self.skip1[1]))
        x3 = run(prec, self.block3, x2)
        x4 = run(prec, self.block4, x3)
        x5 = run(prec, self.block5, x4)
        size = x3.shape[-2:]
        up = lambda t: F.interpolate(t, size=size, mode="bilinear", align_corners=False)  # noqa: E731
        f = run(prec, self.block_fusion[:2], x3 + up(x4) + up(x5))
        return x2, prec.conv(f, self.block_fusion[2])


class Matcher(nn.Sequential):
    def __init__(self, c_in: int, hidden: int, blocks: int):
        super().__init__(*[ConvBlock(c_in if i == 0 else hidden, hidden) for i in range(blocks)],
                         nn.Conv2d(hidden, 3, 1))

    def forward(self, prec: Precision, x: torch.Tensor) -> torch.Tensor:
        x = run(prec, list(self)[:-1], x)
        return F.conv2d(x, self[-1].weight, self[-1].bias)


class TinyRoma(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.xfeat = nn.ModuleList([XFeat()])
        self.coarse_matcher = Matcher(2 * c["coarse_dim"] + 2, c["match_dim"],
                                      c["num_matcher_blocks"])
        self.fine_matcher = Matcher(2 * c["fine_dim"] + 2, c["fine_match_dim"],
                                    c["num_matcher_blocks"])

    @torch.no_grad()
    def match(self, prec: Precision, im_a: torch.Tensor, im_b: torch.Tensor):
        """(B, H, W, 3) in [0, 1], H and W multiples of 32 -> warp (B, H, W, 4)
        and certainty (B, H, W)."""
        B, H, W, _ = im_a.shape
        _, coarse = self.xfeat[0](prec, torch.cat([im_a, im_b]).permute(0, 3, 1, 2))
        f0, f1 = coarse[:B], coarse[B:]
        C, h, w = f0.shape[1:]
        a = prec.low(f0).flatten(2).transpose(1, 2)
        b = prec.low(f1).flatten(2)
        p = torch.softmax(torch.bmm(a, b) / C ** 0.5, -1)
        warp = (p @ grid(h, w, f0.device).reshape(h * w, 2)).reshape(B, h, w, 2)
        to_norm = torch.tensor([2 / W, 2 / H, 1.0], device=f0.device)
        m = torch.cat([warp, torch.zeros_like(warp[..., :1])], -1)
        for _ in range(self.c["coarse_iters"]):
            x = torch.cat([f0, sample(prec.low(f1), m[..., :2]), m[..., :2].permute(0, 3, 1, 2)], 1)
            m = m + self.coarse_matcher(prec, x).permute(0, 2, 3, 1) * to_norm
        flow = bilinear(m[..., :2], (H, W))
        cert = torch.sigmoid(bilinear(m[..., 2:], (H, W))[..., 0])
        return torch.cat([grid(H, W, f0.device).expand(B, H, W, 2), flow], -1), cert
