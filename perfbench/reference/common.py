"""Precision of the reference and of its control, and the shared plain
operations (grids, bilinear sampling and resizing)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def no_tf32() -> None:
    """Full float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class _Rounded(torch.autograd.Function):
    """`round(x)` forward, `round(gradient)` backward."""

    @staticmethod
    def forward(ctx, x, round_):
        ctx.round_ = round_
        return round_(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.round_(grad), None


class Precision:
    """The precision the reference computes in: "float32" everywhere (the
    reference); or the operands of every product the program computes in
    bfloat16 (convolutions, linear layers, attention, correlations, sampled
    feature maps) rounded to "bfloat16" (the yardstick of the rounding a
    bfloat16 program may show) or to "float8" e4m3 with one scale per tensor
    (the control: the next precision below the configuration's bfloat16; the
    KDE's coordinates too)."""

    def __init__(self, mode: str = "float32"):
        if mode not in ("float32", "bfloat16", "float8"):
            raise ValueError(f"precision {mode!r}")
        self.mode = mode

    def low(self, x: torch.Tensor) -> torch.Tensor:
        """An operand rounded to the precision; where autograd records, its
        gradient is rounded alike on the way back, as a program's backward
        in that precision rounds it."""
        x = x.float()
        if self.mode == "float32":
            return x
        return _Rounded.apply(x, self._round)

    def _round(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "bfloat16":
            return x.to(torch.bfloat16).float()
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def kde(self, x: torch.Tensor) -> torch.Tensor:
        """The KDE's coordinates: float32 in the program, float8 in the control."""
        return self.low(x) if self.mode == "float8" else x.float()

    def conv(self, x, conv: torch.nn.Conv2d) -> torch.Tensor:
        return F.conv2d(self.low(x), self.low(conv.weight), conv.bias, conv.stride,
                        conv.padding, conv.dilation, conv.groups)

    def linear(self, x, lin: torch.nn.Linear) -> torch.Tensor:
        return F.linear(self.low(x), self.low(lin.weight), lin.bias)


def grid(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) normalized (x, y) pixel centres, (2 i + 1) / n - 1."""
    xs = (2 * torch.arange(w, device=device, dtype=torch.float64) + 1) / w - 1
    ys = (2 * torch.arange(h, device=device, dtype=torch.float64) + 1) / h - 1
    return torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], -1).float()


def bilinear(x_nhwc: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize of a channels-last map, half-pixel centres."""
    y = F.interpolate(x_nhwc.permute(0, 3, 1, 2).float(), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


def sample(feat_nchw: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (B, C, H, W) at (B, h, w, 2) normalized coordinates,
    zeros outside."""
    return F.grid_sample(feat_nchw.float(), coords.float(), mode="bilinear",
                         padding_mode="zeros", align_corners=False)


def attention(prec: Precision, q, k, v) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, H, N, d)."""
    s = torch.matmul(prec.low(q), prec.low(k).transpose(-1, -2)) / q.shape[-1] ** 0.5
    return torch.matmul(prec.low(torch.softmax(s, -1)), prec.low(v))
