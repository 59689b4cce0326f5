"""Resizing with half-pixel-center semantics, channels-last ``(..., H, W, C)``
at the public functions, as in the JAX package's `ops/resize.py`.

- `interpolate_bilinear`: no antialiasing; PyTorch's bilinear clamps the
  source coordinate at the border, which equals the JAX resize's border
  renormalisation for the two-tap kernel.
- `resize_bicubic`: Keys cubic with a=-0.5, filter widened on downscale and
  weights renormalised over the taps inside the image. That is PyTorch's
  antialiased bicubic (``antialias=True``), not its plain a=-0.75 bicubic.
- `torch_bicubic_resize`: the a=-0.75, clamped-border bicubic of
  ``F.interpolate(mode="bicubic")`` written as two interpolation matrices,
  so the caller-passed coordinate scale (DINOv2's ``+0.1`` pos-embed
  offset) is kept exactly.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _nhwc_call(x: torch.Tensor, fn) -> torch.Tensor:
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = fn(x.reshape(-1, h, w, c).permute(0, 3, 1, 2))
    return y.permute(0, 2, 3, 1).reshape(*lead, *y.shape[-2:], c)


def interpolate_bilinear(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize, half-pixel centers, no antialiasing (NHWC)."""
    return _nhwc_call(
        x,
        lambda t: F.interpolate(
            t, size=tuple(size), mode="bilinear", align_corners=False
        ),
    )


def resize_bicubic(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Keys a=-0.5 bicubic with antialiasing on downscale (NHWC, float)."""
    return _nhwc_call(
        x,
        lambda t: F.interpolate(
            t, size=tuple(size), mode="bicubic", align_corners=False,
            antialias=True,
        ),
    )


def _cubic_conv_kernel(t: np.ndarray, a: float = -0.75) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1,
        ((a + 2) * at - (a + 3)) * at * at + 1,
        np.where(at < 2, a * (((at - 5) * at + 8) * at - 4), 0.0),
    )


def torch_bicubic_matrix(n_in: int, n_out: int, scale: float) -> np.ndarray:
    """(n_out, n_in) matrix of ``F.interpolate(mode='bicubic',
    align_corners=False)`` along one axis, source position
    ``(dst + 0.5) / scale - 0.5`` with the given scale; border taps clamp."""
    i = np.arange(n_out, dtype=np.float64)
    src = (i + 0.5) / scale - 0.5
    f = np.floor(src).astype(np.int64)
    m = np.zeros((n_out, n_in), np.float64)
    for k in range(-1, 3):
        idx = np.clip(f + k, 0, n_in - 1)
        wts = _cubic_conv_kernel(src - (f + k).astype(np.float64))
        np.add.at(m, (i.astype(np.int64), idx), wts)
    return m


def torch_bicubic_resize(
    x: torch.Tensor,
    size: tuple[int, int],
    scale: tuple[float, float] | None = None,
) -> torch.Tensor:
    """a=-0.75 bicubic on the (-3, -2) axes of a channels-last tensor;
    `scale` (h_scale, w_scale) overrides the coordinate-mapping factors."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    h, w = size
    sh = scale[0] if scale is not None else h / h_in
    sw = scale[1] if scale is not None else w / w_in
    kw = dict(device=x.device, dtype=torch.float32)
    mh = torch.as_tensor(torch_bicubic_matrix(h_in, h, sh), **kw)
    mw = torch.as_tensor(torch_bicubic_matrix(w_in, w, sw), **kw)
    y = torch.einsum("hi,...iwc->...hwc", mh, x.float())
    return torch.einsum("wj,...hjc->...hwc", mw, y).to(x.dtype)
