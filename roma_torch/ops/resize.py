"""Resizing with half-pixel-center semantics, channels-last ``(..., H, W, C)``
at the public functions, as in the JAX package's `ops/resize.py`.

- `interpolate_bilinear`: no antialiasing; PyTorch's bilinear clamps the
  source coordinate at the border, which equals the JAX resize's border
  renormalisation for the two-tap kernel.
- `resize_bicubic`: Keys cubic with a=-0.5, filter widened on downscale and
  weights renormalised over the taps inside the image. That is PyTorch's
  antialiased bicubic (``antialias=True``), not its plain a=-0.75 bicubic.
  With ``antialias=False`` the filter is not widened (``jax.image.resize``'s
  cubic without antialiasing): two interpolation matrices from
  `keys_cubic_matrix`, since PyTorch's un-antialiased bicubic is the
  a=-0.75 kernel with a clamped border.
- `interpolate_nearest`: nearest with half-pixel centers (PyTorch's
  "nearest-exact").
- `torch_bicubic_resize`: the a=-0.75, clamped-border bicubic of
  ``F.interpolate(mode="bicubic")`` written as two interpolation matrices,
  so the caller-passed coordinate scale (DINOv2's ``+0.1`` pos-embed
  offset) is kept exactly.
- `pil_bicubic_matrix` / `pil_bicubic_resize_device`: PIL's antialiased
  BICUBIC resize as two interpolation matrices with PIL's per-pass uint8
  rounding, so zero-padded canvases of any source size resize on the device
  as PIL resizes the unpadded image (the matcher's `match_raw`).
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


def interpolate_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize, half-pixel centers (NHWC)."""
    return _nhwc_call(x, lambda t: F.interpolate(t, size=tuple(size), mode="nearest-exact"))


def pad_to_multiple(x: torch.Tensor, multiple: int = 32) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (H // multiple * multiple,
    W // multiple * multiple), the reference's `preprocess_tensor` contract."""
    h, w = x.shape[-3], x.shape[-2]
    return interpolate_bilinear(x, ((h // multiple) * multiple, (w // multiple) * multiple))


def resize_bicubic(x: torch.Tensor, size: tuple[int, int],
                   antialias: bool = True) -> torch.Tensor:
    """Keys a=-0.5 bicubic (NHWC, float), with antialiasing on downscale
    unless `antialias` is False (the two agree on upscale)."""
    if not antialias:
        return _separable(x, keys_cubic_matrix(x.shape[-3], size[0]),
                          keys_cubic_matrix(x.shape[-2], size[1]))
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


def keys_cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of ``jax.image.resize(method="cubic",
    antialias=False)`` along one axis: Keys a=-0.5 at source position
    ``(dst + 0.5) * n_in / n_out - 0.5``, the filter not widened, each row
    renormalised over the taps inside the image (a row summing to nearly 0
    is zeroed, as is one whose centre lies outside the image)."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    w = _cubic_conv_kernel(np.abs(src[:, None] - np.arange(n_in)[None, :]), a=-0.5)
    total = w.sum(axis=1, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (src >= -0.5) & (src <= n_in - 0.5)
    return np.where(inside[:, None], w, 0.0)


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
    return _separable(x, torch_bicubic_matrix(h_in, h, sh), torch_bicubic_matrix(w_in, w, sw))


def _separable(x: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    """(..., H, W, C) -> (..., h, w, C) through the (h, H) and (w, W)
    interpolation matrices, in float32 on x's device."""
    kw = dict(device=x.device, dtype=torch.float32)
    y = torch.einsum("hi,...iwc->...hwc", torch.as_tensor(mh, **kw), x.float())
    return torch.einsum("wj,...hjc->...hwc", torch.as_tensor(mw, **kw), y).to(x.dtype)


def _pil_bicubic_filter(x: np.ndarray) -> np.ndarray:
    """PIL's BICUBIC filter: Keys cubic with a=-0.5, support 2."""
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
        np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0),
    )


def pil_bicubic_matrix(n_in: int, n_out: int, n_cols: int | None = None) -> np.ndarray:
    """(n_out, n_cols or n_in) float32 matrix of PIL's antialiased BICUBIC
    along one axis (Pillow's precompute_coeffs): support widened by the
    downscale factor, window [int(center - support + .5), int(center +
    support + .5)) clipped to the source, weights normalised over it.
    Columns past `n_in` (a zero-padded canvas) are zero."""
    if n_cols is None:
        n_cols = n_in
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    center = (np.arange(n_out, dtype=np.float64) + 0.5) * scale
    m = np.zeros((n_out, n_cols), np.float64)
    for i in range(n_out):
        xmin = max(int(center[i] - support + 0.5), 0)
        xmax = min(int(center[i] + support + 0.5), n_in)
        xs = np.arange(xmin, xmax, dtype=np.float64)
        w = _pil_bicubic_filter((xs - center[i] + 0.5) / filterscale)
        s = w.sum()
        if s != 0.0:
            w = w / s
        m[i, xmin:xmax] = w
    return m.astype(np.float32)


def pil_round_u8(x: torch.Tensor) -> torch.Tensor:
    """PIL's per-pass 8-bit store: round half up, clamp to [0, 255]."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def pil_bicubic_resize_device(x: torch.Tensor, ry: torch.Tensor, rx: torch.Tensor) -> torch.Tensor:
    """PIL-parity antialiased bicubic through interpolation matrices.

    x: (..., H, W, C) float32 in [0, 255]; ry: (..., h_out, H); rx:
    (..., w_out, W). Horizontal pass, round, vertical pass, round, as PIL's
    8-bit path does: within one uint8 level of ``PIL.Image.resize(...,
    BICUBIC)``. Both products stay full float32 (the package turns TF32
    off), or the per-pass ``floor(x + 0.5)`` would cross rounding
    boundaries."""
    hp = pil_round_u8(torch.einsum("...wj,...hjc->...hwc", rx.float(), x.float()))
    return pil_round_u8(torch.einsum("...hi,...iwc->...hwc", ry.float(), hp))
