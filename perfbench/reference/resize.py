"""Pillow's antialiased BICUBIC resize written as two interpolation matrices,
with Pillow's 8-bit store after each pass (round half up, clamp to [0, 255]).
A zero-padded canvas holding an (h, w) image resizes as the unpadded image:
the matrices have no weight past the image."""

from __future__ import annotations

import numpy as np
import torch


def _cubic(t: np.ndarray, a: float = -0.5) -> np.ndarray:
    t = np.abs(t)
    near = ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0
    far = a * (((t - 5.0) * t + 8.0) * t - 4.0)
    return np.where(t < 1.0, near, np.where(t < 2.0, far, 0.0))


def bicubic_matrix(n_in: int, n_out: int, n_cols: int) -> np.ndarray:
    """(n_out, n_cols) weights of Pillow's BICUBIC along one axis: the
    filter's support (2) widened by the downscale factor, the window
    [int(c - s + 0.5), int(c + s + 0.5)) clipped to the image, the weights
    normalised over it."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((n_out, n_cols))
    for i in range(n_out):
        c = (i + 0.5) * scale
        lo = max(int(c - support + 0.5), 0)
        hi = min(int(c + support + 0.5), n_in)
        w = _cubic((np.arange(lo, hi) - c + 0.5) / fscale)
        m[i, lo:hi] = w / w.sum() if w.sum() != 0 else w
    return m.astype(np.float32)


def resize_canvases(raw: torch.Tensor, sizes, out_hw) -> torch.Tensor:
    """(N, Hc, Wc, 3) uint8 canvases holding images of `sizes` [(h, w)] at
    their top-left -> (N, ho, wo, 3) float32 in [0, 255], Pillow's values."""
    n, hc, wc, _ = raw.shape
    ho, wo = out_hw
    dev = raw.device
    ry = torch.stack([torch.from_numpy(bicubic_matrix(h, ho, hc)) for h, _ in sizes]).to(dev)
    rx = torch.stack([torch.from_numpy(bicubic_matrix(w, wo, wc)) for _, w in sizes]).to(dev)
    x = raw.float()
    rows = torch.floor(torch.matmul(rx[:, None], x) + 0.5).clamp(0, 255)       # (N, Hc, wo, 3)
    out = torch.matmul(ry, rows.reshape(n, hc, wo * 3)).reshape(n, ho, wo, 3)
    return torch.floor(out + 0.5).clamp(0, 255)
