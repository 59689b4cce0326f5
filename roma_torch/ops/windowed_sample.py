"""Windowed warp gather: the tile plan and the plain version of the kernel.

Zeros-padding bilinear sampling of a narrow (C <= 16) map, computed per
(8, 128) output tile from one source window: 24 rows from ``ybase`` and
``128 + E`` columns from ``j0_abs`` of a zero-padded frame (PAD = 2 rows on
top, PADX = 128 columns on the left, width ``Wp``). The plan picks each
tile's window from the minima of its real pixels' bilinear bases; a pixel
whose base falls outside its tile's window is clamped into it ("fast"
mode's window-clamped result), and `ok` says whether no real pixel of the
batch needed that clamp and every base is in bounds (then the result is
plain bilinear sampling). The geometry is the JAX package's
(`ops/pallas/windowed_sample.py::_plan`): fast mode's clamped values depend
on it. "exact" mode (`windowed_exact_plain`) takes a pixel's taps from its
tile's window where the window holds them and from the map elsewhere, which
is bilinear sampling for any flow.

These functions are the spec of the CUDA kernel
(``roma_torch/csrc/windowed_sample.cu``), which derives each tile's plan
itself, and the CPU path of ``roma_torch/kernels/windowed_sample.py``.

Features are NCHW (B, C, H, W), as the port's refiner holds them; grids are
(B, Ho, Wo, 2) with Ho, Wo multiples of (8, 128) (edge-padded by the caller);
``valid_hw`` is the real output extent inside them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

TH, TW = 8, 128          # output tile
E = 8                    # column slack of the window
NYB, NXB = 3, 3          # window height in 8-row blocks; frame right margin in 128-col blocks
PAD, PADX = 2, 128       # zero rows above the image, zero columns left of it
WIN_ROWS = NYB * 8       # 24
WIN_COLS = TW + E        # 136
_COORD_LIMIT = float(1 << 20)  # far-out-of-range bases clip to the frame anyway


class Plan(NamedTuple):
    ybase: torch.Tensor   # (B, n_ty, n_tx) int32: frame row of the window's top (8-aligned)
    j0_abs: torch.Tensor  # (B, n_ty, n_tx) int32: frame column of the window's left
    y0rel: torch.Tensor   # (B, Ho, Wo) int32 in [0, 22]: base row - ybase
    e: torch.Tensor       # (B, Ho, Wo) int32 in [0, 6]: base column - j0_abs - local column
    inwin: torch.Tensor   # (B, Ho, Wo) bool: y0rel and e needed no clamp
    wx: torch.Tensor      # (B, Ho, Wo) float32 bilinear weights of the unclamped coordinate
    wy: torch.Tensor
    Wp: int               # frame width
    ok: torch.Tensor      # () bool: the window-clamped result is the exact one


def frame_width(W: int) -> int:
    return PADX + (-(-(W + PAD) // 128) * 128) + NXB * 128


def pad_grid(grid: torch.Tensor) -> torch.Tensor:
    """Edge-replicate a (B, Ho, Wo, 2) grid up to (8, 128) multiples."""
    Ho, Wo = grid.shape[1:3]
    Hp, Wp = -(-Ho // TH) * TH, -(-Wo // TW) * TW
    if (Hp, Wp) == (Ho, Wo):
        return grid.contiguous()
    dev = grid.device
    hi = torch.arange(Hp, device=dev).clamp_max(Ho - 1)
    wi = torch.arange(Wp, device=dev).clamp_max(Wo - 1)
    return grid.index_select(1, hi).index_select(2, wi).contiguous()


def base_coords(grid: torch.Tensor, H: int, W: int):
    """Per-pixel bilinear base (x0, y0) as int32, its weights (wx, wy), all
    float32 arithmetic with the grid_sample pixel mapping
    ``px = (x + 1) * W / 2 - 0.5``."""
    gx = (grid[..., 0].float() + 1.0) * (W / 2) - 0.5
    gy = (grid[..., 1].float() + 1.0) * (H / 2) - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    lim = _COORD_LIMIT
    return (x0.clamp(-lim, lim).to(torch.int32), y0.clamp(-lim, lim).to(torch.int32), wx, wy)


def plan(feat: torch.Tensor, grid: torch.Tensor, valid_hw=None) -> Plan:
    """Window origins per tile, clamped per-pixel offsets, weights and the
    whole-batch `ok`. Pixels outside `valid_hw` (tile padding) are left out
    of the minima and of `ok`; their offsets are clamped like the rest."""
    H, W = feat.shape[-2:]
    B, Ho, Wo = grid.shape[:3]
    Ho0, Wo0 = valid_hw if valid_hw is not None else (Ho, Wo)
    n_ty, n_tx = Ho // TH, Wo // TW
    if n_ty * TH != Ho or n_tx * TW != Wo:
        raise ValueError(f"grid {Ho}x{Wo} is not a multiple of the ({TH}, {TW}) tile")
    dev = grid.device
    Wp = frame_width(W)
    x0r, y0r, wx, wy = base_coords(grid, H, W)
    inb = (x0r >= -1) & (x0r < W) & (y0r >= -1) & (y0r < H)
    x0i = (x0r + PADX).clamp(0, Wp - 2)
    y0i = (y0r + PAD).clamp(0, H + 2 * PAD - 2)

    real = ((torch.arange(Ho, device=dev) < Ho0)[:, None]
            & (torch.arange(Wo, device=dev) < Wo0)[None, :])
    realt = real.reshape(1, n_ty, TH, n_tx, TW)
    big = 1 << 29
    y0t = y0i.reshape(B, n_ty, TH, n_tx, TW)
    y0min = torch.where(realt, y0t, big).amin(dim=(2, 4))
    # disparity against the global output column
    wg = torch.arange(Wo, device=dev, dtype=torch.int32).reshape(1, 1, 1, n_tx, TW)
    d = x0i.reshape(B, n_ty, TH, n_tx, TW) - wg
    j0 = torch.where(realt, d, big).amin(dim=(2, 4))
    txo = (torch.arange(n_tx, device=dev, dtype=torch.int32) * TW)[None, None, :]
    j0_abs = (j0 + txo).clamp(0, Wp - NXB * 128)
    y0min = y0min.clamp(0, H + 2 * PAD - 2)
    ybase = (y0min // 8) * 8
    y0rel = y0t - ybase[:, :, None, :, None]
    e = d - (j0_abs - txo)[:, :, None, :, None]
    inwin = (y0rel >= 0) & (y0rel <= WIN_ROWS - 2) & (e >= 0) & (e <= E - 2)
    ok = (torch.where(realt, inwin, True).all()
          & torch.where(real, inb, True).all())
    y0rel = y0rel.clamp(0, WIN_ROWS - 2).reshape(B, Ho, Wo)
    e = e.clamp(0, E - 2).reshape(B, Ho, Wo)
    i32 = torch.int32
    return Plan(ybase.to(i32), j0_abs.to(i32), y0rel.to(i32), e.to(i32),
                inwin.reshape(B, Ho, Wo), wx, wy, Wp, ok)


def smoothness_ok(feat: torch.Tensor, grid: torch.Tensor, valid_hw=None) -> torch.Tensor:
    """() bool: may the windowed gather serve this batch exactly?"""
    return plan(feat, grid, valid_hw).ok


def windowed_sample_plain(feat: torch.Tensor, grid: torch.Tensor, valid_hw=None,
                          p: Plan | None = None) -> torch.Tensor:
    """"fast" mode in plain PyTorch: feat (B, C, H, W), tile-padded grid
    (B, Ho, Wo, 2) -> (B, C, Ho0, Wo0) in feat's dtype. Each pixel reads the
    2 x 2 taps at frame (ybase + y0rel, j0_abs + e + local column) with the
    weights of its unclamped coordinate; frame positions outside the image
    are zeros. float32 arithmetic."""
    p = plan(feat, grid, valid_hw) if p is None else p
    row, col = _window_taps(p, grid.shape[2])
    return _bilinear_taps(feat, row, col, p, valid_hw)


def windowed_exact_plain(feat: torch.Tensor, grid: torch.Tensor, valid_hw=None,
                         p: Plan | None = None) -> torch.Tensor:
    """"exact" mode in plain PyTorch, arguments as `windowed_sample_plain`:
    a pixel whose offsets lie in its tile's window (`inwin`) reads its taps
    there, any other pixel at its own base in the image. Both are the
    zeros-padded bilinear taps (a base clamped to the frame's edge has all
    its taps outside the image, as the clamped position has), so this is
    bilinear sampling for any flow."""
    H, W = feat.shape[-2:]
    p = plan(feat, grid, valid_hw) if p is None else p
    row, col = _window_taps(p, grid.shape[2])
    x0r, y0r, _, _ = base_coords(grid, H, W)
    row = torch.where(p.inwin, row, y0r)
    col = torch.where(p.inwin, col, x0r)
    return _bilinear_taps(feat, row, col, p, valid_hw)


def _window_taps(p: Plan, Wo: int):
    """Image row and column of each pixel's top-left tap in its window."""
    rep = lambda t: t.repeat_interleave(TH, 1).repeat_interleave(TW, 2)
    lw = (torch.arange(Wo, device=p.e.device) % TW)[None, None, :]
    return rep(p.ybase) + p.y0rel - PAD, rep(p.j0_abs) + p.e + lw - PADX


def _bilinear_taps(feat, row, col, p: Plan, valid_hw):
    """sum of the 2 x 2 taps from (row, col), zeros outside the image, with
    the plan's weights, in the order the kernel adds them."""
    B, C, H, W = feat.shape
    Ho, Wo = row.shape[1:]
    Ho0, Wo0 = valid_hw if valid_hw is not None else (Ho, Wo)
    dev = feat.device
    src = feat.float().reshape(B, C, H * W)
    out = torch.zeros((B, C, Ho * Wo), dtype=torch.float32, device=dev)
    for dy, dx, w in ((0, 0, (1 - p.wy) * (1 - p.wx)), (0, 1, (1 - p.wy) * p.wx),
                      (1, 0, p.wy * (1 - p.wx)), (1, 1, p.wy * p.wx)):
        r, c = row + dy, col + dx
        inside = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        idx = torch.where(inside, r * W + c, 0).reshape(B, 1, Ho * Wo).long()
        v = torch.gather(src, 2, idx.expand(B, C, Ho * Wo))
        out = out + (w * inside).reshape(B, 1, Ho * Wo) * v
    out = out.reshape(B, C, Ho, Wo)[:, :, :Ho0, :Wo0]
    return out.to(feat.dtype)
