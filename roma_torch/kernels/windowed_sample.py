"""Windowed warp gather (CUDA, ``csrc/windowed_sample.cu``), its wrapper and
the public `grid_sample_smooth`.

Replaces the TPU kernel ``roma_tpu/ops/pallas/windowed_sample.py::
grid_sample_smooth``. The plan (per-tile window origins, whole-batch `ok`)
and the plain version live in ``roma_torch/ops/windowed_sample.py``. Bound
and design: see the note at the top of the CUDA source (bytes; one block
per 8 x 128 output tile, the 24 x 136 source window in shared memory).

Modes, as in the JAX package:
- "fast": the windowed gather, always (window-clamped on rough tiles);
- "exact" (or True): the windowed gather when `ok` holds for the whole
  batch, else plain `grid_sample`. Deciding reads `ok` on the host, one
  device-to-host sync per call, the counterpart of the JAX `lax.cond`.
Maps with more than 16 channels take plain `grid_sample` in either mode.
"""

from __future__ import annotations

import ctypes

import torch

from roma_torch.kernels import runtime
from roma_torch.ops.grid_sample import grid_sample_nchw
from roma_torch.ops.windowed_sample import (Plan, pad_grid, plan, smoothness_ok,
                                            windowed_sample_plain)

NAME = "windowed_sample"
MAX_CHANNELS = 16
MODES = ("exact", "fast")


def windowed_sample(feat: torch.Tensor, grid: torch.Tensor, valid_hw, p: Plan) -> torch.Tensor:
    """feat (B,C,H,W), tile-padded grid (B,Ho,Wo,2) and its plan ->
    (B,C,Ho0,Wo0). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if feat.device.type == "cpu":
        return windowed_sample_plain(feat, grid, valid_hw, p)
    return windowed_sample_cuda(feat, grid, valid_hw, p)


def windowed_sample_cuda(feat: torch.Tensor, grid: torch.Tensor, valid_hw, p: Plan) -> torch.Tensor:
    B, C, H, W = feat.shape
    Ho, Wo = grid.shape[1:3]
    Ho0, Wo0 = valid_hw
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{NAME}: needs 1 <= C <= {MAX_CHANNELS}, got {C}")
    dev = feat.device
    runtime.require(NAME, feat, (B, C, H, W), torch.bfloat16, dev)
    runtime.require(NAME, grid, (B, Ho, Wo, 2), torch.float32, dev)
    if grid.data_ptr() % 8:
        raise ValueError(f"{NAME}: the grid must be 8-byte aligned")
    origin = torch.stack([p.ybase, p.j0_abs], dim=-1).reshape(B, -1, 2).contiguous()
    out = torch.empty((B, C, Ho0, Wo0), dtype=torch.bfloat16, device=dev)
    lib = runtime.load(NAME)
    fn = lib.roma_windowed_sample
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(feat.data_ptr(), grid.data_ptr(), origin.data_ptr(), out.data_ptr(),
            B, C, H, W, Ho, Wo, Ho0, Wo0, p.Wp, runtime.stream_handle(feat))
    runtime.check(lib, NAME, rc)
    return out


def grid_sample_smooth_nchw(feat: torch.Tensor, grid: torch.Tensor, mode: str = "exact",
                            with_ok: bool = False):
    """grid_sample (zeros padding) of feat (B,C,H,W) at grid (B,Ho,Wo,2) ->
    (B,C,Ho,Wo) in feat's dtype, through the windowed gather per `mode`.
    `with_ok=True` also returns the whole-batch `ok` flag (a () bool tensor)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    vhw = tuple(grid.shape[1:3])
    if feat.shape[1] > MAX_CHANNELS:
        out = grid_sample_nchw(feat, grid)
        return (out, smoothness_ok(feat, pad_grid(grid.float()), vhw)) if with_ok else out
    gp = pad_grid(grid.float())
    feat = feat.contiguous()
    p = plan(feat, gp, vhw)
    if mode == "fast" or bool(p.ok):
        out = windowed_sample(feat, gp, vhw, p)
    else:
        out = grid_sample_nchw(feat, grid)
    return (out, p.ok) if with_ok else out


def grid_sample_smooth(feat: torch.Tensor, grid: torch.Tensor, mode: str = "exact",
                       with_ok: bool = False):
    """JAX-layout entry: feat (B,H,W,C), grid (B,Ho,Wo,2) -> (B,Ho,Wo,C)."""
    res = grid_sample_smooth_nchw(feat.permute(0, 3, 1, 2), grid, mode, with_ok)
    out = res[0] if with_ok else res
    out = out.permute(0, 2, 3, 1)
    return (out, res[1]) if with_ok else out
