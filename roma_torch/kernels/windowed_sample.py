"""Windowed warp gather (CUDA, ``csrc/windowed_sample.cu``), its wrapper and
the public `grid_sample_smooth`.

Replaces the TPU kernel ``roma_tpu/ops/pallas/windowed_sample.py::
grid_sample_smooth``, its plan and its exact-mode ``lax.cond``. The kernel
derives each tile's plan itself from the unpadded grid, in one launch a
call; the plan, `ok` and the plain versions of both modes live in
``roma_torch/ops/windowed_sample.py`` and serve the CPU path. Bound and
design: see the note at the top of the CUDA source (bytes; one block per
8 x 128 output tile, the rows its pixels read of the 24 x 136 source window
staged by cp.async).

Modes, as in the JAX package:
- "fast": the windowed gather, window-clamped on rough tiles;
- "exact" (or True): bilinear sampling for any flow. A pixel takes its taps
  from its tile's window where the window holds them, from the map
  elsewhere: the same function as JAX's choice between the windowed kernel
  and `grid_sample`, with no host read of `ok` (no device-to-host sync).
`with_ok=True` also returns the whole-batch `ok` as a () bool tensor on the
map's device, reduced by the kernel. Maps with more than 16 channels take
plain `grid_sample` in either mode (the kernel then reduces only `ok`, when
asked for it). bf16 and float32 maps, as the JAX kernel takes the map's
dtype. The kernel reads channels-last maps (the refiner's layout, as the
JAX kernel's maps are (B, H, W, C)); `grid_sample_smooth_nchw` converts any
other layout.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from roma_torch.kernels import runtime
from roma_torch.ops.grid_sample import grid_sample_nchw
from roma_torch.ops.windowed_sample import (TH, TW, frame_width, pad_grid, plan,
                                            windowed_exact_plain, windowed_sample_plain)

NAME = "windowed_sample"
MAX_CHANNELS = 16
MODES = ("exact", "fast")
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


@functools.cache
def _kernel():
    lib = runtime.load(NAME)
    fn = lib.roma_windowed_sample
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def origins_shape(grid: torch.Tensor) -> tuple[int, int, int, int]:
    """(B, tile rows, tile columns, 2) of the kernel's origins buffer."""
    B, Ho, Wo = grid.shape[:3]
    return B, -(-Ho // TH), -(-Wo // TW), 2


def windowed_sample_cuda(feat: torch.Tensor | None, grid: torch.Tensor, exact: bool = False,
                         ok: torch.Tensor | None = None, origins: torch.Tensor | None = None,
                         hw: tuple[int, int] | None = None) -> torch.Tensor | None:
    """One launch: feat (B,C,H,W) bf16 or float32, channels last, sampled
    at the unpadded grid (B,Ho,Wo,2) -> (B,C,Ho,Wo) contiguous
    in feat's dtype ("fast", or "exact" with `exact`). `ok`: a () int32
    tensor set to 1, cleared by the kernel where a tile is not
    window-smooth; `origins` (`origins_shape`) int32 receives each tile's
    (ybase, j0_abs). With feat None only those two are computed, for a map
    of size `hw`."""
    dev = grid.device
    B, Ho, Wo = grid.shape[:3]
    runtime.require(NAME, grid, (B, Ho, Wo, 2), torch.float32, dev)
    if grid.data_ptr() % 8:
        raise ValueError(f"{NAME}: the grid must be 8-byte aligned")
    if ok is not None:
        runtime.require(NAME, ok, (), torch.int32, dev)
    if origins is not None:
        runtime.require(NAME, origins, origins_shape(grid), torch.int32, dev)
    if feat is None:
        (H, W), C, dtype, out = hw, 0, torch.bfloat16, None
    else:
        _, C, H, W = feat.shape
        if not 1 <= C <= MAX_CHANNELS:
            raise ValueError(f"{NAME}: needs 1 <= C <= {MAX_CHANNELS}, got {C}")
        if feat.dtype not in _DTYPE_CODES:
            raise TypeError(f"{NAME}: the map must be bfloat16 or float32, got {feat.dtype}")
        dtype = feat.dtype
        runtime.require(NAME, feat, (B, C, H, W), dtype, dev, contiguous=False)
        if not feat.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(f"{NAME}: the map must be channels last")
        out = torch.empty((B, C, Ho, Wo), dtype=dtype, device=dev)
    lib, fn = _kernel()
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = fn(ptr(feat), grid.data_ptr(), ptr(out), ptr(ok), ptr(origins), B, C, H, W, Ho, Wo,
            frame_width(W), _DTYPE_CODES[dtype], int(exact), runtime.stream_handle(grid))
    runtime.check(lib, NAME, rc)
    return out


def grid_sample_smooth_nchw(feat: torch.Tensor, grid: torch.Tensor, mode: str = "exact",
                            with_ok: bool = False):
    """grid_sample (zeros padding) of feat (B,C,H,W) at grid (B,Ho,Wo,2) ->
    (B,C,Ho,Wo) in feat's dtype, through the windowed gather per `mode`.
    `with_ok=True` also returns the whole-batch `ok` flag (a () bool tensor).
    Through the operator ``roma::windowed_sample``: CPU tensors take the
    plain versions; CUDA tensors launch the kernel once (C <= 16, or
    `with_ok`) and never wait for it. It has no backward (the refiner's
    gate keeps autograd off it)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    out, ok = op(feat, grid, mode == "exact", with_ok)
    return (out, ok) if with_ok else out


def smooth_plain(feat, grid, exact: bool, with_ok: bool):
    """The operator's CPU implementation: the plain versions of both modes
    (plain `grid_sample` past 16 channels); `ok` empty unless `with_ok`."""
    narrow = feat.shape[1] <= MAX_CHANNELS
    vhw = tuple(grid.shape[1:3])
    gp = pad_grid(grid.float())
    p = plan(feat, gp, vhw) if narrow or with_ok else None
    if not narrow:
        out = grid_sample_nchw(feat, grid)
    elif exact:
        out = windowed_exact_plain(feat, gp, vhw, p)
    else:
        out = windowed_sample_plain(feat, gp, vhw, p)
    return out, (p.ok.clone() if with_ok else _no_ok(feat))


def _smooth_cuda(feat, grid, exact: bool, with_ok: bool):
    """The operator's CUDA implementation: the kernel on a channels-last
    copy of a narrow map, plain `grid_sample` past 16 channels (the kernel
    then reduces only `ok`, when asked for it)."""
    grid = grid.float().contiguous()
    ok = torch.ones((), dtype=torch.int32, device=feat.device) if with_ok else None
    if feat.shape[1] <= MAX_CHANNELS:
        feat = feat.contiguous(memory_format=torch.channels_last)
        out = windowed_sample_cuda(feat, grid, exact, ok)
    else:
        out = grid_sample_nchw(feat, grid).contiguous()
        if with_ok:
            windowed_sample_cuda(None, grid, ok=ok, hw=tuple(feat.shape[-2:]))
    return out, (ok.bool() if with_ok else _no_ok(feat))


def _no_ok(feat):
    return torch.empty((0,), dtype=torch.bool, device=feat.device)


def _smooth_fake(feat, grid, exact: bool, with_ok: bool):
    B, C = feat.shape[:2]
    out = feat.new_empty((B, C, *grid.shape[1:3]))
    return out, feat.new_empty(() if with_ok else (0,), dtype=torch.bool)


def flops(feat, grid, exact, with_ok, out_shape=None) -> int:
    """What FlopCounterMode counts for the plain version: 0 (bilinear
    taps are gathers and elementwise products, as `F.grid_sample` counts
    0 there)."""
    return 0


op = runtime.define_op(
    NAME, "(Tensor feat, Tensor grid, bool exact, bool with_ok) -> (Tensor, Tensor)",
    _smooth_cuda, smooth_plain, _smooth_fake, flops)


def grid_sample_smooth(feat: torch.Tensor, grid: torch.Tensor, mode: str = "exact",
                       with_ok: bool = False):
    """JAX-layout entry: feat (B,H,W,C), grid (B,Ho,Wo,2) -> (B,Ho,Wo,C)."""
    res = grid_sample_smooth_nchw(feat.permute(0, 3, 1, 2), grid, mode, with_ok)
    out = res[0] if with_ok else res
    out = out.permute(0, 2, 3, 1)
    return (out, res[1]) if with_ok else out
