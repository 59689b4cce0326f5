"""Local correlation kernel (CUDA, ``csrc/local_corr.cu``) and its wrapper.

Replaces the TPU kernel ``roma_tpu/ops/pallas/block_gather.py::
local_correlation_dma``. Its plain PyTorch version is
``roma_torch.ops.local_corr.local_correlation`` (the (2r+2)^2-corner
formulation), imported here as `local_correlation_plain`. Bound and design:
see the note at the top of the CUDA source (bytes; one warp per pixel
gathering its corners, and from r = 5, for 8 x 8 tiles whose window box is
small enough, the box staged in chunks and the tile's scores one GEMM on
the tensor cores; one kernel below r = 5, three in turn on the caller's
stream from r = 5, each call counted as one launch of the wrapper).
`tile_plan` mirrors the kernels' choice of path per tile. Float32 features
go to the float32 entry (`ENTRIES`): the per-pixel kernel at every radius,
so every float32 tile takes the per-pixel path.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from roma_torch.kernels import runtime
from roma_torch.ops.local_corr import corner_coords
from roma_torch.ops.local_corr import local_correlation as local_correlation_plain

NAME = "local_corr"
MAX_RADIUS = 7
TILE = 8             # tile side in pixels
SHARE_MIN_R = 5      # shared-window path iff radius >= SHARE_MIN_R and
SHARE_U = 4          #   SHARE_U * U <= SHARE_CORNERS * corners
SHARE_CORNERS = 1
ENTRIES = {torch.bfloat16: "roma_local_corr", torch.float32: "roma_local_corr_f32"}


def use_kernel(radius: int, channels: int, *inputs: torch.Tensor) -> bool:
    """The refiner's gate: radius <= 7, C a multiple of 128, and no input
    that autograd would have to differentiate through the kernel (the JAX
    package routes its kernel only when not training)."""
    return (radius <= MAX_RADIUS and channels % 128 == 0
            and not runtime.grad_needed(*inputs))


@dataclass(frozen=True)
class TilePlan:
    """Per 8 x 8 tile, (B, ceil(H/8), ceil(W/8)): `corners`, the in-range
    corners of its pixels' windows; `union`, the pixels U of the bounding box
    of those windows clipped to the image (0 when none is in range);
    `shared`, whether the kernel takes the shared-window path."""

    corners: torch.Tensor
    union: torch.Tensor
    shared: torch.Tensor


def tile_plan(flow: torch.Tensor, radius: int, dtype: torch.dtype = torch.bfloat16) -> TilePlan:
    """The kernel's rule, on a (B, H, W, 2) flow: each pixel's window of
    (2r+2)^2 corners from `corner_coords`, clipped to the image; per tile,
    the union's bounding box and the corner count; the shared-window path
    iff the features are bf16, radius >= SHARE_MIN_R, U > 0 and SHARE_U * U
    <= SHARE_CORNERS * corners (why only from r = 5: the note atop
    csrc/local_corr.cu)."""
    B, H, W, _ = flow.shape
    K2 = 2 * radius + 2
    x0, y0, _, _ = corner_coords(flow, H, W, radius)
    xa, ya = (x0 - radius).clamp(min=0), (y0 - radius).clamp(min=0)
    xb = (x0 - radius + K2 - 1).clamp(max=W - 1)
    yb = (y0 - radius + K2 - 1).clamp(max=H - 1)
    ok = (xa <= xb) & (ya <= yb)
    th, tw = -(-H // TILE), -(-W // TILE)
    pad = (0, tw * TILE - W, 0, th * TILE - H)

    def tiles(v, fill, reduce):
        v = torch.where(ok, v, torch.full_like(v, fill))
        v = torch.nn.functional.pad(v, pad, value=fill)
        return reduce(v.reshape(B, th, TILE, tw, TILE), dim=(2, 4))

    big = 1 << 30
    corners = tiles((xb - xa + 1) * (yb - ya + 1), 0, torch.sum)
    w = tiles(xb, -big, torch.amax) - tiles(xa, big, torch.amin) + 1
    h = tiles(yb, -big, torch.amax) - tiles(ya, big, torch.amin) + 1
    union = torch.where(corners > 0, w * h, torch.zeros_like(corners))
    shared = (union > 0) & (SHARE_U * union <= SHARE_CORNERS * corners)
    shared &= radius >= SHARE_MIN_R and dtype == torch.bfloat16
    return TilePlan(corners, union, shared)


def flops(f0, f1, radius, flow, out_shape=None) -> int:
    """What FlopCounterMode counts for the plain version, from the shapes:
    a dot of C for every (2r+2)^2 corner of every pixel, 2 B H W (2r+2)^2 C
    (out-of-range corners included; the bilinear combine is elementwise)."""
    B, H, W, C = f0
    return 2 * B * H * W * (2 * radius + 2) ** 2 * C


def local_correlation(
    f0: torch.Tensor, f1: torch.Tensor, radius: int, flow: torch.Tensor
) -> torch.Tensor:
    """The operator ``roma::local_corr``: (B,H,W,C) bf16 or float32 x2 +
    flow (B,H,W,2) -> (B,H,W,(2r+1)^2) float32. CPU tensors take the plain
    version; CUDA tensors launch the kernel's entry for their dtype. It has
    no backward (`use_kernel` keeps autograd off it)."""
    return op(f0, f1, radius, flow)


def local_correlation_cuda(
    f0: torch.Tensor, f1: torch.Tensor, radius: int, flow: torch.Tensor,
    tile_paths: torch.Tensor | None = None,
) -> torch.Tensor:
    """The kernel. `tile_paths`, an int32 (B, ceil(H/8), ceil(W/8)) tensor,
    receives 1 for each tile that took the shared-window path, 0 else: from
    r = 5 the bf16 per-pixel kernel writes it and the shared-window kernel
    reads it (allocated here when None); the float32 entry fills it with 0."""
    symbol = runtime.entry(NAME, ENTRIES, f0.dtype)
    f32 = f0.dtype == torch.float32
    B, H, W, C = f0.shape
    if C % 128 != 0 or C > 1024 or not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{NAME}: needs C % 128 == 0, C <= 1024, r <= 7 (C={C}, r={radius})")
    dev = f0.device
    runtime.require(NAME, f0, (B, H, W, C), f0.dtype, dev)
    runtime.require(NAME, f1, (B, H, W, C), f0.dtype, dev)
    runtime.require(NAME, flow, (B, H, W, 2), torch.float32, dev)
    if f0.data_ptr() % 16 or f1.data_ptr() % 16:
        raise ValueError(f"{NAME}: features must be 16-byte aligned")
    tiles = (B, -(-H // TILE), -(-W // TILE))
    scores = None
    if radius >= SHARE_MIN_R and not f32:  # room for the shared tiles' corner scores
        scores = torch.empty((B, H, W, (2 * radius + 2) ** 2), dtype=torch.float32, device=dev)
        if tile_paths is None:
            tile_paths = torch.empty(tiles, dtype=torch.int32, device=dev)
    if tile_paths is not None:
        runtime.require(NAME, tile_paths, tiles, torch.int32, dev)
    k = 2 * radius + 1
    out = torch.empty((B, H, W, k * k), dtype=torch.float32, device=dev)
    scale = (1.0 / torch.sqrt(torch.tensor(float(C), dtype=torch.float32))).item()
    lib = runtime.load(NAME)
    fn = getattr(lib, symbol)
    n_ptr = 5 if f32 else 6  # the float32 entry has no score buffer
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 5 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [f0.data_ptr(), f1.data_ptr(), flow.data_ptr(), out.data_ptr(),
            None if tile_paths is None else tile_paths.data_ptr()]
    if not f32:
        ptrs.append(None if scores is None else scores.data_ptr())
    rc = fn(*ptrs, B, H, W, C, radius, scale, runtime.stream_handle(f0))
    runtime.check(lib, NAME, rc)
    return out


op = runtime.define_op(
    NAME, "(Tensor f0, Tensor f1, int radius, Tensor flow) -> Tensor",
    local_correlation_cuda, local_correlation_plain,
    lambda f0, f1, radius, flow: f0.new_empty((*f0.shape[:3], (2 * radius + 1) ** 2),
                                              dtype=torch.float32),
    flops)
