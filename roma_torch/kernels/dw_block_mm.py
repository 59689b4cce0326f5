"""One whole depthwise-separable refiner block in one launch (CUDA,
``csrc/dw_block_mm.cu``) and its wrappers; the plain version is
`dw_chain.block_plain_nchw`.

Replaces the TPU kernel ``roma_tpu/ops/pallas/depthwise.py::
dw5x5_affine_relu_mm``: ``bf16(relu(dw5x5(x) * scale + shift))`` followed by
the C x C 1x1 mix plus bias, rounded to bf16, for C = D <= 160. As in the
JAX package no model path calls it (the JAX refiner measured and rejected
it for scale 2); the tests and `chip_smoke.py` reach it. Bound and design:
see the note at the top of the CUDA source (bytes; persistent blocks walk
8 x 32 pixel tiles, staging M^T from `m` once, the halo 16 channels at a
time by cp.async, the mix on the tensor cores, z out as 16-byte vectors).
`tile_plan` mirrors the kernel's tiling and shared memory.

Its backward is the plain version's (`runtime.PlainBackward`), as the JAX
`custom_vjp` is its reference's VJP. A float32 block goes to the float32
entry (`ENTRIES`; ``csrc/dw_block_f32.cuh``): a simple FMA kernel with no
bf16 rounding, as the plain version computes for float32.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from roma_torch.kernels import runtime
from roma_torch.kernels.dw_chain import block_plain_nchw, padded_channels
from roma_torch.kernels.dw_chain import block_flops as flops  # one block's

NAME = "dw_block_mm"
MAX_CHANNELS = 160
TILE_H, TILE_W = 8, 32   # a tile's rows (one a warp in the mix) and columns
PATCHES = TILE_H * TILE_W // 16  # 4 x 4 depthwise patches of a tile
THREADS = 256
CHUNK = THREADS // PATCHES  # channels of the halo staged at a time: an item a thread
HALO_UNITS = 6           # 16-byte units of a halo row: columns x0 - 8 .. x0 + 39
TAPS = 28                # fp32 per channel in shared memory: 25 taps, scale, shift, 0
ENTRIES = {torch.bfloat16: "roma_dw_block_mm", torch.float32: "roma_dw_block_mm_f32"}


@dataclass(frozen=True)
class TilePlan:
    """The kernel's tiling of a (B, C, H, W) block: `tiles` = (across W,
    down H, B) tiles of TILE_H x TILE_W pixels, walked by persistent blocks;
    the halo in `chunks` of CHUNK channels; `smem_bytes` of shared memory a
    block."""

    cp: int
    tiles: tuple[int, int, int]
    chunks: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def tile_plan(B: int, C: int, H: int, W: int) -> TilePlan:
    """Raises for C outside 1..160. The shared memory, in the kernel's order:
    two halo buffers (CHUNK channel planes of (TILE_H + 4) x HALO_UNITS
    16-byte units, plus one unit so that planes start in distinct bank
    groups), M^T and the y tile (rows of Cp + 8 bf16), one 16 x TILE_W bf16
    z tile a warp, the taps and the bias."""
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{NAME}: needs 1 <= C <= {MAX_CHANNELS}, got {C}")
    cp = padded_channels(C)
    plane = (TILE_H + 4) * HALO_UNITS + 1
    ld = cp + 8
    smem = (2 * CHUNK * plane * 16 + 2 * cp * ld + 2 * TILE_H * TILE_W * ld
            + 2 * (THREADS // 32) * 16 * TILE_W + 4 * C * TAPS + 4 * cp)
    tiles = (-(-W // TILE_W), -(-H // TILE_H), B)
    return TilePlan(cp, tiles, -(-C // CHUNK), smem)


def dw5x5_affine_relu_mm_nchw(x, w, scale, shift, m, bias):
    """The block on (B,C,H,W) -> (B,C,H,W); w (5,5,C), m (C,C) with
    z[d] = sum_c m[c, d] y[c]. Through the operator ``roma::dw_block_mm``
    (CPU tensors take the plain version, CUDA tensors launch the kernel),
    differentiable through the plain version."""
    return runtime.with_plain_backward(op, block_plain_nchw, x, w, scale, shift, m, bias)


@functools.cache
def _kernel(symbol: str = ENTRIES[torch.bfloat16]):
    lib = runtime.load(NAME)
    fn = getattr(lib, symbol)
    n_int = 4 if symbol == ENTRIES[torch.float32] else 5  # no shared-memory size
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def dw5x5_affine_relu_mm_cuda_nchw(x, w, scale, shift, m, bias):
    symbol = runtime.entry(NAME, ENTRIES, x.dtype)
    B, C, H, W = x.shape
    plan = tile_plan(B, C, H, W)  # raises for C outside 1..160
    dev = x.device
    runtime.require(NAME, x, (B, C, H, W), x.dtype, dev)
    runtime.require(NAME, w, (5, 5, C), x.dtype, dev)
    runtime.require(NAME, m, (C, C), x.dtype, dev)
    for t in (scale, shift, bias):
        runtime.require(NAME, t, (C,), torch.float32, dev)
    z = torch.empty_like(x)
    lib, fn = _kernel(symbol)
    args = [x.data_ptr(), z.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            m.data_ptr(), bias.data_ptr(), B, C, H, W]
    if x.dtype == torch.bfloat16:
        args.append(plan.smem_bytes)
    rc = fn(*args, runtime.stream_handle(x))
    runtime.check(lib, NAME, rc)
    return z


op = runtime.define_op(
    NAME, "(Tensor x, Tensor w, Tensor scale, Tensor shift, Tensor m, Tensor bias) -> Tensor",
    dw5x5_affine_relu_mm_cuda_nchw, block_plain_nchw,
    lambda x, w, scale, shift, m, bias: torch.empty_like(
        x, memory_format=torch.contiguous_format),
    flops)


def dw5x5_affine_relu_mm(x, w, scale, shift, m, bias):
    """JAX-layout entry: x (B,H,C,W) width-major -> (B,H,D,W), D == C, as
    the JAX function takes and returns it."""
    y = dw5x5_affine_relu_mm_nchw(x.permute(0, 2, 1, 3).contiguous(), w, scale, shift, m, bias)
    return y.permute(0, 2, 1, 3)
