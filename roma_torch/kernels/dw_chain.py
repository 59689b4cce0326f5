"""Chained narrow-channel refiner blocks (CUDA, ``csrc/dw_chain.cu``), their
plain PyTorch version and the wrapper.

Replaces the TPU kernel ``roma_tpu/ops/pallas/depthwise.py::dw5x5_mm_chain``.
One block is ``bf16(relu(dw5x5(x) * scale + shift))`` followed by a C x C 1x1
conv plus bias, rounded to bf16; the chain runs N blocks (the scale-1
refiner's block_in + 8 hidden blocks). The kernel launches once per block
and ping-pongs two NCHW buffers; it takes 1 <= C <= 64. Bound and design:
see the note at the top of the CUDA source (bytes; persistent blocks walk
TH x 32 pixel tiles, prefetching the next tile's halo by TMA, 4 x 4
depthwise patches per thread, the C x C mix on the tensor cores).
`tile_plan` mirrors the kernel's tile geometry and shared memory;
`pack_params` lays the weights out as the kernel reads them. A float32
chain goes to the float32 entry (`ENTRIES`; ``csrc/dw_block_f32.cuh``), one
simple FMA kernel a block with no bf16 rounding, as the plain version
computes for float32.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from roma_torch.kernels import runtime
from roma_torch.kernels.dw_affine_relu import dw5x5_affine_relu_plain_nchw

NAME = "dw_chain"
MAX_CHANNELS = 64
TILE_W = 32          # output columns of a tile
STAGE_W = TILE_W + 16  # staged halo row in bf16: 16-byte vectors from column x0 - 8
TAPS = 28            # fp32 per channel: 25 taps (dy, dx order), scale, shift, 0
ENTRIES = {torch.bfloat16: "roma_dw_block", torch.float32: "roma_dw_block_f32"}


def padded_channels(C: int) -> int:
    """Cp: C rounded up to a multiple of 16, the mix's k and n extent."""
    return -(-C // 16) * 16


@dataclass(frozen=True)
class TilePlan:
    """The kernel's tiling of a (B, C, H, W) block: tiles of `rows` x TILE_W
    output pixels, `tiles` = (across W, down H, B) of them, walked by
    persistent blocks; the halo keeps `rows` + 4 staged bf16 rows of
    STAGE_W and float rows of TILE_W + 4 per channel, float planes
    `plane_stride` floats apart; `smem_bytes` of shared memory a block."""

    cp: int
    rows: int
    tiles: tuple[int, int, int]
    plane_stride: int
    smem_bytes: int


@functools.lru_cache(maxsize=None)
def tile_plan(B: int, C: int, H: int, W: int) -> TilePlan:
    """8-row tiles for C <= 32 (two blocks share an SM at C = 24), 4-row
    tiles above. Raises for C outside 1..64. The shared memory, in the
    kernel's order: 128 bytes of slack to align the staged bf16 rows for
    TMA, the staged rows, float rows (the z tile goes over them), the y
    tile, M^T, bias, taps, and 16 bytes for the mbarrier."""
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{NAME}: needs 1 <= C <= {MAX_CHANNELS}, got {C}")
    cp = padded_channels(C)
    rows = 8 if cp <= 32 else 4
    n = -(-(rows + 4) * (TILE_W + 4) // 4)  # 16-byte units of a float plane
    plane_stride = 4 * (n if n % 2 else n + 1)  # an odd count: 8 planes in 8 bank groups
    smem = (128 + 2 * C * (rows + 4) * STAGE_W + 4 * C * plane_stride
            + 2 * rows * TILE_W * (cp + 8) + 2 * cp * (cp + 8) + 4 * cp + 4 * C * TAPS + 16)
    tiles = (-(-W // TILE_W), -(-H // rows), B)
    return TilePlan(cp, rows, tiles, plane_stride, smem)


def pack_params(ws, scales, shifts, ms, biases):
    """The chain's weights as the kernel reads them: taps (N, C, 28) fp32
    (25 taps in dy, dx order, scale, shift, 0), mt (N, Cp, Cp) bf16 with
    mt[j, d, c] = ms[j, c, d] and zeros past C, bias (N, Cp) fp32 with
    zeros past C."""
    N, C = ws.shape[0], ws.shape[-1]
    cp = padded_channels(C)
    taps = torch.zeros((N, C, TAPS), dtype=torch.float32, device=ws.device)
    taps[:, :, :25] = ws.reshape(N, 25, C).transpose(1, 2).float()
    taps[:, :, 25] = scales
    taps[:, :, 26] = shifts
    mt = torch.zeros((N, cp, cp), dtype=torch.bfloat16, device=ws.device)
    mt[:, :C, :C] = ms.transpose(1, 2)
    bias = torch.zeros((N, cp), dtype=torch.float32, device=ws.device)
    bias[:, :C] = biases
    return taps, mt, bias


def block_plain_nchw(x, w, scale, shift, m, bias):
    """One fused block, plain PyTorch, (B,C,H,W) -> (B,C,H,W). w (5,5,C),
    m (C,C) with z[d] = sum_c m[c, d] y[c]. Same rounding points as the
    JAX package's `_mm_reference`: the ReLU output and the block output are
    rounded to x's dtype; the sums are float32 (float64 for float64 x)."""
    y = dw5x5_affine_relu_plain_nchw(x, w, scale, shift)
    ct = runtime.compute_dtype(x)
    z = torch.einsum("bchw,cd->bdhw", y.to(ct), m.to(ct)) + bias.to(ct)[:, None, None]
    return z.to(x.dtype)


def chain_plain_nchw(x, ws, scales, shifts, ms, biases):
    for j in range(ws.shape[0]):
        x = block_plain_nchw(x, ws[j], scales[j], shifts[j], ms[j], biases[j])
    return x


def block_flops(x, w, scale, shift, m, bias, out_shape=None) -> int:
    """What FlopCounterMode counts for one block's plain version, from the
    shapes: the depthwise convolution, 2 B C H W 25, and the 1x1 mix,
    2 B H W C D (the affine, the ReLU and the bias are elementwise)."""
    B, C, H, W = x
    return 2 * B * C * H * W * w[0] * w[1] + 2 * B * H * W * m[0] * m[1]


def flops(x, ws, scales, shifts, ms, biases, out_shape=None) -> int:
    """`block_flops` for each of the chain's N blocks."""
    return ws[0] * block_flops(x, ws[1:], None, None, ms[1:], None)


def chain_nchw(x, ws, scales, shifts, ms, biases):
    """N chained blocks on (B,C,H,W) through the operator ``roma::dw_chain``:
    CPU tensors take the plain version, CUDA tensors launch the kernel once
    per block. It has no backward (the refiner's gate keeps autograd off
    it)."""
    return op(x, ws, scales, shifts, ms, biases)


@functools.cache
def _kernel(symbol: str = ENTRIES[torch.bfloat16]):
    lib = runtime.load(NAME)
    fn = getattr(lib, symbol)
    if symbol == ENTRIES[torch.float32]:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def chain_cuda_nchw(x, ws, scales, shifts, ms, biases):
    symbol = runtime.entry(NAME, ENTRIES, x.dtype)
    if x.dtype == torch.float32:
        return _chain_cuda_f32(symbol, x, ws, scales, shifts, ms, biases)
    B, C, H, W = x.shape
    N = ws.shape[0]
    plan = tile_plan(B, C, H, W)  # raises for C outside 1..64
    dev = x.device
    runtime.require(NAME, x, (B, C, H, W), torch.bfloat16, dev)
    runtime.require(NAME, ws, (N, 5, 5, C), torch.bfloat16, dev)
    runtime.require(NAME, ms, (N, C, C), torch.bfloat16, dev)
    for t in (scales, shifts, biases):
        runtime.require(NAME, t, (N, C), torch.float32, dev)
    taps, mt, bias = pack_params(ws, scales, shifts, ms, biases)
    lib, fn = _kernel()
    stream = runtime.stream_handle(x)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    src = x
    for j in range(N):
        dst = bufs[j % 2]
        rc = fn(src.data_ptr(), dst.data_ptr(), taps[j].data_ptr(), mt[j].data_ptr(),
                bias[j].data_ptr(), B, C, H, W, plan.smem_bytes, stream)
        runtime.check(lib, NAME, rc)
        src = dst
    return src


def _chain_cuda_f32(symbol, x, ws, scales, shifts, ms, biases):
    """The float32 chain: one launch of the float32 entry a block."""
    B, C, H, W = x.shape
    N = ws.shape[0]
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{NAME}: needs 1 <= C <= {MAX_CHANNELS}, got {C}")
    dev = x.device
    runtime.require(NAME, x, (B, C, H, W), torch.float32, dev)
    runtime.require(NAME, ws, (N, 5, 5, C), torch.float32, dev)
    runtime.require(NAME, ms, (N, C, C), torch.float32, dev)
    for t in (scales, shifts, biases):
        runtime.require(NAME, t, (N, C), torch.float32, dev)
    lib, fn = _kernel(symbol)
    stream = runtime.stream_handle(x)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    src = x
    for j in range(N):
        dst = bufs[j % 2]
        rc = fn(src.data_ptr(), dst.data_ptr(), ws[j].data_ptr(), scales[j].data_ptr(),
                shifts[j].data_ptr(), ms[j].data_ptr(), biases[j].data_ptr(), B, C, H, W, stream)
        runtime.check(lib, NAME, rc)
        src = dst
    return src


op = runtime.define_op(
    NAME, "(Tensor x, Tensor ws, Tensor scales, Tensor shifts, Tensor ms, Tensor biases) -> Tensor",
    chain_cuda_nchw, chain_plain_nchw,
    lambda x, ws, scales, shifts, ms, biases: torch.empty_like(
        x, memory_format=torch.contiguous_format),
    flops)


def dw5x5_mm_chain(x, ws, scales, shifts, ms, biases):
    """JAX-layout entry: x (B,H,W,C); ws (N,5,5,C); scales/shifts/biases
    (N,C); ms (N,C,C). Returns (B,H,C,W), as the JAX function does."""
    y = chain_nchw(x.permute(0, 3, 1, 2).contiguous(), ws, scales, shifts, ms, biases)
    return y.permute(0, 2, 1, 3)
