"""Streaming correlation softmax (CUDA, ``csrc/corr_softmax.cu``), its plain
PyTorch version and the wrapper.

Replaces the TPU kernel ``roma_tpu/ops/pallas/corr_softmax.py::
fused_pos_embed``: for every target position p,
``warp[p] = sum_j softmax_j(<f0[p], f1[j]> / sqrt(C)) * grid[j]``, without
the (L0, L1) correlation volume. Bound and design: see the note at the top
of the CUDA source (operations: the products and one exponential a score;
flash-attention streaming, bf16 features scored on the tensor cores by
mma.sync, fp32 features on the CUDA cores).
"""

from __future__ import annotations

import ctypes
import math

import torch

from roma_torch.kernels import runtime

NAME = "corr_softmax"
CHANNELS = (16, 32, 64)


def fused_pos_embed_plain(f0: torch.Tensor, f1: torch.Tensor,
                          grid: torch.Tensor) -> torch.Tensor:
    """(B,L0,C), (B,L1,C), (L1,2) -> (B,L0,2) float32: the correlation
    volume, its softmax over L1, and the product with the grid."""
    cv = torch.bmm(f0.float(), f1.float().transpose(1, 2)) / math.sqrt(f0.shape[-1])
    return torch.softmax(cv, dim=-1) @ grid.float()


def flops(f0, f1, grid, out_shape=None) -> int:
    """What FlopCounterMode counts for the plain version, from the shapes:
    the scores, 2 B L0 L1 C, and the product with the grid, 2 B L0 L1 2."""
    B, L0, C = f0
    L1 = f1[1]
    return 2 * B * L0 * L1 * C + 2 * B * L0 * L1 * grid[1]


def fused_pos_embed(f0: torch.Tensor, f1: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The operator ``roma::corr_softmax``: CPU tensors take the plain
    version; CUDA tensors launch the kernel's entry for their dtype (bf16
    or float32). It has no backward: its callers take the plain version
    where autograd records."""
    return op(f0, f1, grid)


# features' dtype -> the kernel's C entry
ENTRIES = {torch.bfloat16: "roma_corr_softmax_bf16", torch.float32: "roma_corr_softmax"}


def fused_pos_embed_cuda(f0: torch.Tensor, f1: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    B, L0, C = f0.shape
    L1 = f1.shape[1]
    if C not in CHANNELS or L1 < 1:
        raise ValueError(f"{NAME}: C must be one of {CHANNELS} and L1 >= 1 (C={C}, L1={L1})")
    if f0.dtype not in ENTRIES:
        raise TypeError(f"{NAME}: features must be bfloat16 or float32, got {f0.dtype}")
    dev = f0.device
    runtime.require(NAME, f0, (B, L0, C), f0.dtype, dev)
    runtime.require(NAME, f1, (B, L1, C), f0.dtype, dev)
    runtime.require(NAME, grid, (L1, 2), torch.float32, dev)
    if f0.data_ptr() % 16 or f1.data_ptr() % 16 or grid.data_ptr() % 8:
        raise ValueError(f"{NAME}: features must be 16-byte aligned, the grid 8-byte aligned")
    out = torch.empty((B, L0, 2), dtype=torch.float32, device=dev)
    lib = runtime.load(NAME)
    fn = getattr(lib, ENTRIES[f0.dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scale_log2 = math.log2(math.e) / math.sqrt(C)
    rc = fn(f0.data_ptr(), f1.data_ptr(), grid.data_ptr(), out.data_ptr(), B, L0, L1, C,
            scale_log2, runtime.stream_handle(f0))
    runtime.check(lib, NAME, rc)
    return out


op = runtime.define_op(
    NAME, "(Tensor f0, Tensor f1, Tensor grid) -> Tensor", fused_pos_embed_cuda,
    fused_pos_embed_plain,
    lambda f0, f1, grid: f0.new_empty((f0.shape[0], f0.shape[1], 2), dtype=torch.float32),
    flops)
