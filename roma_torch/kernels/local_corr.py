"""Local correlation kernel (CUDA, ``csrc/local_corr.cu``) and its wrapper.

Replaces the TPU kernel ``roma_tpu/ops/pallas/block_gather.py::
local_correlation_dma``. Its plain PyTorch version is
``roma_torch.ops.local_corr.local_correlation`` (the (2r+2)^2-corner
formulation), imported here as `local_correlation_plain`. Bound and design:
see the note at the top of the CUDA source (bytes; one warp per pixel,
f0 in registers, corner dots and the bilinear combine fused).
"""

from __future__ import annotations

import ctypes

import torch

from roma_torch.kernels import runtime
from roma_torch.ops.local_corr import local_correlation as local_correlation_plain

NAME = "local_corr"
MAX_RADIUS = 7


def use_kernel(radius: int, channels: int) -> bool:
    """The refiner's gate (the port is inference-only): radius <= 7 and C a
    multiple of 128."""
    return radius <= MAX_RADIUS and channels % 128 == 0


def local_correlation(
    f0: torch.Tensor, f1: torch.Tensor, radius: int, flow: torch.Tensor
) -> torch.Tensor:
    """(B,H,W,C) bf16 x2 + flow (B,H,W,2) -> (B,H,W,(2r+1)^2) float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if f0.device.type == "cpu":
        return local_correlation_plain(f0, f1, radius, flow)
    return local_correlation_cuda(f0, f1, radius, flow)


def local_correlation_cuda(
    f0: torch.Tensor, f1: torch.Tensor, radius: int, flow: torch.Tensor
) -> torch.Tensor:
    B, H, W, C = f0.shape
    if C % 128 != 0 or C > 1024 or not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{NAME}: needs C % 128 == 0, C <= 1024, r <= 7 (C={C}, r={radius})")
    dev = f0.device
    runtime.require(NAME, f0, (B, H, W, C), torch.bfloat16, dev)
    runtime.require(NAME, f1, (B, H, W, C), torch.bfloat16, dev)
    runtime.require(NAME, flow, (B, H, W, 2), torch.float32, dev)
    k = 2 * radius + 1
    out = torch.empty((B, H, W, k * k), dtype=torch.float32, device=dev)
    scale = (1.0 / torch.sqrt(torch.tensor(float(C), dtype=torch.float32))).item()
    lib = runtime.load(NAME)
    fn = lib.roma_local_corr
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(f0.data_ptr(), f1.data_ptr(), flow.data_ptr(), out.data_ptr(),
            B, H, W, C, radius, scale, runtime.stream_handle(f0))
    runtime.check(lib, NAME, rc)
    return out
