"""Wide-channel depthwise refiner block without its 1x1 (CUDA,
``csrc/dw_affine_relu.cu``), its plain PyTorch version and the wrappers.

Replaces the TPU kernel ``roma_tpu/ops/pallas/depthwise.py::
dw5x5_affine_relu``: ``x.dtype(relu(dw5x5(x, w) * scale + shift))`` with
float32 sums and zeros padding 2. The port's `DWBlock` runs it for every
non-chained block of the wide refiners (scales 16/8/4/2). Bound and design:
see the note at the top of the CUDA source (bytes; one block per 16 x 64
tile of one plane, halo in shared memory, taps in registers).

Inference only: no backward. The JAX function's `custom_vjp` is its plain
reference's VJP; training is a later module of the port.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from roma_torch.kernels import runtime

NAME = "dw_affine_relu"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def dw5x5_affine_relu_plain_nchw(x, w, scale, shift):
    """(B,C,H,W) -> (B,C,H,W) in x's dtype; w (k,k,C) (k = 5 on the kernel
    path), scale/shift (C,) float32. Float32 conv of x's values, `* scale`,
    `+ shift` as two separate operations, ReLU, one rounding to x's dtype."""
    C, k = x.shape[1], w.shape[0]
    y = F.conv2d(x.float(), w.float().permute(2, 0, 1)[:, None], padding=k // 2, groups=C)
    y = y * scale.float()[:, None, None] + shift.float()[:, None, None]
    return torch.relu(y).to(x.dtype)


def dw5x5_affine_relu_nchw(x, w, scale, shift):
    """The block on (B,C,H,W); CPU tensors take the plain version, CUDA
    tensors launch the kernel."""
    if x.device.type == "cpu":
        return dw5x5_affine_relu_plain_nchw(x, w, scale, shift)
    return dw5x5_affine_relu_cuda_nchw(x, w, scale, shift)


def dw5x5_affine_relu_cuda_nchw(x, w, scale, shift):
    B, C, H, W = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{NAME}: x must be bfloat16 or float32, got {x.dtype}")
    dev = x.device
    runtime.require(NAME, x, (B, C, H, W), x.dtype, dev)
    runtime.require(NAME, w, (5, 5, C), x.dtype, dev)
    runtime.require(NAME, scale, (C,), torch.float32, dev)
    runtime.require(NAME, shift, (C,), torch.float32, dev)
    y = torch.empty_like(x)
    lib = runtime.load(NAME)
    fn = lib.roma_dw_affine_relu
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            B, C, H, W, _DTYPE_CODES[x.dtype], runtime.stream_handle(x))
    runtime.check(lib, NAME, rc)
    return y


def dw5x5_affine_relu(x, w, scale, shift, data_format: str = "NHWC"):
    """JAX-layout entry: x (B,H,W,C) for "NHWC" or (B,H,C,W) for "NHCW",
    returned in the same layout, as the JAX function does."""
    if data_format == "NHWC":
        y = dw5x5_affine_relu_nchw(x.permute(0, 3, 1, 2).contiguous(), w, scale, shift)
        return y.permute(0, 2, 3, 1)
    if data_format == "NHCW":
        y = dw5x5_affine_relu_nchw(x.permute(0, 2, 1, 3).contiguous(), w, scale, shift)
        return y.permute(0, 2, 1, 3)
    raise ValueError(f"data_format must be 'NHWC' or 'NHCW', got {data_format!r}")
