"""One whole depthwise-separable refiner block in one launch (CUDA,
``csrc/dw_block_mm.cu``) and its wrappers; the plain version is
`dw_chain.block_plain_nchw`.

Replaces the TPU kernel ``roma_tpu/ops/pallas/depthwise.py::
dw5x5_affine_relu_mm``: ``bf16(relu(dw5x5(x) * scale + shift))`` followed by
the C x C 1x1 mix plus bias, rounded to bf16, for C = D <= 160. As in the
JAX package no model path calls it (the JAX refiner measured and rejected
it for scale 2); the tests and `chip_smoke.py` reach it. Bound and design:
see the note at the top of the CUDA source (bytes; the depthwise part per
16-channel chunk into a shared-memory y tile, the mix on the tensor cores).

Its backward is the plain version's (`runtime.PlainBackward`), as the JAX
`custom_vjp` is its reference's VJP.
"""

from __future__ import annotations

import ctypes

import torch

from roma_torch.kernels import runtime
from roma_torch.kernels.dw_chain import block_plain_nchw

NAME = "dw_block_mm"
MAX_CHANNELS = 160


def dw5x5_affine_relu_mm_nchw(x, w, scale, shift, m, bias):
    """The block on (B,C,H,W) -> (B,C,H,W); w (5,5,C), m (C,C) with
    z[d] = sum_c m[c, d] y[c]. CPU tensors take the plain version, CUDA
    tensors launch the kernel, differentiable through the plain version."""
    if x.device.type == "cpu":
        return block_plain_nchw(x, w, scale, shift, m, bias)
    return runtime.with_plain_backward(dw5x5_affine_relu_mm_cuda_nchw, block_plain_nchw,
                                       x, w, scale, shift, m, bias)


def dw5x5_affine_relu_mm_cuda_nchw(x, w, scale, shift, m, bias):
    B, C, H, W = x.shape
    if not 1 <= C <= MAX_CHANNELS:
        raise ValueError(f"{NAME}: needs 1 <= C <= {MAX_CHANNELS}, got {C}")
    dev = x.device
    runtime.require(NAME, x, (B, C, H, W), torch.bfloat16, dev)
    runtime.require(NAME, w, (5, 5, C), torch.bfloat16, dev)
    runtime.require(NAME, m, (C, C), torch.bfloat16, dev, contiguous=False)
    for t in (scale, shift, bias):
        runtime.require(NAME, t, (C,), torch.float32, dev)
    cp = -(-C // 16) * 16
    mt = torch.zeros((cp, cp), dtype=torch.bfloat16, device=dev)
    mt[:C, :C] = m.T
    z = torch.empty_like(x)
    lib = runtime.load(NAME)
    fn = lib.roma_dw_block_mm
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x.data_ptr(), z.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            mt.data_ptr(), bias.data_ptr(), B, C, H, W, runtime.stream_handle(x))
    runtime.check(lib, NAME, rc)
    return z


def dw5x5_affine_relu_mm(x, w, scale, shift, m, bias):
    """JAX-layout entry: x (B,H,C,W) width-major -> (B,H,D,W), D == C, as
    the JAX function takes and returns it."""
    y = dw5x5_affine_relu_mm_nchw(x.permute(0, 2, 1, 3).contiguous(), w, scale, shift, m, bias)
    return y.permute(0, 2, 1, 3)
