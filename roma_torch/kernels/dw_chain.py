"""Chained narrow-channel refiner blocks (CUDA, ``csrc/dw_chain.cu``), their
plain PyTorch version and the wrapper.

Replaces the TPU kernel ``roma_tpu/ops/pallas/depthwise.py::dw5x5_mm_chain``.
One block is ``bf16(relu(dw5x5(x) * scale + shift))`` followed by a C x C 1x1
conv plus bias, rounded to bf16; the chain runs N blocks (the scale-1
refiner's block_in + 8 hidden blocks). The kernel launches once per block
and ping-pongs two NCHW buffers. Bound and design: see the note at the top
of the CUDA source (bytes; one thread per pixel, halo tile and weights in
shared memory, the depthwise sums and the 1x1 mix kept in registers).
"""

from __future__ import annotations

import ctypes

import torch

from roma_torch.kernels import runtime
from roma_torch.kernels.dw_affine_relu import dw5x5_affine_relu_plain_nchw

NAME = "dw_chain"
CHANNELS = (8, 16, 24, 32)


def block_plain_nchw(x, w, scale, shift, m, bias):
    """One fused block, plain PyTorch, (B,C,H,W) -> (B,C,H,W). w (5,5,C),
    m (C,C) with z[d] = sum_c m[c, d] y[c]. Same rounding points as the
    JAX package's `_mm_reference`: the ReLU output and the block output are
    rounded to x's dtype; the sums are float32."""
    y = dw5x5_affine_relu_plain_nchw(x, w, scale, shift)
    z = torch.einsum("bchw,cd->bdhw", y.float(), m.float()) + bias.float()[:, None, None]
    return z.to(x.dtype)


def chain_plain_nchw(x, ws, scales, shifts, ms, biases):
    for j in range(ws.shape[0]):
        x = block_plain_nchw(x, ws[j], scales[j], shifts[j], ms[j], biases[j])
    return x


def chain_nchw(x, ws, scales, shifts, ms, biases):
    """N chained blocks on (B,C,H,W); CPU tensors take the plain version,
    CUDA tensors launch the kernel once per block."""
    if x.device.type == "cpu":
        return chain_plain_nchw(x, ws, scales, shifts, ms, biases)
    return chain_cuda_nchw(x, ws, scales, shifts, ms, biases)


def chain_cuda_nchw(x, ws, scales, shifts, ms, biases):
    B, C, H, W = x.shape
    N = ws.shape[0]
    if C not in CHANNELS:
        raise ValueError(f"{NAME}: C must be one of {CHANNELS}, got {C}")
    dev = x.device
    runtime.require(NAME, x, (B, C, H, W), torch.bfloat16, dev)
    runtime.require(NAME, ws, (N, 5, 5, C), torch.bfloat16, dev)
    runtime.require(NAME, ms, (N, C, C), torch.bfloat16, dev)
    for t in (scales, shifts, biases):
        runtime.require(NAME, t, (N, C), torch.float32, dev)
    lib = runtime.load(NAME)
    fn = lib.roma_dw_block
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = runtime.stream_handle(x)
    bufs = [torch.empty_like(x), torch.empty_like(x)]
    src = x
    for j in range(N):
        dst = bufs[j % 2]
        rc = fn(src.data_ptr(), dst.data_ptr(), ws[j].data_ptr(), scales[j].data_ptr(),
                shifts[j].data_ptr(), ms[j].data_ptr(), biases[j].data_ptr(),
                B, C, H, W, stream)
        runtime.check(lib, NAME, rc)
        src = dst
    return src


def dw5x5_mm_chain(x, ws, scales, shifts, ms, biases):
    """JAX-layout entry: x (B,H,W,C); ws (N,5,5,C); scales/shifts/biases
    (N,C); ms (N,C,C). Returns (B,H,C,W), as the JAX function does."""
    y = chain_nchw(x.permute(0, 3, 1, 2).contiguous(), ws, scales, shifts, ms, biases)
    return y.permute(0, 2, 1, 3)
