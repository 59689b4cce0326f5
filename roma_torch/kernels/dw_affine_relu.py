"""Wide-channel depthwise refiner block without its 1x1 (CUDA,
``csrc/dw_affine_relu.cu``), its plain PyTorch version and the wrappers.

Replaces the TPU kernel ``roma_tpu/ops/pallas/depthwise.py::
dw5x5_affine_relu``: ``x.dtype(relu(dw5x5(x, w) * scale + shift))`` with
float32 sums and zeros padding 2. The port's `DWBlock` runs it for every
non-chained block of the wide refiners (scales 16/8/4/2). Bound and design:
see the note at the top of the CUDA source (bytes; one block per band of
whole rows, or per 1-8 whole small planes, read as one contiguous range
with 16-byte vector loads). `band_plan` chooses the bands.

Its backward is the plain version's (`runtime.PlainBackward`), as the JAX
function's `custom_vjp` is its plain reference's VJP.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from roma_torch.kernels import runtime

NAME = "dw_affine_relu"
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
SMEM_BUDGET = 72 * 1024  # bytes a block aims for: three blocks share an SM
SMEM_MAX = 232448        # bytes a block may use on the H100 (227 KB)
TAPS = 28                # floats per plane: 25 taps, scale, shift, padding
THREADS = 256            # a block's threads, each computing 4 x 4 output patches
# A round (every thread one patch) costs 16 output slots a thread; reading
# an element costs about half a slot (its 2 bytes at 3.35 TB/s against the
# ~35 instructions an output issues on the H100).
ROUND_COST = 16 * THREADS
READ_COST = 0.5


def _up4(v: int) -> int:
    return (v + 3) // 4 * 4


@dataclass(frozen=True)
class BandPlan:
    """How the kernel cuts (H, W) planes: bands of `rows` output rows (the
    last may be shorter), `planes` whole planes per block where a plane is
    one band, and `smem_bytes` of shared memory per block (`plan_bytes`)."""

    rows: int
    planes: int
    smem_bytes: int


def plan_bytes(W: int, rows: int, planes: int) -> int:
    """Shared memory of a block, as the kernel lays it out: `planes` float
    tiles of (round_up(rows, 4) + 4) x (round_up(W, 4) + 4), then TAPS
    floats for each plane."""
    return 4 * planes * ((_up4(rows) + 4) * (_up4(W) + 4) + TAPS)


@functools.lru_cache(maxsize=None)
def band_plan(H: int, W: int) -> BandPlan:
    """The cheapest cut within SMEM_BUDGET, per plane: 1-8 whole planes to a
    block where one fits, or bands of `rows` (a multiple of 4). A block
    runs ceil(patches / threads per plane) rounds of 4 x 4 patches; the
    cost is ROUND_COST per round plus READ_COST per element read (a band's
    2-row halos are read twice). Raises if even a 4-row band needs more
    shared memory than a block has."""
    nbytes = lambda rows, planes: plan_bytes(W, rows, planes)
    gx = _up4(W) // 4  # patches across a row
    best = None
    if nbytes(H, 1) <= SMEM_BUDGET:
        patches = gx * (_up4(H) // 4)
        for planes in range(1, 9):
            if nbytes(H, planes) > SMEM_BUDGET:
                break
            rounds = math.ceil(patches / (THREADS // planes))
            best = min(best or (math.inf,), (rounds * ROUND_COST / planes + READ_COST * H * W,
                                              H, planes))
    for rows in range(4, H, 4):
        if nbytes(rows, 1) > SMEM_BUDGET:
            break
        bands = [min(rows, H - y0) for y0 in range(0, H, rows)]
        rounds = sum(math.ceil(gx * (_up4(b) // 4) / THREADS) for b in bands)
        cost = rounds * ROUND_COST + READ_COST * (H + 4 * (len(bands) - 1)) * W
        best = min(best or (math.inf,), (cost, rows, 1))
    _, rows, planes = best if best is not None else (0, min(H, 4), 1)
    smem = nbytes(rows, planes)
    if smem > SMEM_MAX:
        raise ValueError(f"{NAME}: planes {W} wide need {smem} bytes of shared memory "
                         f"for a 4-row band, more than {SMEM_MAX}")
    return BandPlan(rows, planes, smem)


@functools.cache
def _kernel():
    lib = runtime.load(NAME)
    fn = lib.roma_dw_affine_relu
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def dw5x5_affine_relu_plain_nchw(x, w, scale, shift):
    """(B,C,H,W) -> (B,C,H,W) in x's dtype; w (k,k,C) (k = 5 on the kernel
    path), scale/shift (C,) float32. Float32 (float64 for float64 x) conv
    of x's values, `* scale`, `+ shift` as two separate operations, ReLU, one
    rounding to x's dtype."""
    C, k, ct = x.shape[1], w.shape[0], runtime.compute_dtype(x)
    y = F.conv2d(x.to(ct), w.to(ct).permute(2, 0, 1)[:, None], padding=k // 2, groups=C)
    y = y * scale.to(ct)[:, None, None] + shift.to(ct)[:, None, None]
    return torch.relu(y).to(x.dtype)


def flops(x, w, scale, shift, out_shape=None) -> int:
    """What FlopCounterMode counts for the plain version, from the shapes:
    the depthwise convolution, 2 B C H W k^2 (the affine and the ReLU are
    elementwise)."""
    B, C, H, W = x
    return 2 * B * C * H * W * w[0] * w[1]


def dw5x5_affine_relu_nchw(x, w, scale, shift):
    """The block on (B,C,H,W) through the operator ``roma::dw_affine_relu``
    (CPU tensors take the plain version, CUDA tensors launch the kernel),
    differentiable through the plain version."""
    return runtime.with_plain_backward(op, dw5x5_affine_relu_plain_nchw, x, w, scale, shift)


def dw5x5_affine_relu_cuda_nchw(x, w, scale, shift):
    B, C, H, W = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{NAME}: x must be bfloat16 or float32, got {x.dtype}")
    dev = x.device
    runtime.require(NAME, x, (B, C, H, W), x.dtype, dev)
    runtime.require(NAME, w, (5, 5, C), x.dtype, dev)
    runtime.require(NAME, scale, (C,), torch.float32, dev)
    runtime.require(NAME, shift, (C,), torch.float32, dev)
    if x.data_ptr() % 16:
        raise ValueError(f"{NAME}: x must start on a 16-byte boundary")
    plan = band_plan(H, W)
    y = torch.empty_like(x)
    lib, fn = _kernel()
    rc = fn(x.data_ptr(), y.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(),
            B, C, H, W, plan.rows, plan.planes, plan.smem_bytes, _DTYPE_CODES[x.dtype],
            runtime.stream_handle(x))
    runtime.check(lib, NAME, rc)
    return y


op = runtime.define_op(
    NAME, "(Tensor x, Tensor w, Tensor scale, Tensor shift) -> Tensor",
    dw5x5_affine_relu_cuda_nchw, dw5x5_affine_relu_plain_nchw,
    lambda x, w, scale, shift: torch.empty_like(x, memory_format=torch.contiguous_format),
    flops)


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
