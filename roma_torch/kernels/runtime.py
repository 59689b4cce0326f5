"""Build and load the hand-written CUDA kernels.

Each source under ``roma_torch/csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, at first
use, into ``build/kernels/`` at the repo root, and loaded with ctypes. The
library name carries a hash of the flags, the source and every shared
header, so an edited source or header is rebuilt and a stale library is
never loaded. Nothing here runs at import
time: the package imports on machines without ``nvcc`` or a GPU.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and nowhere else; ``flash_attn_bwd.cu`` holds two kernels, counted apart as
``flash_attn_dkv`` (K8) and ``flash_attn_dq`` (K9). Attention has a
backward of its own (those two kernels, `kernels/attention.py`). Of the
rest, `grad_needed` is the gates' test for a forward that autograd records
(the kernels of local correlation, the chained blocks, the windowed gather
and the correlation softmax then give way to their plain versions, as the
JAX package routes them only when not training), and `PlainBackward`
differentiates the depthwise blocks through their plain versions, as the
JAX package's custom_vjp's do.

Each forward kernel is a PyTorch operator in the ``roma::`` namespace
(`define_op`): its CUDA implementation launches the kernel, its CPU
implementation is the plain version, its fake implementation gives the
output's shape and dtype without touching data, and its FLOP formula counts
what `torch.utils.flop_counter.FlopCounterMode` counts for the plain version
(2 per multiply-add of its matrix products and convolutions). So
`torch.export` and `FlopCounterMode` see a launch as one op, as `jax.export`
and XLA's cost analysis see a `pallas_call`. A wrapper calls the operator
wherever autograd does not record the call; the operator has no autograd
formula (a backward through it raises), and no implementation for any other
device: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

# kernel name -> CUDA source under csrc/
SOURCES = {
    "local_corr": "local_corr.cu",
    "dw_chain": "dw_chain.cu",
    "flash_attn": "flash_attn.cu",
    "corr_softmax": "corr_softmax.cu",
    "windowed_sample": "windowed_sample.cu",
    "dw_affine_relu": "dw_affine_relu.cu",
    "dw_block_mm": "dw_block_mm.cu",
    "flash_attn_bwd": "flash_attn_bwd.cu",
    "kde": "kde.cu",
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
    "-Xptxas", "-v",  # registers, shared memory and spills, in build()'s report
]

# launch counters: one a source, but flash_attn_bwd.cu's two kernels apart
COUNTERS = [n for n in SOURCES if n != "flash_attn_bwd"] + ["flash_attn_dkv", "flash_attn_dq"]
LAUNCHES: dict[str, int] = {name: 0 for name in COUNTERS}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("roma_torch kernels: nvcc not found (CUDA toolkit required)")
    return path


def lib_path(name: str) -> Path:
    """The library's path, named by a hash of the full flag list, the
    source and every header under csrc/ (any of which it may include), so
    that an edit to any of them rebuilds it."""
    h = hashlib.sha1("\0".join(NVCC_FLAGS).encode())
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"libroma_{name}-{h.hexdigest()[:12]}.so"


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns the compiler's
    report for each source it compiled; raises with the compiler's output
    if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    reports, failures = {}, []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode})\n{text}")
            continue
        os.replace(tmp, out)
        reports[name] = text
    if failures:
        raise RuntimeError("roma_torch kernel build failed:\n" + "\n".join(failures))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            lib.roma_error_string.restype = ctypes.c_char_p
            lib.roma_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if the launch failed, else count it under `name`."""
    if rc != 0:
        msg = lib.roma_error_string(rc).decode()
        raise RuntimeError(f"roma_torch kernel {name}: launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1


def entry(name: str, entries: dict, dtype: torch.dtype) -> str:
    """The C entry a wrapper launches for `dtype` (one of `entries`, dtype ->
    symbol); any other dtype raises, so that a wrapper never casts."""
    if dtype not in entries:
        kinds = ", ".join(str(d) for d in entries)
        raise TypeError(f"roma_torch kernel {name}: takes {kinds}, got {dtype}")
    return entries[dtype]


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    # by device index: the lookup by torch.device costs twice as much host
    # time, which the smallest kernels' launches cannot spare
    return ctypes.c_void_p(torch.cuda.current_stream(t.device.index).cuda_stream)


def require(name: str, t: torch.Tensor, shape, dtype: torch.dtype,
            device: torch.device, contiguous: bool = True) -> None:
    """Device, dtype, shape and layout checks shared by the wrappers."""
    if t.device != device or device.type != "cuda":
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def grad_needed(*tensors: torch.Tensor) -> bool:
    """Whether autograd would record through a kernel called on `tensors`:
    grad mode is on and one of them requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def compute_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic type for `t`: float32, or float64 for
    float64 inputs (as gradcheck uses)."""
    return torch.promote_types(t.dtype, torch.float32)


def define_op(name: str, schema: str, cuda, plain, fake, flops):
    """Register ``roma::<name>`` with `schema` (its arguments and results,
    as `torch.library` writes them): `cuda` for CUDA tensors (the kernel's
    launch), `plain` for CPU tensors, `fake` for fake and meta tensors,
    and `flops` (the argument tensors' shapes and the other arguments, as
    `register_flop_formula` passes them) as its FLOP formula. Every output
    is a new contiguous tensor, as the kernels write them (the plain
    versions' outputs are made so). Returns the operator."""
    from torch.utils.flop_counter import register_flop_formula

    def cpu(*args):
        out = plain(*args)
        return tuple(t.contiguous() for t in out) if isinstance(out, tuple) else out.contiguous()

    op = torch.library.custom_op(f"roma::{name}", cuda, mutates_args=(), device_types="cuda",
                                 schema=schema)
    op.register_kernel("cpu")(cpu)
    op.register_fake(fake)
    register_flop_formula(getattr(torch.ops.roma, name))(flops)
    return op


class PlainBackward(torch.autograd.Function):
    """`forward(*inputs)` (a kernel) with the backward of `plain(*inputs)`:
    the backward recomputes the plain version under autograd from the saved
    inputs and differentiates it. Every input is a tensor."""

    @staticmethod
    def forward(ctx, forward, plain, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        return forward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n) for x, n in zip(ctx.saved_tensors, need)]
            out = ctx.plain(*xs)
        grads = iter(torch.autograd.grad(out, [x for x, n in zip(xs, need) if n], grad))
        return (None, None, *(next(grads) if n else None for n in need))


def with_plain_backward(forward, plain, *inputs: torch.Tensor) -> torch.Tensor:
    """forward(*inputs), through `PlainBackward` when autograd records it."""
    if grad_needed(*inputs):
        return PlainBackward.apply(forward, plain, *inputs)
    return forward(*inputs)
