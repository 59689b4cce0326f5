"""Flash attention (CUDA, ``csrc/flash_attn.cu``), its plain PyTorch version
and the wrapper.

Replaces the TPU kernel reached from ``roma_tpu/models/transformer.py::
_flash_attention`` (the Pallas TPU flash_attention kernel). Computes
softmax(q k^T / sqrt(d)) v on (B, N, H, d), no mask. Bound and design: see
the note at the top of the CUDA source (operations; TMA loads of q/k/v
views into a mbarrier ring, wgmma for both products with an online softmax
in registers, the logits never leave the SM).
"""

from __future__ import annotations

import ctypes
import math

import torch

from roma_torch.kernels import runtime

NAME = "flash_attn"
HEAD_DIMS = (64, 128)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v written out, float32 arithmetic (float64
    for float64 inputs), output in q's dtype. (B,N,H,d) in and out."""
    d, ct = q.shape[-1], runtime.compute_dtype(q)
    logits = torch.einsum("bnhd,bmhd->bhnm", q.to(ct), k.to(ct)) / math.sqrt(d)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.to(ct)).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """CPU tensors take the plain version; CUDA tensors launch the kernel,
    differentiable through the plain version."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    return runtime.with_plain_backward(attention_cuda, attention_plain, q, k, v)


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B,N,H,d) bf16 CUDA tensors, unit stride along d (views of a
    fused qkv projection are taken as they are)."""
    B, N, H, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{NAME}: head dim must be one of {HEAD_DIMS}, got {d}")
    dev = q.device
    for t in (q, k, v):
        runtime.require(NAME, t, (B, N, H, d), torch.bfloat16, dev, contiguous=False)
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{NAME}: needs unit stride on d, 8-element strides, "
                             "16-byte alignment")
    out = torch.empty((B, N, H, d), dtype=torch.bfloat16, device=dev)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    lib = runtime.load(NAME)
    fn = lib.roma_flash_attn
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, H, d,
            strides, scale_log2, runtime.stream_handle(q))
    runtime.check(lib, NAME, rc)
    return out
