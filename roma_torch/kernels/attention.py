"""Flash attention (CUDA): the forward (``csrc/flash_attn.cu``), its two
backward kernels (``csrc/flash_attn_bwd.cu``), their plain PyTorch versions
and the wrappers.

Replaces the TPU kernels reached from ``roma_tpu/models/transformer.py::
_flash_attention``: the Pallas TPU flash_attention forward (K3, with its
saved residuals when differentiated) and the two kernels of its
custom_vjp, ``_flash_attention_bwd_dkv`` (K8) and
``_flash_attention_bwd_dq`` (K9). Computes softmax(q k^T / sqrt(d)) v on
(B, N, H, d), no mask. Bound and design: see the notes at the top of the
CUDA sources (operations; the bf16 forward and backward kernels are TMA +
wgmma, FlashAttention-3-shaped, with the logits kept on the SM; the
float32 forward and backward are simple float32-FMA tiles of 64 rows,
``csrc/attn_simple.cuh``).

`attention` is the entry: a forward that autograd does not record goes
through the operator ``roma::flash_attn`` (the plain version for CPU
tensors, the kernel for CUDA tensors); one that autograd records takes the
plain version on CPU tensors (autograd differentiates it) and
`FlashAttention` on CUDA tensors, which saves q, k, v, o and the rows'
log-sum-exp (``roma::flash_attn_lse``) and runs K8 and K9 in backward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from roma_torch.kernels import runtime

NAME = "flash_attn"
BWD_NAME = "flash_attn_bwd"
HEAD_DIMS = (64, 128)
FWD_ENTRIES = {torch.bfloat16: "roma_flash_attn", torch.float32: "roma_flash_attn_f32"}
BWD_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def _scaled_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q k^T / sqrt(d), (B, H, N, M), float32 (float64 for float64 inputs)."""
    d, ct = q.shape[-1], runtime.compute_dtype(q)
    return torch.einsum("bnhd,bmhd->bhnm", q.to(ct), k.to(ct)) / math.sqrt(d)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v written out, float32 arithmetic (float64
    for float64 inputs), output in q's dtype. (B,N,H,d) in and out."""
    p = torch.softmax(_scaled_logits(q, k), dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.to(p.dtype)).to(q.dtype)


def attention_lse_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Each row's log-sum-exp of the scaled logits, (B, H, N), float32
    (float64 for float64 inputs): the residual the forward saves."""
    return torch.logsumexp(_scaled_logits(q, k), dim=-1)


def attention_with_lse_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """`attention_plain`'s output and `attention_lse_plain`'s residual from
    one set of logits (the forward kernel's two outputs)."""
    logits = _scaled_logits(q, k)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", p, v.to(p.dtype)).to(q.dtype)
    return out, torch.logsumexp(logits, dim=-1)


def attention_di(o: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """di = rowsum(o * dO), (B, H, N) contiguous, float32 (float64 for
    float64): computed outside the backward kernels, as the JAX package's
    backward computes it in XLA."""
    ct = runtime.compute_dtype(o)
    # dout is cast inside the product (type promotion), not copied first
    return (o.to(ct) * dout).sum(-1).transpose(1, 2).contiguous()


def attention_bwd_plain(q, k, v, o, lse, dout):
    """(dq, dk, dv) of softmax(q k^T / sqrt(d)) v written out from the
    residuals, in float32 (float64 for float64 inputs): S = scale q k^T,
    P = exp(S - lse), dV = P^T dO, dP = dO v^T, dS = P (dP - di),
    dK = scale dS^T q, dQ = scale dS k. (B,N,H,d) tensors, lse (B,H,N)."""
    ct = runtime.compute_dtype(q)
    scale = 1.0 / math.sqrt(q.shape[-1])
    q, k, v, dout = (t.to(ct) for t in (q, k, v, dout))
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    p = torch.exp(s - lse.to(ct)[..., None])
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dout)
    dp = torch.einsum("bnhd,bmhd->bhnm", dout, v)
    ds = p * (dp - attention_di(o, dout).to(ct)[..., None])
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, k) * scale
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q) * scale
    return dq, dk, dv


def flops(q, k, v, out_shape=None) -> int:
    """FlopCounterMode's own attention formula, from the (B, N, H, d)
    shapes: q k^T and P v, 2 B H N M d each."""
    from torch.utils.flop_counter import sdpa_flop_count

    bhnd = lambda s: (s[0], s[2], s[1], s[3])  # noqa: E731
    return sdpa_flop_count(bhnd(q), bhnd(k), bhnd(v))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Where autograd records: CPU tensors take the plain version (autograd
    differentiates it), CUDA tensors `FlashAttention` (the forward kernel;
    backward K8 and K9). Elsewhere the operator ``roma::flash_attn``: the
    plain version for CPU tensors, the forward kernel for CUDA tensors."""
    if runtime.grad_needed(q, k, v):
        if q.device.type == "cpu":
            return attention_plain(q, k, v)
        return FlashAttention.apply(q, k, v)
    return op(q, k, v)


class FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp residual (the operator
    ``roma::flash_attn_lse``); backward by the dK/dV kernel (K8) and the dQ
    kernel (K9), which stay outside the dispatcher: no training step is
    exported or counted, in the JAX package either."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = op_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        return attention_bwd_cuda(q, k, v, out, lse, dout)


def _check_qkv(name: str, q, k, v, dtype) -> None:
    B, N, H, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim must be one of {HEAD_DIMS}, got {d}")
    for t in (q, k, v):
        runtime.require(name, t, (B, N, H, d), dtype, q.device, contiguous=False)
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: needs unit stride on d, 8-element strides, "
                             "16-byte alignment")


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   with_lse: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """q, k, v: (B,N,H,d) CUDA tensors of one dtype, bf16 (the wgmma kernel)
    or float32 (the FMA kernel), unit stride along d (views of a fused qkv
    projection are taken as they are). Returns (o, lse): o (B,N,H,d) in the
    inputs' dtype, lse (B,H,N) float32 when `with_lse`, else None."""
    symbol = runtime.entry(NAME, FWD_ENTRIES, q.dtype)
    _check_qkv(NAME, q, k, v, q.dtype)
    B, N, H, d = q.shape
    dev = q.device
    out = torch.empty((B, N, H, d), dtype=q.dtype, device=dev)
    lse = torch.empty((B, H, N), dtype=torch.float32, device=dev) if with_lse else None
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3]
    )
    lib = runtime.load(NAME)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scale_log2 = (1.0 / math.sqrt(d)) * math.log2(math.e)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), B, N, H, d, strides, scale_log2,
            runtime.stream_handle(q))
    runtime.check(lib, NAME, rc)
    return out, lse


def _out_like(q):
    B, N, H, d = q.shape
    return q.new_empty((B, N, H, d))


def _lse_like(q):
    B, N, H, _ = q.shape
    return q.new_empty((B, H, N), dtype=torch.float32)


op = runtime.define_op(
    NAME, "(Tensor q, Tensor k, Tensor v) -> Tensor",
    lambda q, k, v: attention_cuda(q, k, v)[0], attention_plain,
    lambda q, k, v: _out_like(q), flops)
op_lse = runtime.define_op(
    "flash_attn_lse", "(Tensor q, Tensor k, Tensor v) -> (Tensor, Tensor)",
    lambda q, k, v: attention_cuda(q, k, v, with_lse=True),
    attention_with_lse_plain,
    lambda q, k, v: (_out_like(q), _lse_like(q)), flops)


def _bwd_fn(symbol: str, n_out: int):
    lib = runtime.load(BWD_NAME)
    fn = getattr(lib, symbol)
    fn.argtypes = [ctypes.c_void_p] * (6 + n_out) + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def attention_bwd_cuda(q, k, v, out, lse, dout, which=("dkv", "dq")):
    """(dq, dk, dv) from K8 (dk, dv) and K9 (dq): q, k, v (B,N,H,d) of one
    dtype (bf16 or float32, unit stride on d), out the forward's output,
    lse (B,H,N) float32, dout the output's gradient. di = rowsum(o * dO) is
    a plain reduction here. Gradients come back contiguous, in the inputs'
    dtype; `which` leaves one kernel out (its gradients are None)."""
    code = runtime.entry(BWD_NAME, BWD_DTYPES, q.dtype)
    _check_qkv(BWD_NAME, q, k, v, q.dtype)
    B, N, H, d = q.shape
    dev = q.device
    dout = dout.to(q.dtype)
    if dout.stride(-1) != 1 or any(s % 8 for s in dout.stride()[:3]) or dout.data_ptr() % 16:
        dout = dout.contiguous()
    runtime.require(BWD_NAME, lse, (B, H, N), torch.float32, dev)
    di = attention_di(out, dout)
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3])
    scale = 1.0 / math.sqrt(d)
    stream = runtime.stream_handle(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), lse.data_ptr(),
            di.data_ptr())
    dq = dk = dv = None
    if "dkv" in which:
        dk = torch.empty((B, N, H, d), dtype=q.dtype, device=dev)
        dv = torch.empty_like(dk)
        lib, fn = _bwd_fn("roma_flash_attn_bwd_dkv", 2)
        rc = fn(*ptrs, dk.data_ptr(), dv.data_ptr(), B, N, H, d, strides, scale, code, stream)
        runtime.check(lib, "flash_attn_dkv", rc)
    if "dq" in which:
        dq = torch.empty((B, N, H, d), dtype=q.dtype, device=dev)
        lib, fn = _bwd_fn("roma_flash_attn_bwd_dq", 1)
        rc = fn(*ptrs, dq.data_ptr(), B, N, H, d, strides, scale, code, stream)
        runtime.check(lib, "flash_attn_dq", rc)
    return dq, dk, dv
