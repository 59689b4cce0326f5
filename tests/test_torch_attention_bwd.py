"""Flash attention's backward (K8 dK/dV, K9 dQ) and the forward's
log-sum-exp residual, on the CPU:

- `attention_bwd_plain` (the explicit formulas the kernels implement)
  against autograd through `attention_plain` and against `jax.vjp` of
  `jax.nn.dot_product_attention`, what the JAX package's `Attention` runs
  off the TPU; `attention_lse_plain` against JAX's logsumexp;
- a Python emulation of the kernels' tiling (csrc/attn_simple.cuh,
  csrc/flash_attn_bwd.cu), tiles staged with zeros past N, K8's loop over
  query tiles for each block of keys, K9's loop over key tiles for each
  block of queries:
  - the float32 kernels: 64-row tiles both ways, P = exp(S - lse) masked
    to 0 past N, and the float32 forward's online softmax with its lse, at
    N = 1, 63, 65 and 1601, within 1e-5 (relative to the largest gradient
    of the call);
  - the bf16 wgmma kernels: K8 blocks of 128 keys (two warpgroups of 64)
    walking 64-query tiles with no mask (lse = di = 0 past N), K9 blocks
    of 128 queries walking 128-key tiles with P masked past N, P and dS
    rounded to bf16 before their products and the gradients at the end,
    from bf16 inputs, at N = 1, 63, 65, 129 and 1601 and d = 64 and 128,
    within chip_smoke.py's bf16 bound `BWD_TOL` (2^-7 |plain| + 8e-3 M,
    M the largest plain gradient of the call);
- the planted fault's anchors in the source that chip_smoke.py edits;
- the autograd wiring: on CPU tensors `attention` differentiates the plain
  version, and the CUDA entries raise for CPU tensors.

Tolerance otherwise 1e-5 (float32; relative to the largest gradient of the
call)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from roma_torch.kernels import attention as at
from roma_torch.kernels import runtime

TOL = 1e-5
ROWS = 64  # the float32 kernels' tile, both ways
K8_PLAN = dict(block=128, walk=64)   # bf16 K8: 128 keys a block, 64-query tiles
K9_PLAN = dict(block=128, walk=128)  # bf16 K9: 128 queries a block, 128-key tiles


def _inputs(B, N, H, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((B, N, 3, H, d), generator=g)
    dout = torch.randn((B, N, H, d), generator=g)
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], dout


def _assert_grads(got, ref, what):
    scale = max(float(r.abs().max()) for r in ref)
    for name, a, b in zip("qkv", got, ref):
        err = float((a.float() - b.float()).abs().max())
        assert err <= TOL * scale, f"{what} d{name}: max-abs {err:.3g} (scale {scale:.3g})"


@pytest.mark.parametrize("dims", [(2, 37, 3, 16), (1, 65, 2, 64)])
def test_bwd_plain_matches_autograd_and_jax(dims):
    q, k, v, dout = _inputs(*dims)
    o = at.attention_plain(q, k, v)
    lse = at.attention_lse_plain(q, k)
    got = at.attention_bwd_plain(q, k, v, o, lse, dout)

    qs = [t.clone().requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(at.attention_plain(*qs), qs, dout)
    _assert_grads(got, ref, "vs autograd")

    jq, jk, jv, jd = (jnp.asarray(t.numpy()) for t in (q, k, v, dout))
    jo, vjp = jax.vjp(jax.nn.dot_product_attention, jq, jk, jv)
    jref = [torch.from_numpy(np.asarray(t)) for t in vjp(jd)]
    _assert_grads(got, jref, "vs jax")
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=TOL)

    logits = jnp.einsum("bnhd,bmhd->bhnm", jq, jk) / math.sqrt(dims[-1])
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, -1)),
                               rtol=0, atol=TOL)


# ---------------------------------------------------------------- emulation

def _tile(t, n0, N, rows=ROWS):
    """Rows n0 ... n0 + rows - 1 of (B, N, H, d) as (B, H, rows, d), zeros
    past N."""
    out = torch.zeros(t.shape[0], t.shape[2], rows, t.shape[3], dtype=torch.float32)
    n = min(rows, N - n0)
    out[:, :, :n] = t[:, n0:n0 + n].float().transpose(1, 2)
    return out


def _rows(x, n0, N, rows=ROWS):
    """Rows n0 ... n0 + rows - 1 of (B, H, N), zeros past N."""
    out = torch.zeros(x.shape[0], x.shape[1], rows)
    n = min(rows, N - n0)
    out[..., :n] = x[..., n0:n0 + n]
    return out


def _valid(n0, N, rows=ROWS):
    return torch.arange(n0, n0 + rows) < N


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _scores(q_t, k_t, do_t, v_t, lse_t, di_t, mask, scale):
    """P and dS of a query tile x key tile, P set to 0 where `mask` (queries
    x keys, or None) is False."""
    s = q_t @ k_t.transpose(-1, -2)
    dp = do_t @ v_t.transpose(-1, -2)
    p = torch.exp2(s * scale * math.log2(math.e) - lse_t[..., None] * math.log2(math.e))
    if mask is not None:
        p = torch.where(mask, p, torch.zeros(()))
    return p, p * (dp - di_t[..., None])


def _store(dst, acc, n0, N):
    rows = min(acc.shape[2], N - n0)
    dst[:, n0:n0 + rows] = acc[:, :, :rows].transpose(1, 2)


def emulate_dkv(q, k, v, lse, di, dout, block=ROWS, walk=ROWS, bf16=False):
    """K8: a block of `block` keys at a time, its sums over the query tiles
    of `walk` rows. float32 kernel: P masked to 0 past N both ways. bf16
    (the wgmma kernel): no mask, P and dS rounded to bf16 before their
    products, the gradients at the end."""
    B, N, H, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dk, dv = torch.zeros(B, N, H, d), torch.zeros(B, N, H, d)
    for n0 in range(0, N, block):
        k_t, v_t = _tile(k, n0, N, block), _tile(v, n0, N, block)
        acc_k, acc_v = torch.zeros(B, H, block, d), torch.zeros(B, H, block, d)
        for m0 in range(0, N, walk):
            q_t, do_t = _tile(q, m0, N, walk), _tile(dout, m0, N, walk)
            mask = None if bf16 else _valid(m0, N, walk)[:, None] & _valid(n0, N, block)[None, :]
            p, ds = _scores(q_t, k_t, do_t, v_t, _rows(lse, m0, N, walk), _rows(di, m0, N, walk),
                            mask, scale)
            if bf16:
                p, ds = _bf16(p), _bf16(ds)
            acc_v += p.transpose(-1, -2) @ do_t
            acc_k += ds.transpose(-1, -2) @ q_t
        _store(dk, acc_k * scale, n0, N)
        _store(dv, acc_v, n0, N)
    return (_bf16(dk), _bf16(dv)) if bf16 else (dk, dv)


def emulate_dq(q, k, v, lse, di, dout, block=ROWS, walk=ROWS, bf16=False):
    """K9: a block of `block` queries at a time, its sums over the key tiles
    of `walk` rows. float32 kernel: P masked to 0 past N both ways. bf16
    (the wgmma kernel): P masked past N along the keys only, dS rounded to
    bf16 before its product, dQ at the end."""
    B, N, H, d = q.shape
    scale = 1.0 / math.sqrt(d)
    dq = torch.zeros(B, N, H, d)
    for m0 in range(0, N, block):
        q_t, do_t = _tile(q, m0, N, block), _tile(dout, m0, N, block)
        lse_t, di_t = _rows(lse, m0, N, block), _rows(di, m0, N, block)
        acc = torch.zeros(B, H, block, d)
        for n0 in range(0, N, walk):
            k_t, v_t = _tile(k, n0, N, walk), _tile(v, n0, N, walk)
            keys = _valid(n0, N, walk)[None, :]
            mask = keys if bf16 else _valid(m0, N, block)[:, None] & keys
            _, ds = _scores(q_t, k_t, do_t, v_t, lse_t, di_t, mask, scale)
            acc += (_bf16(ds) if bf16 else ds) @ k_t
        _store(dq, acc * scale, m0, N)
    return _bf16(dq) if bf16 else dq


def emulate_fwd(q, k, v):
    """The float32 forward (`attn::fwd_kernel`): online softmax over 64-key
    tiles in log2 units, the last tile's keys past N at -inf; (o, lse)."""
    B, N, H, d = q.shape
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    o, lse = torch.zeros(B, N, H, d), torch.zeros(B, H, N)
    for m0 in range(0, N, ROWS):
        q_t = _tile(q, m0, N)
        m_run = torch.full((B, H, ROWS), -math.inf)
        l_run, acc = torch.zeros(B, H, ROWS), torch.zeros(B, H, ROWS, d)
        for n0 in range(0, N, ROWS):
            s = (q_t @ _tile(k, n0, N).transpose(-1, -2)) * scale_log2
            s = torch.where(_valid(n0, N)[None, None, None, :], s, torch.tensor(-math.inf))
            m_new = torch.maximum(m_run, s.amax(-1))
            alpha = torch.exp2(m_run - m_new)
            p = torch.exp2(s - m_new[..., None])
            l_run = l_run * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + p @ _tile(v, n0, N)
            m_run = m_new
        _store(o, acc / l_run[..., None], m0, N)
        rows = min(ROWS, N - m0)
        lse[..., m0:m0 + rows] = ((m_run + torch.log2(l_run)) * math.log(2))[..., :rows]
    return o, lse


@pytest.mark.parametrize("N", [1, 63, 65, 1601])
def test_kernel_tiling_emulation_matches_plain(N):
    H, d = (1, 64) if N == 1601 else (2, 64)
    q, k, v, dout = _inputs(1, N, H, d, seed=N)
    o, lse = emulate_fwd(q, k, v)
    np.testing.assert_allclose(o.numpy(), at.attention_plain(q, k, v).numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.numpy(), at.attention_lse_plain(q, k).numpy(), rtol=0,
                               atol=TOL)
    di = at.attention_di(o, dout)
    dk, dv = emulate_dkv(q, k, v, lse, di, dout)
    dq = emulate_dq(q, k, v, lse, di, dout)
    ref = at.attention_bwd_plain(q, k, v, o, lse, dout)
    _assert_grads((dq, dk, dv), ref, f"emulation N={N}")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("N", [1, 63, 65, 129, 1601])
def test_wgmma_tiling_emulation_matches_plain(N, d):
    H = 1 if N == 1601 else 2
    q, k, v, dout = (t.to(torch.bfloat16) for t in _inputs(1, N, H, d, seed=N + d))
    o = at.attention_plain(q, k, v)
    lse = at.attention_lse_plain(q, k)
    di = at.attention_di(o, dout)
    dk, dv = emulate_dkv(q, k, v, lse, di, dout, **K8_PLAN, bf16=True)
    dq = emulate_dq(q, k, v, lse, di, dout, **K9_PLAN, bf16=True)
    ref = at.attention_bwd_plain(q, k, v, o, lse, dout)
    rel, absn = chip_smoke.BWD_TOL["bfloat16"]
    big = max(float(r.abs().max()) for r in ref)
    for name, g, r in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        worst = float(((g - r).abs() / (rel * r.abs() + absn * big)).max())
        assert worst <= 1.0, f"N={N} d={d} {name}: {worst:.2f}x the bf16 bound"


def test_planted_fault_anchors_are_in_the_source_once():
    src = (runtime.CSRC / "flash_attn_bwd.cu").read_text()
    out = chip_smoke.planted_source(src)
    for anchor, fault in chip_smoke.PLANTED:
        assert src.count(anchor) == 1 and out.count(fault) == 1, anchor


def test_di_is_rowsum_of_o_times_dout():
    q, k, v, dout = _inputs(2, 9, 3, 8)
    o = at.attention_plain(q, k, v)
    di = at.attention_di(o, dout)
    assert tuple(di.shape) == (2, 3, 9) and di.is_contiguous()
    torch.testing.assert_close(di, torch.einsum("bnhd,bnhd->bhn", o, dout))


def test_cpu_attention_differentiates_the_plain_version():
    q, k, v, dout = _inputs(1, 20, 2, 16)
    qs = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(at.attention(*qs), qs, dout)
    o = at.attention_plain(q, k, v)
    _assert_grads(got, at.attention_bwd_plain(q, k, v, o, at.attention_lse_plain(q, k), dout),
                  "cpu attention")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_entries_raise_for_cpu_tensors(dtype):
    q, k, v, dout = (t.to(dtype) for t in _inputs(1, 8, 2, 64))
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="expected a tensor on"):
        at.attention_cuda(q, k, v, with_lse=True)
    with pytest.raises(ValueError, match="expected a tensor on"):
        at.attention_bwd_cuda(q, k, v, q, lse, dout)
    with pytest.raises(TypeError, match="takes"):
        at.attention_cuda(q.half(), k.half(), v.half())
