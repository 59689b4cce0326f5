"""The kernels' training guard: the gates of the local-correlation, chained
block, windowed-gather and correlation-softmax kernels give way to the plain
versions when autograd records through them (the JAX package routes them
only when not training), and attention and the depthwise blocks carry their
plain versions' backward (`runtime.PlainBackward`, as the JAX custom_vjp's
do), checked by gradcheck in float64 with the plain version as the forward.
"""

import dataclasses

import pytest
import torch

from roma_torch.config import TinyRomaConfig
from roma_torch.kernels import attention as tattn
from roma_torch.kernels import corr_softmax as tcs
from roma_torch.kernels import dw_affine_relu as tk4
from roma_torch.kernels import dw_chain as tchain
from roma_torch.kernels import local_corr as tlc
from roma_torch.kernels import runtime
from roma_torch.models import refiner as trefiner
from roma_torch.models import tiny_roma as ttiny
from roma_torch.models.refiner import ConvRefiner


def _gen():
    return torch.Generator().manual_seed(0)


def test_grad_needed():
    x = torch.zeros(2)
    w = torch.zeros(2, requires_grad=True)
    assert runtime.grad_needed(x, w) and not runtime.grad_needed(x)
    with torch.no_grad():
        assert not runtime.grad_needed(x, w)
    with torch.inference_mode():
        assert not runtime.grad_needed(w)


def test_local_corr_gate_takes_grad_into_account():
    f = torch.zeros((1, 2, 2, 128))
    flow = torch.zeros((1, 2, 2, 2), requires_grad=True)
    assert tlc.use_kernel(3, 128, f, f)
    assert not tlc.use_kernel(3, 128, f, f, flow)
    with torch.no_grad():
        assert tlc.use_kernel(3, 128, f, f, flow)


class _Spy:
    """Stands in for a kernel entry point: counts calls, runs `fn`."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        return self.fn(*args, **kwargs)


def _refiner_inputs(C, H=6, W=7):
    g = _gen()
    x = torch.randn((1, C, H, W), generator=g)
    y = torch.randn((1, C, H, W), generator=g)
    flow = (torch.rand((1, H, W, 2), generator=g) * 2 - 1)
    return x, y, flow


@pytest.mark.parametrize("grad", [False, True])
def test_refiner_local_corr_gate(monkeypatch, grad):
    """Scales 16/8/4: the local correlation reaches the kernel's entry only
    while autograd does not record; with grad the plain version runs and
    the backward reaches the features."""
    spy = _Spy(tlc.local_correlation)
    monkeypatch.setattr(tlc, "local_correlation", spy)
    C, r, disp = 128, 1, 7
    ref = ConvRefiner(2 * C + disp + (2 * r + 1) ** 2, 2 * C + disp + (2 * r + 1) ** 2, disp,
                      local_corr_radius=r, hidden_blocks=1, dtype=torch.float32)
    x, y, flow = _refiner_inputs(C)
    if grad:
        x.requires_grad_()
        dflow, dcert = ref(x, y, flow)
        (dflow.sum() + dcert.sum()).backward()
        assert spy.calls == 0 and bool(torch.isfinite(x.grad).all())
    else:
        with torch.no_grad():
            ref(x, y, flow)
        assert spy.calls == 1


@pytest.mark.parametrize("grad", [False, True])
def test_refiner_chain_and_windowed_gather_gates(monkeypatch, grad):
    """Scale 1 with smooth_warp_gather: the chained blocks and the windowed
    gather reach their kernels' entries only while autograd does not
    record through them (the blocks' weights require grad, as a module's
    do; the gathered features do with grad)."""
    chain = _Spy(tchain.chain_nchw)
    gather = _Spy(trefiner.grid_sample_smooth_nchw)
    monkeypatch.setattr(tchain, "chain_nchw", chain)
    monkeypatch.setattr(trefiner, "grid_sample_smooth_nchw", gather)
    C, disp = 8, 8
    ref = ConvRefiner(2 * C + disp, 2 * C + disp, disp, hidden_blocks=2, dtype=torch.float32,
                      smooth_warp="fast")
    x, y, flow = _refiner_inputs(C)
    if grad:
        y.requires_grad_()
        dflow, _ = ref(x, y, flow)
        dflow.sum().backward()
        assert (chain.calls, gather.calls) == (0, 0)
        assert ref.block1[0].weight.grad is not None and y.grad is not None
    else:
        with torch.no_grad():
            ref(x, y, flow)
        assert (chain.calls, gather.calls) == (1, 1)


@pytest.mark.parametrize("grad", [False, True])
def test_tiny_coarse_warp_gate(monkeypatch, grad):
    """Tiny RoMa's coarse warp reaches the correlation-softmax kernel's
    entry, with the features in their own dtype (no cast), only while
    autograd does not record; with grad it takes the exact expectation over
    the correlation volume, the same function."""
    seen = []
    spy = _Spy(lambda f0, f1, grid: (seen.append(f0.dtype), tcs.fused_pos_embed(f0, f1, grid))[1])
    monkeypatch.setattr(ttiny, "fused_pos_embed", spy)
    cfg = dataclasses.replace(TinyRomaConfig(), fused_kernel=True, dtype="bfloat16")
    model = ttiny.TinyRoma(cfg)
    g = _gen()
    f0 = torch.randn((1, 16, 4, 5), generator=g).to(torch.bfloat16)
    f1 = torch.randn((1, 16, 4, 5), generator=g).to(torch.bfloat16)
    with torch.no_grad():
        ref = model.coarse_warp(f0, f1)[0]
    assert spy.calls == 1 and seen == [torch.bfloat16]
    if grad:
        a, b = f0.float().requires_grad_(), f1.float()
        got = model.coarse_warp(a, b)[0]
        got.sum().backward()
        assert spy.calls == 1 and a.grad is not None
        torch.testing.assert_close(got.detach(), ref, atol=1e-5, rtol=0)


def _plain_backward_gradcheck(plain, *inputs):
    assert torch.autograd.gradcheck(
        lambda *xs: runtime.PlainBackward.apply(plain, plain, *xs), inputs)


def test_attention_plain_backward_gradcheck():
    g = _gen()
    q, k, v = (torch.randn((1, 5, 2, 4), generator=g, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    _plain_backward_gradcheck(tattn.attention_plain, q, k, v)


def test_dw_affine_relu_plain_backward_gradcheck():
    g = _gen()
    x = torch.randn((1, 3, 5, 6), generator=g, dtype=torch.float64, requires_grad=True)
    w = (0.3 * torch.randn((5, 5, 3), generator=g, dtype=torch.float64)).requires_grad_()
    scale = (0.5 + torch.rand((3,), generator=g, dtype=torch.float64)).requires_grad_()
    shift = (0.1 * torch.randn((3,), generator=g, dtype=torch.float64)).requires_grad_()
    _plain_backward_gradcheck(tk4.dw5x5_affine_relu_plain_nchw, x, w, scale, shift)


def test_dw_block_mm_plain_backward_gradcheck():
    g = _gen()
    x = torch.randn((1, 3, 5, 6), generator=g, dtype=torch.float64, requires_grad=True)
    w = (0.3 * torch.randn((5, 5, 3), generator=g, dtype=torch.float64)).requires_grad_()
    scale = (0.5 + torch.rand((3,), generator=g, dtype=torch.float64)).requires_grad_()
    shift = (0.1 * torch.randn((3,), generator=g, dtype=torch.float64)).requires_grad_()
    m = (0.3 * torch.randn((3, 3), generator=g, dtype=torch.float64)).requires_grad_()
    bias = (0.1 * torch.randn((3,), generator=g, dtype=torch.float64)).requires_grad_()
    _plain_backward_gradcheck(tchain.block_plain_nchw, x, w, scale, shift, m, bias)


def test_plain_backward_takes_the_forward_it_is_given():
    """PlainBackward's forward value is the kernel's (here a stand-in off
    by one), its gradient the plain version's; only the inputs that
    require grad get one. `with_plain_backward` calls the kernel directly
    when autograd does not record."""
    x = torch.randn((3,), dtype=torch.float64, requires_grad=True)
    c = torch.randn((3,), dtype=torch.float64)
    plain = lambda a, b: (a * b).sin()
    kernel = lambda a, b: plain(a, b) + 1
    out = runtime.with_plain_backward(kernel, plain, x, c)
    torch.testing.assert_close(out, plain(x, c) + 1)
    out.sum().backward()
    torch.testing.assert_close(x.grad, c * (x * c).cos())
    with torch.no_grad():
        assert runtime.with_plain_backward(kernel, plain, x, c).grad_fn is None
