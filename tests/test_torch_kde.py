"""The KDE operator ``roma::kde`` (`roma_torch/kernels/kde.py`, `csrc/kde.cu`).

On the CPU: `utils/kde.py::kde` is the plain version bitwise, it reaches
the operator whether or not autograd records the call (the gradient is
the plain version's), and the kernel's column split covers every column. On the card (marked
`cuda`, skipped without one): the kernel against a float64
direct-difference sum, its determinism, its launch count, the inputs it
refuses, and balanced sampling drawing the same matches through it as
through the plain version. Run the card cases with
`python -m pytest --noconftest tests/test_torch_kde.py -m cuda` on a
machine with a GPU (`--noconftest`: `tests/conftest.py` imports JAX, which
that machine need not have).
"""

from __future__ import annotations

import pytest
import torch

from roma_torch.kernels import kde as kk
from roma_torch.utils.kde import kde


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _points(n: int, kind: str, generator: torch.Generator, device="cpu") -> torch.Tensor:
    """(n, 4) float32 in [-1, 1]: uniform, or a warp-like pool (x_B a smooth
    function of x_A, as a dense warp's matches are)."""
    a = torch.rand((n, 2), generator=generator, device=device) * 2 - 1
    if kind == "uniform":
        b = torch.rand((n, 2), generator=generator, device=device) * 2 - 1
    else:
        b = (0.8 * a + 0.15 * torch.sin(3.0 * a.flip(-1)) + 0.05).clamp(-1, 1)
    return torch.cat([a, b], -1)


def _density_f64(x: torch.Tensor, std: float = 0.1, tile: int = 1024) -> torch.Tensor:
    """The density summed in float64 over direct differences."""
    x = x.double()
    return torch.cat([torch.exp(-((x[i:i + tile, None] - x[None]) ** 2).sum(-1) / (2 * std * std))
                      .sum(-1) for i in range(0, x.shape[0], tile)])


# ---------------------------------------------------------------- CPU

@pytest.mark.parametrize("n,tile", [(1, 2048), (300, 64), (517, 2048)])
def test_kde_on_the_cpu_is_the_plain_version(n, tile):
    x = _points(n, "uniform", torch.Generator().manual_seed(n))
    assert torch.equal(kde(x, std=0.1, tile=tile), kk.kde_plain(x, 0.1, tile))


def test_kde_reaches_the_operator_unless_autograd_records():
    """Every call goes through ``roma::kde``; under autograd the gradient
    is the plain version's, bitwise."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "roma":
                seen.append(func.name())
            return func(*args, **(kwargs or {}))

    x = _points(50, "warp", torch.Generator().manual_seed(0))
    with Spy():
        kde(x)
    assert seen == ["roma::kde"]
    seen.clear()
    xg = x.clone().requires_grad_()
    w = torch.linspace(-1.0, 2.0, 50)
    with Spy():
        out = kde(xg)
    assert seen == ["roma::kde"] and out.grad_fn is not None
    assert torch.equal(out.detach(), kk.kde_plain(x))
    (grad,) = torch.autograd.grad((out * w).sum(), xg)
    xp = x.clone().requires_grad_()
    (ref,) = torch.autograd.grad((kk.kde_plain(xp) * w).sum(), xp)
    assert torch.equal(grad, ref)
    seen.clear()
    with Spy(), torch.no_grad():
        kde(x.clone().requires_grad_())
    assert seen == ["roma::kde"]


@pytest.mark.parametrize("n", [0, 1, 63, 128, 2049, 20000, 40000, 100000, 10**7])
def test_kde_column_split_covers_every_column(n):
    """The parts cover [0, n) with ceil(n / S) columns each and none empty,
    at least MIN_COLS columns a part where split, within the grid's
    65,535; about BLOCKS blocks at the sampler's pool sizes."""
    s = kk.splits(n)
    cols = -(-n // s)
    assert 1 <= s <= 65535
    assert (s - 1) * cols < n or n == 0
    assert s == 1 or cols >= kk.MIN_COLS
    if n in (20000, 40000):
        assert kk.BLOCKS <= -(-n // kk.ROWS) * s < kk.BLOCKS * 1.05


# ---------------------------------------------------------------- card

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["warp", "uniform"])
@pytest.mark.parametrize("n", [1, 5, 127, 2049, 20000, 40000])
def test_kde_kernel_against_float64(card, n, kind):
    """Max relative error <= 2e-5 against float64 (a serial float32 sum
    reads 7e-6 at N = 40,000, the plain version's expansion 8e-6)."""
    x = _points(n, kind, torch.Generator(device=card).manual_seed(n), card)
    got = kde(x, std=0.1)
    ref = _density_f64(x)
    rel = ((got.double() - ref).abs() / ref).max().item()
    assert got.shape == (n,) and got.dtype == torch.float32
    assert rel <= 2e-5, rel


@pytest.mark.cuda
def test_kde_kernel_is_deterministic_and_counted(card):
    from roma_torch.kernels import LAUNCHES

    x = _points(40000, "warp", torch.Generator(device=card).manual_seed(1), card)
    n0 = LAUNCHES["kde"]
    a = kde(x)
    b = kde(x)
    torch.cuda.synchronize()
    assert LAUNCHES["kde"] == n0 + 2
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_kde_kernel_under_autograd(card):
    """A call that autograd records runs the kernel forward (bitwise the
    untracked call) and takes the plain version's gradient."""
    from roma_torch.kernels import LAUNCHES

    x = _points(3000, "warp", torch.Generator(device=card).manual_seed(4), card)
    xg = x.clone().requires_grad_()
    n0 = LAUNCHES["kde"]
    out = kde(xg)
    assert LAUNCHES["kde"] == n0 + 1
    assert torch.equal(out.detach(), kde(x))
    (grad,) = torch.autograd.grad(out.sum(), xg)
    xp = x.clone().requires_grad_()
    (ref,) = torch.autograd.grad(kk.kde_plain(xp).sum(), xp)
    assert torch.equal(grad, ref)


@pytest.mark.cuda
def test_kde_kernel_refuses_what_it_does_not_take(card):
    x = torch.rand((100, 4), device=card)
    with pytest.raises(TypeError, match="float32"):
        kde(x.double())
    with pytest.raises(ValueError, match="D <= 4"):
        kde(torch.rand((100, 5), device=card))


@pytest.mark.cuda
def test_sampling_draws_the_same_matches_through_the_kernel(card, monkeypatch):
    """A 40,000-point pool (10,000 matches drawn): >= 99.9% of the draws are
    the same with the kernel as with the plain KDE, same generator seed."""
    from roma_torch.utils import sampling

    h, w = 240, 320
    gen = torch.Generator(device=card).manual_seed(2)
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, h, device=card),
                            torch.linspace(-1, 1, w, device=card), indexing="ij")
    a = torch.stack([xs, ys], -1)
    warp = torch.cat([a, (0.8 * a + 0.15 * torch.sin(3.0 * a.flip(-1))).clamp(-1, 1)], -1)
    cert = torch.rand((h, w), generator=gen, device=card)

    def draw():
        m, _ = sampling.sample_matches(warp, cert, num=10000,
                                       generator=torch.Generator(device=card).manual_seed(3))
        return {tuple(r) for r in m.cpu().tolist()}

    got = draw()
    monkeypatch.setattr(sampling, "kde", kk.kde_plain)
    ref = draw()
    assert len(got) == len(ref) == 10000
    assert len(got & ref) >= 0.999 * 10000
