"""Gaussian kernel density estimate (CUDA, ``csrc/kde.cu``), its plain
PyTorch version and the operator ``roma::kde``.

Replaces no TPU kernel: ``roma_tpu/utils/kde.py`` is plain ``jnp``, row
tiles of the pairwise distances left to XLA. On the card the same plain
code runs ~9 elementwise passes over each 2,048 x N float32 tile; the
kernel evaluates every pair in registers and writes only the N densities.
Bound and design: see the note at the top of the CUDA source (operations:
one exponential and ~9 float32 instructions a pair). The balanced
sampler (`utils/sampling.py::sample_matches`) calls it through
`utils/kde.py::kde`.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from roma_torch.kernels import runtime

NAME = "kde"
MAX_DIM = 4
ROWS = 1024       # rows a block (csrc/kde.cu: kRows, which the library reports)
BLOCKS = 4096     # blocks a launch to aim at: several waves on the H100's 132 SMs
MIN_COLS = 64     # fewest columns a block walks


def kde_plain(x: torch.Tensor, std: float = 0.1, tile: int = 2048) -> torch.Tensor:
    """Density at each row of x (N, D): sum_j exp(-||x_i - x_j||^2 / (2 std^2)),
    in row tiles so peak memory is O(tile * N) rather than O(N^2)."""
    x = x.float()
    inv = 1.0 / (2.0 * std * std)
    sq = (x * x).sum(-1)
    out = []
    for i in range(0, x.shape[0], tile):
        xr = x[i:i + tile]
        d2 = sq[i:i + tile, None] + sq[None, :] - 2.0 * (xr @ x.T)
        out.append(torch.exp(-d2.clamp_min(0.0) * inv).sum(-1))
    return torch.cat(out)


def flops(x, std, tile, out_shape=None) -> int:
    """What FlopCounterMode counts for the plain version, from the shapes:
    its tiles' products with x.T, 2 N N D."""
    n, d = x
    return 2 * n * n * d


def splits(n: int) -> int:
    """Parts the kernel cuts the columns into for n points: enough for about
    BLOCKS blocks with the (n / ROWS) row blocks, at least MIN_COLS columns
    a part, none empty. Depends on n alone."""
    s = min(-(-BLOCKS // max(1, -(-n // ROWS))), n // MIN_COLS)
    if s <= 1:
        return 1
    cols = -(-n // s)
    return -(-n // cols)


@functools.cache
def _kernel():
    lib = runtime.load(NAME)
    rows = lib.roma_kde_rows()
    if rows != ROWS:
        raise RuntimeError(f"{NAME}: the kernel's blocks hold {rows} rows, splits() assumes {ROWS}")
    fn = lib.roma_kde
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def kde_cuda(x: torch.Tensor, std: float, tile: int) -> torch.Tensor:
    """The kernel on float32 x (N, D), D <= 4; `tile` is the plain
    version's and unused here. Two launches: the pairs into an (S, N)
    scratch of column parts, then their sum."""
    if x.dim() != 2 or not 1 <= x.shape[1] <= MAX_DIM:
        raise ValueError(f"{NAME}: x must be (N, D) with 1 <= D <= {MAX_DIM}, got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"{NAME}: x must be float32, got {x.dtype}")
    x = x.contiguous()
    n, d = x.shape
    out = torch.empty((n,), dtype=torch.float32, device=x.device)
    s = splits(n)
    part = torch.empty((s, n), dtype=torch.float32, device=x.device)
    lib, fn = _kernel()
    rc = fn(x.data_ptr(), part.data_ptr(), out.data_ptr(), n, d, s,
            math.sqrt(math.log2(math.e) / (2.0 * std * std)), runtime.stream_handle(x))
    runtime.check(lib, NAME, rc)
    return out


op = runtime.define_op(
    NAME, "(Tensor x, float std, int tile) -> Tensor", kde_cuda, kde_plain,
    lambda x, std, tile: x.new_empty((x.shape[0],), dtype=torch.float32), flops)
