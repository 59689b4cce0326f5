"""The local-correlation kernel's design on the CPU: its tile plan (which
8 x 8 tiles take the shared-window path), a Python emulation of both of its
paths against the plain version and the JAX Pallas kernel in interpret mode,
and the index maps by which its two kernels split the tiles. The kernels
themselves run only on the card (`chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops.pallas.block_gather import local_correlation_dma
from roma_torch.kernels import local_corr as tlc
from roma_torch.ops.local_corr import corner_coords, prescale

TILE = tlc.TILE


def _flow(rng, kind, B, H, W):
    """Normalized flows: "coherent" (identity plus a smooth shift, a few
    pixels of scatter), "scattered" (uniform over and past the image) or
    "far" (coherent, with whole rows and single pixels far out of range and
    some windows half outside the image)."""
    ys, xs = np.meshgrid((np.arange(H) + 0.5) / H * 2 - 1, (np.arange(W) + 0.5) / W * 2 - 1,
                         indexing="ij")
    base = np.stack([xs, ys], -1)[None].repeat(B, 0)
    if kind == "scattered":
        return rng.uniform(-1.3, 1.3, (B, H, W, 2)).astype(np.float32)
    flow = base + 0.15 * np.sin(base[..., ::-1] * 3) + rng.normal(0, 0.5 / H, (B, H, W, 2))
    if kind == "far":
        flow[0, 0, 0] = [1e5, -3e4]
        flow[0, 2] = [-7.0, 0.2]
        flow[-1, :, -3:] += [1.0, 0.0]  # past the right edge by half the image
    return flow.astype(np.float32)


def _inputs(rng, B, H, W, C, kind):
    f0 = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).to(torch.bfloat16)
    f1 = torch.from_numpy(rng.standard_normal((B, H, W, C)).astype(np.float32)).to(torch.bfloat16)
    return f0, f1, torch.from_numpy(_flow(rng, kind, B, H, W))


def _windows(flow, r):
    """Per pixel: window origin (x0 - r, y0 - r) and the window clipped to
    the image (xa, xb, ya, yb), as numpy ints."""
    B, H, W, _ = flow.shape
    x0, y0, _, _ = corner_coords(flow, H, W, r)
    ox, oy = (x0 - r).numpy(), (y0 - r).numpy()
    K2 = 2 * r + 2
    return ox, oy, np.maximum(ox, 0), np.minimum(ox + K2 - 1, W - 1), np.maximum(oy, 0), \
        np.minimum(oy + K2 - 1, H - 1)


def _tiles(B, H, W):
    for b in range(B):
        for ty in range(0, H, TILE):
            for tx in range(0, W, TILE):
                ys, xs = np.meshgrid(np.arange(ty, min(ty + TILE, H)),
                                     np.arange(tx, min(tx + TILE, W)), indexing="ij")
                yield b, ty // TILE, tx // TILE, ys.ravel(), xs.ravel()


def emulate(f0, f1, r, flow, force=None):
    """Both paths of the kernel, tile by tile, in float64: the path
    `tile_plan` chooses (or `force`: "shared" or "pixel" for every tile).
    Shared-window path: the tile's window box (the union of its pixels'
    windows clipped to the image), the P x U scores as one product, and
    every score whose box pixel lies in a pixel's window scattered into
    that pixel's corners (the kernel's unsigned range test); the box must
    hold every in-range corner. Per-pixel path: each pixel's in-range
    corners dotted one by one. Then the bilinear combine."""
    B, H, W, C = f0.shape
    K2, k = 2 * r + 2, 2 * r + 1
    plan = tlc.tile_plan(flow, r)
    ox, oy, xa, xb, ya, yb = _windows(flow, r)
    f0s, f1d = prescale(f0).double(), f1.double()
    g = torch.zeros((B, H, W, K2, K2), dtype=torch.float64)
    for b, ty, tx, ys, xs in _tiles(B, H, W):
        shared = bool(plan.shared[b, ty, tx]) if force is None else force == "shared"
        ok = (xa[b, ys, xs] <= xb[b, ys, xs]) & (ya[b, ys, xs] <= yb[b, ys, xs])
        corners = int(((xb - xa + 1) * (yb - ya + 1))[b, ys, xs][ok].sum())
        assert corners == int(plan.corners[b, ty, tx])
        if not ok.any():
            assert int(plan.union[b, ty, tx]) == 0
            continue
        if shared:
            bx0, bx1 = xa[b, ys, xs][ok].min(), xb[b, ys, xs][ok].max()
            by0, by1 = ya[b, ys, xs][ok].min(), yb[b, ys, xs][ok].max()
            assert (bx1 - bx0 + 1) * (by1 - by0 + 1) == int(plan.union[b, ty, tx])
            Y, X = (t.ravel() for t in np.meshgrid(np.arange(by0, by1 + 1),
                                                   np.arange(bx0, bx1 + 1), indexing="ij"))
            S = f0s[b, ys, xs] @ f1d[b, Y, X].T                       # P x U
            DX = X[None] - ox[b, ys, xs][:, None]
            DY = Y[None] - oy[b, ys, xs][:, None]
            hit = (DX >= 0) & (DX < K2) & (DY >= 0) & (DY < K2)
            assert hit.sum() == corners  # the box holds every in-range corner once
            pi, ui = np.nonzero(hit)
            g[b, ys[pi], xs[pi], DY[pi, ui], DX[pi, ui]] = S[pi, ui]
        else:
            for y, x in zip(ys, xs):
                for dy in range(K2):
                    for dx in range(K2):
                        yy, xx = oy[b, y, x] + dy, ox[b, y, x] + dx
                        if 0 <= yy < H and 0 <= xx < W:
                            g[b, y, x, dy, dx] = f0s[b, y, x] @ f1d[b, yy, xx]
    _, _, wx, wy = corner_coords(flow, H, W, r)
    wx, wy = wx.double()[..., None, None], wy.double()[..., None, None]
    out = ((1 - wy) * (1 - wx) * g[..., :k, :k] + (1 - wy) * wx * g[..., :k, 1:]
           + wy * (1 - wx) * g[..., 1:, :k] + wy * wx * g[..., 1:, 1:])
    return out.reshape(B, H, W, k * k).float()


KINDS = ("coherent", "scattered", "far")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("r,C", [(0, 128), (2, 256), (3, 512), (7, 128)])
def test_local_corr_paths_emulated_match_plain(rng, kind, r, C):
    """Every tile on the shared-window path, every tile on the per-pixel
    path, and the plan's mix, each against the plain version on H and W off
    the tile. Tolerance 1e-5: float64 against float32 sums of the same
    products."""
    f0, f1, flow = _inputs(rng, 2, 13, 19, C, kind)
    ref = tlc.local_correlation(f0, f1, r, flow)
    for force in ("shared", "pixel", None):
        got = emulate(f0, f1, r, flow, force)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=0, err_msg=str(force))
    if kind == "far":
        assert np.all(ref.numpy()[0, 0, 0] == 0.0)


@pytest.mark.parametrize("kind,shape,r", [("coherent", (1, 18, 21, 128), 7),
                                          ("scattered", (2, 11, 17, 256), 3),
                                          ("far", (1, 16, 9, 128), 2)])
def test_local_corr_plan_emulated_matches_pallas_interpret(rng, kind, shape, r):
    """The plan's mix of paths against the JAX kernel in interpret mode.
    Tolerance 1e-5, as the plain version's test."""
    B, H, W, C = shape
    f0, f1, flow = _inputs(rng, B, H, W, C, kind)
    ref = np.asarray(local_correlation_dma(
        jnp.asarray(f0.float().numpy(), jnp.bfloat16), jnp.asarray(f1.float().numpy(), jnp.bfloat16),
        r, jnp.asarray(flow.numpy()), interpret=True))
    np.testing.assert_allclose(emulate(f0, f1, r, flow).numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("r", [2, 7])
def test_tile_plan_against_a_direct_count(rng, kind, r):
    """`tile_plan` against a count tile by tile: in-range corners, the
    union's bounding box, and the rule r >= 5 and 4 U <= corners."""
    B, H, W = 2, 21, 30
    flow = torch.from_numpy(_flow(rng, kind, B, H, W))
    plan = tlc.tile_plan(flow, r)
    assert plan.shared.shape == (B, 3, 4)
    _, _, xa, xb, ya, yb = _windows(flow, r)
    for b, ty, tx, ys, xs in _tiles(B, H, W):
        ok = (xa[b, ys, xs] <= xb[b, ys, xs]) & (ya[b, ys, xs] <= yb[b, ys, xs])
        corners = int(((xb - xa + 1) * (yb - ya + 1))[b, ys, xs][ok].sum())
        union = 0
        if ok.any():
            union = int((xb[b, ys, xs][ok].max() - xa[b, ys, xs][ok].min() + 1)
                        * (yb[b, ys, xs][ok].max() - ya[b, ys, xs][ok].min() + 1))
        assert (int(plan.corners[b, ty, tx]), int(plan.union[b, ty, tx])) == (corners, union)
        assert bool(plan.shared[b, ty, tx]) == (r >= 5 and union > 0 and 4 * union <= corners)


def test_tile_plan_paths_follow_the_flow(rng):
    """At r = 7 coherent flows put every tile on the shared-window path and
    uniformly scattered ones put the tiles of a 96 x 96 map on the
    per-pixel path; below r = 5 every tile takes the per-pixel path; at
    40 x 40 and r = 7 (coarse scale 16) any flow fits."""
    coherent = torch.from_numpy(_flow(rng, "coherent", 1, 64, 64))
    assert bool(tlc.tile_plan(coherent, 7).shared.all())
    plan = tlc.tile_plan(coherent, 4)
    assert bool((4 * plan.union <= plan.corners).all()) and not bool(plan.shared.any())
    plan = tlc.tile_plan(torch.from_numpy(_flow(rng, "scattered", 1, 96, 96)), 7)
    assert not bool(plan.shared.any())
    plan = tlc.tile_plan(torch.from_numpy(_flow(rng, "scattered", 2, 40, 40)), 7)
    assert bool(plan.shared.all())


@pytest.mark.parametrize("B,H,W,grid", [(4, 40, 40, 132), (1, 13, 19, 2), (3, 70, 70, 5)])
def test_kernels_split_the_tiles(B, H, W, grid):
    """The index maps of the CUDA code: the per-pixel kernel's warp for
    linear pixel p finds its tile by (b, y, x), each tile's path is recorded
    by the warp of its first pixel only, and the shared kernel's sweep (block
    i, thread j: tile t0 + j * grid for t0 = i, i + grid * 256, ...) visits
    every tile once; a tile holds the pixels of the image that it covers."""
    th, tw = -(-H // TILE), -(-W // TILE)
    n_tiles = B * th * tw
    p = np.arange(B * H * W)
    b, yx = p // (H * W), p % (H * W)
    y, x = yx // W, yx % W
    tile = (b * th + y // TILE) * tw + x // TILE
    np.testing.assert_array_equal(np.bincount(tile, minlength=n_tiles),
                                  np.minimum(H - np.arange(th) * TILE, TILE)[None, :, None]
                                  .repeat(B, 0).repeat(tw, 2).ravel()
                                  * np.tile(np.minimum(W - np.arange(tw) * TILE, TILE), B * th))
    first = ((x | y) & (TILE - 1)) == 0
    np.testing.assert_array_equal(np.sort(tile[first]), np.arange(n_tiles))
    seen = np.zeros(n_tiles, int)
    for i in range(min(n_tiles, grid)):
        for t0 in range(i, n_tiles, grid * 256):
            t = t0 + np.arange(256) * grid
            seen[t[t < n_tiles]] += 1
    np.testing.assert_array_equal(seen, 1)
