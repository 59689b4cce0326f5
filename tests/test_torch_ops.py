"""roma_torch ops and geometry against the JAX package on the CPU (fp32).
Tolerance: 1e-5 max-abs for single ops unless stated beside the assert."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.ops import corr as jcorr
from roma_tpu.ops.grid_sample import grid_sample as j_grid_sample
from roma_tpu.ops import resize as jres
from roma_tpu.utils import geometry as jgeo
from roma_torch.ops import corr as tcorr
from roma_torch.ops.grid_sample import grid_sample as t_grid_sample
from roma_torch.ops import resize as tres
from roma_torch.utils import geometry as tgeo


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, ref, atol):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


@pytest.mark.parametrize("h,w", [(7, 9), (40, 40), (1, 5)])
def test_coord_grid_and_get_grid(h, w):
    _close(tcorr.coord_grid(h, w), jcorr.coord_grid(h, w), 1e-6)
    _close(tgeo.get_grid(2, h, w), jgeo.get_grid(2, h, w), 1e-6)


def test_normalized_to_pixel(rng):
    c = rng.uniform(-1, 1, (3, 5, 2)).astype(np.float32)
    _close(tgeo.normalized_to_pixel(_t(c), 30, 40),
           jgeo.normalized_to_pixel(jnp.asarray(c), 30, 40), 1e-5)
    np.testing.assert_allclose(tgeo.normalized_to_pixel(c, 30, 40),
                               jgeo.normalized_to_pixel(c, 30, 40))


@pytest.mark.parametrize("res", [4, 8])
def test_cls_to_flow_refine(rng, res):
    cls = rng.standard_normal((2, 5, 6, res * res)).astype(np.float32) * 3
    _close(tgeo.cls_to_flow_refine(_t(cls)), jgeo.cls_to_flow_refine(jnp.asarray(cls)), 1e-5)


@pytest.mark.parametrize(
    "lo,hi,padding",
    [(-1.3, 1.3, "zeros"), (-1.3, 1.3, "border"), (-40.0, 40.0, "zeros")],
)
def test_grid_sample_matches_jax(rng, lo, hi, padding):
    """Includes out-of-range and far-out-of-range targets."""
    feat = rng.standard_normal((2, 13, 17, 5)).astype(np.float32)
    grid = rng.uniform(lo, hi, (2, 9, 11, 2)).astype(np.float32)
    grid[0, 0, 0] = [1e6, -1e6]
    ref = j_grid_sample(jnp.asarray(feat), jnp.asarray(grid), padding)
    _close(t_grid_sample(_t(feat), _t(grid), padding), ref, 1e-5)


@pytest.mark.parametrize("c", [3, 300])
def test_grid_sample_point_lists_and_channel_widths(rng, c):
    """(B, L, 2) point lists; C > 256 takes the JAX per-corner formulation."""
    feat = rng.standard_normal((1, 6, 7, c)).astype(np.float32)
    pts = rng.uniform(-1.1, 1.1, (1, 15, 2)).astype(np.float32)
    ref = j_grid_sample(jnp.asarray(feat), jnp.asarray(pts))
    _close(t_grid_sample(_t(feat), _t(pts)), ref, 1e-5)


@pytest.mark.parametrize("size", [(26, 34), (7, 9), (5, 30), (108, 108)])
def test_interpolate_bilinear(rng, size):
    """Up- and down-scaling (the upsample pass shrinks 112^2 flows to 108^2
    at full size); no antialiasing on either side."""
    x = rng.standard_normal((2, 13, 17, 3)).astype(np.float32)
    if size == (108, 108):
        x = rng.standard_normal((1, 112, 112, 2)).astype(np.float32)
    ref = jres.interpolate_bilinear(jnp.asarray(x), size)
    _close(tres.interpolate_bilinear(_t(x), size), ref, 1e-5)


@pytest.mark.parametrize("src,size", [((35, 47), (24, 28)), ((20, 22), (41, 39)),
                                      ((30, 30), (30, 30)), ((50, 40), (14, 70))])
def test_resize_bicubic_antialias_matches_jax(rng, src, size):
    """JAX's Keys a=-0.5 antialiased cubic == PyTorch's antialiased bicubic
    (down, up, identity and mixed). Tolerance 1e-4: both renormalise the
    border taps, in different summation orders."""
    x = rng.uniform(0, 1, (2, *src, 3)).astype(np.float32)
    ref = jres.resize_bicubic(jnp.asarray(x), size)
    _close(tres.resize_bicubic(_t(x), size), ref, 1e-4)


@pytest.mark.parametrize("scale", [None, ((8 + 0.1) / 37, (6 + 0.1) / 37)])
def test_torch_bicubic_resize_keeps_caller_scale(rng, scale):
    """DINOv2's pos-embed resize: a=-0.75 bicubic with the +0.1 scale
    kludge; also checked against PyTorch's own F.interpolate call form."""
    x = rng.standard_normal((1, 37, 37, 4)).astype(np.float32)
    ref = jres.torch_bicubic_resize(jnp.asarray(x), (8, 6), scale=scale)
    got = tres.torch_bicubic_resize(_t(x), (8, 6), scale=scale)
    _close(got, ref, 1e-5)
    kw = dict(size=(8, 6)) if scale is None else dict(scale_factor=scale)
    direct = torch.nn.functional.interpolate(
        _t(x).permute(0, 3, 1, 2), mode="bicubic", align_corners=False, **kw
    ).permute(0, 2, 3, 1)
    _close(got, direct.numpy(), 1e-4)  # same weights, another summation order
