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


# ---------------------------------------------------------------- the tail (A14)

@pytest.fixture
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grid_sample_nearest_matches_jax_exactly(rng, padding, dtype):
    """`grid_sample_nearest` against the JAX function, exactly: a (2, 6, 8, 5)
    map at a grid of half-pixel ties (pixel coordinates k + 0.5, where
    `F.grid_sample` would round to even), a random (2, 3, 4) grid reaching
    outside the map, and a point list (2, 11)."""
    import jax

    from roma_tpu.ops.grid_sample import grid_sample_nearest as j_nearest
    from roma_torch.ops import grid_sample_nearest as t_nearest

    feat = rng.standard_normal((2, 6, 8, 5)).astype(np.float32)
    xs = np.arange(-1, 10) * 0.25 - 1.0          # px = 2 (x + 1) * 2 - 0.5 on W = 8
    ys = np.arange(-1, 8) / 3.0 - 1.0            # py = (y + 1) * 3 - 0.5 on H = 6
    ties = np.stack(np.meshgrid(xs, ys), -1).astype(np.float32)
    grids = [np.broadcast_to(ties, (2, *ties.shape)),
             rng.uniform(-1.3, 1.3, (2, 3, 4, 2)).astype(np.float32),
             rng.uniform(-1.1, 1.1, (2, 11, 2)).astype(np.float32)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    for grid in grids:
        ref = np.asarray(j_nearest(jnp.asarray(feat).astype(jdt), jnp.asarray(grid), padding)
                         .astype(jnp.float32))
        got = t_nearest(_t(feat).to(getattr(torch, dtype)), _t(grid), padding)
        assert got.dtype == getattr(torch, dtype) and got.shape == ref.shape
        np.testing.assert_array_equal(got.float().numpy(), ref)
    # pixel coordinates 0.5, 1.5, 2.5 on a 4-wide map: floor(px + 0.5) reads
    # columns 1, 2, 3, where F.grid_sample's nearest mode (ties to even) reads 0, 2, 2
    tie = torch.tensor([[[-0.5, 0.0], [0.0, 0.0], [0.5, 0.0]]])
    one_row = torch.arange(4.0).reshape(1, 1, 4, 1)
    assert t_nearest(one_row, tie)[..., 0].tolist() == [[1.0, 2.0, 3.0]]
    assert jax.device_get(j_nearest(jnp.asarray(one_row.numpy()), jnp.asarray(tie.numpy()))
                          )[..., 0].tolist() == [[1.0, 2.0, 3.0]]
    torch_nearest = torch.nn.functional.grid_sample(
        one_row.permute(0, 3, 1, 2), tie[:, None], mode="nearest", align_corners=False)
    assert torch_nearest.flatten().tolist() == [0.0, 2.0, 2.0]


def test_geometry_helpers_match_jax(rng):
    """The helpers the JAX package's `utils` exports beside the ones above."""
    c = rng.uniform(0, 40, (3, 5, 2)).astype(np.float32)
    _close(tgeo.pixel_to_normalized(_t(c), 30, 40),
           jgeo.pixel_to_normalized(jnp.asarray(c), 30, 40), 1e-6)
    np.testing.assert_allclose(tgeo.pixel_to_normalized(c, 30, 40),
                               jgeo.pixel_to_normalized(c, 30, 40))
    w = rng.uniform(-1, 1, (4, 4)).astype(np.float32)
    for got, ref in zip(tgeo.warp_to_pixel_coordinates(_t(w), 30, 40, 20, 50),
                        jgeo.warp_to_pixel_coordinates(jnp.asarray(w), 30, 40, 20, 50)):
        _close(got, ref, 1e-5)
    cls = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    _close(tgeo.cls_to_flow(_t(cls)), jgeo.cls_to_flow(jnp.asarray(cls)), 1e-6)


def _op_inputs():
    """Tiny CPU inputs for each roma:: operator, in its schema's order."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dt=torch.float32: torch.randn(s, generator=g).to(dt)  # noqa: E731
    u = lambda *s: torch.rand(s, generator=g) * 2 - 1  # noqa: E731
    bf = torch.bfloat16
    qkv = r(1, 9, 3, 2, 64, dt=bf)  # views of a fused qkv, as Attention passes them
    return {
        "local_corr": (r(1, 6, 7, 128, dt=bf), r(1, 6, 7, 128, dt=bf), 2, u(1, 6, 7, 2)),
        "dw_chain": (r(1, 8, 6, 7, dt=bf), r(2, 5, 5, 8, dt=bf), r(2, 8), r(2, 8),
                     r(2, 8, 8, dt=bf), r(2, 8)),
        "flash_attn": (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]),
        "flash_attn_lse": (r(1, 9, 2, 64, dt=bf), r(1, 9, 2, 64, dt=bf), r(1, 9, 2, 64, dt=bf)),
        "corr_softmax": (r(1, 12, 64, dt=bf), r(1, 10, 64, dt=bf), u(10, 2)),
        "windowed_sample": (r(1, 4, 9, 11), u(1, 5, 6, 2), True, True),
        "dw_affine_relu": (r(1, 8, 6, 7, dt=bf), r(5, 5, 8, dt=bf), r(8), r(8)),
        "dw_block_mm": (r(1, 8, 6, 7, dt=bf), r(5, 5, 8, dt=bf), r(8), r(8), r(8, 8, dt=bf),
                        r(8)),
        "kde": (u(37, 4), 0.1, 16),
    }


OP_NAMES = ["local_corr", "dw_chain", "flash_attn", "flash_attn_lse", "corr_softmax",
            "windowed_sample", "dw_affine_relu", "dw_block_mm", "kde"]


@pytest.mark.parametrize("name", OP_NAMES)
def test_roma_operator_opcheck(few_threads, name):
    """`torch.library.opcheck` of each kernel's operator on the CPU: its
    schema, autograd registration, fake implementation (shapes, dtypes and
    strides against the CPU implementation's) and AOT dispatch."""
    from roma_torch.kernels import OPS

    res = torch.library.opcheck(OPS[name], _op_inputs()[name])
    assert set(res.values()) == {"SUCCESS"}, res


@pytest.mark.parametrize("name", OP_NAMES)
def test_roma_operator_flop_formula(few_threads, name):
    """Each operator's FLOP formula equals FlopCounterMode over its plain
    version on the same inputs, and the operator's CPU implementation is
    the plain version (equal outputs)."""
    from torch.utils.flop_counter import FlopCounterMode

    from roma_torch.kernels import OPS, PLAIN

    args = _op_inputs()[name]
    with FlopCounterMode(display=False) as op_count:
        got = OPS[name](*args)
    with FlopCounterMode(display=False) as plain_count:
        ref = PLAIN[name](*args)
    assert op_count.get_total_flops() == plain_count.get_total_flops()
    assert op_count.get_flop_counts()["Global"].keys() == {getattr(torch.ops.roma, name)}
    if name != "windowed_sample":
        assert op_count.get_total_flops() > 0
    for a, b in zip(*((x,) if torch.is_tensor(x) else x for x in (got, ref))):
        assert torch.equal(a, b)


def test_wrappers_go_through_the_operators(few_threads, monkeypatch):
    """A call that autograd does not record reaches the operator on the
    CPU too (counted by a dispatch mode); one that it records takes the
    plain version (attention) or `PlainBackward` (the depthwise block)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from roma_torch.kernels import attention, dw_affine_relu

    seen = []

    class Spy(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.namespace == "roma":
                seen.append(func.name())
            return func(*args, **(kwargs or {}))

    ins = _op_inputs()
    q, k, v = (t.float() for t in ins["flash_attn_lse"])
    x, w, sc, sh = ins["dw_affine_relu"]
    with Spy():
        attention.attention(q, k, v)
        dw_affine_relu.dw5x5_affine_relu_nchw(x, w, sc, sh)
    assert seen == ["roma::flash_attn", "roma::dw_affine_relu"]
    seen.clear()
    with Spy():
        out = attention.attention(q.requires_grad_(), k, v)
        y = dw_affine_relu.dw5x5_affine_relu_nchw(x.float().requires_grad_(), w.float(), sc, sh)
    assert seen == ["roma::dw_affine_relu"] and out.grad_fn is not None
    assert type(y.grad_fn).__name__ == "PlainBackwardBackward"


def test_tiny_flops_are_the_same_with_the_fused_kernel(few_threads):
    """Tiny RoMa's forward counts the same FLOPs through K7's operator as
    through the correlation volume and its exact expectation."""
    from torch.utils.flop_counter import FlopCounterMode

    from roma_torch.config import TinyRomaConfig
    from roma_torch.models.zoo import build_model

    x = torch.rand((1, 64, 64, 3), generator=torch.Generator().manual_seed(0))
    counts = []
    for fused in (False, True):
        model = build_model(TinyRomaConfig(fused_kernel=fused, dtype="float32"), 0).eval()
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            model(x, x)
        counts.append(fc.get_total_flops())
    assert counts[0] == counts[1] > 0
