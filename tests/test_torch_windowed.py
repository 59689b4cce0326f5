"""The windowed warp gather in the port against the JAX package on the CPU:
the tile plan, `smoothness_ok` and the kernel's plain version against JAX
`_plan`, `smoothness_ok` and `_windowed_path(interpret=True)`; the public
`grid_sample_smooth` in both modes; the ConvRefiner and the debug-size
full-RoMa slice with `smooth_warp_gather`, against JAX with the windowed
kernel forced into interpret mode. Interpret-mode calls take ~10-15 s each
on the CPU and grow with C, so each case makes one, at C = 2, and shares it
through module fixtures.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roma_tpu.ops.grid_sample import grid_sample as j_grid_sample
from roma_tpu.ops.pallas import windowed_sample as jws
from roma_torch.kernels.windowed_sample import grid_sample_smooth
from roma_torch.ops import windowed_sample as tws
from roma_torch.ops.grid_sample import grid_sample as t_grid_sample
from test_pallas_kernels import _fast_mode_oracle, _smooth_sine_grid

# the window-clamped sample in float32 on both sides; 3e-5 as the JAX
# package's own fast-mode contract test (sums of 4 products in another order)
SAMPLE_TOL = 3e-5


def _rough(rng, grid):
    """Roughen tile (ty=1, tx=0) with large in-bounds displacements and send
    two pixels far out of range."""
    g = np.asarray(grid).copy()
    B = g.shape[0]
    g[:, 8:16, 0:128, :] = rng.uniform(-0.9, 0.9, (B, 8, 128, 2))
    g[:, 20, 130] = [40.0, -3.0]
    g[:, 3, 5] = [-1e5, 2e4]
    return g


CASES = {
    # name: (B, H, W, C, rough, output width Wo0 before edge padding)
    "smooth_ragged_width": (2, 32, 256, 2, False, 200),
    "rough_far_out_of_range": (1, 32, 256, 2, True, 256),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    B, H, W, C, rough, Wo0 = CASES[request.param]
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((B, H, W, C)).astype(np.float32)
    grid = np.array(_smooth_sine_grid(B, H, W))
    if rough:
        grid = _rough(rng, grid)
    grid = np.ascontiguousarray(grid[:, :, :Wo0])
    gp = np.array(jnp.pad(grid, ((0, 0), (0, 0), (0, (-Wo0) % 128), (0, 0)), mode="edge"))
    vhw = (H, Wo0)
    jplan = jws._plan(jnp.asarray(feat), jnp.asarray(gp), vhw)
    jout = np.asarray(jws._windowed_path(jnp.asarray(feat), jnp.asarray(gp), interpret=True,
                                         valid_hw=vhw))[:, :, :Wo0]
    return dict(feat=feat, grid=grid, gp=gp, vhw=vhw, rough=rough, jplan=jplan, jout=jout)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def test_plan_matches_jax(case):
    """Window origins, clamped offsets, weights, frame width and `ok`,
    exactly (weights to float32 rounding)."""
    tile, y0r, e, wx, wy, Wp, ok = case["jplan"]
    p = tws.plan(_nchw(case["feat"]), torch.from_numpy(case["gp"]), case["vhw"])
    tile = np.asarray(tile).reshape(*p.ybase.shape, 3)
    np.testing.assert_array_equal(p.ybase.numpy(), tile[..., 0] * 8)
    np.testing.assert_array_equal(p.j0_abs.numpy(), tile[..., 1] * 128 + tile[..., 2])
    np.testing.assert_array_equal(p.y0rel.numpy(), np.asarray(y0r))
    np.testing.assert_array_equal(p.e.numpy(), np.asarray(e))
    np.testing.assert_allclose(p.wx.numpy(), np.asarray(wx), atol=1e-6, rtol=0)
    np.testing.assert_allclose(p.wy.numpy(), np.asarray(wy), atol=1e-6, rtol=0)
    assert p.Wp == Wp
    assert bool(p.ok) == bool(ok) == (not case["rough"])
    assert bool(tws.smoothness_ok(_nchw(case["feat"]), torch.from_numpy(case["gp"]),
                                  case["vhw"])) == bool(ok)


def test_plain_matches_jax_interpret(case):
    """The kernel's plain version == `_windowed_path(interpret=True)` and the
    JAX test's numpy oracle; on the smooth batch also == grid_sample."""
    got = tws.windowed_sample_plain(_nchw(case["feat"]), torch.from_numpy(case["gp"]),
                                    case["vhw"]).permute(0, 2, 3, 1).numpy()
    assert got.shape == case["jout"].shape
    np.testing.assert_allclose(got, case["jout"], atol=SAMPLE_TOL, rtol=0)
    oracle = _fast_mode_oracle(case["feat"], case["gp"], case["vhw"])[:, :, :case["vhw"][1]]
    np.testing.assert_allclose(got, oracle, atol=SAMPLE_TOL, rtol=0)
    plain = np.asarray(j_grid_sample(jnp.asarray(case["feat"]), jnp.asarray(case["grid"])))
    if case["rough"]:
        assert np.abs(got - plain).max() > 1e-2  # the clamp bites on the rough tile
    else:
        np.testing.assert_allclose(got, plain, atol=SAMPLE_TOL, rtol=0)


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_grid_sample_smooth_modes(case, mode):
    """The public wrapper (JAX layout): "exact" equals grid_sample on both
    batches (windowed when smooth, plain otherwise); "fast" equals the
    window-clamped result; `with_ok` returns the plan's flag."""
    feat, grid = torch.from_numpy(case["feat"]), torch.from_numpy(case["grid"])
    got, ok = grid_sample_smooth(feat, grid, mode=mode, with_ok=True)
    assert bool(ok) == (not case["rough"])
    ref = case["jout"] if mode == "fast" else np.asarray(t_grid_sample(feat, grid))
    np.testing.assert_allclose(got.numpy(), ref, atol=SAMPLE_TOL, rtol=0)
    assert torch.equal(grid_sample_smooth(feat, grid, mode=mode), got)


def test_grid_sample_smooth_channel_gate_and_modes(rng):
    """C > 16 takes plain grid_sample in either mode (with_ok still reports
    the plan's flag); unknown modes raise."""
    B, H, W = 1, 32, 256
    feat = torch.from_numpy(rng.standard_normal((B, H, W, 32)).astype(np.float32))
    rough = torch.from_numpy(_rough(rng, np.asarray(_smooth_sine_grid(B, H, W)))
                             .astype(np.float32))
    got, ok = grid_sample_smooth(feat, rough, mode="fast", with_ok=True)
    assert torch.equal(got, t_grid_sample(feat, rough)) and not bool(ok)
    with pytest.raises(ValueError, match="mode"):
        grid_sample_smooth(feat[..., :8], rough, mode="approximate")


# ---------------------------------------------------------------- in the model

@pytest.fixture
def force_interpret():
    jws._FORCE_INTERPRET = True
    try:
        yield
    finally:
        jws._FORCE_INTERPRET = False


@pytest.mark.parametrize("smooth_warp,rough", [("fast", True), (True, False)])
@torch.no_grad()
def test_refiner_smooth_warp(rng, force_interpret, smooth_warp, rough):
    """A narrow refiner (C = 3, so the interpret-mode kernel compiles
    quickly; the gate is C <= 16) with the windowed warp: "fast" on a rough
    flow (clamped tiles inside the model), exact on a smooth flow (the
    windowed branch). fp32; tolerance 1e-3 as the other refiner tests."""
    from roma_tpu.models import port as jport
    from roma_tpu.models.refiner import ConvRefiner as JConvRefiner
    from roma_torch.models.refiner import ConvRefiner

    B, H, W, C = 1, 16, 128, 3
    torch.manual_seed(0)
    mod = ConvRefiner(8, 8, 2, None, hidden_blocks=1, dtype=torch.float32,
                      smooth_warp=smooth_warp).eval()
    params, stats = jport.port_conv_refiner(
        {k: v.numpy() for k, v in mod.state_dict().items()}, hidden_blocks=1)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    y = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = np.array(_smooth_sine_grid(B, H, W), np.float32)
    if rough:
        flow = rng.uniform(-1, 1, (B, H, W, 2)).astype(np.float32)
    jmod = JConvRefiner(hidden_dim=8, displacement_emb_dim=2, hidden_blocks=1,
                        dtype=jnp.float32, smooth_warp=smooth_warp)
    rflow, rcert = jmod.apply({"params": params, "batch_stats": stats}, x, y, flow)
    dflow, dcert = mod(_nchw(x), _nchw(y), torch.from_numpy(flow))
    np.testing.assert_allclose(dflow.numpy(), np.asarray(rflow), atol=1e-3, rtol=0)
    np.testing.assert_allclose(dcert.numpy(), np.asarray(rcert), atol=1e-3, rtol=0)


def test_debug_slice_fast_smooth_warp(force_interpret):
    """`debug_roma_config()` with smooth_warp_gather="fast" in fp32, JAX
    weights carried into the port: `match()` (both passes; the scale-1 warp
    of each goes through the windowed gather, clamped on the random-weight
    flows) agrees with JAX. The warp is held to 1e-4 everywhere, as in the
    plain slice test. The certainty is held to 1e-4 on all but 0.5% of the
    pixels and to 1e-2 on the rest: where the clamp bites, the fast-mode
    sample jumps when a bilinear base or a tile's window origin moves by one
    pixel, and the two frameworks' scale-1 flows differ by ~1e-6 (a 1e-6
    perturbation of the port's own flow moves 8 certainties by up to 2e-4;
    the measured gap to JAX is 144 of 100,352 values, at most 4.8e-3)."""
    from roma_tpu.models.matcher import RomaMatcher as JMatcher
    from roma_tpu.models.zoo import debug_roma_config as j_debug_config
    from roma_torch.models.matcher import RomaMatcher, RomaModel
    from roma_torch.models.port import state_dict_from_jax
    from roma_torch.models.zoo import debug_roma_config

    kw = dict(dtype="float32", smooth_warp_gather="fast")
    jm = JMatcher.init(jax.random.PRNGKey(0), dataclasses.replace(j_debug_config(), **kw))
    model = RomaModel(dataclasses.replace(debug_roma_config(), **kw))
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jm.params)),
                          strict=True)
    tm = RomaMatcher(model, device="cpu")
    rng = np.random.default_rng(5)
    im_a, im_b = (rng.uniform(0, 1, (1, 140, 180, 3)).astype(np.float32) for _ in range(2))
    rw, rc = jm.match(im_a, im_b, batched=True)
    w, c = tm.match(im_a, im_b, batched=True)
    assert tuple(w.shape) == (1, 224, 448, 4)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-4, rtol=0)
    dc = np.abs(c.numpy() - np.asarray(rc))
    assert (dc > 1e-4).mean() <= 5e-3 and dc.max() <= 1e-2, (int((dc > 1e-4).sum()), dc.max())
