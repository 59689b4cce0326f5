"""The windowed warp gather in the port against the JAX package on the CPU:
the tile plan, `smoothness_ok` and the kernel's plain version against JAX
`_plan`, `smoothness_ok` and `_windowed_path(interpret=True)`; the CUDA
kernel's own per-tile plan (mirrored in plain PyTorch) against both; the
plain exact mode against JAX `grid_sample`; the public `grid_sample_smooth`
in both modes; the ConvRefiner and the debug-size full-RoMa slice with
`smooth_warp_gather`, against JAX with the windowed kernel forced into
interpret mode. Interpret-mode calls take ~10-15 s each
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
from roma_torch.kernels import LAUNCHES
from roma_torch.kernels.windowed_sample import grid_sample_smooth, windowed_sample_cuda
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


def _edge_pad(grid):
    """The JAX wrapper's edge padding of a grid to (8, 128) tile multiples."""
    return np.array(jnp.pad(grid, ((0, 0), (0, (-grid.shape[1]) % 8),
                                   (0, (-grid.shape[2]) % 128), (0, 0)), mode="edge"))


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    B, H, W, C, rough, Wo0 = CASES[request.param]
    rng = np.random.default_rng(1)
    feat = rng.standard_normal((B, H, W, C)).astype(np.float32)
    grid = np.array(_smooth_sine_grid(B, H, W))
    if rough:
        grid = _rough(rng, grid)
    grid = np.ascontiguousarray(grid[:, :, :Wo0])
    gp = _edge_pad(grid)
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
    batches (window taps where the window holds them, the map's elsewhere);
    "fast" equals the window-clamped result; `with_ok` returns the plan's
    flag."""
    feat, grid = torch.from_numpy(case["feat"]), torch.from_numpy(case["grid"])
    got, ok = grid_sample_smooth(feat, grid, mode=mode, with_ok=True)
    assert bool(ok) == (not case["rough"])
    ref = case["jout"] if mode == "fast" else np.asarray(t_grid_sample(feat, grid))
    np.testing.assert_allclose(got.numpy(), ref, atol=SAMPLE_TOL, rtol=0)
    assert torch.equal(grid_sample_smooth(feat, grid, mode=mode), got)


def _kernel_plan(feat_hw, grid):
    """The CUDA kernel's per-block plan, tile by tile in plain PyTorch: the
    tile's grid values read from the unpadded grid with the index clamped to
    the last row and column (no padded copy), the bases with the plan's
    float32 arithmetic, the minima of the frame row and of the disparity
    over the tile's real pixels, the plan's clamps, and the tile's validity.
    Returns ybase, j0_abs (B, tile rows, tile columns) and the whole-batch
    `ok`."""
    H, W = feat_hw
    B, Ho, Wo = grid.shape[:3]
    Wp = tws.frame_width(W)
    n_ty, n_tx = -(-Ho // tws.TH), -(-Wo // tws.TW)
    ybase = torch.zeros((B, n_ty, n_tx), dtype=torch.int32)
    j0_abs = torch.zeros_like(ybase)
    ok = True
    for b in range(B):
        for ty in range(n_ty):
            for tx in range(n_tx):
                h = ty * tws.TH + torch.arange(tws.TH)
                w = tx * tws.TW + torch.arange(tws.TW)
                g = grid[b][h.clamp_max(Ho - 1)][:, w.clamp_max(Wo - 1)]
                x0, y0, _, _ = tws.base_coords(g, H, W)
                real = (h < Ho)[:, None] & (w < Wo)[None, :]
                y0i = (y0 + tws.PAD).clamp(0, H + 2 * tws.PAD - 2)
                d = (x0 + tws.PADX).clamp(0, Wp - 2) - w[None, :]
                jt = int((d[real].min() + tx * tws.TW).clamp(0, Wp - tws.NXB * 128))
                yt = int(y0i[real].min().clamp(0, H + 2 * tws.PAD - 2)) // 8 * 8
                yrel, e = y0i - yt, d - (jt - tx * tws.TW)
                inb = (x0 >= -1) & (x0 < W) & (y0 >= -1) & (y0 < H)
                valid = ((yrel <= tws.WIN_ROWS - 2) & (e >= 0) & (e <= tws.E - 2) & inb)[real]
                ok = ok and bool(valid.all())
                ybase[b, ty, tx], j0_abs[b, ty, tx] = yt, jt
    return ybase, j0_abs, ok


def _plan_case(name):
    """Two cases beyond CASES for the plan alone: a last tile column with
    two real columns (Wo0 = 130), and `ok` false through one pixel just
    above the image (its base row is -2, inside its tile's window)."""
    rng = np.random.default_rng(2)
    if name == "two_real_columns":
        B, H, W = 2, 16, 130
        feat = rng.standard_normal((B, H, W, 2)).astype(np.float32)
        grid = np.array(_smooth_sine_grid(B, H, W), np.float32)
    else:
        B, H, W = 1, 16, 256
        feat = rng.standard_normal((B, H, W, 2)).astype(np.float32)
        grid = np.array(_smooth_sine_grid(B, H, W), np.float32)
        grid[0, 0, 5, 1] = -1.0 - 2.0 / H  # pixel row -1.5: base row -2
    return feat, grid


@pytest.mark.parametrize("name", ["two_real_columns", "oob_only"])
def test_kernel_plan_matches_plan_on_edge_cases(name):
    """The kernel's per-tile plan == `plan()` == JAX `_plan` (origins, `ok`)
    on the unpadded grid; in the second case only the out-of-bounds pixel
    clears `ok`: every real pixel's offsets lie in its window."""
    feat, grid = _plan_case(name)
    H, W = feat.shape[1:3]
    vhw = grid.shape[1:3]
    ybase, j0_abs, ok = _kernel_plan((H, W), torch.from_numpy(grid))
    gp = _edge_pad(grid)
    p = tws.plan(_nchw(feat), torch.from_numpy(gp), vhw)
    tile = np.asarray(jws._plan(jnp.asarray(feat), jnp.asarray(gp), vhw)[0]).reshape(
        *p.ybase.shape, 3)
    assert torch.equal(ybase, p.ybase) and torch.equal(j0_abs, p.j0_abs)
    np.testing.assert_array_equal(ybase.numpy(), tile[..., 0] * 8)
    np.testing.assert_array_equal(j0_abs.numpy(), tile[..., 1] * 128 + tile[..., 2])
    jok = bool(jws._plan(jnp.asarray(feat), jnp.asarray(gp), vhw)[6])
    assert ok == bool(p.ok) == jok == (name == "two_real_columns")
    assert bool(p.inwin[:, :vhw[0], :vhw[1]].all())


def test_kernel_plan_matches_plan(case):
    """On CASES (a ragged smooth batch, a rough one with pixels far out of
    range), the kernel's per-tile plan == `plan()` == JAX `_plan`."""
    feat = case["feat"]
    ybase, j0_abs, ok = _kernel_plan(feat.shape[1:3], torch.from_numpy(case["grid"]))
    tile = np.asarray(case["jplan"][0]).reshape(*ybase.shape, 3)
    np.testing.assert_array_equal(ybase.numpy(), tile[..., 0] * 8)
    np.testing.assert_array_equal(j0_abs.numpy(), tile[..., 1] * 128 + tile[..., 2])
    p = tws.plan(_nchw(feat), torch.from_numpy(case["gp"]), case["vhw"])
    assert torch.equal(ybase, p.ybase) and torch.equal(j0_abs, p.j0_abs)
    assert ok == bool(p.ok) == bool(case["jplan"][6])


def test_exact_plain_matches_jax_grid_sample(case):
    """The plain exact mode (window taps where the window holds them, the
    map's taps elsewhere) == JAX `grid_sample` within 3e-5 (float32, sums in
    another order); on the rough batch both kinds of pixel occur."""
    feat, gp = _nchw(case["feat"]), torch.from_numpy(case["gp"])
    p = tws.plan(feat, gp, case["vhw"])
    got = tws.windowed_exact_plain(feat, gp, case["vhw"], p).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(j_grid_sample(jnp.asarray(case["feat"]), jnp.asarray(case["grid"])))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=SAMPLE_TOL, rtol=0)
    real_inwin = p.inwin[:, :case["vhw"][0], :case["vhw"][1]]
    assert bool(real_inwin.all()) == (not case["rough"])
    assert bool(real_inwin.any())


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper takes CUDA tensors only: a CPU tensor raises
    before anything is built or launched."""
    feat = torch.zeros((1, 2, 8, 128), dtype=torch.bfloat16)
    grid = torch.zeros((1, 8, 128, 2))
    n0 = LAUNCHES["windowed_sample"]
    with pytest.raises(ValueError, match="expected a tensor on"):
        windowed_sample_cuda(feat, grid)
    assert LAUNCHES["windowed_sample"] == n0


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


@pytest.mark.parametrize("C,W,unit", [(9, 560, 8), (9, 864, 8), (9, 560, 4), (2, 136, 8),
                                      (16, 8, 8), (3, 37, 1)])
def test_channels_last_window_staging(rng, C, W, unit):
    """The CUDA kernel's staging of a window row from a channels-last map,
    mirrored in numpy: units of `unit` elements (8 bf16 or 4 float32 = 16
    bytes; 1 = element by element, where a map row is not a multiple of 16
    bytes) from element x_lo * C - sh of the map's row, sh = (x_lo * C) mod
    unit, each unit copied or zero-filled whole. Where W * C is a multiple
    of the unit, every unit lies wholly inside or outside the image's row,
    and the staged row's element sh + col * C + c is the map's (x_lo + col,
    c), zero outside the image, for every window column and channel; the
    staged row fits its length."""
    kcols = tws.TW + tws.E
    vec = 8 if unit == 1 else unit
    row_len = (kcols * C + 2 * vec - 1) // vec * vec
    row = rng.standard_normal((W, C)).astype(np.float32).ravel()
    for x_lo in (-128, -37, -1, 0, 3, W - 5, W + 2):
        sh = (x_lo * C) % unit
        units = (sh + kcols * C + unit - 1) // unit
        assert units * unit <= row_len
        staged = np.full(row_len, np.nan, np.float32)
        for u in range(units):
            e = x_lo * C - sh + u * unit
            inside = 0 <= e < W * C
            if unit > 1 and (W * C) % unit == 0:
                assert inside == (0 <= e + unit - 1 < W * C)  # all in or all out
            staged[u * unit:(u + 1) * unit] = row[e:e + unit] if inside else 0.0
        for col in range(kcols):
            x = x_lo + col
            want = row[x * C:(x + 1) * C] if 0 <= x < W else np.zeros(C, np.float32)
            np.testing.assert_array_equal(staged[sh + col * C:sh + (col + 1) * C], want)
