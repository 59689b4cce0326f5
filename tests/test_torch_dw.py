"""The plain versions of the port's wide-channel depthwise block (K4) and
whole-block (K5) kernels, and the refiner's DWBlock that runs K4, against
the JAX functions on the CPU: the Pallas kernels in interpret mode (as the
JAX package's own tests run them) and the JAX reference. The wrappers take
these plain versions for CPU tensors."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.models import port as jport
from roma_tpu.models.refiner import DWBlock as JDWBlock
from roma_tpu.ops.pallas import depthwise as jdw
from roma_torch.kernels import dw_affine_relu as k4
from roma_torch.kernels import dw_block_mm as k5
from roma_torch.kernels import LAUNCHES, dw_chain
from roma_torch.kernels.dw_chain import block_plain_nchw
from roma_torch.models.refiner import ConvRefiner, DWBlock

SHAPES = [(2, 23, 31, 24), (1, 40, 40, 144), (2, 16, 20, 569), (1, 11, 13, 9)]


def _inputs(rng, shape):
    """bf16 x (B,H,W,C) and w (5,5,C) (x 0.2), scale in [0.5, 1.5], shift
    x 0.1, as the JAX package's kernel tests make them; numpy float32."""
    C = shape[-1]
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return (bf(rng.standard_normal(shape)), bf(rng.standard_normal((5, 5, C)) * 0.2),
            rng.uniform(0.5, 1.5, (C,)).astype(np.float32),
            (rng.standard_normal((C,)) * 0.1).astype(np.float32))


def _bf(a):
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


def _one_ulp(got, ref):
    """Elementwise one bf16 ulp of the element's own value: |got - ref| <=
    2^-7 |ref| + 1e-5 (only the float32 sum order differs before the one
    rounding)."""
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    tol = 2.0 ** -7 * np.abs(ref) + 1e-5
    err = np.abs(got - ref)
    assert np.all(err <= tol), f"max err {err.max():.3g}, worst err/tol {(err / tol).max():.3g}"


@pytest.mark.parametrize("layout", ["nhwc", "ncw"])
@pytest.mark.parametrize("shape", SHAPES)
def test_dw_affine_relu_plain_matches_pallas_interpret(rng, shape, layout):
    """K4's plain version against `_pallas_call(interpret=True)` in both
    Pallas layouts and against `_jax_reference`, at the JAX test's shapes
    (C = 569 and the odd C = 9 included), bf16 in and out. One bf16 ulp
    elementwise; measured: equal to the Pallas kernel but for a few
    elements (max 3e-8), within one ulp of the XLA reference at <= 3e-5 of
    the elements (max 1.2e-4)."""
    x, w, sc, sh = _inputs(rng, shape)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref = jdw._pallas_call(jx, jw, jnp.asarray(sc), jnp.asarray(sh), interpret=True, layout=layout)
    plain = jdw._jax_reference(jx, jw, jnp.asarray(sc), jnp.asarray(sh))
    got = k4.dw5x5_affine_relu_plain_nchw(_bf(x).permute(0, 3, 1, 2), _bf(w),
                                          torch.from_numpy(sc), torch.from_numpy(sh))
    assert got.dtype == torch.bfloat16 and got.shape == (shape[0], shape[3], *shape[1:3])
    got = got.permute(0, 2, 3, 1).float().numpy()
    _one_ulp(got, ref)
    _one_ulp(got, plain)


@pytest.mark.parametrize("data_format", ["NHWC", "NHCW"])
def test_dw_affine_relu_jax_layouts(rng, data_format):
    """The JAX-layout entry in both layouts against the JAX function, bf16,
    one bf16 ulp elementwise; CPU tensors launch nothing."""
    x, w, sc, sh = _inputs(rng, (2, 14, 19, 24))
    if data_format == "NHCW":
        x = np.ascontiguousarray(x.transpose(0, 1, 3, 2))
    ref = jdw.dw5x5_affine_relu(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                jnp.asarray(sc), jnp.asarray(sh), data_format)
    n0 = LAUNCHES["dw_affine_relu"]
    got = k4.dw5x5_affine_relu(_bf(x), _bf(w), torch.from_numpy(sc), torch.from_numpy(sh),
                               data_format)
    assert LAUNCHES["dw_affine_relu"] == n0
    assert tuple(got.shape) == x.shape
    _one_ulp(got.float().numpy(), ref)
    with pytest.raises(ValueError, match="data_format"):
        k4.dw5x5_affine_relu(_bf(x), _bf(w), torch.from_numpy(sc), torch.from_numpy(sh), "NCHW")


@pytest.mark.parametrize("shape", [(2, 14, 19, 24), (1, 33, 40, 144)])
def test_dw_block_mm_plain_matches_pallas_interpret(rng, shape):
    """K5's plain version (`block_plain_nchw`) through the JAX-layout entry
    against `_mm_tpu_path(interpret=True)` and `_mm_reference`, x (B,H,C,W)
    bf16, m and bias as in the JAX test. Tolerance: the JAX test's 5e-2 abs
    + 2e-2 rel against the Pallas kernel (its MXU rounds the ReLU output to
    bf16 as well, sums in another order); one bf16 ulp + 1e-5 against the
    reference, which rounds at the same two points."""
    B, H, W, C = shape
    x, w, sc, sh = _inputs(rng, shape)
    m = np.asarray(jnp.asarray(rng.standard_normal((C, C)) * 0.2, jnp.bfloat16).astype(jnp.float32))
    bias = (rng.standard_normal((C,)) * 0.1).astype(np.float32)
    xt = np.ascontiguousarray(x.transpose(0, 1, 3, 2))
    j = lambda a: jnp.asarray(a, jnp.bfloat16)
    ref = jdw._mm_tpu_path(j(xt), j(w), jnp.asarray(sc), jnp.asarray(sh), j(m),
                           jnp.asarray(bias), interpret=True)
    ref_plain = jdw._mm_reference(j(x), j(w), jnp.asarray(sc), jnp.asarray(sh), j(m),
                                  jnp.asarray(bias))
    got = k5.dw5x5_affine_relu_mm(_bf(xt), _bf(w), torch.from_numpy(sc), torch.from_numpy(sh),
                                  _bf(m), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, H, C, W)
    got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), atol=5e-2, rtol=2e-2)
    _one_ulp(got.transpose(0, 1, 3, 2), ref_plain)
    # the NCHW entry on a CPU tensor is the plain version itself
    xn = _bf(x).permute(0, 3, 1, 2).contiguous()
    args = (_bf(w), torch.from_numpy(sc), torch.from_numpy(sh), _bf(m), torch.from_numpy(bias))
    assert torch.equal(k5.dw5x5_affine_relu_mm_nchw(xn, *args), block_plain_nchw(xn, *args))


def _randomize_bn(bn, rng):
    c = bn.num_features
    bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1))
    bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    bn.weight.data.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    bn.bias.data.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [144, 569])
@torch.no_grad()
def test_dwblock_matches_jax_dwblock(rng, C, dtype):
    """The port's DWBlock (K4's plain version + the 1x1) against the JAX
    DWBlock at the scale-2 and scale-4 widths, randomised BatchNorm
    statistics, weights carried with the JAX package's port helpers.
    float32: 1e-4 abs (measured 7e-7). bfloat16: 2^-6 x max(1, max|ref|)
    abs, two bf16 ulps at the largest output (the JAX side rounds the 1x1
    output and adds a bf16 bias, the port adds the bias before its one
    rounding; the ReLU output may differ by one ulp); measured 7.8e-3, one
    ulp at outputs of ~1.3."""
    torch.manual_seed(0)
    blk = DWBlock(C).eval()
    _randomize_bn(blk[1], rng)
    sd = {k: v.numpy() for k, v in blk.state_dict().items()}
    params, stats = {}, {}
    jport.port_conv(sd, "0", params, ("conv1",))
    jport.port_batchnorm(sd, "1", params, stats, ("norm",))
    jport.port_conv(sd, "3", params, ("conv2",))
    x = rng.standard_normal((2, 9, 11, C)).astype(np.float32)
    tdt = getattr(torch, dtype)
    ref = JDWBlock(C, dtype=getattr(jnp, dtype)).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x, getattr(jnp, dtype)))
    ref = np.asarray(ref, np.float32)
    got = blk(torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2))
    assert got.dtype == tdt
    got = got.permute(0, 2, 3, 1).float().numpy()
    tol = 1e-4 if dtype == "float32" else 2.0 ** -6 * max(1.0, np.abs(ref).max())
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@torch.no_grad()
def test_refiner_routes_wide_blocks_through_k4(rng, monkeypatch):
    """Every block of a wide stack calls the K4 wrapper; the scale-1 chain
    (hidden_dim < 64) never does and goes through the chain wrapper once."""
    calls, chains = [], []
    real, real_chain = k4.dw5x5_affine_relu_nchw, dw_chain.chain_nchw
    monkeypatch.setattr(k4, "dw5x5_affine_relu_nchw",
                        lambda x, *a: calls.append(tuple(x.shape)) or real(x, *a))
    monkeypatch.setattr(dw_chain, "chain_nchw",
                        lambda x, *a: chains.append(tuple(x.shape)) or real_chain(x, *a))
    B, H, W = 1, 6, 7
    for C, emb, blocks, n_k4, n_chain in ((64, 16, 2, 3, 0), (9, 6, 2, 0, 1)):
        hidden = 2 * C + emb
        torch.manual_seed(0)
        ref = ConvRefiner(hidden, hidden, emb, None, hidden_blocks=blocks).eval()
        calls.clear()
        chains.clear()
        ref(torch.randn(B, C, H, W), torch.randn(B, C, H, W), torch.rand(B, H, W, 2) * 2 - 1)
        assert len(calls) == n_k4 and all(s == (B, hidden, H, W) for s in calls)
        assert len(chains) == n_chain


# K4's band plan at every main-path plane (refiners 16/8/4/2 at 560 -> 864)
# and the ragged planes chip_smoke.py checks on the card
PLAN_SHAPES = [(40, 40), (70, 70), (140, 140), (280, 280), (108, 108), (216, 216), (432, 432),
               (37, 45), (71, 130), (19, 67), (200, 131), (1, 131), (77, 1), (13, 7),
               (1000, 45), (9, 45), (1, 1)]


def _bands(plan, H):
    return [(y0, min(y0 + plan.rows, H)) for y0 in range(0, H, plan.rows)]


@pytest.mark.parametrize("H,W", PLAN_SHAPES)
def test_dw_band_plan_covers_each_row_once(H, W):
    """Every output row in exactly one band, each band's halo inside its
    plane, several planes to a block only where a plane is one band, and
    the block within the H100's 227 KB of shared memory."""
    plan = k4.band_plan(H, W)
    bands = _bands(plan, H)
    rows = [y for y0, y1 in bands for y in range(y0, y1)]
    assert rows == list(range(H))
    for y0, y1 in bands:
        ya, yb = max(y0 - 2, 0), min(y1 + 2, H)
        assert 0 <= ya <= y0 < y1 <= yb <= H
    assert 1 <= plan.planes <= 8 and (plan.planes == 1 or plan.rows == H)
    assert plan.smem_bytes == k4.plan_bytes(W, plan.rows, plan.planes) <= k4.SMEM_MAX


def test_dw_band_plan_raises_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        k4.band_plan(8, 8000)


@pytest.mark.parametrize("H,W", [(140, 140), (1000, 45), (77, 1), (1, 131), (13, 7)])
def test_dw_band_emulation_equals_plain(rng, H, W):
    """The kernel's bands emulated in plain PyTorch: each band's rows plus
    halo read as one flat range of the plane, zero rows added where the
    halo leaves the plane, a conv with width padding only. Equal to
    `dw5x5_affine_relu_plain_nchw` on the whole plane within 1e-6, fp32
    (the CPU conv may sum a band in another order than the whole plane)."""
    B, C = 2, 3
    x = torch.from_numpy(rng.standard_normal((B, C, H, W)).astype(np.float32))
    w = torch.from_numpy((0.2 * rng.standard_normal((5, 5, C))).astype(np.float32))
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    sh = torch.from_numpy((0.1 * rng.standard_normal(C)).astype(np.float32))
    plan = k4.band_plan(H, W)
    flat = x.reshape(B * C, H * W)
    out = []
    for y0, y1 in _bands(plan, H):
        ya, yb = max(y0 - 2, 0), min(y1 + 2, H)
        rows = flat[:, ya * W:yb * W].reshape(B * C, yb - ya, W)
        rows = torch.cat([rows.new_zeros(B * C, ya - (y0 - 2), W), rows,
                          rows.new_zeros(B * C, y1 + 2 - yb, W)], dim=1)
        y = torch.nn.functional.conv2d(rows.reshape(B, C, -1, W), w.permute(2, 0, 1)[:, None],
                                       padding=(0, 2), groups=C)
        out.append(torch.relu(y * sc[:, None, None] + sh[:, None, None]))
    got = torch.cat(out, dim=2)
    ref = k4.dw5x5_affine_relu_plain_nchw(x, w, sc, sh)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6, rtol=0)


# K2's weight packing, tile plan and tiling (the CUDA kernel's host-side
# pieces), at every padded width Cp = 16, 32, 48, 64
@pytest.mark.parametrize("C", [1, 8, 16, 24, 40, 63, 64])
def test_dw_chain_pack_params_unpacks_to_the_weights(rng, C):
    """taps (N, C, 28) fp32: 25 taps in dy, dx order, scale, shift, 0;
    mt (N, Cp, Cp) bf16 = M^T with zeros past C; bias (N, Cp) with zeros past
    C. Unpacked, each equals the unpadded weight exactly."""
    N = 2
    ws = _bf(rng.standard_normal((N, 5, 5, C)) * 0.2)
    scales = torch.from_numpy(rng.uniform(0.5, 1.5, (N, C)).astype(np.float32))
    shifts = torch.from_numpy((rng.standard_normal((N, C)) * 0.1).astype(np.float32))
    ms = _bf(rng.standard_normal((N, C, C)) * 0.2)
    biases = torch.from_numpy((rng.standard_normal((N, C)) * 0.1).astype(np.float32))
    taps, mt, bias = dw_chain.pack_params(ws, scales, shifts, ms, biases)
    cp = dw_chain.padded_channels(C)
    assert cp % 16 == 0 and C <= cp < C + 16
    assert taps.shape == (N, C, dw_chain.TAPS) and taps.dtype == torch.float32
    assert mt.shape == (N, cp, cp) and mt.dtype == torch.bfloat16
    assert bias.shape == (N, cp) and bias.dtype == torch.float32
    assert torch.equal(taps[:, :, :25].reshape(N, C, 5, 5).permute(0, 2, 3, 1), ws.float())
    assert torch.equal(taps[:, :, 25], scales) and torch.equal(taps[:, :, 26], shifts)
    assert not taps[:, :, 27].any()
    assert torch.equal(mt[:, :C, :C].transpose(1, 2), ms)
    assert not mt[:, C:].any() and not mt[:, :, C:].any()
    assert torch.equal(bias[:, :C], biases) and not bias[:, C:].any()


# (B, C, H, W): the main path's two shapes, then ragged ones
TILE_SHAPES = [(4, 24, 560, 560), (4, 24, 864, 864), (1, 8, 37, 53), (1, 24, 1, 70),
               (1, 40, 70, 1), (1, 63, 37, 53), (1, 64, 13, 72), (3, 5, 17, 33)]


@pytest.mark.parametrize("B,C,H,W", TILE_SHAPES)
def test_dw_chain_tile_plan_covers_each_pixel_once(B, C, H, W):
    """The tiles cover every output pixel of every image exactly once; the
    float channel planes hold a tile's halo and start in 8 distinct bank
    groups; a block fits the H100's 227 KB of shared memory."""
    plan = dw_chain.tile_plan(B, C, H, W)
    nx, ny, nb = plan.tiles
    assert nb == B and plan.rows in (4, 8) and plan.cp == dw_chain.padded_channels(C)
    assert (nx - 1) * dw_chain.TILE_W < W <= nx * dw_chain.TILE_W
    assert (ny - 1) * plan.rows < H <= ny * plan.rows
    cover = np.zeros((H, W), np.int64)
    for ty in range(ny):
        for tx in range(nx):
            cover[ty * plan.rows:(ty + 1) * plan.rows,
                  tx * dw_chain.TILE_W:(tx + 1) * dw_chain.TILE_W] += 1
    assert (cover == 1).all()
    assert plan.plane_stride >= (plan.rows + 4) * (dw_chain.TILE_W + 4)
    assert plan.plane_stride % 4 == 0 and (plan.plane_stride // 4) % 2 == 1
    assert plan.smem_bytes <= k4.SMEM_MAX


def _emulate_chain_block(x, w, scale, shift, m, bias):
    """One block the way the kernel cuts it, in plain PyTorch: per tile the
    staged bf16 halo (rows y0 - 2 .. y0 + rows + 1, columns x0 - 8 ..
    x0 + 39, zeros outside the plane), its float rows from column x0 - 2,
    the depthwise sums from the packed taps, y rounded to bf16 and padded
    with zero channels to Cp, the mix with the packed M^T and bias, and only
    the tile's in-plane pixels written. Returns z and the count of writes
    per pixel."""
    B, C, H, W = x.shape
    plan = dw_chain.tile_plan(B, C, H, W)
    taps, mt, bp = (t[0] for t in dw_chain.pack_params(w[None], scale[None], shift[None],
                                                       m[None], bias[None]))
    R, TW, SW = plan.rows, dw_chain.TILE_W, dw_chain.STAGE_W
    out = torch.zeros((B, C, H, W), dtype=torch.bfloat16)
    count = torch.zeros((B, H, W), dtype=torch.int64)
    nx, ny, nb = plan.tiles
    for b in range(nb):
        for ty in range(ny):
            for tx in range(nx):
                x0, y0 = tx * TW, ty * R
                stage = torch.zeros((C, R + 4, SW))
                ya, yb = max(y0 - 2, 0), min(y0 + R + 2, H)
                xa, xb = max(x0 - 8, 0), min(x0 + SW - 8, W)
                if yb > ya and xb > xa:
                    stage[:, ya - y0 + 2:yb - y0 + 2, xa - x0 + 8:xb - x0 + 8] = \
                        x[b, :, ya:yb, xa:xb].float()
                rows = stage[:, :, 6:6 + TW + 4]
                acc = torch.nn.functional.conv2d(rows[None], taps[:, :25].reshape(C, 1, 5, 5),
                                                 groups=C)[0]
                y = torch.relu(acc * taps[:, 25, None, None] + taps[:, 26, None, None])
                yp = torch.zeros((plan.cp, R, TW))
                yp[:C] = y.to(torch.bfloat16).float()
                z = torch.einsum("dc,crw->drw", mt.float(), yp) + bp[:, None, None]
                h1, w1 = min(R, H - y0), min(TW, W - x0)
                out[b, :, y0:y0 + h1, x0:x0 + w1] = z[:C, :h1, :w1].to(torch.bfloat16)
                count[b, y0:y0 + h1, x0:x0 + w1] += 1
    return out, count


@pytest.mark.parametrize("B,C,H,W", TILE_SHAPES[2:] + [(2, 24, 21, 64), (1, 16, 9, 40)])
def test_dw_chain_tile_emulation_matches_plain(rng, B, C, H, W):
    """The kernel's tiling (tile plan, staged halo offsets, zero fill, Cp
    padding, packed weights) emulated per tile equals `block_plain_nchw`
    within one bf16 ulp elementwise (the tile's conv and the padded mix sum
    in another order), and writes every pixel once."""
    x = _bf(rng.standard_normal((B, C, H, W)))
    w = _bf(rng.standard_normal((5, 5, C)) * 0.2)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    sh = torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32))
    m = _bf(rng.standard_normal((C, C)) * 0.2)
    bias = torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32))
    got, count = _emulate_chain_block(x, w, sc, sh, m, bias)
    assert (count == 1).all()
    _one_ulp(got.float().numpy(), block_plain_nchw(x, w, sc, sh, m, bias).float().numpy())


@pytest.mark.parametrize("C", [65, 96])
def test_dw_chain_kernel_rejects_more_than_64_channels(C):
    """A request the kernel does not take raises before anything is built
    or launched (here on the CPU, through the wrapper's argument check)."""
    x = torch.zeros((1, C, 4, 4), dtype=torch.bfloat16)
    ws = torch.zeros((9, 5, 5, C), dtype=torch.bfloat16)
    ms = torch.zeros((9, C, C), dtype=torch.bfloat16)
    vec = torch.zeros((9, C))
    n0 = LAUNCHES["dw_chain"]
    with pytest.raises(ValueError, match="1 <= C <= 64"):
        dw_chain.chain_cuda_nchw(x, ws, vec, vec, ms, vec)
    assert LAUNCHES["dw_chain"] == n0


# K5's schedule (the CUDA kernel's index arithmetic, mirrored): the three
# chip shapes and the two ragged ones chip_smoke.py checks
K5_SHAPES = [(4, 144, 280, 280), (4, 144, 432, 432), (4, 24, 560, 560), (2, 37, 45, 61),
             (1, 160, 33, 70)]


def _k5_tile_origin(plan, tile):
    tw, th, _ = plan.tiles
    rest = tile // tw
    return (tile % tw) * k5.TILE_W, (rest % th) * k5.TILE_H, rest // th


@pytest.mark.parametrize("B,C,H,W", K5_SHAPES)
def test_dw_block_mm_schedule_covers_each_pixel_once(B, C, H, W):
    """The persistent blocks' walk (tile = block, block + grid, ...) takes
    every tile once for any grid size; the tiles cover every pixel once;
    within a tile the depthwise items (a channel and a 4 x 4 patch a thread,
    channels fastest; a shorter last chunk packed onto the first threads)
    cover every (channel, pixel) of each chunk once, and the mix's stores
    (a warp a tile row, 16-channel output tiles, 4 units of 8 pixels) every
    (channel, pixel) of the tile once; each
    patch's 8 halo columns lie in its two 16-byte units; a block fits the
    H100's 227 KB of shared memory."""
    plan = k5.tile_plan(B, C, H, W)
    tw, th, nb = plan.tiles
    n = tw * th * nb
    assert nb == B and plan.cp == dw_chain.padded_channels(C)
    assert k5.CHUNK * k5.PATCHES == k5.THREADS and plan.chunks == -(-C // k5.CHUNK)
    assert plan.smem_bytes <= k4.SMEM_MAX
    for grid in (132, 264, 396, n):
        grid = min(grid, n)
        walked = sorted(t for blk in range(grid) for t in range(blk, n, grid))
        assert walked == list(range(n))
    cover = np.zeros((B, H, W), np.int64)
    for t in range(n):
        x0, y0, b = _k5_tile_origin(plan, t)
        cover[b, y0:y0 + k5.TILE_H, x0:x0 + k5.TILE_W] += 1
    assert (cover == 1).all()
    tid = np.arange(k5.THREADS)
    tail = C - (plan.chunks - 1) * k5.CHUNK
    for nc in {k5.CHUNK, tail}:
        ch, pq = tid % nc, tid // nc
        busy = pq < k5.PATCHES
        py, px = pq[busy] & 1, pq[busy] >> 1
        dw = np.zeros((nc, k5.TILE_H, k5.TILE_W), np.int64)
        for oy in range(4):
            for j in range(4):
                np.add.at(dw, (ch[busy], 4 * py + oy, 4 * px + j), 1)
        assert (dw == 1).all()
        if nc == k5.CHUNK:
            first = 4 * px + 6  # staged column of a patch's first tap (column x0 - 8 is 0)
            ub, off = first >> 3, first & 7
            assert set(off) == {2, 6}  # the kernel's two selections of 4 bf16 pairs
            assert ((first + 8 <= (ub + 2) * 8) & (ub + 2 <= k5.HALO_UNITS)).all()
    mix = np.zeros((plan.cp, k5.TILE_H, k5.TILE_W), np.int64)
    lane = np.arange(32)
    for warp in range(k5.THREADS // 32):
        for mt in range(plan.cp // 16):
            for u in (lane, lane + 32):
                np.add.at(mix, (mt * 16 + (u >> 2), warp, 8 * (u & 3) + np.arange(8)[:, None]), 1)
    assert (mix == 1).all()
    # the warp's z tile keeps unit q of channel row r at q ^ (r / 2 % 4): a
    # permutation of the tile's 64 units
    r, q = np.meshgrid(np.arange(16), np.arange(4), indexing="ij")
    slot = r * 4 + (q ^ (r >> 1 & 3))
    assert sorted(slot.ravel()) == list(range(64))


def _emulate_block_mm(x, w, scale, shift, m, bias):
    """One block the way the K5 kernel cuts it, in plain PyTorch: per 8 x 32
    tile and per 16-channel chunk the staged bf16 halo (rows y0 - 2 ..
    y0 + 9, columns x0 - 8 .. x0 + 39, zeros outside the plane), the
    depthwise sums from its columns 6 .., y rounded to bf16 into a y tile
    padded with zero channels to Cp; then the mix from M^T (read from `m`,
    zero-padded to Cp x Cp, as the kernel stages it), accumulated in
    float32 one 16-channel k-step after another, plus bias,
    rounded to bf16; only the tile's in-plane pixels written. Returns z and
    the count of writes per pixel."""
    B, C, H, W = x.shape
    plan = k5.tile_plan(B, C, H, W)
    cp = plan.cp
    mt = torch.zeros((cp, cp))
    mt[:C, :C] = m.float().T
    TH, TW = k5.TILE_H, k5.TILE_W
    out = torch.zeros((B, C, H, W), dtype=torch.bfloat16)
    count = torch.zeros((B, H, W), dtype=torch.int64)
    tw, th, nb = plan.tiles
    for t in range(tw * th * nb):
        x0, y0, b = _k5_tile_origin(plan, t)
        y = torch.zeros((cp, TH, TW))
        for k in range(plan.chunks):
            c0, c1 = k5.CHUNK * k, min(k5.CHUNK * (k + 1), C)
            stage = torch.zeros((c1 - c0, TH + 4, 48))
            ya, yb = max(y0 - 2, 0), min(y0 + TH + 2, H)
            xa, xb = max(x0 - 8, 0), min(x0 + 40, W)
            if yb > ya and xb > xa:
                stage[:, ya - y0 + 2:yb - y0 + 2, xa - x0 + 8:xb - x0 + 8] = \
                    x[b, c0:c1, ya:yb, xa:xb].float()
            acc = torch.nn.functional.conv2d(stage[None, :, :, 6:6 + TW + 4],
                                             w[:, :, c0:c1].float().permute(2, 0, 1)[:, None],
                                             groups=c1 - c0)[0]
            y[c0:c1] = torch.relu(acc * scale[c0:c1, None, None] + shift[c0:c1, None, None]) \
                .to(torch.bfloat16).float()
        z = torch.zeros((cp, TH, TW))
        for ks in range(cp // 16):
            z = z + torch.einsum("dc,chw->dhw", mt[:, 16 * ks:16 * ks + 16], y[16 * ks:16 * ks + 16])
        z = z[:C] + bias[:, None, None]
        h1, w1 = min(TH, H - y0), min(TW, W - x0)
        out[b, :, y0:y0 + h1, x0:x0 + w1] = z[:, :h1, :w1].to(torch.bfloat16)
        count[b, y0:y0 + h1, x0:x0 + w1] += 1
    return out, count


@pytest.mark.parametrize("B,C,H,W", [(1, 37, 13, 40), (2, 24, 9, 64), (1, 160, 8, 33),
                                     (1, 16, 17, 31), (1, 100, 9, 35)])
def test_dw_block_mm_chunk_emulation_matches_plain(rng, B, C, H, W):
    """The K5 kernel's schedule (tiles, 16-channel halo chunks, M^T
    zero-padded to Cp, the mix accumulated k-step by k-step) emulated in plain PyTorch equals
    `block_plain_nchw` within one bf16 ulp elementwise (only the float32
    sum order differs before each rounding), and writes every pixel once."""
    x = _bf(rng.standard_normal((B, C, H, W)))
    w = _bf(rng.standard_normal((5, 5, C)) * 0.2)
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, C).astype(np.float32))
    sh = torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32))
    m = _bf(rng.standard_normal((C, C)) * 0.2)
    bias = torch.from_numpy((rng.standard_normal(C) * 0.1).astype(np.float32))
    got, count = _emulate_block_mm(x, w, sc, sh, m, bias)
    assert (count == 1).all()
    _one_ulp(got.float().numpy(), block_plain_nchw(x, w, sc, sh, m, bias).float().numpy())


@pytest.mark.parametrize("C", [0, 161])
def test_dw_block_mm_kernel_rejects_channels_outside_1_to_160(C):
    """A request the kernel does not take raises before anything is built
    or launched (here on the CPU, through the wrapper's plan)."""
    with pytest.raises(ValueError, match="1 <= C <= 160"):
        k5.dw5x5_affine_relu_mm_cuda_nchw(torch.zeros((1, C, 4, 4), dtype=torch.bfloat16),
                                          *(torch.zeros(1),) * 5)
