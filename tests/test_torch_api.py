"""The port's matcher entry points beyond `match()` against the JAX package
on the CPU: the PIL-parity device resize (`pil_bicubic_matrix`,
`pil_bicubic_resize_device`), `interpolate_nearest`, `pad_to_multiple`,
`models/api.py`, `RomaMatcher.match_raw` / `_prep_raw_impl` /
`sample_batched`, and Tiny RoMa's api methods. Inputs from numpy seeds."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from roma_tpu.models import api as japi
from roma_tpu.models.matcher import RomaMatcher as JMatcher
from roma_tpu.ops import resize as jresize
from roma_torch.models import api
from roma_torch.models.zoo import debug_roma_config, roma_outdoor, tiny_roma_v1_outdoor
from roma_torch.ops import resize

LEVEL = (1.0 / 255.0) / 0.224  # one uint8 level over the smallest ImageNet std


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("n_in,n_out,n_cols", [(150, 112, None), (99, 224, 150), (640, 560, 800),
                                               (37, 37, None), (480, 864, 600)])
def test_pil_bicubic_matrix_equals_jax(n_in, n_out, n_cols):
    """Downscale, upscale, identity and padded-canvas columns: equal."""
    got = resize.pil_bicubic_matrix(n_in, n_out, n_cols)
    ref = jresize.pil_bicubic_matrix(n_in, n_out, n_cols)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src,out", [((150, 190), (112, 112)), ((99, 131), (224, 224)),
                                     ((60, 80), (97, 45))])
def test_pil_bicubic_resize_device_within_one_level(rng, src, out):
    """A zero-padded canvas resized through the bank matrices: within one
    uint8 level of the JAX function and of `PIL.Image.resize(BICUBIC)` on
    the unpadded image (measured: equal to JAX, <= 1 level from PIL)."""
    from PIL import Image

    im = rng.uniform(0, 255, src + (3,)).astype(np.uint8)
    canvas = np.zeros((160, 200, 3), np.uint8)
    canvas[:src[0], :src[1]] = im
    ry = resize.pil_bicubic_matrix(src[0], out[0], 160)
    rx = resize.pil_bicubic_matrix(src[1], out[1], 200)
    got = resize.pil_bicubic_resize_device(_t(canvas), _t(ry), _t(rx)).numpy()
    ref = np.asarray(jresize.pil_bicubic_resize_device(
        jnp.asarray(canvas, jnp.float32), jnp.asarray(ry), jnp.asarray(rx)))
    pil = np.asarray(Image.fromarray(im).resize(out[::-1], Image.BICUBIC), np.float32)
    assert got.shape == out + (3,)
    assert np.abs(got - ref).max() <= 1.0
    assert np.abs(got - pil).max() <= 1.0
    assert np.all(got == np.round(got)) and got.min() >= 0 and got.max() <= 255


@pytest.mark.parametrize("size", [(7, 9), (20, 31), (13, 13)])
def test_interpolate_nearest_and_pad_to_multiple(rng, size):
    """Half-pixel-center nearest (up and down) equal to the JAX function;
    pad_to_multiple (bilinear to floor multiples) within 1e-5."""
    x = rng.standard_normal((2, 13, 17, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        resize.interpolate_nearest(_t(x), size).numpy(),
        np.asarray(jresize.interpolate_nearest(jnp.asarray(x), size)))
    y = rng.standard_normal((1, 70 + size[0], 99 + size[1], 3)).astype(np.float32)
    got = resize.pad_to_multiple(_t(y), 32).numpy()
    ref = np.asarray(jresize.pad_to_multiple(jnp.asarray(y), 32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _warp_and_cert(rng, H=12, W=16):
    warp = rng.uniform(-1.05, 1.05, (H, W, 4)).astype(np.float32)
    cert = rng.uniform(0, 1, (H, W)).astype(np.float32)
    return warp, cert


def test_match_keypoints_equals_jax(rng):
    """Mutual nearest neighbours through the warp, fixed shapes with a
    validity mask; some B keypoints copy A's warp targets so pairs are
    mutual. Indices and masks equal; default and finite max_dist."""
    warp, cert = _warp_and_cert(rng)
    x_a = rng.uniform(-1, 1, (40, 2)).astype(np.float32)
    x_b = rng.uniform(-1, 1, (30, 2)).astype(np.float32)
    tgt = np.asarray(japi.grid_sample(jnp.asarray(warp)[None, :, :, 2:],
                                      jnp.asarray(x_a)[None, :, None, :]))[0, :, 0]
    x_b[:20] = tgt[:20] + rng.normal(0, 1e-3, (20, 2)).astype(np.float32)
    for kw in ({}, {"max_dist": 0.05}):
        ia, ib, v = api.match_keypoints(_t(x_a), _t(x_b), _t(warp), _t(cert), 0.2, **kw)
        ra, rb, rv = japi.match_keypoints(jnp.asarray(x_a), jnp.asarray(x_b), jnp.asarray(warp),
                                          jnp.asarray(cert), 0.2, **kw)
        np.testing.assert_array_equal(ia.numpy(), np.asarray(ra))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(ib.numpy()[v.numpy()], np.asarray(rb)[np.asarray(rv)])
        assert 0 < int(v.sum()) < 40


@pytest.mark.parametrize("batched", [False, True])
def test_conf_from_fb_consistency_equals_jax(rng, batched):
    """Near-inverse flows (identity plus small noise): equal masks."""
    H, W = 24, 32
    gy, gx = np.meshgrid(np.linspace(-1 + 1 / H, 1 - 1 / H, H),
                         np.linspace(-1 + 1 / W, 1 - 1 / W, W), indexing="ij")
    grid = np.stack([gx, gy], -1).astype(np.float32)
    fwd = (grid + rng.normal(0, 0.05, grid.shape)).astype(np.float32)
    bwd = (grid + rng.normal(0, 0.05, grid.shape)).astype(np.float32)
    if batched:
        fwd, bwd = np.stack([fwd, bwd]), np.stack([bwd, fwd])
    got = api.conf_from_fb_consistency(_t(fwd), _t(bwd), 3.0).numpy()
    ref = np.asarray(japi.conf_from_fb_consistency(jnp.asarray(fwd), jnp.asarray(bwd), 3.0))
    assert got.shape == ref.shape and 0 < got.mean() < 1
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("symmetric", [True, False])
def test_visualize_warp_equals_jax(rng, tmp_path, symmetric):
    """Same arrays in, same rendering out (1e-5), PNG written."""
    warp, cert = _warp_and_cert(rng, 12, 32 if symmetric else 16)
    im_a = rng.uniform(0, 1, (30, 40, 3)).astype(np.float32)
    im_b = rng.uniform(0, 1, (25, 35, 3)).astype(np.float32)
    path = tmp_path / "vis.png"
    got = api.visualize_warp(_t(warp), _t(cert), im_a, im_b, symmetric, str(path))
    ref = japi.visualize_warp(warp, cert, im_a, im_b, symmetric)
    assert got.shape == (12, warp.shape[1], 3) and path.exists()
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def debug_matcher():
    return roma_outdoor(cfg=dataclasses.replace(debug_roma_config(), dtype="float32"),
                        device="cpu")


def _pairs_and_banks(rng):
    from PIL import Image

    ims = [Image.fromarray(rng.uniform(0, 255, hw + (3,)).astype(np.uint8))
           for hw in [(150, 190), (120, 160), (150, 190), (99, 131)]]
    sizes = sorted({im.size[::-1] for im in ims})
    size_idx = {s: i for i, s in enumerate(sizes)}
    bucket = (max(h for h, _ in sizes), max(w for _, w in sizes))

    def canvas(im):
        c = np.zeros(bucket + (3,), np.uint8)
        a = np.asarray(im, np.uint8)
        c[:a.shape[0], :a.shape[1]] = a
        return c

    order = (0, 2, 1, 3)  # A images over B images: pairs (0, 1), (2, 3)
    raw = np.stack([canvas(ims[i]) for i in order])
    idx = np.array([size_idx[ims[i].size[::-1]] for i in order], np.int32)
    return ims, order, sizes, bucket, raw, idx


def test_prep_raw_matches_host_pil_and_jax(debug_matcher, rng):
    """Banks on the matcher's device; the port's `_prep_raw_impl` within one
    uint8 level of the JAX `_prep_raw_impl` on the same banks and of the
    host PIL resize + normalisation (`host_prep_np`, equal to JAX's)."""
    m = debug_matcher
    ims, order, sizes, bucket, raw, idx = _pairs_and_banks(rng)
    banks = m.build_resize_banks(sizes, bucket)
    assert len(banks) == 4 and all(b.device == m.device and b.dtype == torch.float32
                                   for b in banks)
    (hc, wc), (hu, wu) = m.cfg.coarse_resolution, m.cfg.upsample_resolution
    n = len(sizes)
    assert tuple(banks[0].shape) == (n, hc, bucket[0]) and tuple(banks[3].shape) == (n, wu, bucket[1])
    xc, xu = m._prep_raw_impl(torch.from_numpy(raw), torch.from_numpy(idx).long(), *banks, up=True)
    assert m._prep_raw_impl(torch.from_numpy(raw), torch.from_numpy(idx).long(), *banks[:2]).shape == xc.shape
    jb = [jnp.asarray(b.numpy()) for b in banks]
    jc, ju = JMatcher._prep_raw_impl(jnp.asarray(raw), jnp.asarray(idx), *jb, up=True)
    assert np.abs(xc.numpy() - np.asarray(jc)).max() <= LEVEL + 1e-5
    assert np.abs(xu.numpy() - np.asarray(ju)).max() <= LEVEL + 1e-5
    host_c = np.stack([m.host_prep_np(ims[i], hc, wc) for i in order])
    host_u = np.stack([m.host_prep_np(ims[i], hu, wu) for i in order])
    assert np.abs(xc.numpy() - host_c).max() <= LEVEL + 1e-5
    assert np.abs(xu.numpy() - host_u).max() <= LEVEL + 1e-5
    jm = JMatcher.__new__(JMatcher)
    np.testing.assert_array_equal(host_c[0], JMatcher.host_prep_np(jm, ims[0], hc, wc))


def test_match_raw_matches_prepped_and_sample_batched(debug_matcher, rng):
    """`match_raw` on the canvases against `match_prepped` on host PIL
    resizes of the same images, with the JAX package's statistical bounds
    (its `test_roma_match_raw_matches_prepped`: one-uint8-level input
    differences move a random-init model chaotically at a few pixels). Then
    `sample_batched` per pair equal to `sample` with the same generator."""
    m = debug_matcher
    ims, order, sizes, bucket, raw, idx = _pairs_and_banks(rng)
    banks = m.build_resize_banks(sizes, bucket)
    warps_r, certs_r = m.match_raw(raw, idx, banks)
    (hc, wc), (hu, wu) = m.cfg.coarse_resolution, m.cfg.upsample_resolution
    host = lambda ids, h, w: np.stack([m.host_resize_np(ims[i], h, w) for i in ids])
    warps_h, certs_h = m.match_prepped(host((0, 2), hc, wc), host((1, 3), hc, wc),
                                       host((0, 2), hu, wu), host((1, 3), hu, wu))
    assert warps_r.shape == warps_h.shape == (2, hu, 2 * wu, 4)
    dw = (warps_r - warps_h).abs().numpy()
    dc = (certs_r - certs_h).abs().numpy()
    assert dw.mean() < 2e-2, dw.mean()
    assert np.quantile(dw, 0.9) < 5e-2, np.quantile(dw, 0.9)
    assert dc.mean() < 2e-2, dc.mean()

    gens = [torch.Generator().manual_seed(s) for s in (3, 4)]
    got_m, got_c = m.sample_batched(warps_r, certs_r, 500, gens)
    assert tuple(got_m.shape) == (2, 500, 4) and tuple(got_c.shape) == (2, 500)
    for i, seed in enumerate((3, 4)):
        ref_m, ref_c = m.sample(warps_r[i], certs_r[i], 500, torch.Generator().manual_seed(seed))
        assert torch.equal(got_m[i], ref_m) and torch.equal(got_c[i], ref_c)


def test_roma_and_tiny_api_methods_equal_jax(rng, debug_matcher, tmp_path):
    """Both matchers' `match_keypoints` (their own sample_thresh),
    `conf_from_fb_consistency` and `visualize_warp` (symmetric for full
    RoMa, one-sided for Tiny RoMa) against the JAX api functions."""
    tiny = tiny_roma_v1_outdoor(device="cpu")
    for m, sym in ((debug_matcher, True), (tiny, False)):
        warp, cert = _warp_and_cert(rng, 10, 24 if sym else 12)
        x_a = rng.uniform(-1, 1, (25, 2)).astype(np.float32)
        x_b = rng.uniform(-1, 1, (25, 2)).astype(np.float32)
        half = warp[:, :12]
        got = m.match_keypoints(_t(x_a), _t(x_b), _t(half), _t(cert[:, :12]))
        ref = japi.match_keypoints(jnp.asarray(x_a), jnp.asarray(x_b), jnp.asarray(half),
                                   jnp.asarray(cert[:, :12]), sample_thresh=m.cfg.sample_thresh)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
        np.testing.assert_array_equal(got[1].numpy()[got[2].numpy()],
                                      np.asarray(ref[1])[np.asarray(ref[2])])
        fwd, bwd = half[..., 2:], half[..., :2]
        np.testing.assert_allclose(m.conf_from_fb_consistency(_t(fwd), _t(bwd)).numpy(),
                                   np.asarray(japi.conf_from_fb_consistency(
                                       jnp.asarray(fwd), jnp.asarray(bwd))), atol=1e-5)
        im = rng.uniform(0, 1, (20, 30, 3)).astype(np.float32)
        vis = m.visualize_warp(_t(warp), _t(cert), im, im, save_path=str(tmp_path / "v.png"))
        np.testing.assert_allclose(vis, np.asarray(japi.visualize_warp(warp, cert, im, im, sym)),
                                   atol=1e-5, rtol=0)
