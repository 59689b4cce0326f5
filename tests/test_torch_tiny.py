"""Tiny RoMa v1 in the port against the JAX package on the CPU, float32.

Modules (ConvBlock, instance_norm, XFeat, the correlation warps and their
band/row variants) and the whole model: JAX `TinyRoma` variables with
randomised BatchNorm statistics, carried into the port with
`tiny_state_dict_from_jax`, then forward (scales 8 and 4) and `match()`
compared on the same numpy inputs. The port's `fused_kernel=True` (the
correlation-softmax kernel's plain version on the CPU) is held against JAX
`fused_kernel=False, exact_softmax=True`, the same function: JAX's fused
model needs the TPU (its Pallas kernel runs on the CPU only in interpret
mode, which the model does not ask for).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roma_tpu.config import TinyRomaConfig as JConfig
from roma_tpu.models import port as jport
from roma_tpu.models.layers import ConvBlock as JConvBlock
from roma_tpu.models.layers import instance_norm as j_instance_norm
from roma_tpu.models.tiny_roma import TinyRoma as JTinyRoma
from roma_tpu.models.tiny_roma import TinyRomaMatcher as JMatcher
from roma_tpu.models.xfeat import XFeatBackbone as JXFeat
from roma_tpu.ops import band_corr as jband
from roma_tpu.ops import corr as jcorr
from roma_torch.config import TinyRomaConfig
from roma_torch.models.layers import ConvBlock, instance_norm
from roma_torch.models.port import tiny_state_dict_from_jax
from roma_torch.models.tiny_roma import TinyRoma, TinyRomaMatcher
from roma_torch.models.xfeat import XFeatBackbone
from roma_torch.ops import band_corr, corr

F32 = torch.float32
# float32 on both sides. Flows are in normalized units (1e-4 is 0.003 px
# at 64x96); certainties are logits. Measured max-abs errors ~1e-7 (flows)
# and ~5e-7 (logits).
FLOW_TOL = 1e-4
CERT_TOL = 1e-4


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def randomize_stats(module, rng):
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.running_mean.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))


@pytest.mark.parametrize("cin,cout,k,s", [(5, 7, 3, 2), (6, 4, 1, 1), (3, 8, 3, 1)])
@torch.no_grad()
def test_conv_block(rng, cin, cout, k, s):
    """Conv (torch padding, stride, no bias) -> BatchNorm(affine=False) ->
    ReLU on an odd-sized input. Tolerance 1e-5."""
    torch.manual_seed(0)
    blk = ConvBlock(cin, cout, k, s, dtype=F32).eval()
    randomize_stats(blk, rng)
    sd = {k_: v.numpy() for k_, v in blk.state_dict().items()}
    params, stats = {}, {}
    jport.port_conv_block(sd, "layer.0", "layer.1", params, stats, ("b",))
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
    ref = JConvBlock(cout, kernel_size=k, stride=s, dtype=jnp.float32).apply(
        {"params": params["b"], "batch_stats": stats["b"]}, x)
    close(nhwc(blk(nchw(x))), ref, 1e-5)


def test_instance_norm(rng):
    x = rng.standard_normal((2, 9, 11, 3)).astype(np.float32) * 3 + 1
    close(nhwc(instance_norm(nchw(x))), j_instance_norm(jnp.asarray(x)), 1e-5)


@torch.no_grad()
def test_xfeat_backbone(rng):
    """The whole trunk (raw XFeat key layout, read by `port_tiny_roma`):
    fine (1/4, 24 ch) and coarse (1/8, 64 ch) features. Tolerance 1e-4."""
    torch.manual_seed(0)
    net = XFeatBackbone(dtype=F32).eval()
    randomize_stats(net, rng)
    v = jport.port_tiny_roma({k: t.numpy() for k, t in net.state_dict().items()})
    x = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    rfine, rcoarse = JXFeat(dtype=jnp.float32).apply(
        {"params": v["params"]["backbone"], "batch_stats": v["batch_stats"]["backbone"]}, x)
    fine, coarse = net(nchw(x))
    assert tuple(fine.shape) == (2, 24, 16, 24) and tuple(coarse.shape) == (2, 64, 8, 12)
    close(nhwc(fine), rfine, 1e-4)
    close(nhwc(coarse), rcoarse, 1e-4)


def _feats(rng, B=2, H=8, W=12, C=16, scale=1.0):
    return [(rng.standard_normal((B, H, W, C)) * scale).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("op", ["volume", "expectation", "fast", "fast_faithful", "warp_exact",
                                "warp_fast"])
def test_corr_ops(rng, op):
    """All-pairs volume and the softmax-expectation warps (exact, the
    strided shortcut in both forms; its stride 4 needs source sides that
    are multiples of 4). Tolerance 1e-5."""
    f0, f1 = _feats(rng, scale=2.0)
    t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
    j0, j1 = jnp.asarray(f0), jnp.asarray(f1)
    if op == "volume":
        got, ref = corr.corr_volume(t0, t1), jcorr.corr_volume(j0, j1)
    elif op.startswith("warp"):
        exact = op == "warp_exact"
        got, ref = corr.pos_embed_warp(t0, t1, exact), jcorr.pos_embed_warp(j0, j1, exact)
    else:
        cv = corr.corr_volume(t0, t1)
        jcv = jnp.asarray(cv.numpy())
        if op == "expectation":
            got, ref = corr.pos_embed_expectation(cv, (8, 12)), jcorr.pos_embed_expectation(jcv, (8, 12))
        else:
            faithful = op == "fast_faithful"
            got = corr.pos_embed_fast(cv, (8, 12), faithful=faithful)
            ref = jcorr.pos_embed_fast(jcv, (8, 12), faithful=faithful)
    close(got, ref, 1e-5)


@pytest.mark.parametrize("radius", [None, 0, 2])
def test_band_and_row_warps(rng, radius):
    """`banded_pos_embed` (+-radius rows, borders masked) and `row_pos_embed`
    (radius None). Tolerance 1e-5."""
    f0, f1 = _feats(rng, B=2, H=8, W=10, C=16)
    t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
    if radius is None:
        got, ref = band_corr.row_pos_embed(t0, t1), jband.row_pos_embed(f0, f1)
    else:
        got = band_corr.banded_pos_embed(t0, t1, radius)
        ref = jband.banded_pos_embed(jnp.asarray(f0), jnp.asarray(f1), radius)
    close(got, ref, 1e-5)


# ---------------------------------------------------------------- whole model

@pytest.fixture(scope="module")
def carried():
    """JAX TinyRoma variables (fp32, randomised BatchNorm statistics) and the
    same weights as the port's state_dict."""
    rng = np.random.default_rng(11)
    model = JTinyRoma(JConfig(dtype="float32"))
    x = jnp.zeros((1, 64, 96, 3), jnp.float32)
    variables = jax.tree_util.tree_map(
        np.array, jax.jit(lambda k: model.init(k, x, x))(jax.random.PRNGKey(0)))
    variables["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape) * 0.1
                         if jax.tree_util.keystr(path).endswith("['mean']")
                         else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    return variables, tiny_state_dict_from_jax(variables)


def _port(sd, **kw):
    model = TinyRoma(TinyRomaConfig(dtype="float32", **kw))
    model.load_state_dict(sd, strict=True)
    return model.eval()


@pytest.mark.parametrize("port_kw,jax_kw", [
    ({}, {}),
    ({"fused_kernel": True}, {"exact_softmax": True}),
    ({"search_mode": "band", "band_radius": 1}, None),
    ({"search_mode": "row", "coarse_iters": 2}, None),
    ({"exact_softmax": False, "faithful_fast_path": True}, None),
])
@torch.no_grad()
def test_tiny_forward(carried, port_kw, jax_kw):
    """Forward at 64x96 (coarse 8x12, fine 16x24), both scales, per config.
    `jax_kw` None means the same options on both sides."""
    variables, sd = carried
    jax_kw = port_kw if jax_kw is None else jax_kw
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32) for _ in range(2))
    ref = JTinyRoma(JConfig(dtype="float32", **jax_kw)).apply(variables, a, b)
    got = _port(sd, **port_kw)(torch.from_numpy(a), torch.from_numpy(b))
    assert sorted(got) == [4, 8]
    assert tuple(got[8]["flow"].shape) == (2, 8, 12, 2)
    assert tuple(got[4]["certainty"].shape) == (2, 16, 24, 1)
    for s in (8, 4):
        close(got[s]["flow"], ref[s]["flow"], FLOW_TOL)
        close(got[s]["certainty"], ref[s]["certainty"], CERT_TOL)


def test_tiny_match_arrays_pil_and_paths(carried, tmp_path):
    """`match()` on arrays (a size that is not a multiple of 32, resized
    bilinearly), PIL images and image paths, then `sample` and
    `to_pixel_coordinates`. Tolerance 1e-4 on warp and certainty."""
    from PIL import Image

    variables, sd = carried
    jm = JMatcher(jax.tree_util.tree_map(jnp.asarray, variables), JConfig(dtype="float32"))
    tm = TinyRomaMatcher(_port(sd, fused_kernel=True), device="cpu")
    rng = np.random.default_rng(5)
    a, b = (rng.uniform(0, 1, (1, 70, 100, 3)).astype(np.float32) for _ in range(2))
    rw, rc = jm.match(a, b, batched=True)
    w, c = tm.match(a, b, batched=True)
    assert tuple(w.shape) == (1, 70, 100, 4) and tuple(c.shape) == (1, 70, 100)
    assert 0 <= float(c.min()) and float(c.max()) <= 1
    close(w, rw, FLOW_TOL)
    close(c, rc, CERT_TOL)
    w1, c1 = tm.match(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    assert torch.equal(w1, w[0]) and torch.equal(c1, c[0])

    ims = [Image.fromarray(rng.uniform(0, 255, (72, 104, 3)).astype(np.uint8)) for _ in range(2)]
    close(tm.match(*ims)[0], jm.match(*ims)[0], FLOW_TOL)
    paths = [tmp_path / "a.png", tmp_path / "b.png"]
    for im, p in zip(ims, paths):
        im.save(p)
    w, c = tm.match(*paths)
    rw, rc = jm.match(*paths)
    assert tuple(w.shape) == (64, 96, 4)
    close(w, rw, FLOW_TOL)
    close(c, rc, CERT_TOL)

    m, mc = tm.sample(w, c, num=200, generator=torch.Generator().manual_seed(0))
    assert tuple(m.shape) == (200, 4) and tuple(mc.shape) == (200,)
    ka, kb = tm.to_pixel_coordinates(m, 64, 96, 64, 96)
    ra, rb = jm.to_pixel_coordinates(np.asarray(m), 64, 96, 64, 96)
    close(ka, ra, 1e-5)
    close(kb, rb, 1e-5)


def test_tiny_factory_is_seeded_and_on_cpu():
    from roma_torch.models.zoo import tiny_roma_v1_outdoor

    m1 = tiny_roma_v1_outdoor(seed=3, device="cpu")
    m2 = tiny_roma_v1_outdoor(seed=3, device="cpu",
                              cfg=dataclasses.replace(TinyRomaConfig(), fused_kernel=True))
    assert m2.cfg.fused_kernel and not m1.cfg.fused_kernel
    for (k, v1), v2 in zip(m1.model.state_dict().items(), m2.model.state_dict().values()):
        assert torch.equal(v1, v2), k
    assert m1.model.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="search_mode"):
        TinyRoma(TinyRomaConfig(search_mode="diagonal"))
