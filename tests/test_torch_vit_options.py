"""The ViT block's options, the DINO head and un-antialiased bicubic resize
against the JAX package on the CPU, float32, on numpy-seeded inputs and
weights: `SwiGLUFFN`, `Block(ffn_layer="swiglu")` in eval mode and in train
mode with stochastic depth (the JAX side replays the masks the port drew,
in the port's order, through a monkeypatched `drop_path`; outputs and
gradients against `jax.grad`), `drop_path`'s own laws, `DINOHead`,
`resize_bicubic(antialias=False)` and the weight carry of
`roma_torch.models.port`.

Tolerance: max|port - JAX| <= 1e-5 max|JAX| (each gradient against its
own tensor's max), unless a case says otherwise.
"""

import numpy as np
import pytest
import torch
from flax import traverse_util

import jax
import jax.numpy as jnp

import roma_tpu.models.transformer as jtr
from roma_tpu.ops.resize import resize_bicubic as j_resize_bicubic
from roma_torch.models import port
from roma_torch.models import transformer as ttr
from roma_torch.ops.resize import resize_bicubic

RTOL = 1e-5
F32 = torch.float32


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def close(got, ref, rtol=RTOL, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= rtol, f"{what}: {err:.3e} of max|ref| > {rtol}"


def seeded_params(variables, rng, scale=0.2):
    """The JAX init's tree with every leaf redrawn from `rng`: LayerNorm
    scales and LayerScale gammas around 1, everything else around 0."""
    flat = traverse_util.flatten_dict(variables["params"])
    out = {}
    for path in sorted(flat):
        centre = 1.0 if path[-1] in ("scale", "gamma") else 0.0
        out[path] = (centre + scale * rng.standard_normal(flat[path].shape)).astype(np.float32)
    return {"params": traverse_util.unflatten_dict(out)}


def block_state_dict(params) -> dict[str, torch.Tensor]:
    w = port._Writer()
    w.vit_block("b", params["params"])
    return {k[len("b."):]: v for k, v in w.sd.items()}


def make_block(rng, layer_scale, qkv_bias, rate, dim=32, heads=4, n=(2, 5)):
    x = rng.standard_normal((*n, dim)).astype(np.float32)
    kw = dict(layer_scale=layer_scale, qkv_bias=qkv_bias, ffn_layer="swiglu",
              drop_path_rate=rate)
    jblk = jtr.Block(dim, heads, dtype=jnp.float32, **kw)
    params = seeded_params(jblk.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    blk = ttr.Block(dim, heads, dtype=F32, **kw)
    blk.load_state_dict(block_state_dict(params), strict=True)
    return jblk, params, blk, x


@pytest.mark.parametrize("dim,ratio", [(32, 4.0), (40, 3.0)])
def test_swiglu_ffn(rng, dim, ratio):
    """Hidden width int(dim * ratio * 2/3 + 7) // 8 * 8: 88 at (32, 4),
    rounded up from 85.3; 80 at (40, 3)."""
    x = rng.standard_normal((2, 7, dim)).astype(np.float32)
    jffn = jtr.SwiGLUFFN(dim, ratio, dtype=jnp.float32)
    params = seeded_params(jffn.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    ffn = ttr.SwiGLUFFN(dim, ratio, dtype=F32)
    w = port._Writer()
    for name in ("w12", "w3"):
        w.linear(name, params["params"][name])
    ffn.load_state_dict(w.sd, strict=True)
    assert ffn.w3.in_features == params["params"]["w3"]["kernel"].shape[0]
    assert ffn.w3.in_features == {32: 88, 40: 80}[dim]
    with torch.no_grad():
        got = ffn(torch.from_numpy(x))
    close(got, jffn.apply(params, jnp.asarray(x)), what="swiglu ffn")


@pytest.mark.parametrize("layer_scale,qkv_bias", [(True, True), (True, False),
                                                  (False, True), (False, False)])
def test_block_swiglu_eval(rng, layer_scale, qkv_bias):
    """Eval mode ignores the drop-path rate (JAX: deterministic=True)."""
    jblk, params, blk, x = make_block(rng, layer_scale, qkv_bias, rate=0.5)
    with torch.no_grad():
        got = blk.eval()(torch.from_numpy(x))
    close(got, jblk.apply(params, jnp.asarray(x), deterministic=True), what="block eval")


class MaskRecorder:
    """Wraps the port's `drop_path_mask`, keeping each mask it draws."""

    def __init__(self):
        self.masks: list[np.ndarray] = []
        self.orig = ttr.drop_path_mask

    def __call__(self, x, rate, generator):
        m = self.orig(x, rate, generator)
        self.masks.append(m.numpy())
        return m


@pytest.mark.parametrize("layer_scale", [True, False])
def test_block_swiglu_train_replays_port_masks(rng, monkeypatch, layer_scale):
    """Train mode, rate 0.5, batch 8: the JAX block's drop_path replays the
    port's masks (attention branch first, then the FFN's); outputs and
    every gradient (parameters and input, of sum(y * w)) agree."""
    rate = 0.5
    jblk, params, blk, x = make_block(rng, layer_scale, True, rate, n=(8, 5))
    wgt = rng.standard_normal(x.shape).astype(np.float32)
    rec = MaskRecorder()
    monkeypatch.setattr(ttr, "drop_path_mask", rec)
    blk.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = blk(xt, generator=torch.Generator().manual_seed(3))
    (y * torch.from_numpy(wgt)).sum().backward()
    assert len(rec.masks) == 2 and all(m.shape == (8, 1, 1) for m in rec.masks)
    drawn = np.concatenate([m.ravel() for m in rec.masks])
    assert drawn.any() and not drawn.all()  # both kept and dropped samples

    def replay(h, rate_, deterministic, rng_=None):
        assert not deterministic and rate_ == rate
        return jnp.where(jnp.asarray(next(masks)), h / (1.0 - rate_), 0.0)

    monkeypatch.setattr(jtr, "drop_path", replay)

    def loss(p, xx):
        return (jblk.apply(p, xx, deterministic=False,
                           rngs={"drop_path": jax.random.PRNGKey(1)}) * wgt).sum()

    masks = iter(rec.masks)
    ref = jblk.apply(params, jnp.asarray(x), deterministic=False,
                     rngs={"drop_path": jax.random.PRNGKey(1)})
    close(y.detach(), ref, what="block train forward")
    masks = iter(rec.masks)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    close(xt.grad, gx, what="d input")
    ref_grads = block_state_dict(gp)
    got_grads = dict(blk.named_parameters())
    assert sorted(ref_grads) == sorted(got_grads)
    for name, g in ref_grads.items():
        close(got_grads[name].grad, g, what=f"d {name}")


def test_drop_path_laws(rng):
    x = torch.from_numpy(rng.uniform(1.0, 2.0, (64, 3, 4)).astype(np.float32))
    out = ttr.drop_path(x, 0.25, True, torch.Generator().manual_seed(0))
    kept = (out != 0).flatten(1).all(1)
    dropped = (out == 0).flatten(1).all(1)
    assert bool((kept | dropped).all()) and bool(kept.any()) and bool(dropped.any())
    torch.testing.assert_close(out[kept], x[kept] / 0.75, rtol=0, atol=0)
    # identity when not training, or at rate 0 (no generator needed)
    assert ttr.drop_path(x, 0.25, False) is x
    assert ttr.drop_path(x, 0.0, True) is x
    with pytest.raises(ValueError, match="Generator"):
        ttr.drop_path(x, 0.25, True)
    blk = ttr.Block(16, 2, ffn_layer="swiglu", drop_path_rate=0.3, dtype=F32)
    h = torch.from_numpy(rng.standard_normal((4, 6, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="Generator"):
        blk.train()(h)
    # eval mode ignores the rate: the same weights at rate 0 give the same output
    plain = ttr.Block(16, 2, ffn_layer="swiglu", dtype=F32)
    plain.load_state_dict(blk.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(blk.eval()(h), plain.eval()(h), rtol=0, atol=0)
        torch.testing.assert_close(plain.train()(h), plain.eval()(h), rtol=0, atol=0)


@pytest.mark.parametrize("nlayers", [1, 3])
def test_dino_head(rng, nlayers):
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jhead = jtr.DINOHead(out_dim=16, hidden_dim=24, bottleneck_dim=8, nlayers=nlayers)
    params = seeded_params(jhead.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng, 0.3)
    head = ttr.DINOHead(32, 16, hidden_dim=24, bottleneck_dim=8, nlayers=nlayers)
    head.load_state_dict(port.dino_head_state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(x))
    ref = np.asarray(jhead.apply(params, jnp.asarray(x)))
    close(got, ref, what="dino head")
    # unit-norm bottleneck against unit-norm prototypes
    assert np.abs(got.numpy()).max() <= 1 + 1e-5 and np.abs(ref).max() <= 1 + 1e-5


@pytest.mark.parametrize("src,dst", [((37, 37), (14, 14)), ((64, 64), (48, 48)),
                                     ((48, 64), (30, 17)), ((14, 14), (37, 37))])
def test_resize_bicubic_antialias(rng, src, dst):
    """antialias=False: JAX's unwidened Keys a=-0.5 with border
    renormalisation (the JAX side builds its weights in float32, the port
    in float64: ~3e-6 of max apart). antialias=True unchanged (the default,
    bit-equal to the call without the argument), and on upscale both
    settings agree."""
    x = rng.standard_normal((2, *src, 3)).astype(np.float32)
    xt = torch.from_numpy(x)
    for aa in (False, True):
        close(resize_bicubic(xt, dst, antialias=aa),
              j_resize_bicubic(jnp.asarray(x), dst, antialias=aa), what=f"antialias={aa}")
    assert torch.equal(resize_bicubic(xt, dst, antialias=True), resize_bicubic(xt, dst))
    if dst[0] > src[0]:
        close(resize_bicubic(xt, dst, antialias=False), resize_bicubic(xt, dst),
              what="upscale")


@pytest.mark.parametrize("ffn", ["mlp", "swiglu"])
def test_port_vit_block_keys(rng, ffn):
    """`_Writer.vit_block` carries both FFN layouts onto the port's names,
    Dense kernels transposed."""
    x = jnp.asarray(rng.standard_normal((1, 3, 16)).astype(np.float32))
    jblk = jtr.Block(16, 2, layer_scale=True, ffn_layer=ffn, dtype=jnp.float32)
    params = seeded_params(jblk.init(jax.random.PRNGKey(0), x), rng)
    sd = block_state_dict(params)
    blk = ttr.Block(16, 2, layer_scale=True, ffn_layer=ffn, dtype=F32)
    assert sorted(sd) == sorted(blk.state_dict())
    first = "w12" if ffn == "swiglu" else "fc1"
    np.testing.assert_array_equal(sd[f"mlp.{first}.weight"].numpy(),
                                  params["params"]["mlp"][first]["kernel"].T)


def test_port_dino_head_keys(rng):
    x = jnp.asarray(rng.standard_normal((1, 32)).astype(np.float32))
    jhead = jtr.DINOHead(out_dim=16, hidden_dim=24, bottleneck_dim=8)
    params = seeded_params(jhead.init(jax.random.PRNGKey(0), x), rng)
    sd = port.dino_head_state_dict_from_jax(params)
    head = ttr.DINOHead(32, 16, hidden_dim=24, bottleneck_dim=8)
    assert sorted(sd) == sorted(head.state_dict()) == [
        "last_layer.weight", "mlp.0.bias", "mlp.0.weight", "mlp.2.bias", "mlp.2.weight",
        "mlp.4.bias", "mlp.4.weight"]
    np.testing.assert_array_equal(sd["last_layer.weight"].numpy(),
                                  params["params"]["last_layer_v"].T)
