"""roma_torch modules against their JAX counterparts on the CPU, float32.

Pattern: build the torch module with a seed, randomise its BatchNorm
statistics and affines, carry its state_dict into the JAX module through the
JAX package's own porting helpers (roma_tpu.models.port), run both on the
same numpy inputs and compare. Tolerance: 1e-4 max-abs for single layers,
1e-3 for composed modules, as stated at each assert.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roma_tpu.models import port as jport
from roma_tpu.models.dinov2 import DinoViT as JDinoViT
from roma_tpu.models.gp import GP as JGP
from roma_tpu.models.refiner import ConvRefiner as JConvRefiner
from roma_tpu.models.transformer import Block as JBlock
from roma_tpu.models.transformer import TransformerDecoder as JDecoder
from roma_tpu.models.vgg import VGG19 as JVGG19
from roma_torch.models.dinov2 import DinoViT
from roma_torch.models.gp import GP
from roma_torch.models.refiner import ConvRefiner
from roma_torch.models.transformer import Block, TransformerDecoder
from roma_torch.models.vgg import VGG19

F32 = torch.float32


def randomize_bn(module, rng):
    for m in module.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            c = m.num_features
            m.running_mean.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1))
            m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
            m.weight.data.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
            m.bias.data.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32) * 0.1))


def seeded(cls, *args, **kw):
    torch.manual_seed(0)
    return cls(*args, **kw).eval()


def np_sd(module, prefix=""):
    return {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}


def close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=0)


@torch.no_grad()
def test_vgg19_pyramid(rng):
    vgg = seeded(VGG19, dtype=F32)
    randomize_bn(vgg, rng)
    x = rng.standard_normal((2, 32, 40, 3)).astype(np.float32)
    got = vgg(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = JVGG19(dtype=jnp.float32).apply(jport.port_vgg19(np_sd(vgg), "layers."), x, False)
    assert sorted(got) == sorted(ref) == [1, 2, 4, 8]
    for s in ref:
        close(got[s].permute(0, 2, 3, 1), ref[s], 1e-4)  # 12 convs: composed, fp32


@pytest.mark.parametrize("layer_scale,qkv_bias", [(True, True), (False, False)])
@torch.no_grad()
def test_vit_block(rng, layer_scale, qkv_bias):
    """DINOv2 block (layer scale, qkv bias) and match-decoder block (neither);
    head width 64, as DINOv2's."""
    blk = seeded(Block, 128, 2, layer_scale=layer_scale, qkv_bias=qkv_bias, dtype=F32)
    if layer_scale:
        blk.ls1.gamma.data.uniform_(0.5, 1.5)
        blk.ls2.gamma.data.uniform_(0.5, 1.5)
    tgt: dict = {}
    jport.port_vit_block(np_sd(blk, "b."), "b", tgt, layer_scale=layer_scale)
    x = rng.standard_normal((2, 17, 128)).astype(np.float32)
    ref = JBlock(128, 2, layer_scale=layer_scale, qkv_bias=qkv_bias,
                 dtype=jnp.float32).apply({"params": tgt}, x)
    close(blk(torch.from_numpy(x)), ref, 1e-4)


@torch.no_grad()
def test_dinov2_depth2(rng):
    """Patch embed, bicubic pos-embed resize (with the +0.1 offset) from the
    37x37 grid, 2 blocks, final LayerNorm. Tolerance 1e-4."""
    vit = seeded(DinoViT, embed_dim=128, depth=2, num_heads=2, dtype=F32)
    x = rng.standard_normal((2, 56, 70, 3)).astype(np.float32)
    got = vit(torch.from_numpy(x).permute(0, 3, 1, 2))
    ref = JDinoViT(embed_dim=128, depth=2, num_heads=2, dtype=jnp.float32).apply(
        jport.port_dinov2(np_sd(vit), depth=2), x)
    assert got.shape == (2, 4, 5, 128)
    close(got, ref, 1e-4)


@torch.no_grad()
def test_gp_posterior(rng):
    """Cosine kernel, Cholesky solve and Fourier basis, fp32. Tolerance 1e-4."""
    gp = seeded(GP, gp_dim=16)
    x = rng.standard_normal((2, 6, 7, 12)).astype(np.float32)
    y = rng.standard_normal((2, 6, 7, 12)).astype(np.float32)
    got = gp(torch.from_numpy(x), torch.from_numpy(y))
    ref = JGP(gp_dim=16).apply({"params": jport.port_gp(np_sd(gp))}, x, y)
    close(got, ref, 1e-4)


@torch.no_grad()
def test_transformer_decoder(rng):
    dec = seeded(TransformerDecoder, hidden_dim=128, out_dim=17, num_blocks=2,
                 num_heads=1, dtype=F32)
    p = jport.port_transformer_decoder(np_sd(dec), num_blocks=2)
    gp = rng.standard_normal((2, 4, 5, 64)).astype(np.float32)
    feats = rng.standard_normal((2, 4, 5, 64)).astype(np.float32)
    cls, cert = dec(torch.from_numpy(gp), torch.from_numpy(feats))
    rcls, rcert = JDecoder(hidden_dim=128, out_dim=17, num_blocks=2, num_heads=1,
                           dtype=jnp.float32).apply({"params": p}, gp, feats)
    close(cls, rcls, 1e-3)
    close(cert, rcert, 1e-3)


def _flow(rng, B, H, W, spread):
    gy, gx = np.meshgrid(np.linspace(-1 + 1 / H, 1 - 1 / H, H),
                         np.linspace(-1 + 1 / W, 1 - 1 / W, W), indexing="ij")
    grid = np.stack([gx, gy], -1)[None].repeat(B, 0)
    return (grid + rng.standard_normal((B, H, W, 2)) * spread).astype(np.float32)


@pytest.mark.parametrize(
    "C,emb,radius,blocks",
    [(9, 6, None, 2),      # scale-1 shape: the chained narrow stack
     (128, 16, 2, 1),      # local correlation (kernel gate: C % 128 == 0)
     (64, 16, None, 1)],   # scale-2 shape: plain depthwise blocks
)
@torch.no_grad()
def test_conv_refiner(rng, C, emb, radius, blocks):
    """Warp, displacement embedding (gain 40/32 * scale_factor), optional
    local correlation, BN-folded depthwise blocks with randomised running
    stats, fp32 head. Flows reach outside the image. Tolerance 1e-3."""
    hidden = 2 * C + emb + (0 if radius is None else (2 * radius + 1) ** 2)
    ref_mod = seeded(ConvRefiner, hidden, hidden, emb, radius, hidden_blocks=blocks,
                     dtype=F32)
    randomize_bn(ref_mod, rng)
    params, stats = jport.port_conv_refiner(np_sd(ref_mod), hidden_blocks=blocks)
    B, H, W = 2, 11, 13
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    y = rng.standard_normal((B, H, W, C)).astype(np.float32)
    flow = _flow(rng, B, H, W, 0.4)
    dflow, dcert = ref_mod(torch.from_numpy(x).permute(0, 3, 1, 2),
                           torch.from_numpy(y).permute(0, 3, 1, 2),
                           torch.from_numpy(flow), scale_factor=1.5)
    jmod = JConvRefiner(hidden_dim=hidden, displacement_emb_dim=emb,
                        local_corr_radius=radius, hidden_blocks=blocks, dtype=jnp.float32)
    rflow, rcert = jmod.apply({"params": params, "batch_stats": stats}, x, y, flow,
                              scale_factor=1.5)
    assert ref_mod.use_chain(hidden) == (hidden < 64)
    close(dflow, rflow, 1e-3)
    close(dcert, rcert, 1e-3)
