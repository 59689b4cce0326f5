"""The plain versions of the port's three kernels against the JAX functions,
run as the JAX package's own tests run them on the CPU: the Pallas kernels
in interpret mode. The wrappers take these plain versions for CPU tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from roma_tpu.ops.pallas.block_gather import local_correlation_dma
from roma_tpu.ops.pallas.corr_softmax import fused_pos_embed as j_fused_pos_embed
from roma_tpu.ops.pallas.depthwise import dw5x5_mm_chain as j_chain
from roma_torch.kernels import attention as tattn
from roma_torch.kernels import corr_softmax as tcs
from roma_torch.kernels import dw_chain as tchain
from roma_torch.kernels import local_corr as tlc
from roma_torch.ops.local_corr import local_correlation as t_local_corr


def _bf16_np(a):
    """Round float32 data to bf16 values, kept as float32 numpy."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize(
    "shape,r",
    [((2, 12, 16, 128), 3), ((1, 10, 10, 256), 2), ((1, 18, 18, 128), 7),
     ((2, 9, 11, 128), 1)],
)
def test_local_corr_plain_matches_pallas_interpret(rng, shape, r):
    """bf16 features, fp32 out, flows reaching well outside the image and
    some far out of range (exact zeros). Tolerance 1e-5: fp32 dots in
    another summation order."""
    B, H, W, C = shape
    f0 = _bf16_np(rng.standard_normal(shape))
    f1 = _bf16_np(rng.standard_normal(shape))
    flow = rng.uniform(-1.7, 1.7, (B, H, W, 2)).astype(np.float32)
    flow[0, 0, 0] = [1e5, -3e4]
    flow[0, 1, 1] = [-7.0, 0.2]
    ref = np.asarray(local_correlation_dma(
        jnp.asarray(f0, jnp.bfloat16), jnp.asarray(f1, jnp.bfloat16), r,
        jnp.asarray(flow), interpret=True))
    tf0 = torch.from_numpy(f0).to(torch.bfloat16)
    tf1 = torch.from_numpy(f1).to(torch.bfloat16)
    got = tlc.local_correlation(tf0, tf1, r, torch.from_numpy(flow))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)
    assert np.all(got.numpy()[0, 0, 0] == 0.0)
    np.testing.assert_array_equal(got.numpy(), t_local_corr(tf0, tf1, r, torch.from_numpy(flow)).numpy())


def test_local_corr_gate():
    assert tlc.use_kernel(7, 512) and tlc.use_kernel(2, 256)
    assert not tlc.use_kernel(8, 512)
    assert not tlc.use_kernel(3, 200)


@pytest.mark.parametrize("shape,n", [((2, 21, 19, 24), 3), ((1, 9, 40, 24), 2)])
def test_dw_chain_plain_matches_pallas_interpret(rng, shape, n):
    """C = 24 chained blocks, bf16 activations and weights, fp32 affine.
    Both versions round at the same two points; tolerance 2e-2 + 2e-2 rel
    (one bf16 ulp of the block output, after fp32 sums in another order)."""
    B, H, W, C = shape
    x = _bf16_np(rng.standard_normal(shape))
    ws = _bf16_np(rng.standard_normal((n, 5, 5, C)) * 0.2)
    scales = rng.uniform(0.5, 1.5, (n, C)).astype(np.float32)
    shifts = (rng.standard_normal((n, C)) * 0.1).astype(np.float32)
    ms = _bf16_np(rng.standard_normal((n, C, C)) * 0.2)
    biases = (rng.standard_normal((n, C)) * 0.1).astype(np.float32)
    ref = np.asarray(j_chain(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(ws, jnp.bfloat16), jnp.asarray(scales),
        jnp.asarray(shifts), jnp.asarray(ms, jnp.bfloat16), jnp.asarray(biases),
        interpret=True), np.float32)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = tchain.dw5x5_mm_chain(bf(x), bf(ws), torch.from_numpy(scales),
                                torch.from_numpy(shifts), bf(ms), torch.from_numpy(biases))
    assert got.shape == (B, H, C, W) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=2e-2, rtol=2e-2)


def test_dw_chain_plain_fp32_equals_block_loop(rng):
    """In float32 the chain is exactly the loop of single blocks, and one
    block equals depthwise conv -> affine -> ReLU -> 1x1 written with
    conv2d (tolerance 1e-4 abs, 1e-5 rel)."""
    B, C, H, W = 1, 24, 7, 9
    x = torch.from_numpy(rng.standard_normal((B, C, H, W)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 5, 5, C)).astype(np.float32))
    sc = torch.from_numpy(rng.uniform(0.5, 1.5, (2, C)).astype(np.float32))
    sh = torch.from_numpy(rng.standard_normal((2, C)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal((2, C, C)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, C)).astype(np.float32))
    got = tchain.chain_nchw(x, w, sc, sh, m, b)
    y = x
    for j in range(2):
        z = torch.nn.functional.conv2d(y, w[j].permute(2, 0, 1)[:, None], padding=2, groups=C)
        z = torch.relu(z * sc[j][:, None, None] + sh[j][:, None, None])
        y = torch.nn.functional.conv2d(z, m[j].T[:, :, None, None], b[j])
    np.testing.assert_allclose(got.numpy(), y.numpy(), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("n,h,d", [(257, 2, 64), (130, 2, 128), (65, 1, 64)])
def test_attention_plain_matches_pallas_interpret(rng, n, h, d):
    """Ragged N (not a multiple of 64 or 128), both head widths, fp32.
    Tolerance 2e-3, as the JAX package's own flash-attention test."""
    from jax.experimental.pallas import tpu as pltpu

    from roma_tpu.models.transformer import _flash_attention

    q, k, v = (rng.standard_normal((1, n, h, d)).astype(np.float32) for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-3, rtol=0)
    exact = np.asarray(jax.nn.dot_product_attention(q, k, v))
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,d", [(1601, 64), (1600, 128)])
def test_attention_plain_matches_jax_at_model_tokens(rng, n, d):
    """The ragged-tail reference at the real token counts (DINOv2's 1601,
    the decoder's 1600): the plain version against the JAX Attention's
    off-TPU path, `jax.nn.dot_product_attention`, fp32, one head.
    Tolerance 1e-5 (float32 sums in another order)."""
    q, k, v = (rng.standard_normal((1, n, 1, d)).astype(np.float32) for _ in range(3))
    got = tattn.attention(*(torch.from_numpy(a) for a in (q, k, v)))
    exact = np.asarray(jax.nn.dot_product_attention(q, k, v))
    np.testing.assert_allclose(got.numpy(), exact, atol=1e-5, rtol=0)


def test_attention_plain_takes_strided_qkv_views(rng):
    """The model hands the wrapper views of a fused qkv projection."""
    B, N, H, d = 2, 33, 2, 64
    qkv = torch.from_numpy(rng.standard_normal((B, N, 3, H, d)).astype(np.float32))
    got = tattn.attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    ref = tattn.attention_plain(*(qkv[:, :, i].contiguous() for i in range(3)))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("l0,l1,c", [(60, 48, 16), (256, 512, 64), (100, 700, 32), (30, 700, 64)])
def test_corr_softmax_plain_matches_pallas_interpret(rng, l0, l1, c):
    """The streaming correlation softmax's plain version against JAX
    `fused_pos_embed(interpret=True)` at the JAX package's own test shapes
    (ragged L0 and L1 against its tiles), fp32. Tolerance 2e-4, as there."""
    f0 = rng.standard_normal((2, l0, c)).astype(np.float32)
    f1 = rng.standard_normal((2, l1, c)).astype(np.float32)
    grid = rng.uniform(-1, 1, (l1, 2)).astype(np.float32)
    ref = np.asarray(j_fused_pos_embed(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(grid),
                                       chunk=128, tile=64, interpret=True))
    got = tcs.fused_pos_embed(*(torch.from_numpy(a) for a in (f0, f1, grid)))
    assert got.shape == (2, l0, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)


def test_corr_softmax_plain_peaked(rng):
    """A sharply peaked volume (each row's softmax concentrated on one
    source), as in the JAX package's test. Tolerance 1e-4."""
    l0, l1, c = 32, 96, 8
    f1 = rng.standard_normal((1, l1, c)).astype(np.float32) * 0.01
    peaks = rng.integers(0, l1, l0)
    f0 = 20.0 * f1[0, peaks][None] / np.linalg.norm(f1[0, peaks], axis=-1, keepdims=True)
    grid = rng.uniform(-1, 1, (l1, 2)).astype(np.float32)
    ref = np.asarray(j_fused_pos_embed(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(grid),
                                       chunk=32, tile=32, interpret=True))
    got = tcs.fused_pos_embed(*(torch.from_numpy(a) for a in (f0, f1, grid))).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("l0,l1,c", [(70, 45, 16), (129, 65, 32), (100, 193, 64)])
def test_corr_softmax_bf16_plain_matches_pallas_interpret(rng, l0, l1, c):
    """Tiny RoMa's features are bf16; the kernel's bf16 entry computes the
    function on their values. The plain version on bf16 tensors against JAX
    `fused_pos_embed(interpret=True)` on the same values in fp32 (as the
    JAX model casts them), ragged L0 and L1 against the kernel's 128-row
    blocks and 64-column chunks. Tolerance 2e-4, as the fp32 test."""
    f0 = _bf16_np(rng.standard_normal((2, l0, c)))
    f1 = _bf16_np(rng.standard_normal((2, l1, c)))
    grid = rng.uniform(-1, 1, (l1, 2)).astype(np.float32)
    ref = np.asarray(j_fused_pos_embed(jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(grid),
                                       chunk=64, tile=64, interpret=True))
    got = tcs.fused_pos_embed(torch.from_numpy(f0).to(torch.bfloat16),
                              torch.from_numpy(f1).to(torch.bfloat16), torch.from_numpy(grid))
    assert got.shape == (2, l0, 2) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=0)


def test_corr_softmax_dtype_dispatch(rng):
    """One C entry per features' dtype, both hand-written; on the CPU both
    dtypes take the plain version, which gives the same values for bf16
    features as for their fp32 copies."""
    assert tcs.ENTRIES == {torch.bfloat16: "roma_corr_softmax_bf16",
                           torch.float32: "roma_corr_softmax"}
    f0 = torch.from_numpy(rng.standard_normal((1, 30, 16)).astype(np.float32)).to(torch.bfloat16)
    f1 = torch.from_numpy(rng.standard_normal((1, 40, 16)).astype(np.float32)).to(torch.bfloat16)
    grid = torch.from_numpy(rng.uniform(-1, 1, (40, 2)).astype(np.float32))
    assert torch.equal(tcs.fused_pos_embed(f0, f1, grid),
                       tcs.fused_pos_embed(f0.float(), f1.float(), grid))
