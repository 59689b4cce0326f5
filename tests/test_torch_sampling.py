"""KDE and balanced Gumbel-top-k sampling. The port draws its noise from a
torch.Generator, so the draws differ from the JAX package's; parity is
statistical, as in tests/test_sampling.py."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from roma_tpu.utils.kde import kde as j_kde
from roma_tpu.utils.sampling import gumbel_topk as j_gumbel_topk
from roma_torch.utils.kde import kde
from roma_torch.utils.sampling import gumbel_topk, sample_matches


def _grid_warp(H, W):
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, W), np.linspace(-1, 1, H), indexing="xy"), -1)
    return torch.from_numpy(np.concatenate([grid, grid], -1).astype(np.float32))


def test_kde_matches_dense_and_jax(rng):
    """Tiled density == dense formula == JAX kde (tolerance 1e-4)."""
    x = rng.standard_normal((300, 4)).astype(np.float32)
    ours = kde(torch.from_numpy(x), std=0.1, tile=64).numpy()
    d2 = ((x[:, None] - x[None]) ** 2).sum(-1)
    np.testing.assert_allclose(ours, np.exp(-d2 / (2 * 0.1**2)).sum(-1), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours, np.asarray(j_kde(jnp.asarray(x), std=0.1, tile=64)),
                               rtol=1e-4, atol=1e-4)


def test_gumbel_topk_distribution_matches_jax():
    """Same weights, 2000 draws of 2 each: no repeats, never a zero weight,
    and per-item frequencies within 0.05 of JAX's."""
    w = np.array([0.0, 1.0, 1.0, 4.0, 0.0, 2.0], np.float32)
    gen = torch.Generator().manual_seed(0)
    ours, ref = np.zeros(6), np.zeros(6)
    for i in range(2000):
        idx = gumbel_topk(torch.from_numpy(w), 2, gen).numpy()
        assert len(set(idx.tolist())) == 2 and all(w[j] > 0 for j in idx)
        ours[idx] += 1
        ref[np.asarray(j_gumbel_topk(jax.random.PRNGKey(i), jnp.asarray(w), 2))] += 1
    assert ours[0] == ours[4] == 0 and ours[3] == ours.max()
    np.testing.assert_allclose(ours / 2000, ref / 2000, atol=0.05)


def test_sample_matches_balanced_spread():
    warp = _grid_warp(64, 64)
    cert = torch.full((64, 64), 0.9)
    m, c = sample_matches(warp, cert, num=256, generator=torch.Generator().manual_seed(0))
    assert m.shape == (256, 4) and c.shape == (256,)
    assert m.abs().max() <= 1.0
    xs = m[:, 0]
    assert xs.min() < -0.7 and xs.max() > 0.7


def test_sample_matches_respects_certainty():
    warp = _grid_warp(32, 32)
    cert = torch.zeros((32, 32))
    cert[:, :16] = 0.9  # only the left half is confident
    m, _ = sample_matches(warp, cert, num=128, generator=torch.Generator().manual_seed(1))
    assert m[:, 0].max() < 0.05


def test_matcher_sample_returns_num():
    from roma_torch.models.matcher import RomaMatcher

    class _Cfg:
        sample_thresh = 0.05

    class _Model(torch.nn.Module):
        cfg = _Cfg()

    matcher = RomaMatcher(_Model(), device="cpu")
    warp = _grid_warp(40, 80)
    cert = torch.rand((40, 80), generator=torch.Generator().manual_seed(2))
    m, c = matcher.sample(warp, cert, num=500)
    assert m.shape == (500, 4) and c.shape == (500,)
    assert bool(((c >= 0) & (c <= 1)).all())
