"""Balanced sampling of matches from a dense warp (upstream RoMa's `sample`):
certainties above the threshold count as 1, a pool of 4 x num matches is
drawn without replacement in proportion to certainty, each pool match is
weighted by 1 / (1 + its Gaussian KDE density, std 0.1) (1e-7 where the
density is under 10), and num matches are drawn from the pool by those
weights. Draws without replacement are Gumbel top-k: the k largest of
log(weight) + Gumbel noise, the noise -log(-log(u)) of uniforms u from the
generator, one draw over the whole warp and then one over the pool.

The density is summed directly over pairwise squared distances, in row
tiles, not through the expansion |a|^2 + |b|^2 - 2 a.b.
"""

from __future__ import annotations

import torch

from perfbench.reference.common import Precision


def gumbel_top(weights: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(weights.shape, generator=generator, device=weights.device)
    keys = torch.log(weights.clamp_min(0.0)) - torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.topk(keys, k).indices


def density(prec: Precision, x: torch.Tensor, std: float = 0.1, tile: int = 1024) -> torch.Tensor:
    x = prec.kde(x)
    out = []
    for i in range(0, x.shape[0], tile):
        d2 = ((x[i:i + tile, None, :] - x[None, :, :]) ** 2).sum(-1)
        out.append(torch.exp(-d2 / (2 * std * std)).sum(-1))
    return torch.cat(out)


@torch.no_grad()
def sample(prec: Precision, warp: torch.Tensor, cert: torch.Tensor, num: int, thresh: float,
           generator: torch.Generator) -> tuple[torch.Tensor, torch.Tensor]:
    """warp (..., 4), certainty (...) -> matches (num, 4), certainties (num,)."""
    matches = warp.reshape(-1, 4).float()
    c = cert.reshape(-1).float()
    c = torch.where(c > thresh, 1.0, c)
    pool = min(4 * num, matches.shape[0])
    idx = gumbel_top(c, pool, generator)
    good, good_c = matches[idx], c[idx]
    dens = density(prec, good)
    p = torch.where(dens < 10, 1e-7, 1.0 / (dens + 1.0))
    keep = gumbel_top(p, min(num, pool), generator)
    return good[keep], good_c[keep]
