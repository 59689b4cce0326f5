"""Balanced certainty-weighted correspondence sampling: threshold the
certainty, draw an oversampled pool proportional to certainty, re-weight by
inverse KDE density for spatial balance, and draw the final set. Draws
without replacement are Gumbel top-k, with noise from a `torch.Generator`
(the draws differ from the JAX package's; their distribution does not)."""

from __future__ import annotations

import torch

from roma_torch.utils.kde import kde
from roma_torch.utils.profiling import span


def gumbel_topk(weights: torch.Tensor, k: int,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Indices of k draws without replacement with P(i) proportional to
    weights (N,) >= 0; zero weights are drawn only if fewer than k are positive."""
    logw = torch.log(weights.float().clamp_min(0.0))
    u = torch.rand(weights.shape, generator=generator, device=weights.device)
    g = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.topk(logw + g, k).indices


def sample_matches(
    matches: torch.Tensor,
    certainty: torch.Tensor,
    num: int = 10000,
    sample_thresh: float = 0.05,
    expansion_factor: int = 4,
    balanced: bool = True,
    generator: torch.Generator | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Draw `num` balanced correspondences from a dense warp (..., 4) with
    certainty (...,) in [0, 1]. Returns (matches (num, 4), certainty (num,))."""
    with span("roma.sample"):
        matches = matches.reshape(-1, 4)
        certainty = certainty.reshape(-1).float()
        certainty = torch.where(certainty > sample_thresh, torch.ones_like(certainty), certainty)
        if not balanced:
            idx = gumbel_topk(certainty, num, generator)
            return matches[idx], certainty[idx]
        pool = min(expansion_factor * num, matches.shape[0])
        good_idx = gumbel_topk(certainty, pool, generator)
        good_matches = matches[good_idx]
        good_certainty = certainty[good_idx]
        with span("roma.sample.kde"):
            density = kde(good_matches, std=0.1)
        p = 1.0 / (density + 1.0)
        # need ~10 near-perfect neighbours to count as a populated region
        p = torch.where(density < 10, torch.full_like(p, 1e-7), p)
        final_idx = gumbel_topk(p, min(num, pool), generator)
        return good_matches[final_idx], good_certainty[final_idx]
