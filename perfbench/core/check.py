"""The comparison that decides `correct`: what the timed path produced for a
sample of the window's calls against the plain reference on the same
inputs and weights.

With random weights a dense matcher is chaotic in places (near-tied
anchors or correlation peaks), and how far any bfloat16
computation departs from float32 varies from pair to pair and seed to
seed. So each pair's departure is measured in units of the departure of
the reference itself computed with bfloat16 operands (`Precision
("bfloat16")`) on the same pair:
- warp_rel: (median over pixels of the program's largest |warp - float32
  reference| over the four coordinates + 1e-4) / (the same of the bfloat16
  reference + 1e-4);
- cert_rel: (mean |certainty - float32 reference| + 1e-4) / (the same of
  the bfloat16 reference + 1e-4);
- sample_miss: the share of the program's sampled matches (with their
  certainties) that the reference sampler does not draw from the
  program's own warp and certainty with the same generator seeds. The
  reference follows the program's dense output there; that output is
  judged by the numbers above.
A number is the largest over the checked pairs; with `_mid` it is their
median; dense_rel_mid is the larger of warp_rel_mid and cert_rel_mid (a
lower precision shows in the warp on some seeds and in the certainty on
others, and in neither alone on every seed). Besides them every pair
reports the plain departures (warp_q50, warp_q90, cert_mean) and what the
reference's output looks like, for the record. A limits file names the numbers a cell compares and their limits.
A training cell's configuration module brings its own numbers
(`perfbench/core/train.py`); `verdict` holds them to the limits alike.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

from perfbench.core.program import generator
from perfbench.reference import sampling
from perfbench.reference.common import Precision

EPS = 1e-4
NUMBERS = ("dense_rel_mid", "warp_rel", "warp_rel_mid", "cert_rel", "cert_rel_mid",
           "sample_miss")


def _rows(m: torch.Tensor, c: torch.Tensor) -> np.ndarray:
    a = np.ascontiguousarray(torch.cat([m.float(), c.float()[:, None]], 1).cpu().numpy())
    return a.view(np.dtype((np.void, a.dtype.itemsize * a.shape[1])))[:, 0]


def _departure(warp, cert, ref_warp, ref_cert) -> tuple[torch.Tensor, float]:
    """Per-pixel largest |warp difference| (sorted), mean |certainty difference|."""
    d = (warp.float() - ref_warp.float()).abs().amax(-1).flatten().sort().values
    return d, (cert.float() - ref_cert.float()).abs().mean().item()


def pair_numbers(out_w, out_c, ref, b16, matches=None, mcert=None, ref_samples=None) -> dict:
    """One pair: the program's (out_w, out_c) against the float32 reference
    `ref` and the bfloat16 reference `b16`, each a (warp, certainty)."""
    d, dc = _departure(out_w, out_c, *ref)
    db, dcb = _departure(*b16, *ref)
    at = lambda t, q: t[round(q * (t.numel() - 1))].item()  # noqa: E731
    out = {"warp_rel": (at(d, 0.5) + EPS) / (at(db, 0.5) + EPS),
           "cert_rel": (dc + EPS) / (dcb + EPS),
           "warp_q50": at(d, 0.5), "warp_q90": at(d, 0.9), "cert_mean": dc,
           "b16_warp_q50": at(db, 0.5), "b16_cert_mean": dcb,
           "ref_clamped_share": (ref[0].abs() >= 1).any(-1).float().mean().item(),
           "ref_cert_mean": ref[1].float().mean().item()}
    if matches is not None:
        got = _rows(matches, mcert)
        out["sample_miss"] = float(np.mean(~np.isin(got, _rows(*ref_samples))))
    return out


def judge(outputs, ref, b16, seeds, num: int, thresh: float) -> list[dict]:
    """Numbers of each pair of one checked call; `ref` and `b16` the
    reference's (warp, certainty) batches in float32 and bfloat16. The
    reference sampler runs on the program's own dense output with the
    call's generator seeds."""
    out = []
    for i in range(ref[0].shape[0]):
        extra = {}
        if num:
            rs = sampling.sample(Precision(), outputs.warp[i], outputs.cert[i], num, thresh,
                                 generator(outputs.warp.device, seeds[i]))
            extra = dict(matches=outputs.matches[i], mcert=outputs.mcert[i], ref_samples=rs)
        out.append(pair_numbers(outputs.warp[i], outputs.cert[i], (ref[0][i], ref[1][i]),
                                (b16[0][i], b16[1][i]), **extra))
    return out


def aggregate(pairs: list[dict]) -> dict[str, float]:
    """Every per-pair number's largest value over the pairs, its median
    under the name with `_mid`, and dense_rel_mid where the pairs are dense
    warps."""
    out = {}
    for name in pairs[0] if pairs else ():
        vals = [p[name] for p in pairs]
        out[name] = max(vals)
        out[name + "_mid"] = statistics.median(vals)
    if "warp_rel_mid" in out:
        out["dense_rel_mid"] = max(out["warp_rel_mid"], out["cert_rel_mid"])
    return out


def verdict(pairs: list[dict], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}) for the numbers `limits`
    names; a missing or non-finite one fails."""
    agg = aggregate(pairs)
    checks, ok = {}, bool(pairs)
    for name, limit in limits.items():
        v = agg.get(name, float("nan"))
        checks[name] = {"value": v, "limit": limit}
        ok = ok and math.isfinite(v) and v <= limit
    return ok, checks
