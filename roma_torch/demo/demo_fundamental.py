"""Fundamental matrix: match with full RoMa, sample 10000 correspondences and
estimate F with the port's robust estimator, the port of the JAX package's
demo/demo_fundamental.py.

    python -m roma_torch.demo.demo_fundamental --im_A_path A.jpg --im_B_path B.jpg
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image

from roma_torch.benchmarks.harness_core import host_numpy
from roma_torch.estimation import estimate_fundamental_ransac
from roma_torch.models.zoo import roma_outdoor


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--im_A_path", required=True)
    p.add_argument("--im_B_path", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    matcher = roma_outdoor(device=args.device)
    pil_a = Image.open(args.im_A_path).convert("RGB")
    pil_b = Image.open(args.im_B_path).convert("RGB")
    (w1, h1), (w2, h2) = pil_a.size, pil_b.size
    im_a = np.asarray(pil_a, np.float32) / 255
    im_b = np.asarray(pil_b, np.float32) / 255
    warp, certainty = matcher.match(im_a, im_b)
    gen = torch.Generator(device=warp.device).manual_seed(0)
    matches, _ = matcher.sample(warp, certainty, num=10000, generator=gen)
    kpts1, kpts2 = matcher.to_pixel_coordinates(matches, h1, w1, h2, w2)
    res = estimate_fundamental_ransac(host_numpy(kpts1).astype(np.float64),
                                      host_numpy(kpts2).astype(np.float64),
                                      threshold_px=0.2, max_iters=2000)
    if res is None:
        print("fundamental estimation failed")
        return None
    print("F =\n", res.model)
    print(f"inliers: {res.inliers.mean():.1%} of {len(res.inliers)}")
    return res


if __name__ == "__main__":
    main()
