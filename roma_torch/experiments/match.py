"""Sparse-match visualization: Tiny RoMa match -> sample N correspondences
-> draw them side by side, optionally estimate a fundamental matrix.

    python -m roma_torch.experiments.match --im_A_path A.jpg --im_B_path B.jpg

The port of the JAX package's experiments/match.py, with its arguments;
the image paths have no default here. Circles are drawn with
PIL.ImageDraw (OpenCV is not required). `--params` loads a reference Tiny
RoMa torch checkpoint (.pth) directly: the port uses the reference key
names.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image, ImageDraw

from roma_torch.benchmarks.harness_core import host_numpy
from roma_torch.models.port import load_reference_tiny
from roma_torch.models.zoo import tiny_roma_v1_outdoor

DEVICE = None  # the GPU


def draw_matches(im_a: Image.Image, im_b: Image.Image, kpts_a, kpts_b) -> Image.Image:
    """A and B side by side, each match a numbered color's circle pair
    (radius 3, width 2) in both images."""
    (w_a, h_a), (w_b, h_b) = im_a.size, im_b.size
    h = max(h_a, h_b)
    canvas = Image.new("RGB", (w_a + w_b, h))
    canvas.paste(im_a.resize((w_a, h)), (0, 0))
    canvas.paste(im_b.resize((w_b, h)), (w_a, 0))
    draw = ImageDraw.Draw(canvas)
    rng = np.random.default_rng(0)
    for (xa, ya), (xb, yb) in zip(kpts_a, kpts_b + np.array([w_a, 0])):
        color = tuple(int(c) for c in rng.integers(0, 256, 3))
        for x, y in ((xa, ya), (xb, yb)):
            draw.ellipse([x - 3, y - 3, x + 3, y + 3], outline=color, width=2)
    return canvas


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--im_A_path", required=True)
    p.add_argument("--im_B_path", required=True)
    p.add_argument("--save_path", default="match.jpg")
    p.add_argument("--num", type=int, default=300)
    p.add_argument("--params", default=None,
                   help="reference tiny-RoMa torch checkpoint (.pth) to load")
    p.add_argument("--fundamental", action="store_true",
                   help="also estimate F from the sampled matches")
    args = p.parse_args(argv)

    matcher = tiny_roma_v1_outdoor(device=DEVICE)
    if args.params:
        load_reference_tiny(matcher.model, torch.load(args.params, map_location="cpu",
                                                      weights_only=True))

    im_a = Image.open(args.im_A_path).convert("RGB")
    im_b = Image.open(args.im_B_path).convert("RGB")
    (w_a, h_a), (w_b, h_b) = im_a.size, im_b.size

    warp, certainty = matcher.match(im_a, im_b)
    gen = torch.Generator(device=warp.device).manual_seed(0)
    matches, _ = matcher.sample(warp, certainty, num=args.num, generator=gen)
    kpts_a, kpts_b = matcher.to_pixel_coordinates(matches, h_a, w_a, h_b, w_b)
    kpts_a = host_numpy(kpts_a).round().astype(int)
    kpts_b = host_numpy(kpts_b).round().astype(int)

    draw_matches(im_a, im_b, kpts_a, kpts_b).save(args.save_path)
    print(f"{len(kpts_a)} matches; saved {args.save_path}")

    result = None
    if args.fundamental:
        from roma_torch.estimation import estimate_fundamental_ransac

        result = estimate_fundamental_ransac(
            kpts_a.astype(np.float64), kpts_b.astype(np.float64), threshold_px=1.0,
        )
        if result is None:
            print("fundamental estimation failed")
        else:
            print("F =\n", result.model)
            print(f"inliers: {int(result.inliers.sum())}/{len(kpts_a)}")
    return kpts_a, kpts_b, result


if __name__ == "__main__":
    main()
