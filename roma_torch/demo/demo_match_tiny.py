"""Tiny RoMa matching: match two images at 448 x 608, sample 2000
correspondences and save the warp visualisation, the port of the JAX
package's demo/demo_match_tiny.py.

    python -m roma_torch.demo.demo_match_tiny --im_A_path A.jpg --im_B_path B.jpg
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image

from roma_torch.models.zoo import tiny_roma_v1_outdoor

H, W = 448, 608  # the common size of the pair


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--im_A_path", required=True)
    p.add_argument("--im_B_path", required=True)
    p.add_argument("--save_path", default="tiny_roma_warp.jpg")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    matcher = tiny_roma_v1_outdoor(device=args.device)
    im_a, im_b = (np.asarray(Image.open(path).convert("RGB").resize((W, H)), np.float32) / 255
                  for path in (args.im_A_path, args.im_B_path))
    warp, certainty = matcher.match(im_a, im_b)
    gen = torch.Generator(device=warp.device).manual_seed(0)
    matches, _ = matcher.sample(warp, certainty, num=2000, generator=gen)
    k_a, k_b = matcher.to_pixel_coordinates(matches, H, W, H, W)
    print(f"sampled {len(k_a)} matches")
    matcher.visualize_warp(warp, certainty, im_a, im_b, save_path=args.save_path)
    print(f"saved {args.save_path}")
    return k_a, k_b


if __name__ == "__main__":
    main()
