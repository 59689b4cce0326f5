"""Dense-warp visualisation: match two images with full RoMa and save the
certainty-blended warp, the port of the JAX package's demo/demo_match.py.

    python -m roma_torch.demo.demo_match --im_A_path A.jpg --im_B_path B.jpg
"""

from __future__ import annotations

import argparse

import numpy as np
from PIL import Image

from roma_torch.models.zoo import roma_outdoor


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--im_A_path", required=True)
    p.add_argument("--im_B_path", required=True)
    p.add_argument("--save_path", default="roma_warp.jpg")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    matcher = roma_outdoor(device=args.device)
    im_a = np.asarray(Image.open(args.im_A_path).convert("RGB"), np.float32) / 255
    im_b = np.asarray(Image.open(args.im_B_path).convert("RGB"), np.float32) / 255
    warp, certainty = matcher.match(im_a, im_b)
    matcher.visualize_warp(warp, certainty, im_a, im_b, save_path=args.save_path)
    print(f"saved {args.save_path}")
    return warp, certainty


if __name__ == "__main__":
    main()
