"""3D parallax frames: interpolate the dense warp between the two views and
resample image B at each intermediate warp (the port's `grid_sample`),
writing one JPEG a frame, the port of the JAX package's
demo/demo_3D_effect.py.

    python -m roma_torch.demo.demo_3D_effect --im_A_path A.jpg --im_B_path B.jpg
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from PIL import Image

from roma_torch.models.zoo import roma_outdoor
from roma_torch.ops.grid_sample import grid_sample


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--im_A_path", required=True)
    p.add_argument("--im_B_path", required=True)
    p.add_argument("--save_path", default="gif/roma_warp")
    p.add_argument("--frames", type=int, default=200)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    matcher = roma_outdoor(device=args.device)
    # one direction is enough for the effect (the reference sets
    # symmetric=False): the A-side half of the symmetric warp
    warp, _ = matcher.match(args.im_A_path, args.im_B_path)
    h, w = warp.shape[0], warp.shape[1] // 2
    warp = warp[:, :w]
    coords_a, coords_b = warp[..., :2], warp[..., 2:]
    im_b = np.asarray(Image.open(args.im_B_path).convert("RGB").resize((w, h)),
                      np.float32) / 255.0
    x_b = torch.from_numpy(im_b)[None].to(warp.device)

    os.makedirs(os.path.dirname(args.save_path) or ".", exist_ok=True)
    paths = []
    for i, x in enumerate(np.linspace(0, 2 * np.pi, args.frames)):
        t = float((1 + np.cos(x)) / 2)
        frame = grid_sample(x_b, ((1 - t) * coords_a + t * coords_b)[None])[0]
        frame = (frame.clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
        paths.append(f"{args.save_path}_{i:03d}.jpg")
        Image.fromarray(frame).save(paths[-1])
    print(f"saved {args.frames} frames to {args.save_path}_*.jpg")
    return paths


if __name__ == "__main__":
    main()
