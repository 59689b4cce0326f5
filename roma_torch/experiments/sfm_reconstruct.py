"""Multi-view SfM from a directory of images: dense matching -> pose graph ->
tracks -> bundle adjustment.

    python -m roma_torch.experiments.sfm_reconstruct --images DIR [--matcher roma]

The port of the JAX package's experiments/sfm_reconstruct.py, with its
arguments: matches each image with the next `--window` ones (Tiny RoMa at
608x448, or full RoMa at its shipped resolutions), samples
`--num_matches` correspondences a pair (a `torch.Generator` seeded 0, in
place of the JAX CLI's split PRNG keys), reconstructs, writes poses and
points to `--out`, and reports ATE when a ground-truth trajectory is
given. No weights ship with the repo: the matcher is randomly initialised
from seed 0.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch
from PIL import Image

from roma_torch.models.zoo import roma_outdoor, tiny_roma_v1_outdoor
from roma_torch.sfm.reconstruction import reconstruct

DEVICE = None  # the GPU


def main(argv=None) -> dict:
    """Runs the CLI; returns {"matches": {(i, j): n}, "pair_s": {(i, j): wall
    seconds of match + sample}, "reconstruction": Reconstruction, "out": path}."""
    p = argparse.ArgumentParser()
    p.add_argument("--images", required=True, help="directory of images (sorted)")
    p.add_argument("--intrinsics", default=None,
                   help="3x3 K as a .txt (one shared camera); default: focal=1.2*max(h,w)")
    p.add_argument("--matcher", default="tiny", choices=["tiny", "roma"])
    p.add_argument("--window", type=int, default=3, help="match i with i+1..i+window")
    p.add_argument("--num_matches", type=int, default=2000)
    p.add_argument("--gt_trajectory", default=None,
                   help="npy of (N, 3) GT camera centers for ATE")
    p.add_argument("--out", default="results/sfm_reconstruction.npz")
    args = p.parse_args(argv)

    paths = sorted(
        sum([glob.glob(os.path.join(args.images, e)) for e in ("*.jpg", "*.png", "*.ppm")], [])
    )
    n = len(paths)
    assert n >= 3, f"need >= 3 images, found {n}"
    print(f"{n} images")

    matcher = tiny_roma_v1_outdoor(device=DEVICE) if args.matcher == "tiny" \
        else roma_outdoor(device=DEVICE)

    sizes, ims = [], []
    for path in paths:
        im = Image.open(path).convert("RGB")
        sizes.append(im.size)  # (w, h)
        if args.matcher == "tiny":
            im = im.resize((608, 448))
        ims.append(np.asarray(im, np.float32) / 255.0)

    if args.intrinsics:
        K = np.loadtxt(args.intrinsics).reshape(3, 3)
    else:
        w0, h0 = sizes[0]
        f = 1.2 * max(w0, h0)
        K = np.array([[f, 0, w0 / 2], [0, f, h0 / 2], [0, 0, 1.0]])

    gen = torch.Generator(device=matcher.device).manual_seed(0)
    matches, pair_s = {}, {}
    for i in range(n):
        for j in range(i + 1, min(i + 1 + args.window, n)):
            t0 = time.perf_counter()
            warp, cert = matcher.match(ims[i], ims[j])
            sparse, _ = matcher.sample(warp, cert, args.num_matches, generator=gen)
            wi, hi = sizes[i]
            wj, hj = sizes[j]
            ki = matcher.to_pixel_coordinates(sparse[:, :2], hi, wi).cpu().numpy()
            kj = matcher.to_pixel_coordinates(sparse[:, 2:], hj, wj).cpu().numpy()
            pair_s[(i, j)] = time.perf_counter() - t0
            matches[(i, j)] = (ki, kj)
            print(f"pair ({i},{j}): {len(ki)} matches")

    rec = reconstruct(matches, np.tile(K, (n, 1, 1)).astype(np.float32), n,
                      device=matcher.device)
    print(f"BA final robust cost: {rec.cost:.4g} px^2, {len(rec.points)} points")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, rotations=rec.rotations, translations=rec.translations,
             points=rec.points, centers=rec.centers)
    print(f"saved {args.out}")

    if args.gt_trajectory:
        from roma_torch.sfm.metrics import absolute_trajectory_error

        gt = np.load(args.gt_trajectory)
        print(json.dumps(absolute_trajectory_error(rec.centers, gt), indent=2))
    return {"matches": {k: len(v[0]) for k, v in matches.items()}, "pair_s": pair_s,
            "reconstruction": rec, "out": args.out}


if __name__ == "__main__":
    main()
