"""Evaluate Tiny RoMa v1 on Mega-1500 (+ Mega-8-scenes).

    python -m roma_torch.experiments.eval_tiny_roma_v1_outdoor [--data_root ...]

The port of the JAX package's experiments/eval_tiny_roma_v1_outdoor.py,
with its arguments and the Mega-8 scene list. `--checkpoint` is a
directory that roma_torch.train.checkpoint.CheckPoint wrote (e.g.
workspace/checkpoints/tiny_roma_v1_outdoor).
"""

from __future__ import annotations

import argparse
import json
import os

from roma_torch.benchmarks import MegaDepthPoseEstimationBenchmark
from roma_torch.experiments.eval_roma_outdoor import load_checkpoint
from roma_torch.models.zoo import tiny_roma_v1_outdoor

DEVICE = None  # the GPU
MEGA8_SCENES = [
    "mega_8_scenes_0019_0.1_0.3.npz", "mega_8_scenes_0025_0.1_0.3.npz",
    "mega_8_scenes_0021_0.1_0.3.npz", "mega_8_scenes_0008_0.1_0.3.npz",
    "mega_8_scenes_0032_0.1_0.3.npz", "mega_8_scenes_1589_0.1_0.3.npz",
    "mega_8_scenes_0063_0.1_0.3.npz", "mega_8_scenes_0024_0.1_0.3.npz",
    "mega_8_scenes_0019_0.3_0.5.npz", "mega_8_scenes_0025_0.3_0.5.npz",
    "mega_8_scenes_0021_0.3_0.5.npz", "mega_8_scenes_0008_0.3_0.5.npz",
    "mega_8_scenes_0032_0.3_0.5.npz", "mega_8_scenes_1589_0.3_0.5.npz",
    "mega_8_scenes_0063_0.3_0.5.npz", "mega_8_scenes_0024_0.3_0.5.npz",
]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default="data/megadepth")
    p.add_argument("--checkpoint", default=None, help="CheckPoint directory")
    p.add_argument("--mega8", action="store_true")
    p.add_argument("--out", default="results/tiny_roma_v1_outdoor.json")
    args = p.parse_args(argv)

    matcher = tiny_roma_v1_outdoor(device=DEVICE)
    if args.checkpoint:
        load_checkpoint(matcher.model, args.checkpoint)

    results = {}
    bench = MegaDepthPoseEstimationBenchmark(data_root=args.data_root)
    results["mega1500"] = bench.benchmark(matcher, model_name="tiny_roma_v1")
    if args.mega8:
        bench8 = MegaDepthPoseEstimationBenchmark(data_root=args.data_root,
                                                  scene_names=MEGA8_SCENES)
        results["mega8"] = bench8.benchmark(matcher, model_name="tiny_roma_v1")
    print(json.dumps(results, indent=2))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
