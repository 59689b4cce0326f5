"""Evaluate full RoMa on the pose/dense benchmarks.

    python -m roma_torch.experiments.eval_roma_outdoor [--data_root ...]

The port of the JAX package's experiments/eval_roma_outdoor.py, with its
arguments: load a checkpoint (or random weights from seed 0 for plumbing
checks), run Mega-1500 (and optionally Mega-8 and the dense benchmark) and
print/save the metric dict. `--checkpoint` is a directory that
roma_torch.train.checkpoint.CheckPoint wrote (e.g.
workspace/checkpoints/roma_outdoor); its latest weights are loaded.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

from roma_torch.benchmarks import MegadepthDenseBenchmark, MegaDepthPoseEstimationBenchmark
from roma_torch.models.zoo import roma_outdoor
from roma_torch.train.checkpoint import CheckPoint

DEVICE = None  # the GPU


def load_checkpoint(model, path: str):
    """The latest weights of a CheckPoint directory into `model`."""
    root = Path(path)
    return CheckPoint(root.parent, root.name).load_model(model)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default="data/megadepth")
    p.add_argument("--checkpoint", default=None, help="CheckPoint directory")
    p.add_argument("--coarse_res", type=int, default=560)
    p.add_argument("--upsample_res", type=int, default=864)
    p.add_argument("--out", default="results/roma_outdoor_mega1500.json")
    p.add_argument("--dense", action="store_true")
    p.add_argument("--mega8", action="store_true",
                   help="also run the Mega-8-scenes list")
    p.add_argument("--pose_backend", default="auto",
                   choices=["auto", "cv2", "native", "numpy"])
    p.add_argument("--shard_index", type=int, default=0)
    p.add_argument("--shard_count", type=int, default=1)
    p.add_argument("--batch", type=int, default=1,
                   help=">1: the batched schedule (stacked match, prefetch, pooled "
                        "RANSAC), protocol-identical")
    p.add_argument("--device-resize", action="store_true",
                   help="ship original-res uint8, PIL-parity resize on the device "
                        "(<= 1 uint8 level)")
    args = p.parse_args(argv)

    matcher = roma_outdoor(coarse_res=args.coarse_res, upsample_res=args.upsample_res,
                           device=DEVICE)
    if args.checkpoint:
        load_checkpoint(matcher.model, args.checkpoint)

    common = dict(data_root=args.data_root, shard=(args.shard_index, args.shard_count),
                  pose_backend=args.pose_backend, batch_size=args.batch,
                  device_resize=args.device_resize)
    results = {}
    bench = MegaDepthPoseEstimationBenchmark(**common)
    results.update(bench.benchmark(matcher, model_name="roma_outdoor"))
    if args.mega8:
        from roma_torch.experiments.eval_tiny_roma_v1_outdoor import MEGA8_SCENES

        bench8 = MegaDepthPoseEstimationBenchmark(scene_names=MEGA8_SCENES, **common)
        results["mega8"] = bench8.benchmark(matcher, model_name="roma_outdoor")
    if args.dense:
        results.update(MegadepthDenseBenchmark(data_root=args.data_root).benchmark(matcher))
    print(json.dumps(results, indent=2))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
