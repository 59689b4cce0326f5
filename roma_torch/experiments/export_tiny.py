"""Tiny RoMa export: serialise the forward at a fixed shape with
`torch.export` (weights as the first argument) and print the work of one
run (FLOPs, bytes, peak device memory), the port of the JAX package's
experiments/export_tiny.py.

    python -m roma_torch.experiments.export_tiny --check --fused-kernel

`--fused-kernel` exports the streaming correlation-softmax kernel as its
``roma::corr_softmax`` operator; the program launches it when run on the
card. `--check` loads the artifact back and holds it to the eager model on
random images (atol 1e-5).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from roma_torch.config import TinyRomaConfig
from roma_torch.export import export_tiny_roma, load_exported
from roma_torch.models.port import load_reference_tiny
from roma_torch.models.zoo import tiny_roma_v1_outdoor


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--height", type=int, default=320)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--checkpoint", default=None,
                   help="reference tiny-RoMa torch checkpoint (.pth) to load")
    p.add_argument("--out", default="tiny_roma.pt2")
    p.add_argument("--check", action="store_true",
                   help="round-trip the artifact and compare outputs")
    p.add_argument("--device", default="cuda")
    p.add_argument("--fused-kernel", action="store_true",
                   help="the streaming correlation-softmax kernel (K7) for the coarse warp")
    args = p.parse_args(argv)

    cfg = TinyRomaConfig(fused_kernel=args.fused_kernel)
    matcher = tiny_roma_v1_outdoor(device=args.device, cfg=cfg)
    if args.checkpoint:
        load_reference_tiny(matcher.model, torch.load(args.checkpoint, map_location="cpu",
                                                      weights_only=True))
    params = dict(matcher.model.state_dict())
    hw = (args.height, args.width)
    result = export_tiny_roma(params, hw=hw, cfg=cfg, path=args.out)
    print(f"serialized {len(result.serialized) / 1e6:.1f} MB -> {args.out}")
    peak = "" if result.peak_memory is None else f", peak {result.peak_memory / 1e6:.1f} MB"
    print(f"forward: {result.flops / 1e9:.2f} GFLOP, "
          f"{result.bytes_accessed / 1e9:.2f} GB accessed{peak}")

    if args.check:
        rng = np.random.default_rng(0)
        a, b = (torch.from_numpy(rng.uniform(0, 1, (1, *hw, 3)).astype(np.float32))
                .to(matcher.device) for _ in range(2))
        out = load_exported(result.serialized)(params, a, b)
        with torch.no_grad():
            ref = matcher.model(a, b)
        np.testing.assert_allclose(out[0].cpu().numpy(), ref[8]["flow"].cpu().numpy(), atol=1e-5)
        print("round-trip check passed")
    return result


if __name__ == "__main__":
    main()
