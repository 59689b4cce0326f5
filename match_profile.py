#!/usr/bin/env python3
"""Device time of the full-RoMa match() on one GPU, call by call.

    python3 match_profile.py LABEL [--calls N] [--smooth {off,fast,exact}]

Run from a checkout's root (this one, another commit's, or an edited copy
of the port): builds roma_outdoor() with seed 0 (with `--smooth`, its
smooth_warp_gather set to "fast" or True), matches 2 pairs of random
560 x 560 images from a seeded generator once, times N more calls on the
host clock, then profiles N more (torch.profiler, CUDA activity). Prints
one line: LABEL, a checksum of the warp and certainty (sums in float64;
equal checksums mean equal outputs), the untraced wall ms of each call,
and per profiled call the device busy ms (the sum of every kernel's device
time, as `chip_smoke.py --profile` counts it), the device ms of
`grid_sampler_2d`, of the local-correlation kernels and of the windowed
gather. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("label")
    ap.add_argument("--calls", type=int, default=3)
    ap.add_argument("--smooth", choices=("off", "fast", "exact"), default="off")
    args = ap.parse_args()
    sys.path.insert(0, str(Path.cwd()))
    import torch

    if not torch.cuda.is_available():
        print("match_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from roma_torch.models.zoo import roma_outdoor

    dev = torch.device("cuda", 0)
    smooth = {"off": False, "fast": "fast", "exact": True}[args.smooth]
    matcher = roma_outdoor(seed=cs.SEED, device=dev, smooth_warp_gather=smooth)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    h, w = matcher.cfg.coarse_resolution
    ims = [torch.rand((cs.PAIRS, h, w, 3), generator=gen, device=dev) for _ in range(2)]
    warp, cert, _ = cs.timed_match(matcher, *ims)
    checksum = (float(warp.double().sum()), float(cert.double().sum()))
    k1_names = ("local_corr", "pixel_kernel", "box_chunk", "combine_kernel")
    wall_ms = [cs.timed_match(matcher, *ims)[2] * 1e3 for _ in range(args.calls)]
    calls = []
    for _ in range(args.calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cs.timed_match(matcher, *ims)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.key.startswith("roma.")]

        def ms(e):
            return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3

        calls.append(dict(busy_ms=sum(ms(e) for e in kernels),
                          grid_sample_ms=sum(ms(e) for e in kernels if "grid_sampler" in e.key),
                          local_corr_ms=sum(ms(e) for e in kernels
                                            if any(n in e.key for n in k1_names)),
                          windowed_ms=sum(ms(e) for e in kernels if "windowed_sample" in e.key)))
    print(f"[{cs.gpu_line()}] {args.label}: checksum {checksum}; wall ms "
          + ", ".join(f"{t:.2f}" for t in wall_ms)
          + "; busy / grid_sample / local_corr / windowed ms a call: "
          + ", ".join(f"{c['busy_ms']:.3f} / {c['grid_sample_ms']:.3f} / {c['local_corr_ms']:.3f}"
                      f" / {c['windowed_ms']:.3f}" for c in calls), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
