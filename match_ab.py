#!/usr/bin/env python3
"""Full-RoMa match() pairs/s of two checkouts of the port, in turns, on one GPU.

    python3 match_ab.py OTHER_CHECKOUT [--calls N] [--out FILE]

Runs OTHER_CHECKOUT (the root of another commit's tree, e.g. a `git
archive` of the parent), this checkout, this checkout, OTHER_CHECKOUT,
each in a process of its own started from that checkout's root: it builds
the kernels, builds full-width roma_outdoor()'s model with the same
weights in every checkout (`RomaModel` with flax's initialisation,
`layers.flax_init_`, after `manual_seed(0)`, whatever the checkout's
`build_model` default), matches 2 pairs of random 560 x 560 images three
times to warm up, then times N more calls on the host clock (each ending
in a synchronize) and profiles 3 (the device busy ms a call, as
`chip_smoke.py --profile` counts it). Prints one JSON line a run and
writes them all to FILE. Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ONE_RUN = r'''
import json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from roma_torch.config import RomaConfig
from roma_torch.kernels import runtime
from roma_torch.models.layers import flax_init_
from roma_torch.models.matcher import RomaMatcher, RomaModel

runtime.build()
dev = torch.device("cuda", 0)
with torch.random.fork_rng(devices=[]):
    torch.manual_seed(0)
    model = RomaModel(RomaConfig())
    torch.manual_seed(0)
    flax_init_(model)
m = RomaMatcher(model, device=dev)
gen = torch.Generator(device=dev).manual_seed(0)
a, b = (torch.rand((2, 560, 560, 3), generator=gen, device=dev) for _ in range(2))
for _ in range(3):
    cs.timed_match(m, a, b)
times = [cs.timed_match(m, a, b)[2] for _ in range(int(sys.argv[1]))]
busy = cs.profiled_device_ms(lambda: m.match(a, b, batched=True), 3)
print("RESULT " + json.dumps({"match_s": times, "pairs_per_s": 2 / min(times),
                              "median_s": sorted(times)[len(times) // 2],
                              "device_busy_ms": busy}))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--calls", type=int, default=15)
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "match_ab.json")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("match_ab: no CUDA device", file=sys.stderr)
        return 2
    runs = []
    for label, root in (("other", args.other), ("this", ROOT), ("this", ROOT),
                        ("other", args.other)):
        p = subprocess.run([sys.executable, "-c", ONE_RUN, str(args.calls)], cwd=root,
                           capture_output=True, text=True)
        line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")]
        if p.returncode or not line:
            print(p.stdout[-3000:], p.stderr[-3000:], file=sys.stderr)
            return 1
        runs.append(dict(json.loads(line[0][len("RESULT "):]), checkout=label,
                         root=str(root)))
        print(json.dumps(runs[-1]), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
