#!/usr/bin/env python3
"""chip_smoke.py's ViT-L/14 SwiGLU training phase alone, in a fresh process, on one GPU.

    python3 vit_step.py [--out FILE]

Builds the kernels, then runs `chip_smoke.run_vit_swiglu` with the seed
and generator the whole script uses: the warm-up and timed steps with
their readings (host enqueue time and its parts, device span, new
cudaMalloc segments, the SM clock), one more step under torch.profiler
(device busy ms and idle share; its table beside FILE), the launch
counts, the drop_path draws, the GPU-vs-CPU parity of 2 blocks, the
un-antialiased resize and K8/K9 beside SDPA's backward at
(4, 1601, 16, 64). Its step times against the same phase
inside the whole chip_smoke.py say what the earlier phases cost it.
Prints the card's line, the phase's lines and one JSON line of its report
(also written to FILE); exits non-zero without a GPU or when a check
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=ROOT / "results" / "vit_step.json")
    args = ap.parse_args()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # as chip_smoke.py's main

    import torch

    if not torch.cuda.is_available():
        print("vit_step: torch.cuda.is_available() is False; no GPU, no result", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from roma_torch.kernels import runtime

    card = cs.gpu_line()
    print(card, flush=True)
    runtime.build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    try:
        res = cs.run_vit_swiglu(dev, gen, card, args.out.parent)
    except cs.SmokeFailure as e:
        print(f"vit_step: FAILED: {e}", file=sys.stderr)
        return 1
    res.pop("parity", None)  # per-tensor readings; the phase printed its summary
    args.out.write_text(json.dumps(res, indent=1))
    print(json.dumps({k: res[k] for k in ("warmup_s", "step_s", "median_step_s", "step_readings",
                                          "start_mem_gb", "peak_mem_gb", "peak_above_start_gb")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
