"""The readings that a cell's limits are set from: the numbers the check
compares (perfbench/core/check.py), read from runs of the cell as the
benchmark runs it (set-up, a window of two calls, the check), on many
seeds for the program and on a few for the control (the reference in the
program's place at the control's precision), all in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--out FILE]

Needs a card, as the benchmark does.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import perfbench.run  # noqa: E402,F401  (the caches inside the checkout)


def control_program(cell, state, device):
    from perfbench.core.program import Control

    return Control(cell.cfgmod, cell.cfg, cell.traffic, state, device)


def readings(cell, seeds, control: bool, device="cuda") -> list[dict]:
    """Every number of the check (no limit) of one short run a seed."""
    from perfbench.core import check, harness

    extra = ("warp_q50", "warp_q90", "cert_mean", "b16_warp_q50", "b16_cert_mean",
             "ref_clamped_share", "ref_cert_mean")
    numbers = [n for n in check.NUMBERS + extra + tuple(e + "_mid" for e in extra)
               if n != "sample_miss" or cell.traffic["num"]]
    cell = dataclasses.replace(cell, limits={n: float("inf") for n in numbers})
    out = []
    for s in seeds:
        t = time.time()
        kw = {"make_program": control_program} if control else {}
        res = harness.run(cell, s, 0.0, False, device, t, **kw)
        out.append({"seed": s, "control": control, "seconds": time.time() - t,
                    **{n: c["value"] for n, c in res["checks"].items()}})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from perfbench.core import cells

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    rows = readings(cell, args.seeds, False) + readings(cell, args.control_seeds, True)
    summary = {}
    for n in rows[0]:
        if n in ("seed", "control", "seconds"):
            continue
        prog = [r[n] for r in rows if not r["control"]]
        ctrl = [r[n] for r in rows if r["control"]]
        summary[n] = {"program_max": max(prog), "control_min": min(ctrl) if ctrl else None}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
