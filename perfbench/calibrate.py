"""The readings that a cell's limits are set from: the numbers the check
compares (perfbench/core/check.py, or a training cell's
perfbench/core/train.py), read from runs of the cell as the benchmark runs
it (set-up, a window of two calls, the check), on many seeds for the
program, on a few for the control (the reference in the program's place
at the control's precision: the configuration module's `Control` where it
defines one) and, for a training cell, on a few for a fault planted in the
program (the configuration module's `FAULTS`), all in one process.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 ... \
        --control-seeds 101 102 103 [--faults half_the_batch --fault-seeds 201 202 203] \
        [--out FILE]

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
    if hasattr(cell.cfgmod, "Control"):
        return cell.cfgmod.Control(cell.cfg, cell.traffic, state, device)
    from perfbench.core.program import Control

    return Control(cell.cfgmod, cell.cfg, cell.traffic, state, device)


def faulty_program(fault: str):
    """The program with the configuration module's fault `fault` planted
    under its step."""
    def make(cell, state, device):
        from perfbench.core import harness

        program = harness.default_program(cell, state, device)
        program.step = cell.cfgmod.FAULTS[fault](program)
        return program
    return make


def matching_record(cell) -> list[str]:
    """Every number of a matching cell's check, and its plain departures."""
    from perfbench.core import check

    extra = ("warp_q50", "warp_q90", "cert_mean", "b16_warp_q50", "b16_cert_mean",
             "ref_clamped_share", "ref_cert_mean")
    return [n for n in check.NUMBERS + extra + tuple(e + "_mid" for e in extra)
            if n != "sample_miss" or cell.traffic["num"]]


def readings(cell, seeds, control: bool, device="cuda", fault: str | None = None) -> list[dict]:
    """Every number of the check (no limit) of one short run a seed: those
    the configuration module's `record(cell)` names, or a matching cell's."""
    from perfbench.core import harness

    numbers = getattr(cell.cfgmod, "record", matching_record)(cell)
    cell = dataclasses.replace(cell, limits={n: float("inf") for n in numbers})
    out = []
    for s in seeds:
        t = time.time()
        kw = {"make_program": control_program} if control else {}
        if fault:
            kw = {"make_program": faulty_program(fault)}
        res = harness.run(cell, s, 0.0, False, device, t, **kw)
        out.append({"seed": s, "control": control, "fault": fault, "seconds": time.time() - t,
                    **{n: c["value"] for n, c in res["checks"].items()}})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from perfbench.core import cells

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    rows = readings(cell, args.seeds, False) + readings(cell, args.control_seeds, True)
    for fault in args.faults:
        rows += readings(cell, args.fault_seeds, False, fault=fault)
    summary = {}
    for n in rows[0]:
        if n in ("seed", "control", "fault", "seconds"):
            continue
        prog = [r[n] for r in rows if not r["control"] and not r["fault"]]
        ctrl = [r[n] for r in rows if r["control"]]
        summary[n] = {"program_max": max(prog), "control_min": min(ctrl) if ctrl else None}
        for fault in args.faults:
            summary[n][f"{fault}_min"] = min(r[n] for r in rows if r["fault"] == fault)
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
