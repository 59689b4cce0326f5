"""Host time and host syncs by span of a benchmark cell's calls, read from the
port's in-memory span log (`roma_torch.utils.profiling.SpanLog`), on the card.

    python3 span_log.py --workload tiny-b8-dense [--workload ...] [--seed N]
        [--calls 40] [--out chiprun_out/spans.json]

For each cell: the program, weights and inputs as `perfbench/run.py` makes
them, the traffic's warm-up calls, then `--calls` calls in turns with the
log off and on (each call's host ms; with the log on also the summed host
ms of the program's root spans, `roma.match` / `tiny.match` and each
`roma.sample`), then 2 calls under ``SpanLog(syncs=True)`` (syncs a call
by innermost span) and 2 under the benchmark's own sync count around the
entries. First, the host ns of one range: bare `record_function`, `span`
with no log, `span` logged, in turns. Prints one JSON object a cell and writes all
of them to `--out`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import record_function

from perfbench.core import cells, harness, inputs
from perfbench.core.program import SyncCounter
from perfbench.reference.common import no_tf32
from roma_torch.utils.profiling import SpanLog, span


def ns_a_range(n: int = 100_000, rounds: int = 7) -> dict:
    """Host ns a `with` block of each kind: the least and the median over
    `rounds` runs of n, the kinds in turns."""
    def run(make):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with make("t.x"):
                pass
        return (time.perf_counter_ns() - t0) / n

    times: dict[str, list] = {"record_function": [], "span, no log": [], "span, logged": []}
    for _ in range(rounds):
        times["record_function"].append(run(record_function))
        times["span, no log"].append(run(span))
        with SpanLog():
            times["span, logged"].append(run(span))
    return {k: {"min": min(v), "median": statistics.median(v)} for k, v in times.items()}


def measure(cell: cells.Cell, seed: int, n_calls: int, dev) -> dict:
    t = cell.traffic
    program = harness.default_program(cell, harness.make_weights(cell, seed, dev), dev)
    pool = inputs.make_pool(t, seed, dev)

    def call(i, syncs=None):
        return program.call(pool[i % t["pool"]], harness.sample_seeds(seed, i, t["pairs"]), syncs)

    for i in range(t["warmup"]):
        call(-1 - i)
    off, on, roots = [], [], []
    names: set = set()
    for i in range(n_calls):
        logged = i % 4 in (1, 2)   # off, on, on, off, ...
        log = SpanLog()
        c0 = time.perf_counter_ns()
        with log if logged else contextlib.nullcontext():
            call(i)
        c1 = time.perf_counter_ns()
        (on if logged else off).append((c1 - c0) / 1e6)
        if logged:
            roots.append(sum(s.end_ns - s.start_ns for s in log.roots()) / 1e6)
            names |= {s.name for s in log.roots()}
    with SpanLog(syncs=True) as log:
        for j in range(2):
            call(n_calls + j)
    by_span = {k: v / 2 for k, v in log.syncs_by_span().items()}
    counter = SyncCounter()
    if dev.type == "cuda":
        torch.cuda.set_sync_debug_mode("warn")
    try:
        for j in range(2):
            call(n_calls + 2 + j, counter)
    finally:
        if dev.type == "cuda":
            torch.cuda.set_sync_debug_mode(0)
    q = lambda v: [round(x, 4) for x in statistics.quantiles(v, n=4)]   # noqa: E731
    return {
        "workload": cell.name, "seed": seed, "calls_each": len(on),
        "host_ms_a_call_log_off": {"median": statistics.median(off), "quartiles": q(off)},
        "host_ms_a_call_log_on": {"median": statistics.median(on), "quartiles": q(on)},
        "root_spans": sorted(names),
        "root_span_host_ms_a_call": {"median": statistics.median(roots), "quartiles": q(roots),
                                     "min": min(roots), "max": max(roots)},
        "program_syncs_a_call": sum(by_span.values()),
        "program_syncs_a_call_by_span": by_span,
        "benchmark_syncs_a_call": counter.n / 2,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 77)
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--out", default="chiprun_out/spans.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_log.py needs a CUDA device", file=sys.stderr)
        return 2
    from roma_torch.kernels import runtime

    no_tf32()
    dev = torch.device("cuda")
    torch.cuda.init()
    runtime.build()
    res = {"device": torch.cuda.get_device_name(dev), "ns_a_range": ns_a_range(), "cells": []}
    print(json.dumps(res["ns_a_range"]), flush=True)
    for name in args.workload:
        res["cells"].append(measure(cells.load(name), args.seed, args.calls, dev))
        print(json.dumps(res["cells"][-1]), flush=True)
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
