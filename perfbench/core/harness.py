"""One run of one cell: set-up, the timed window, the traced calls, the check,
and the result line.

A call runs in a closed loop with one call in flight over the pool of
input batches (call i takes batch i mod pool, its sampling generators
seeded from (seed, i, pair)); it ends with its outputs on the host, or
synchronized on the device where the cell samples nothing. The window
opens after set-up (kernels built or found, weights, inputs, warm-up
calls) and closes at the end of the first call that ends `seconds` after
it opened and after a call of every batch of the pool, so every call in it
is whole. A traffic file may set `in_flight` (default 1) for a cell whose
calls leave their outputs on the device: the host then dispatches up to
that many calls ahead of the one it waits for, and when the time is up it
sends nothing more, waits for all that was sent and reads the clock after
that wait, so the window holds all of that work and all of that time.

A configuration's module may bring its own inputs and check; where it
defines none of these hooks the cell runs as the matching cells do:
- `make_pool(traffic, seed, device)`: the pool of batches, in place of
  `inputs.make_pool`;
- `judge(cell, seed, device, pool, observed, count_flops)`, run after the
  program is released, returns the numbers for `check.verdict` and one
  call's FLOPs (or None), in place of `compare`; `observed` is what the
  program's `observed()` returned while it was still alive (after the
  window and the traced calls): host data only.
"""

from __future__ import annotations

import collections
import gc
import statistics
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core import check, inputs, trace, weights
from perfbench.core.cells import Cell, metric, rooflines
from perfbench.core.program import SyncCounter, reference_on, synchronize
from perfbench.core.reading import Reading
from perfbench.core.seeds import derive
from perfbench.reference.common import Precision, no_tf32

BANNED = ("jax", "jaxlib", "flax", "roma_tpu")


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is banned."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def default_program(cell: Cell, state: dict, device):
    return cell.cfgmod.Program(cell.cfg, cell.traffic, state, device)


def _meta_reference(cell: Cell):
    with torch.device("meta"):
        return cell.cfgmod.reference_model(cell.cfg)


def make_weights(cell: Cell, seed: int, device) -> dict:
    """The cell's weights from the seed (`weights.make`), then shaped where
    the configuration's module says how (`shape_weights`)."""
    state = weights.make(_meta_reference(cell), seed, device)
    if hasattr(cell.cfgmod, "shape_weights"):
        cell.cfgmod.shape_weights(state, cell.cfg)
    return state


def sample_seeds(seed: int, i: int, pairs: int) -> list[int]:
    """The sampling generators' seeds of call i's pairs."""
    return [derive(seed, "sample", i, p) for p in range(pairs)]


def window(call, seconds: float, pool_n: int, checked: list[int], in_flight: int = 1,
           device=None):
    """The timed closed loop: each call's seconds (with calls in flight, the
    host's seconds to dispatch it), the window's seconds, and the last
    outputs of each checked batch with its call's index. What set-up made
    is kept out of the collector's sweeps meanwhile."""
    gc.collect()
    gc.freeze()
    times, kept, fences = [], {}, collections.deque()
    i, start = 0, time.perf_counter()
    while True:
        c0 = time.perf_counter()
        out = call(i)
        if in_flight > 1:
            fences.append(fence(device))
            if len(fences) > in_flight:
                fences.popleft().synchronize()
        c1 = time.perf_counter()
        times.append(c1 - c0)
        if i % pool_n in checked:
            kept[i % pool_n] = (i, out)
        del out
        i += 1
        if c1 - start >= seconds and len(times) >= max(2, pool_n):
            break
    if in_flight > 1:
        synchronize(device)
        c1 = time.perf_counter()
    gc.unfreeze()
    return times, c1 - start, kept


class _Done:
    def synchronize(self) -> None:
        pass


def fence(device):
    """An event recorded after the work sent so far (a no-op off the card)."""
    if torch.device(device).type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev


def traced_calls(call, first: int, k: int, dev) -> tuple[trace.Profile, float | None]:
    """k profiled calls after one warm-up step of the profiler, then host
    syncs a call over two calls under sync debug mode "warn" (on the card)."""
    cuda = dev.type == "cuda"
    if cuda:
        from roma_torch.kernels import LAUNCHES, reset_launches

        reset_launches()
    with profile(activities=[ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else []),
                 schedule=schedule(wait=0, warmup=1, active=k, repeat=1)) as p:
        for j in range(k + 1):
            call(first + j)
            synchronize(dev)
            p.step()
    if not cuda:
        return trace.from_torch(p), None
    print(f"hand-written kernel launches a call (roma_torch LAUNCHES, {k + 1} calls): "
          + ", ".join(f"{n} {v / (k + 1):g}" for n, v in LAUNCHES.items() if v), flush=True)
    counter = SyncCounter()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for j in range(2):
            call(first + k + 1 + j, counter)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return trace.from_torch(p), counter.n / 2


def compare(cell: Cell, seed: int, dev, pool, kept: dict, count_flops: bool):
    """The check's numbers of every kept call, against the reference built
    from the same seed in float32 and with bfloat16 operands; and one call's
    FLOPs (FlopCounterMode over the float32 reference) if asked."""
    ref = reference_on(cell.cfgmod, cell.cfg, make_weights(cell, seed, dev), dev)
    t = cell.traffic
    numbers, flops = [], None

    def reference(b: int, mode: str):
        return cell.cfgmod.reference_dense(ref, Precision(mode), pool[b], dev, cell.cfg)

    for b, (i, out) in sorted(kept.items()):
        if count_flops and flops is None:
            with FlopCounterMode(display=False) as fc:
                r32 = reference(b, "float32")
            flops = float(fc.get_total_flops())
        else:
            r32 = reference(b, "float32")
        numbers += check.judge(out, r32, reference(b, "bfloat16"),
                               sample_seeds(seed, i, t["pairs"]), t["num"],
                               cell.cfg["sample_thresh"])
    return numbers, flops


def run(cell: Cell, seed: int, seconds: float, traced: bool, device, t_start: float,
        make_program=default_program) -> dict:
    """The result line's object; `make_program(cell, state, device)` builds
    what the window drives (the port, or in tests a stand-in)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    no_tf32()
    phases = {"start": time.time() - t_start}
    if cuda:
        from roma_torch.kernels import runtime

        torch.cuda.init()
        phases["cuda"] = time.time() - t_start
        runtime.build()
        phases["kernels"] = time.time() - t_start
    t = cell.traffic
    state = make_weights(cell, seed, dev)
    synchronize(dev)
    phases["weights"] = time.time() - t_start
    program = make_program(cell, state, dev)
    del state
    phases["program"] = time.time() - t_start
    pool = getattr(cell.cfgmod, "make_pool", inputs.make_pool)(t, seed, dev)
    phases["inputs"] = time.time() - t_start

    def call(i: int, syncs=None):
        with record_function("bench.call"):
            return program.call(pool[i % t["pool"]], sample_seeds(seed, i, t["pairs"]), syncs)

    for i in range(t["warmup"]):
        call(-1 - i)
        phases[f"warmup{i}"] = time.time() - t_start
    print("set-up, seconds since the process started: "
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()), file=sys.stderr, flush=True)
    order = torch.randperm(t["pool"], generator=torch.Generator().manual_seed(derive(seed, "checked")))
    checked = sorted(int(b) for b in order[:t.get("checked", 0)])

    t_open = time.time()
    times, window_s, kept = window(call, seconds, t["pool"], checked, t.get("in_flight", 1), dev)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    prof = syncs_per_call = None
    if traced:
        prof, syncs_per_call = traced_calls(call, len(times), t["profiled_calls"], dev)
    judge = getattr(cell.cfgmod, "judge", None)
    observed = program.observed() if judge else None
    del program, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if judge:
        numbers, flops = judge(cell, seed, dev, pool, observed, traced)
    else:
        numbers, flops = compare(cell, seed, dev, pool, kept, traced)
    correct, checks = check.verdict(numbers, cell.limits)

    result = {"correct": correct, "attempted": t["pairs"] * len(times), "failed": 0}
    if traced:
        reading = Reading(profile=prof, cfg=cell.cfg, traffic=t, syncs_per_call=syncs_per_call,
                          flops_per_call=flops, untraced_s_per_call=window_s / len(times),
                          rooflines=rooflines())
        if prof.calls:
            traced_ms = prof.window_us / 1e3 / len(prof.calls)
            print(f"a call: traced {traced_ms:.4f} ms (wall of the profiled calls), untraced "
                  f"{1e3 * window_s / len(times):.4f} ms (the window), ratio "
                  f"{traced_ms / (1e3 * window_s / len(times)):.4f}", flush=True)
        mods = {m["name"]: metric(m["name"]) for m in cell.per_layer}
        for mod in mods.values():
            if hasattr(mod, "note"):
                print(mod.note(reading), flush=True)
        values = {name: mod.read(reading) for name, mod in mods.items()}
    else:
        values = {"pairs_per_s": t["pairs"] * len(times) / window_s,
                  "call_p95_ms": 1e3 * statistics.quantiles(times, n=20, method="inclusive")[-1],
                  "peak_mem_gb": peak / 1e9,
                  "setup_s": t_open - t_start}
        values = {m["name"]: values[m["name"]] for m in cell.end_to_end}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in values.items()
                         if v is not None}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                        "count": 1, "memory_peak_bytes": int(peak)}
    if traced:
        result["device"]["busy_s"] = trace.busy_us(prof) / 1e6
        result["device"]["window_s"] = prof.window_us / 1e6
        gaps = sorted(trace.idle_gaps(prof).items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [list(x) for x in trace.top_device_ops(prof)],
                               "idle_gaps": [list(x) for x in gaps]}
    result["checks"] = checks
    return result
