"""A traced stretch of calls reduced to plain records, and the arithmetic the
per-layer readers share.

`Profile` holds what the readers need and nothing of the profiler:
- `device_ops`: every operation that ran on the device (kernels, copies,
  fills) with its start and end (us), when the host launched it, whether
  the thread that made the calls launched it (autograd launches a
  backward from a device thread of its own), and the host ranges
  (record_function names) of the calls' thread open at its launch, so an
  op launched by another thread is put under the calls' ranges open then;
- `host`: the host events of the thread that made the calls (ranges, ops
  and runtime calls), for labelling idle gaps;
- `calls`: the start and end (us) of each profiled call (the `bench.call`
  ranges);
- `launches`: kernel launches the host made inside those calls, on any
  thread.
"""

from __future__ import annotations

import dataclasses
import re

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cudaGraphLaunch")
CALL_SPAN = "bench.call"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float
    end: float
    ranges: tuple = ()
    launch: float | None = None   # when the host launched it (us), where the trace says
    calls_thread: bool = True     # launched by the thread that made the calls


@dataclasses.dataclass
class Profile:
    device_ops: list
    host: list          # (name, start, end, is_range)
    calls: list         # (start, end)
    launches: int

    @property
    def window_us(self) -> float:
        return self.calls[-1][1] - self.calls[0][0] if self.calls else 0.0

    def in_window(self) -> list:
        if not self.calls:
            return []
        lo, hi = self.calls[0][0], self.calls[-1][1]
        return [op for op in self.device_ops if op.end > lo and op.start < hi]


def union_us(intervals, lo: float, hi: float) -> float:
    """Length of the union of (start, end) intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_us(p: Profile) -> float:
    if not p.calls:
        return 0.0
    return union_us([(op.start, op.end) for op in p.device_ops], p.calls[0][0], p.calls[-1][1])


def in_calls(p: Profile) -> list:
    """The device ops launched inside the profiled calls, by any thread."""
    return [op for op in p.device_ops if op.launch is not None
            and any(c0 <= op.launch <= c1 for c0, c1 in p.calls)]


def span_device_ms(p: Profile, pattern: str) -> float | None:
    """Device ms a call of the ops launched inside a host range whose name
    matches `pattern` (a regular expression matched whole); None where no
    such range launched anything."""
    rx = re.compile(pattern)
    ops = [op for op in p.in_window() if any(rx.fullmatch(r) for r in op.ranges)]
    if not ops or not p.calls:
        return None
    return sum(op.end - op.start for op in ops) / 1e3 / len(p.calls)


def idle_gaps(p: Profile) -> dict[str, float]:
    """Idle seconds of the device inside the profiled calls, summed by what
    the host was doing at each gap's middle: the innermost open range and
    the innermost op or runtime call, or "python" between ops."""
    if not p.calls:
        return {}
    lo, hi = p.calls[0][0], p.calls[-1][1]
    ops = sorted((max(op.start, lo), min(op.end, hi)) for op in p.in_window())
    gaps, t = [], lo
    for s, e in ops:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    # one thread's events nest, so a stack swept over the sorted midpoints
    # holds, innermost on top, the events open at each midpoint
    host = sorted(p.host, key=lambda h: (h[1], -h[2]))
    out: dict[str, float] = {}
    stack: list = []
    i = 0
    for s, e in gaps:
        mid = (s + e) / 2
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] < host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        rng = next((h[0] for h in reversed(stack) if h[3] and h[2] >= mid), "harness")
        op = next((h[0] for h in reversed(stack) if not h[3] and h[2] >= mid), "python")
        label = f"{rng}: {op}"
        out[label] = out.get(label, 0.0) + (e - s) / 1e6
    return out


def top_device_ops(p: Profile, n: int = 10) -> list:
    tot: dict[str, float] = {}
    for op in p.in_window():
        tot[op.name] = tot.get(op.name, 0.0) + (op.end - op.start) / 1e6
    return sorted(tot.items(), key=lambda kv: -kv[1])[:n]


def from_torch(prof) -> Profile:
    """Reduce a finished `torch.profiler.profile` to a `Profile`."""
    from torch.autograd import DeviceType

    events = list(prof.events())
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    calls = sorted((e.time_range.start, e.time_range.end) for e in cpu if e.name == CALL_SPAN)
    thread = next((e.thread for e in cpu if e.name == CALL_SPAN), None)
    mine = [e for e in cpu if e.thread == thread]
    ranges = [e for e in mine if getattr(e, "is_user_annotation", False)
              or e.name.startswith(("roma.", "tiny.", "bench.", "eval."))]
    range_ids = {id(e) for e in ranges}
    range_names = {e.name for e in ranges}
    launch_at = {e.id: (e.time_range.start, e.thread) for e in cpu
                 if e.name.startswith(("cuda", "cu"))}
    ops = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in range_names \
                or getattr(e, "is_user_annotation", False):
            continue
        t, by = launch_at.get(e.id, (None, None))
        opened = () if t is None else tuple(r.name for r in ranges
                                            if r.time_range.start <= t <= r.time_range.end)
        ops.append(DeviceOp(e.name, e.time_range.start, e.time_range.end, opened, t,
                            by is None or by == thread))
    lo, hi = (calls[0][0], calls[-1][1]) if calls else (0.0, 0.0)
    launches = sum(1 for e in cpu if e.name in LAUNCH_CALLS and lo <= e.time_range.start <= hi)
    host = [(e.name, e.time_range.start, e.time_range.end, id(e) in range_ids) for e in mine
            if e.time_range.end >= lo and e.time_range.start <= hi]
    return Profile(device_ops=ops, host=host, calls=calls, launches=launches)
