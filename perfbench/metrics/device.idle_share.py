"""Share (%) of a call's time in which no operation ran on the device: 1 -
the union of the device's operation intervals in the profiled calls, a
call, over the untraced window's seconds a call. The profiler slows the
host's side of a traced call, so the traced calls' own wall time would
count its overhead as idle; the device's busy time is what tracing leaves
as it is. Busy time above the untraced call reads below 0, as measured."""

from perfbench.core.trace import busy_us


def read(r):
    p = r.profile
    if not p.calls or not r.untraced_s_per_call:
        return None
    busy = busy_us(p) / 1e6 / len(p.calls)
    return 100.0 * (1.0 - busy / r.untraced_s_per_call) if busy else None
