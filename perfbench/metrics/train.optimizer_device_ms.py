"""Device ms a step of the update: the ops that the thread making the calls
launched after the step's loss (`bench.loss`) had returned, outside the
read-back of the metrics (`bench.readback`): the global norm and the clip,
AdamW's update, and the backward's seed gradient (one fill)."""

from perfbench.core.trace import in_calls


def read(r):
    p = r.profile
    ends = [max((e for n, s, e, _ in p.host if n == "bench.loss" and c0 <= s <= c1), default=None)
            for c0, c1 in p.calls]
    total = 0.0
    for op in in_calls(p):
        if not op.calls_thread or "bench.readback" in op.ranges:
            continue
        end = next(e for (c0, c1), e in zip(p.calls, ends) if c0 <= op.launch <= c1)
        if end is not None and op.launch > end:
            total += op.end - op.start
    return total / 1e3 / len(p.calls) if total else None
