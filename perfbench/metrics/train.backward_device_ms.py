"""Device ms a step of the backward pass: the ops that autograd's device
thread launched inside the profiled steps (`loss.backward()`: every
gradient, the activation checkpoints' recompute, K8 and K9). The forward
and the optimizer are launched by the thread that makes the calls."""

from perfbench.core.trace import in_calls


def read(r):
    p = r.profile
    ops = [op for op in in_calls(p) if not op.calls_thread]
    return sum(op.end - op.start for op in ops) / 1e3 / len(p.calls) if ops else None
