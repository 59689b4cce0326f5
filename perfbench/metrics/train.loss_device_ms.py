"""Device ms a step of the training loss: the ops launched inside the
benchmark's `bench.loss` range around the program's loss function
(`losses/robust_loss.py`: the ground-truth warps, the anchors' labels, the
log-softmax over the scale-16 anchors, the BCEs and the regressions)."""

from perfbench.core.trace import span_device_ms


def read(r):
    return span_device_ms(r.profile, r"bench\.loss")
