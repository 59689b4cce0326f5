"""The whole call's share (%) of the bf16 tensor-core peak: one call's
FLOPs, counted by FlopCounterMode over the benchmark's reference at the
cell's shapes, over the untraced window's seconds a call."""

from perfbench.core.peaks import BF16_FLOPS


def read(r):
    if not r.flops_per_call or not r.untraced_s_per_call:
        return None
    return 100.0 * r.flops_per_call / r.untraced_s_per_call / BF16_FLOPS
