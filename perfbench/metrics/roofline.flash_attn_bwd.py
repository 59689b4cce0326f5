"""Share (%) of its roofline the attention backward reaches in the profiled
steps: the least time of one step's K8 (dK, dV) and K9 (dQ) launches at the
cell's shapes (`perfbench/rooflines/K8_flash_attn_bwd.py`) times the
steps, over the device time of those kernels. None where the profile
holds none of them."""

import re

from perfbench.core.peaks import bound_ms

ROLE = "K8_flash_attn_bwd"


def read(r):
    mod = r.rooflines.get(ROLE)
    if mod is None:
        return None
    work = mod.launches(r.cfg, r.traffic)
    rx = re.compile(mod.KERNELS)
    ms = sum(op.end - op.start for op in r.profile.in_window() if rx.search(op.name)) / 1e3
    if not work or not ms:
        return None
    return 100.0 * len(r.profile.calls) * sum(bound_ms(*w) for w in work) / ms
