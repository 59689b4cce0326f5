"""Share (%) of their rooflines the hand-written kernels reach in the
profiled calls: the sum over the kernel roles named in ROLES of the least
time of one call's launches at the cell's shapes
(`perfbench/rooflines/<role>.py`) times the calls, over the sum of those
roles' device time. A role whose kernels the profile lacks, or that has no
launch at these shapes, counts neither. A roofline file added later is
not summed here: it gets a metric of its own."""

import re

from perfbench.core.peaks import bound_ms

ROLES = ("K1_local_corr", "K2_dw_chain", "K3_flash_attn", "K4_dw_affine_relu", "K7_corr_softmax")


def _device_ms(r) -> dict:
    """Device ms of each role with launches at the cell's shapes."""
    out = {}
    for name in ROLES:
        mod = r.rooflines.get(name)
        if mod is None or not mod.launches(r.cfg, r.traffic):
            continue
        rx = re.compile(mod.KERNELS)
        ms = sum(op.end - op.start for op in r.profile.in_window() if rx.search(op.name)) / 1e3
        if ms:
            out[name] = ms
    return out


def note(r) -> str:
    return "roofline roles found in the profile: " + (", ".join(_device_ms(r)) or "none")


def read(r):
    found = _device_ms(r)
    bound = sum(len(r.profile.calls) * sum(bound_ms(*w) for w in r.rooflines[n].launches(r.cfg, r.traffic))
                for n in found)
    device = sum(found.values())
    return 100.0 * bound / device if device else None
