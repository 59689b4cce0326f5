"""What a per-layer reader is handed: the traced calls, the counters and
the cell's shapes. A reader (`perfbench/metrics/<name>.py`) defines
`read(r: Reading) -> float | None` and returns None where it finds
nothing to read; the harness then leaves the metric out of the line."""

from __future__ import annotations

import dataclasses

from perfbench.core.trace import Profile


@dataclasses.dataclass
class Reading:
    profile: Profile
    cfg: dict                      # the configuration file
    traffic: dict                  # the traffic file
    syncs_per_call: float | None   # sync debug mode "warn" reports inside the program's entries
    flops_per_call: float | None   # FlopCounterMode over the reference, one call's work
    untraced_s_per_call: float     # the window's seconds over its calls, tracing off
    rooflines: dict                # role name -> module of perfbench/rooflines/
