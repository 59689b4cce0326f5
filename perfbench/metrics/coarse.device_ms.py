"""Device ms a call of the coarse match: the GP and the transformer match
decoder (`roma.gp`, `roma.match_decoder`) or Tiny's global correlation
(`tiny.coarse_warp`)."""

from perfbench.core.trace import span_device_ms


def read(r):
    return span_device_ms(r.profile, r"roma\.gp|roma\.match_decoder|tiny\.coarse_warp")
