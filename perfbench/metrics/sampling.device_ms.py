"""Device ms a call of the balanced sampling (`utils/sampling.py`,
`utils/kde.py`), inside the benchmark's own `bench.sample` span."""

from perfbench.core.trace import span_device_ms


def read(r):
    return span_device_ms(r.profile, r"bench\.sample")
