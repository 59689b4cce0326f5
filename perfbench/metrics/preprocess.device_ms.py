"""Device ms a call of the device resize (`roma.preprocess`, `ops/resize.py`)."""

from perfbench.core.trace import span_device_ms


def read(r):
    return span_device_ms(r.profile, r"roma\.preprocess")
