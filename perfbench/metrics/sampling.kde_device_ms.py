"""Device ms a call of the KDE inside the balanced sampling: the ops launched
inside the program's `roma.sample.kde` span (`utils/kde.py`), a part of
`sampling.device_ms`. None where the program opens no such span."""

from perfbench.core.trace import span_device_ms


def read(r):
    return span_device_ms(r.profile, r"roma\.sample\.kde")
