"""Kernel launches a call: the CUDA runtime's launch calls the host made
inside the profiled calls, over their number."""


def read(r):
    p = r.profile
    return p.launches / len(p.calls) if p.calls and p.launches else None
