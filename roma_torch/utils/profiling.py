"""Profiling and roofline accounting, the counterpart of the JAX package's
``utils/profiling.py``: a trace context around `torch.profiler`, a timer
that waits for the device (CUDA events and a synchronize on the card, the
host clock on the CPU), and a roofline report that pairs the time with the
work one call does, counted by the dispatcher: FLOPs by
`torch.utils.flop_counter.FlopCounterMode` (the kernels' ``roma::``
operators through their FLOP formulas) and bytes by `BytesCounter`, the
analogue of XLA's "bytes accessed", against the H100 SXM's peaks.

`span` is how the port opens a named range, and `SpanLog` keeps the spans
of one thread in memory, with the host syncs inside each: per-span host
time without the profiler's slowdown.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import warnings

import torch
from torch.profiler import record_function
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# NVIDIA H100 SXM (the data sheet's dense rates, at its 700 W limit)
PEAK_BF16_FLOPS = 989e12   # tensor cores, bf16
PEAK_BYTES = 3.35e12       # HBM3 bytes a second
PEAK_EXPS = 3.9e12         # exponentials a second on the special-function units
                           # (the FlashAttention-3 paper's figure)


# thread id -> the SpanLog active on that thread; empty unless one is
_LOGS: dict[int, SpanLog] = {}


class span(record_function):
    """``with span(name):`` opens `torch.profiler.record_function(name)`
    (what the profiler and its readers see), and where a `SpanLog` is
    active on the calling thread also logs the span: its interval on the
    host clock the profiler uses (CLOCK_REALTIME, read before the range
    opens and after it closes, so the logged interval holds the
    profiler's). With no log the only cost beyond the range is one check
    of `_LOGS`."""

    _logged: int | None = None   # the span's index in the active log while open

    def __enter__(self):
        if _LOGS:
            log = _LOGS.get(threading.get_ident())
            if log is not None:
                self._log, self._logged = log, log._open(self.name)
        return record_function.__enter__(self)

    def __exit__(self, exc_type, exc_value, traceback):
        record_function.__exit__(self, exc_type, exc_value, traceback)
        if self._logged is not None:
            self._log._close(self._logged)
            self._log = self._logged = None


@dataclasses.dataclass
class Span:
    request: int          # spans opened while another logged span is open share its request
    name: str
    parent: int | None    # index of the enclosing span in `SpanLog.spans`; None for a root
    start_ns: int         # time.time_ns(), the clock of a profiled event's
                          # trace_start_ns() + time_range
    end_ns: int = 0
    syncs: int = 0        # synchronizing calls reported while this was the innermost open span


class SpanLog:
    """Within ``with SpanLog():``, every `span` the entering thread opens is
    appended to `spans`, in the order opened; spans of other threads are
    not logged. A span opened with no logged span open starts a new
    request. With ``syncs=True`` (where CUDA is initialised) sync debug
    mode is "warn" inside, the previous mode restored on exit, and each
    warning of a synchronizing call is counted on the innermost logged span
    open when it fires, not shown. The log writes nothing out."""

    def __init__(self, syncs: bool = False):
        self.syncs = syncs
        self.spans: list[Span] = []
        self._stack: list[int] = []
        self._requests = 0

    def _open(self, name: str) -> int:
        t = time.time_ns()
        if self._stack:
            parent = self._stack[-1]
            request = self.spans[parent].request
        else:
            parent, request = None, self._requests
            self._requests += 1
        self.spans.append(Span(request, name, parent, t))
        self._stack.append(len(self.spans) - 1)
        return self._stack[-1]

    def _close(self, i: int) -> None:
        self.spans[i].end_ns = time.time_ns()
        self._stack.pop()

    def _show(self, message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message) and threading.get_ident() == self._thread:
            if self._stack:
                self.spans[self._stack[-1]].syncs += 1
            return
        self._shown(message, category, filename, lineno, file, line)

    def roots(self) -> list[Span]:
        return [s for s in self.spans if s.parent is None]

    def syncs_by_span(self) -> dict[str, int]:
        """Syncs counted on each span name, innermost span only."""
        out: dict[str, int] = {}
        for s in self.spans:
            if s.syncs:
                out[s.name] = out.get(s.name, 0) + s.syncs
        return out

    def __enter__(self):
        self._thread = threading.get_ident()
        self._outer = _LOGS.get(self._thread)
        _LOGS[self._thread] = self
        self._mode = None
        if self.syncs:
            self._warnings = warnings.catch_warnings()
            self._warnings.__enter__()
            warnings.filterwarnings("always", message=".*synchroniz")
            self._shown, warnings.showwarning = warnings.showwarning, self._show
            if torch.cuda.is_initialized():
                self._mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if self._mode is not None:
            torch.cuda.set_sync_debug_mode(self._mode)
        if self.syncs:
            self._warnings.__exit__(*exc)
        if self._outer is None:
            del _LOGS[self._thread]
        else:
            _LOGS[self._thread] = self._outer


def enable_compilation_cache(path: str | None = None) -> dict[str, str]:
    """Build every kernel ahead (`runtime.build`, one ``nvcc`` a source, all
    at once) into `path` (default: ``build/kernels/`` at the repo root),
    where later processes find them. The port's startup cost is ``nvcc``,
    not XLA's compiler: a kernel is built at its first launch otherwise,
    inside whatever that first call is timing. Returns the compiler's
    report for each source it built."""
    from pathlib import Path

    from roma_torch.kernels import runtime

    if path is not None:
        runtime.BUILD_DIR = Path(path)
    return runtime.build()


@contextlib.contextmanager
def trace(log_dir: str):
    """A `torch.profiler` trace of the block, host and (where there is a
    card) device activity, written to ``log_dir/trace.json`` as a Chrome
    trace (chrome://tracing, Perfetto). Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _on_cuda(tree) -> bool:
    return any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(tree))


def timed(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Best seconds a call of ``fn(*args)``. Where the warm-up's output or
    the arguments are on the card, each call is timed by CUDA events and
    waited for; else by the host clock (a CPU call has finished when it
    returns)."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    if _on_cuda((out, args)):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(iters):
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


class BytesCounter(TorchDispatchMode):
    """Within, `bytes` sums the bytes of every operator's tensor inputs and
    outputs, each read or written once, as the dispatcher sees the
    operators (a ``roma::`` kernel as one; views and allocations move
    nothing and are not counted): what the program would move if nothing
    stayed on chip between operators, as XLA's "bytes accessed" counts
    its operations."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.namespace == "profiler"
                or func.overloadpacket in _ALLOCATIONS):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in tree_leaves((args, kwargs, out))
                              if isinstance(t, torch.Tensor))
        return out


# operators that only allocate: they read and write nothing
_ALLOCATIONS = {torch.ops.aten.empty, torch.ops.aten.empty_like, torch.ops.aten.empty_strided}


def count(fn, *args) -> tuple[float, float]:
    """(FLOPs, bytes) of one call of ``fn(*args)``: `FlopCounterMode`'s
    total and `BytesCounter`'s."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as flops, BytesCounter() as nbytes:
        fn(*args)
    return float(flops.get_total_flops()), float(nbytes.bytes)


@dataclasses.dataclass
class Roofline:
    seconds: float
    flops: float | None
    bytes_accessed: float | None

    @property
    def achieved_tflops(self) -> float | None:
        return None if self.flops is None else self.flops / self.seconds / 1e12

    @property
    def tensor_core_utilization(self) -> float | None:
        """The achieved rate over the bf16 tensor-core peak (the JAX
        package's `mxu_utilization`, with the H100's tensor cores for the
        TPU's matrix unit)."""
        t = self.achieved_tflops
        return None if t is None else t * 1e12 / PEAK_BF16_FLOPS

    @property
    def hbm_utilization(self) -> float | None:
        if self.bytes_accessed is None:
            return None
        return self.bytes_accessed / self.seconds / PEAK_BYTES

    def report(self) -> str:
        parts = [f"{self.seconds * 1e3:.2f} ms"]
        if self.achieved_tflops is not None:
            parts.append(f"{self.achieved_tflops:.1f} TFLOP/s"
                         f" ({100 * self.tensor_core_utilization:.1f}% tensor cores)")
        if self.hbm_utilization is not None:
            parts.append(f"{100 * self.hbm_utilization:.1f}% HBM")
        return " | ".join(parts)


def roofline(fn, *args, iters: int = 5) -> Roofline:
    """Time ``fn(*args)`` (`timed`) and pair it with the work one call does
    (`count`)."""
    seconds = timed(fn, *args, iters=iters)
    flops, nbytes = count(fn, *args)
    return Roofline(seconds, flops, nbytes)
