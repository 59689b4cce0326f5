"""The port's span helper and in-memory span log (`utils/profiling.py`):
`span` always opens a `torch.profiler` range, and a `SpanLog` active on
the thread records each span's request, parent, interval on the
profiler's clock and the host syncs inside it. Then the spans the
matchers and the sampler open, on the CPU."""

import dataclasses
import pathlib
import re
import threading
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from roma_torch.config import TinyRomaConfig
from roma_torch.models.zoo import debug_roma_config, roma_outdoor, tiny_roma_v1_outdoor
from roma_torch.utils import profiling
from roma_torch.utils.profiling import SpanLog, span

REPO = pathlib.Path(__file__).resolve().parents[1]
SYNC = "called a synchronizing CUDA operation"


def _tree(log: SpanLog) -> list[tuple]:
    """(request, name, parent's name) of every logged span, in order."""
    return [(s.request, s.name, None if s.parent is None else log.spans[s.parent].name)
            for s in log.spans]


def test_without_a_log_a_span_appends_nothing_and_the_profiler_sees_it():
    idle = SpanLog()   # made, never entered
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("t.off"):
            torch.ones(4).sum()
    assert idle.spans == [] and profiling._LOGS == {}
    assert "t.off" in {e.name for e in prof.events()}


def test_parents_and_requests_for_nested_spans_and_two_calls():
    def call():
        with span("t.call"):
            with span("t.a"):
                with span("t.b"):
                    pass
            with span("t.c"):
                pass

    with SpanLog() as log:
        call()
        call()
    assert _tree(log) == [(r, n, p) for r in (0, 1) for n, p in
                          [("t.call", None), ("t.a", "t.call"), ("t.b", "t.a"), ("t.c", "t.call")]]
    assert [s.parent for s in log.spans] == [None, 0, 1, 0, None, 4, 5, 4]
    assert [s.name for s in log.roots()] == ["t.call", "t.call"]
    for s in log.spans:
        assert 0 < s.start_ns <= s.end_ns
        if s.parent is not None:
            outer = log.spans[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns
    assert profiling._LOGS == {}


def test_a_nested_log_restores_the_outer_one_and_an_exception_closes_the_span():
    with SpanLog() as outer:
        with SpanLog() as inner:
            with pytest.raises(ValueError):
                with span("t.raises"):
                    raise ValueError
        with span("t.after"):
            pass
    assert [s.name for s in inner.spans] == ["t.raises"] and inner.spans[0].end_ns > 0
    assert [s.name for s in outer.spans] == ["t.after"] and outer.spans[0].request == 0
    assert profiling._LOGS == {}


def test_spans_of_other_threads_are_not_logged():
    def other():
        with span("t.other"):
            pass

    with SpanLog() as log:
        with span("t.mine"):
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
    assert not t.is_alive()
    assert [s.name for s in log.spans] == ["t.mine"]


def test_a_logged_interval_encloses_the_profilers_event_on_the_same_clock():
    """Absolute profiler time: trace_start_ns() + time_range (us); the log
    reads the clock before the range opens and after it closes."""
    x = torch.randn(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof, SpanLog() as log:
        for _ in range(2):
            with span("t.outer"):
                y = x @ x
                with span("t.inner"):
                    y @ x
    t0 = prof.profiler.kineto_results.trace_start_ns()
    events = sorted((e for e in prof.events() if e.name.startswith("t.")),
                    key=lambda e: e.time_range.start)
    logged = sorted(log.spans, key=lambda s: s.start_ns)
    assert [e.name for e in events] == [s.name for s in logged]
    for s, e in zip(logged, events):
        early = t0 + 1e3 * e.time_range.start - s.start_ns
        late = s.end_ns - (t0 + 1e3 * e.time_range.end)
        assert -1e3 < early < 2e6 and -1e3 < late < 2e6, (s.name, early, late)


def test_sync_warnings_are_counted_on_the_innermost_span():
    """The CPU has no sync debug mode: the warnings are raised by hand.
    Other warnings pass through; a sync outside every span counts nowhere."""
    with SpanLog(syncs=True) as log:
        warnings.warn(SYNC)
        with span("t.call"):
            with span("t.a"):
                warnings.warn(SYNC)
                warnings.warn(SYNC)
            warnings.warn(SYNC)
            with span("t.b"):
                with pytest.warns(UserWarning, match="unrelated"):
                    warnings.warn("unrelated")
            with span("t.a"):
                warnings.warn(SYNC)
    assert [s.syncs for s in log.spans] == [1, 2, 0, 1]
    assert log.syncs_by_span() == {"t.call": 1, "t.a": 3}
    with SpanLog() as plain, span("t.call"), pytest.warns(UserWarning, match="synchronizing"):
        warnings.warn(SYNC)   # counted only with syncs=True
    assert plain.spans[0].syncs == 0


def test_syncs_true_sets_warn_and_restores_the_previous_sync_debug_mode(monkeypatch):
    set_to = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", set_to.append)
    with SpanLog(syncs=True):
        assert set_to == ["warn"]
    assert set_to == ["warn", 2]
    with SpanLog():
        pass
    assert set_to == ["warn", 2]


def test_tiny_match_and_sample_open_their_spans_in_order():
    m = tiny_roma_v1_outdoor(device="cpu", cfg=TinyRomaConfig(match_dim=32, fine_match_dim=16,
                                                              dtype="float32"))
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.uniform(0, 1, (64, 96, 3)).astype(np.float32)) for _ in "ab")
    with SpanLog() as log:
        warp, cert = m.match(a, b)
        m.sample(warp, cert, num=50, generator=torch.Generator().manual_seed(0))
    assert _tree(log) == [(0, "tiny.match", None), (0, "tiny.xfeat", "tiny.match"),
                          (0, "tiny.coarse_warp", "tiny.match"),
                          (0, "tiny.coarse_matcher", "tiny.match"),
                          (0, "tiny.fine_matcher", "tiny.match"),
                          (0, "tiny.postprocess", "tiny.match"),
                          (1, "roma.sample", None), (1, "roma.sample.kde", "roma.sample")]


def test_roma_match_raw_and_sample_batched_open_their_spans():
    m = roma_outdoor(cfg=dataclasses.replace(debug_roma_config(), dtype="float32"), device="cpu")
    rng = np.random.default_rng(0)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 120, 160, 3), dtype=np.uint8))
    banks = m.build_resize_banks([(120, 160)], (120, 160))
    with SpanLog() as log:
        warp, cert = m.match_raw(raw, torch.zeros(2, dtype=torch.long), banks)
        m.sample_batched(warp, cert, 50, [torch.Generator().manual_seed(0)])
    tree = _tree(log)
    assert [t for t in tree if t[2] is None] == [
        (0, "roma.match", None), (1, "roma.sample", None)]
    assert (0, "roma.dinov2.pos_embed", "roma.dinov2") in tree
    assert (0, "roma.preprocess", "roma.match") in tree
    assert (1, "roma.sample.kde", "roma.sample") in tree
    assert sum(t[1] == "roma.dinov2.pos_embed" for t in tree) == 1   # the coarse pass only


def test_every_range_of_the_port_opens_through_span():
    """`record_function` appears in `utils/profiling.py` alone."""
    for path in sorted((REPO / "roma_torch").rglob("*.py")):
        if path.name == "profiling.py" and path.parent.name == "utils":
            continue
        assert not re.search(r"\brecord_function\b", path.read_text()), path
