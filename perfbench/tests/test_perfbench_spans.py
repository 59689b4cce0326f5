"""The KDE's reader, and the readers that were there before the program
opened its own spans (`roma.match`, `tiny.match`, `roma.sample`,
`roma.sample.kde`, `roma.dinov2.pos_embed`): they read the same values
with those spans open around their ops."""

import dataclasses

import pytest

from perfbench.core import cells, harness, trace
from perfbench.core.trace import DeviceOp
from perfbench_small import small
from test_perfbench_metrics import BENCH, reading, recorded


def with_program_spans():
    """The recorded profile as the program now traces it: the matcher's
    entry span around the call's model ops, `roma.dinov2.pos_embed` inside
    `roma.dinov2`, the sampler's spans inside `bench.sample`, and one more
    KDE op of 6 us."""
    p = recorded()

    def opened(op):
        r = op.ranges
        if "bench.sample" in r:
            return r + ("roma.sample", "roma.sample.kde")
        if "roma.dinov2" in r:
            return r[:1] + ("roma.match",) + r[1:] + ("roma.dinov2.pos_embed",)
        return r[:1] + ("roma.match",) + r[1:] if r else r

    ops = [dataclasses.replace(op, ranges=opened(op)) for op in p.device_ops]
    ops.append(DeviceOp("gumbel", 82, 84, ("bench.call", "bench.sample", "roma.sample")))
    ops.append(DeviceOp("kde2", 84, 90, ("bench.call", "bench.sample", "roma.sample",
                                         "roma.sample.kde")))
    host = p.host + [("roma.match", 1, 49, True), ("roma.sample", 56, 94, True),
                     ("roma.sample.kde", 57, 93, True)]
    return dataclasses.replace(p, device_ops=ops, host=host)


def test_the_kde_reader_reads_its_span_and_none_without_it():
    read = cells.reader("sampling.kde_device_ms")
    assert read(reading(profile=with_program_spans())) == pytest.approx((20 + 6) / 1e3 / 2)
    assert read(reading()) is None


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]
                                    if m["name"] != "sampling.kde_device_ms"])
def test_earlier_readers_read_the_same_with_the_program_spans_open(metric):
    """Only the two added ops (the Gumbel draw and a KDE op, both inside
    `bench.sample`) move what a reader reads, and only the readers that
    count every op in the window or in `bench.sample`."""
    before = cells.reader(metric)(reading())
    after = cells.reader(metric)(reading(profile=with_program_spans()))
    added = {"sampling.device_ms": 8 / 1e3 / 2,
             "device.idle_share": -100 * 8e-6 / 2 / 1.0}.get(metric, 0.0)
    if before is None:
        assert after is None
    else:
        assert after == pytest.approx(before + added)


def test_idle_gaps_inside_the_sampler_are_put_down_to_its_spans():
    gaps = trace.idle_gaps(with_program_spans())
    assert gaps == pytest.approx({"roma.refiner8: python": 5e-6,
                                  "roma.refiner8: aten::conv2d": 30e-6,
                                  "roma.sample.kde: python": 2e-6,
                                  "bench.sample: python": 10e-6})


def test_a_traced_small_run_reads_the_earlier_metrics_with_the_program_spans_on_its_path():
    """On the CPU no op reaches the device, so the KDE reader leaves its
    metric out; the line holds what it held before. The program opens its
    spans on the benchmark's path (a log around the run records them)."""
    from roma_torch.utils.profiling import SpanLog

    with SpanLog() as log:
        res = harness.run(small("tiny-b8-s5k"), 2 ** 31 + 11, 0.0, True, "cpu", 0.0)
    assert res["correct"] is True
    earlier = {m["name"] for m in BENCH["per_layer"]} - {"sampling.kde_device_ms"}
    assert set(res["metrics"]) <= earlier
    assert {s.name for s in log.spans} >= {"tiny.match", "roma.sample", "roma.sample.kde"}
