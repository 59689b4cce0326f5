"""The per-layer readers on a small recorded profile, and the result line."""

import json
import re
import types
from pathlib import Path

import pytest

from perfbench.core import cells, harness, trace
from perfbench.core.reading import Reading
from perfbench.core.trace import DeviceOp, Profile
from perfbench_small import small

BENCH = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())


def recorded() -> Profile:
    """Two calls of 50 us each; device ops overlap once, one op runs before
    the first call (left out), one range launches nothing."""
    ops = [DeviceOp("void (anonymous namespace)::flash_fwd_kernel<64>(x)", 0, 10,
                    ("bench.call", "roma.coarse_pass", "roma.dinov2")),
           DeviceOp("gemm", 5, 15, ("bench.call", "roma.coarse_pass", "roma.dinov2")),
           DeviceOp("void (anonymous namespace)::pixel_kernel<4, false>(y)", 20, 30,
                    ("bench.call", "roma.refiner8")),
           DeviceOp("kde", 60, 80, ("bench.call", "bench.sample")),
           DeviceOp("early", -20, -10, ())]
    host = [("bench.call", 0, 50, True), ("roma.refiner8", 16, 48, True),
            ("aten::conv2d", 31, 47, False), ("bench.call", 50, 100, True),
            ("bench.sample", 55, 95, True)]
    return Profile(device_ops=ops, host=host, calls=[(0, 50), (50, 100)], launches=7)


def reading(**kw) -> Reading:
    base = dict(profile=recorded(), cfg={}, traffic={}, syncs_per_call=3.0, flops_per_call=None,
                untraced_s_per_call=1.0, rooflines={})
    return Reading(**{**base, **kw})


@pytest.mark.parametrize("metric,want", [
    ("encoders.device_ms", (10 + 10) / 1e3 / 2),      # overlap counted per op
    ("refine.device_ms", 10 / 1e3 / 2),
    ("sampling.device_ms", 20 / 1e3 / 2),
    ("api.launches_per_call", 3.5),
    ("api.host_syncs_per_call", 3.0),
])
def test_readers_on_a_recorded_profile(metric, want):
    assert cells.reader(metric)(reading()) == pytest.approx(want)


@pytest.mark.parametrize("untraced_us,want", [
    (50, 100 * (1 - 22.5 / 50)),     # union 0-15, 20-30, 60-80: 45 us over 2 calls
    (30, 100 * (1 - 22.5 / 30)),     # untraced calls faster than the traced ones
    (20, 100 * (1 - 22.5 / 20)),     # busier than the untraced call: below 0, as measured
])
def test_idle_share_divides_by_the_untraced_call(untraced_us, want):
    r = reading(untraced_s_per_call=untraced_us * 1e-6)
    assert cells.reader("device.idle_share")(r) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["preprocess.device_ms", "coarse.device_ms", "match_mfu",
                                    "kernels.roofline_share"])
def test_a_reader_with_nothing_to_read_returns_none(metric):
    assert cells.reader(metric)(reading()) is None


def test_roofline_share_leaves_out_absent_roles_and_roles_it_does_not_name():
    def role(regex, work):
        return types.SimpleNamespace(KERNELS=regex, launches=lambda cfg, t: work)

    roles = {"K3_flash_attn": role(r"flash_fwd_kernel", [(0.0, 989e12 * 1e-6, 0.0)]),  # 0.001 ms
             "K1_local_corr": role(r"pixel_kernel", []),                    # no launch here
             "K7_corr_softmax": role(r"absent_kernel", [(3.35e12, 0.0, 0.0)]),  # not in the profile
             "K99_added_later": role(r"^kde$", [(3.35e12, 0.0, 0.0)])}     # in it, but not named
    mod = cells.metric("kernels.roofline_share")
    r = reading(rooflines=roles)
    assert mod.read(r) == pytest.approx(100 * 2 * 0.001 / 0.010)
    assert mod.note(r) == "roofline roles found in the profile: K3_flash_attn"
    # every role file but the attention backward's, which has a metric of its own
    assert set(mod.ROLES) == set(cells.rooflines()) - {"K8_flash_attn_bwd"}


def test_match_mfu_arithmetic():
    r = reading(flops_per_call=989e12 * 0.25, untraced_s_per_call=0.5)
    assert cells.reader("match_mfu")(r) == pytest.approx(50.0)


def test_idle_gaps_are_labelled_by_the_host():
    # busy 0-15, 20-30, 60-80 of 0-100: gaps 15-20, 30-60, 80-100
    assert trace.idle_gaps(recorded()) == pytest.approx({
        "roma.refiner8: python": 5e-6, "roma.refiner8: aten::conv2d": 30e-6,
        "bench.sample: python": 20e-6})


def test_union_of_intervals():
    assert trace.union_us([(0, 10), (5, 15), (20, 30), (25, 26)], 2, 28) == pytest.approx(21)


@pytest.mark.parametrize("traced", [False, True])
def test_the_result_line_holds_the_contracts_keys(traced):
    res = harness.run(small("tiny-b8-s5k"), 2 ** 31 + 11, 0.0, traced, "cpu", 0.0)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res) == want + (["breakdown"] if traced else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(v) == {"value", "limit"} for v in res["checks"].values())
    json.dumps(res)
    names = {m["name"] for m in (BENCH["per_layer"] if traced else BENCH["end_to_end"])}
    assert set(res["metrics"]) <= names
    if not traced:
        assert set(res["metrics"]) == names
    else:
        assert set(res["device"]) >= {"busy_s", "window_s"}
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_metric_has_its_reader_and_every_cell_its_files():
    for m in BENCH["per_layer"]:
        assert callable(cells.reader(m["name"]))
    for w in BENCH["workloads"]:
        cell = cells.load(w["name"])
        assert cell.limits and cell.traffic["pairs"] >= 1
        assert [m["name"] for m in cell.end_to_end] == [
            m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert {"setup_s", "pairs_per_s"} <= {m["name"] for m in cell.end_to_end}
        assert any(re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}", n)
                   for n in [w["name"], w["traffic"]])


@pytest.mark.parametrize("in_flight", [1, 3])
def test_the_window_waits_for_every_call_it_sent(monkeypatch, in_flight):
    """With calls in flight the host waits for the call `in_flight` before
    the newest, and the window closes only after all that was sent; with
    one call in flight the window waits for nothing itself."""
    sent, waited, synced = [], [], []

    class Event:
        def __init__(self, i):
            self.i = i

        def synchronize(self):
            waited.append(self.i)

    monkeypatch.setattr(harness, "fence", lambda dev: Event(sent[-1]))
    monkeypatch.setattr(harness, "synchronize", lambda dev: synced.append(len(sent)))

    def call(i):
        sent.append(i)
        return -i

    times, window_s, kept = harness.window(call, 0.0, 5, [1, 3], in_flight, "cpu")
    assert len(times) == len(sent) == 5 and window_s > 0
    assert kept == {1: (1, -1), 3: (3, -3)}
    if in_flight == 1:
        assert waited == synced == []
    else:
        assert waited == [0, 1] and synced == [5]
