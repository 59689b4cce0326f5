"""The training cell at a size a test run holds, on the CPU: the port's
train step against the plain training reference in float32, the pairs'
geometry, a sound run and its control, and the planted faults that the
check has to catch."""

import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench import calibrate
from perfbench.configs import roma_outdoor_train
from perfbench.core import cells, harness, scenes, trace, train
from perfbench.core.trace import DeviceOp, Profile
from perfbench.reference.common import Precision
from perfbench.reference.robust_loss import gt_warp
from perfbench_small import small
from test_perfbench_metrics import reading

CELL = "roma-train-b8"
SEED = 2 ** 31 + 23
# the images moved as `grad_parity` measures the port against itself, by
# the size of the reference's own float32 departure: F.interpolate's
# bicubic position embedding differs from the port's matrices by ~1e-5
# (test_perfbench_reference.py), and that moves DINOv2's features as much
MOVES = (1e-7, -1e-7, 1e-6, -1e-6, 1e-5, -1e-5)


def port_grads(cell, batch):
    """The port's first step on `batch`: its metrics and every trainable
    gradient before the clip (the clipped one times norm / clip where the
    clip engaged)."""
    prog = cell.cfgmod.Program(cell.cfg, cell.traffic, harness.make_weights(cell, SEED, "cpu"),
                               "cpu")
    _, metrics = prog.step(prog.state, batch)
    unclip = max(1.0, metrics["grad_norm"].item() / cell.cfg["optimizer"]["grad_clip"])
    return prog, metrics, {k: p.grad * unclip for k, p in prog.trainable().items()}


def test_the_ports_step_matches_the_reference_in_float32():
    """One step from one seed: the loss terms within 1e-4 relative, every
    gradient before the clip under `grad_parity`'s rule: GRAD_TOL of max|g|
    a tensor, the biases before a BatchNorm exact zeros, and the
    kink-sensitive tensors named as that rule names them, by the port
    against itself: those that the port's own step moves past GRAD_TOL
    when the images move by one of MOVES (ReLU kinks behind
    batch-statistics BatchNorms over few pixels), each held to twice the
    largest of those relative L2 errors."""
    from roma_torch.train.grad_parity import GRAD_TOL, grad_mismatches

    cell = small(CELL)
    batch = scenes.make_pool(cell.traffic, SEED, "cpu")[0]
    prog, got, grads = port_grads(cell, batch)
    named = {}
    for dx in MOVES:
        _, _, moved = port_grads(cell, {k: v + dx if k in ("im_A", "im_B") else v
                                        for k, v in batch.items()})
        for k, g in grads.items():
            if (moved[k] - g).abs().max() > GRAD_TOL * g.abs().max():
                e = ((moved[k] - g).norm() / g.norm().clamp_min(1e-30)).item()
                named[k] = named.get(k, ()) + (e,)

    ref = cell.cfgmod.reference_trainer(cell.cfg, harness.make_weights(cell, SEED, "cpu"), "cpu",
                                        Precision(), 1)
    b = {k: torch.as_tensor(v) for k, v in batch.items()}
    total, terms = ref.loss(ref.forward(b["im_A"], b["im_B"]), b)
    total.backward()
    want = dict(terms, total_loss=total)
    assert set(want) <= set(got)
    for k, v in want.items():
        assert abs(got[k].item() - v.item()) <= 1e-4 * abs(v.item()) + 1e-7, (k, got[k], v)
    bad, worst = grad_mismatches(prog.state.model, grads,
                                 {k: p.grad for k, p in ref.params.items()}, named)
    assert not bad, (bad, worst)
    # about half of the 136 tensors that are not exact zeros are named, as
    # `grad_parity` finds of the port against itself at this size (67 to 69)
    assert worst["n_zero"] > 0 and worst["n_tol"] >= 60 and worst["n_kink"] <= 70


def test_the_pairs_are_two_views_of_one_plane():
    """The ground-truth warp takes A's pixels to B's pixels of the same
    texture; an eighth of each depth map is zeroed; every seed draws the
    same shapes."""
    t = small(CELL).traffic
    pools = [scenes.make_pool(t, s, "cpu") for s in (SEED, SEED + 1)]
    assert [{k: v.shape for k, v in b.items()} for b in pools[0]] == \
        [{k: v.shape for k, v in b.items()} for b in pools[1]]
    b = {k: torch.as_tensor(v) for k, v in pools[0][0].items()}
    assert (b["im_A_depth"] == 0).float().mean().item() == pytest.approx(t["holes"], abs=1e-3)
    h, w = t["resolution"]
    x2, prob = gt_warp(b, h, w, 0.05)
    valid = prob > 0
    assert 0.35 <= valid.float().mean().item() < 1.0
    im_b = F.grid_sample(b["im_B"].permute(0, 3, 1, 2), x2, align_corners=False)
    err = (im_b.permute(0, 2, 3, 1) - b["im_A"]).abs().mean(-1)
    shifted = (b["im_A"].roll(h // 20, 1) - b["im_A"]).abs().mean(-1)
    assert err[valid].mean() < 0.35 * shifted.mean()
    g = scenes.draw_geometry(np.random.default_rng(1), dict(t, resolution=[560, 560]))
    assert scenes.overlap(g, 560, 560) >= t["min_overlap"]


def test_a_sound_run_is_correct_and_the_control_is_not():
    cell = small(CELL)
    res = harness.run(cell, SEED, 0.0, False, "cpu", 0.0)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == set(cell.limits) == set(train.compared(
        cell.cfgmod.groups(cell.cfg)))
    res = harness.run(cell, SEED, 0.0, False, "cpu", 0.0, make_program=calibrate.control_program)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("fault", sorted(roma_outdoor_train.FAULTS))
def test_a_broken_step_is_not_correct(fault):
    res = harness.run(small(CELL), SEED, 0.0, False, "cpu", 0.0,
                      make_program=calibrate.faulty_program(fault))
    assert res["correct"] is False, res["checks"]


def test_the_groups_hold_every_leaf_and_the_exact_zeros_are_the_biases_before_batchnorms():
    """Every trainable leaf lies in one group of the check; the leaves left
    out as exact zeros are the biases of the convolutions before a
    BatchNorm (VGG's, the projections', each refiner block's first), and
    the float32 reference's gradient there is round-off: under a
    thousandth of the same convolution's weight's."""
    cell = small(CELL)
    ref = cell.cfgmod.reference_trainer(cell.cfg, harness.make_weights(cell, SEED, "cpu"), "cpu",
                                        Precision(), 1)
    groups = cell.cfgmod.groups(cell.cfg).values()
    assert all(sum(k.startswith(p) for p in groups) == 1 for k in ref.params)
    zeros = ref.exact_zero
    blocks = 1 + cell.cfg["refiners"]["1"]["hidden_blocks"]
    assert len(zeros) == 12 + 5 + 5 * blocks
    assert all(k.endswith(".0.bias") for k in zeros if not k.startswith("encoder."))
    ref.call(scenes.make_pool(cell.traffic, SEED, "cpu")[0])
    g = {k: p.grad for k, p in ref.params.items()}
    for k in zeros:
        assert g[k].norm() < 1e-3 * g[k[:-len("bias")] + "weight"].norm(), k


def test_a_traced_small_run_reports_the_cells_metrics():
    """On the CPU no op reaches the device: the device readers leave their
    metrics out and the line holds only what the cell reports."""
    cell = small(CELL)
    res = harness.run(cell, SEED + 2, 0.0, True, "cpu", 0.0)
    assert res["correct"] is True
    assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
    assert res["attempted"] == cell.traffic["pairs"] * 3


def test_the_matching_cells_check_numbers_are_unchanged():
    """The small matching cells give the check numbers they gave before the
    training hooks, bit for bit (recorded on the tree before them)."""
    from perfbench.core import check

    want = json.loads((Path(__file__).parent / "matching_checks.json").read_text())
    seen = []
    verdict = check.verdict

    def spy(pairs, limits):
        seen.append(check.aggregate(pairs))
        return verdict(pairs, limits)

    check.verdict = spy
    try:
        for name, numbers in want.items():
            harness.run(small(name), 2 ** 31 + 19, 0.0, False, "cpu", 0.0)
            assert seen[-1] == numbers, name
    finally:
        check.verdict = verdict


def train_profile():
    """Two recorded steps of 100 us: a forward op, the loss, two backward
    ops from autograd's thread (one of them K8), the update and the
    read-back; one op launched before the steps."""
    def step(t):
        return [DeviceOp("conv", t + 6, t + 10, ("bench.call", "roma.vgg"), t + 5),
                DeviceOp("log_softmax", t + 21, t + 25, ("bench.call", "bench.loss"), t + 20),
                DeviceOp("wgrad", t + 41, t + 61, ("bench.call",), t + 40, False),
                DeviceOp("void dkv_wgmma_kernel<128>(x)", t + 62, t + 64, ("bench.call",),
                         t + 45, False),
                DeviceOp("multi_tensor_apply", t + 70, t + 75,
                         ("bench.call", "Optimizer.step#AdamW.step"), t + 69),
                DeviceOp("memcpy", t + 90, t + 91, ("bench.call", "bench.readback"), t + 89)]
    host = [("bench.call", 0, 100, True), ("bench.loss", 15, 30, True),
            ("bench.readback", 85, 95, True), ("bench.call", 100, 200, True),
            ("bench.loss", 115, 130, True), ("bench.readback", 185, 195, True)]
    ops = step(0) + step(100) + [DeviceOp("early", -20, -10, (), -21, False)]
    return Profile(device_ops=ops, host=host, calls=[(0, 100), (100, 200)], launches=12)


@pytest.mark.parametrize("metric,want", [
    ("train.loss_device_ms", 4 / 1e3),
    ("train.backward_device_ms", (20 + 2) / 1e3),
    ("train.optimizer_device_ms", 5 / 1e3),
    ("encoders.device_ms", 4 / 1e3),
])
def test_the_step_readers_on_a_recorded_profile(metric, want):
    assert cells.reader(metric)(reading(profile=train_profile())) == pytest.approx(want)


def test_the_attention_backward_roofline_reader():
    role = types.SimpleNamespace(KERNELS=cells.rooflines()["K8_flash_attn_bwd"].KERNELS,
                                 launches=lambda cfg, t: [(0.0, 989e12 * 1e-6, 0.0)])
    read = cells.reader("roofline.flash_attn_bwd")
    r = reading(profile=train_profile(), rooflines={"K8_flash_attn_bwd": role})
    assert read(r) == pytest.approx(100 * 2 * 0.001 / 0.004)
    assert read(reading(rooflines={"K8_flash_attn_bwd": role})) is None   # no K8 op


def test_launches_of_every_thread_are_counted_and_their_ops_put_under_the_calls_ranges():
    from torch.autograd import DeviceType

    def ev(name, s, e, thread, id_=0, cuda=False, user=False):
        return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=s, end=e),
                                     thread=thread, id=id_, is_user_annotation=user,
                                     device_type=DeviceType.CUDA if cuda else DeviceType.CPU)

    events = [ev("bench.call", 0, 100, 1, user=True), ev("bench.loss", 10, 30, 1, user=True),
              ev("cudaLaunchKernel", 20, 21, 1, 1), ev("fwd", 22, 25, 0, 1, cuda=True),
              ev("cudaLaunchKernel", 50, 51, 7, 2), ev("bwd", 52, 60, 0, 2, cuda=True),
              ev("cudaLaunchKernel", 150, 151, 7, 3), ev("late", 152, 160, 0, 3, cuda=True)]
    p = trace.from_torch(types.SimpleNamespace(events=lambda: events))
    assert p.launches == 2 and p.calls == [(0, 100)]
    ops = {op.name: op for op in p.device_ops}
    assert ops["fwd"].calls_thread and ops["fwd"].ranges == ("bench.call", "bench.loss")
    assert not ops["bwd"].calls_thread and ops["bwd"].ranges == ("bench.call",)
    assert ops["bwd"].launch == 50 and trace.in_calls(p) == [ops["fwd"], ops["bwd"]]
