"""The port's three evaluation command lines on the CPU, on the synthetic
MegaDepth layout of tests/test_benchmarks.py: `main()` with the JAX
package's flags. The shrinking is done here by monkeypatching (the CPU for
the GPU, the debug-size float32 full RoMa, a narrow float32 Tiny RoMa, the
synthetic scene for the default scene lists, a small dense benchmark),
never through a flag. Each run's metrics are finite; --checkpoint loads a
CheckPoint's weights and --params a reference-layout state_dict. Two
torch threads: the test workers share the machine's cores."""

import dataclasses
import functools
import json
import types

import numpy as np
import pytest
import torch

from roma_torch.benchmarks import megadepth_pose
from roma_torch.benchmarks.dense import MegadepthDenseBenchmark
from roma_torch.config import TinyRomaConfig
from roma_torch.experiments import eval_roma_outdoor as roma_cli
from roma_torch.experiments import eval_tiny_roma_v1_outdoor as tiny_cli
from roma_torch.experiments import match as match_cli
from roma_torch.models.tiny_roma import TinyRomaMatcher
from roma_torch.models.zoo import build_model, debug_roma_config, roma_outdoor
from roma_torch.train.checkpoint import CheckPoint
from tests.test_benchmarks import IMG_H, IMG_W, mega_scene_dir  # noqa: F401

TINY = TinyRomaConfig(match_dim=32, fine_match_dim=16, dtype="float32")


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def one_scene(monkeypatch):
    """The synthetic scene.npz stands for Mega-1500's and Mega-8's lists,
    with one RANSAC run on 500 matches a pair (the native estimator unless
    the command line names one)."""
    monkeypatch.setattr(megadepth_pose, "DEFAULT_SCENES", ["scene.npz"])
    monkeypatch.setattr(tiny_cli, "MEGA8_SCENES", ["scene.npz"])
    small = functools.partial(megadepth_pose.MegaDepthPoseEstimationBenchmark,
                              pose_backend="native", num_ransac_runs=1, sample_num=500)
    for cli in (roma_cli, tiny_cli):
        monkeypatch.setattr(cli, "MegaDepthPoseEstimationBenchmark", small)


def _save(model, tmp_path, name):
    """A CheckPoint of `model` with its weights moved off their init."""
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.01)
    state = types.SimpleNamespace(step=4, updates=2, model=model,
                                  optimizer=torch.optim.SGD(model.parameters(), lr=0.0))
    CheckPoint(tmp_path / "ck", name).save(state)
    return str(tmp_path / "ck" / name), {k: v.clone() for k, v in model.state_dict().items()}


def _capture(monkeypatch, module, attr, make):
    made = []
    monkeypatch.setattr(module, attr, lambda *a, **k: made.append(make(*a, **k)) or made[-1])
    return made


def _assert_loaded(matcher, want):
    got = matcher.model.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_eval_roma_outdoor_cli(monkeypatch, tmp_path, mega_scene_dir, one_scene):
    """Batched, device resize, native estimator, a checkpoint, the dense
    benchmark: the metric dict is printed, written and finite."""
    cfg = dataclasses.replace(debug_roma_config(), dtype="float32")
    monkeypatch.setattr(roma_cli, "DEVICE", "cpu")
    made = _capture(monkeypatch, roma_cli, "roma_outdoor",
                    lambda coarse_res, upsample_res, device: roma_outdoor(cfg=cfg, device=device))
    monkeypatch.setattr(roma_cli, "MegadepthDenseBenchmark", functools.partial(
        MegadepthDenseBenchmark, h=IMG_H // 2, w=IMG_W // 2, num_samples=2, batch_size=2))
    ck, want = _save(roma_outdoor(cfg=cfg, device="cpu").model, tmp_path, "roma_outdoor")
    out = tmp_path / "res" / "mega.json"
    res = roma_cli.main(["--data_root", str(mega_scene_dir), "--checkpoint", ck,
                         "--out", str(out), "--dense", "--pose_backend", "native",
                         "--batch", "2", "--device-resize"])
    _assert_loaded(made[0], want)
    assert json.loads(out.read_text()) == res
    assert {"auc_5", "auc_10", "auc_20", "map_5", "epe", "mega_pck_1"} <= set(res)
    assert all(np.isfinite(v) for v in res.values())


def test_eval_tiny_cli(monkeypatch, tmp_path, mega_scene_dir, one_scene):
    """Mega-1500 and Mega-8 through the serial harness, Tiny RoMa loaded
    from a CheckPoint."""
    monkeypatch.setattr(tiny_cli, "DEVICE", "cpu")
    made = _capture(monkeypatch, tiny_cli, "tiny_roma_v1_outdoor",
                    lambda device: TinyRomaMatcher(build_model(TINY), device=device))
    ck, want = _save(build_model(TINY), tmp_path, "tiny_roma_v1_outdoor")
    out = tmp_path / "tiny.json"
    res = tiny_cli.main(["--data_root", str(mega_scene_dir), "--checkpoint", ck, "--mega8",
                         "--out", str(out)])
    _assert_loaded(made[0], want)
    assert set(res) == {"mega1500", "mega8"} and json.loads(out.read_text()) == res
    assert all(np.isfinite(v) for r in res.values() for v in r.values())


def test_match_cli(monkeypatch, tmp_path, mega_scene_dir):
    """Tiny RoMa from a reference-layout state_dict, 100 matches drawn side
    by side, and the fundamental matrix of the sampled matches."""
    monkeypatch.setattr(match_cli, "DEVICE", "cpu")
    made = _capture(monkeypatch, match_cli, "tiny_roma_v1_outdoor",
                    lambda device: TinyRomaMatcher(build_model(TINY, seed=1), device=device))
    ref = build_model(TINY, seed=2)
    torch.save(ref.state_dict(), tmp_path / "tiny.pth")
    save = tmp_path / "m.jpg"
    kpts_a, kpts_b, result = match_cli.main([
        "--im_A_path", str(mega_scene_dir / "images/im_0.jpg"),
        "--im_B_path", str(mega_scene_dir / "images/im_1.jpg"),
        "--save_path", str(save), "--num", "100", "--params", str(tmp_path / "tiny.pth"),
        "--fundamental"])
    _assert_loaded(made[0], ref.state_dict())
    assert kpts_a.shape == kpts_b.shape == (100, 2)
    assert (kpts_a >= 0).all() and (kpts_a[:, 0] <= IMG_W).all() and (kpts_a[:, 1] <= IMG_H).all()
    from PIL import Image

    assert Image.open(save).size == (2 * IMG_W, IMG_H)
    assert result is None or result.model.shape == (3, 3)
