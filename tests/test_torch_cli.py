"""The port's three training command lines on the CPU, on synthetic
MegaDepth and ScanNet layouts (tests/test_torch_datasets.py's): each
`main()` takes 2 steps, writes a checkpoint, and a second run resumes from
it for 2 more. The shrinking is done here by monkeypatching (the CPU for
the GPU, a 64x64 resolution table and narrow float32 matchers for Tiny
RoMa, the debug-size float32 full RoMa), never through a flag: the
arguments are the JAX package's. The Tiny command line's --checkpoint warm
start loads a state_dict that the port saved, in the reference key
layouts. Two torch threads: the test workers share the machine's cores."""

import dataclasses
import json

import pytest
import torch

from roma_torch.config import TinyRomaConfig
from roma_torch.experiments import train_roma_indoor, train_roma_outdoor
from roma_torch.experiments import train_tiny_roma_v1_outdoor as tiny_cli
from roma_torch.models.tiny_roma import TinyRoma
from roma_torch.models.zoo import build_model, debug_roma_config
from roma_torch.train.checkpoint import CheckPoint
from roma_torch.train.train import make_tiny_train_state
from test_torch_datasets import make_megadepth_layout, make_scannet_layout

TINY = TinyRomaConfig(match_dim=32, fine_match_dim=16, dtype="float32")


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _small_tiny(monkeypatch):
    """The Tiny command line on the CPU at 64x64 with narrow matchers."""
    monkeypatch.setattr(tiny_cli, "DEVICE", "cpu")
    monkeypatch.setattr(tiny_cli, "RESOLUTIONS", {"big": (64, 64)})
    monkeypatch.setattr(tiny_cli, "make_tiny_train_state", lambda cfg, trainable, seed, device:
                        make_tiny_train_state(cfg, model=build_model(TINY, seed),
                                              trainable=trainable, device=device))


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    return (make_megadepth_layout(tmp_path_factory.mktemp("megadepth")),
            make_scannet_layout(tmp_path_factory.mktemp("scannet")))


def _run_twice(module, name, args, tmp_path):
    """main() for 2 steps (batch 2, 4 samples), then resumed to 8 samples."""
    ck, logs = str(tmp_path / "ck"), str(tmp_path / "logs")
    common = [*args, "--checkpoint_dir", ck, "--log_dir", logs, "--batch_size", "2"]
    module.main([*common, "--total_samples", "4"])
    store = CheckPoint(ck, name)
    assert store.steps() == [4]
    first = torch.load(store._path(4), weights_only=True)
    assert first["updates"] == 2
    module.main([*common, "--total_samples", "8"])
    assert store.steps() == [4, 8]
    blob = torch.load(store._path(8), weights_only=True)
    assert blob["step"] == 8 and blob["updates"] == 4
    moved = [k for k, v in blob["model"].items() if not torch.equal(v, first["model"][k])]
    assert moved
    return blob


def test_tiny_cli_trains_checkpoints_and_resumes(monkeypatch, tmp_path, layouts):
    _small_tiny(monkeypatch)
    blob = _run_twice(tiny_cli, "tiny_roma_v1_outdoor",
                      ["--data_root", layouts[0], "--eval_every", "4"], tmp_path)
    assert "fine_matcher.0.layer.0.weight" in blob["model"]


@pytest.mark.parametrize("flag,frozen", [("--train_fine_matcher", ("xfeat", "coarse_matcher")),
                                         ("--freeze_xfeat", ("xfeat",))])
def test_tiny_cli_staged_flags(monkeypatch, tmp_path, layouts, flag, frozen):
    """--train_fine_matcher and --freeze_xfeat freeze the JAX package's roots."""
    _small_tiny(monkeypatch)
    ck = tmp_path / "ck"
    tiny_cli.main(["--data_root", layouts[0], "--checkpoint_dir", str(ck), "--log_dir",
                   str(tmp_path / "logs"), "--batch_size", "2", "--total_samples", "2",
                   "--eval_every", "2", flag])
    blob = torch.load(CheckPoint(str(ck), "tiny_roma_v1_outdoor")._path(2), weights_only=True)
    init = build_model(TINY, 0).state_dict()
    for k, v in blob["model"].items():
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        assert torch.equal(v, init[k]) == k.startswith(frozen), k


@pytest.mark.parametrize("layout", ["trainable", "raw_xfeat"])
def test_tiny_cli_warm_start(monkeypatch, tmp_path, layouts, layout):
    """--checkpoint loads a reference .pth straight into the port's modules:
    here a state_dict the port saved, with the trunk under `xfeat.0.` or
    bare (the raw XFeat checkpoint's keys)."""
    _small_tiny(monkeypatch)
    seen = []
    monkeypatch.setattr(tiny_cli, "replicate", lambda state, mesh: seen.append(state) or state)
    sd = TinyRoma(TINY).state_dict()
    sd = {k: torch.randn_like(v) if v.is_floating_point() else v for k, v in sd.items()}
    saved = {k.removeprefix("xfeat.0.") if layout == "raw_xfeat" else k: v for k, v in sd.items()}
    saved["keypoint_head.0.weight"] = torch.zeros(3)  # not read
    path = tmp_path / "ref.pth"
    torch.save(saved, path)
    tiny_cli.main(["--data_root", layouts[0], "--checkpoint_dir", str(tmp_path / "ck"),
                   "--log_dir", str(tmp_path / "logs"), "--only_test", "--checkpoint", str(path)])
    got = seen[0].model.state_dict()
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def _debug_roma(monkeypatch, module):
    monkeypatch.setattr(module, "DEVICE", "cpu")
    monkeypatch.setattr(module, "RomaConfig",
                        lambda: dataclasses.replace(debug_roma_config(), dtype="float32"))


def test_roma_outdoor_cli_trains_checkpoints_and_resumes(monkeypatch, tmp_path, layouts):
    _debug_roma(monkeypatch, train_roma_outdoor)
    blob = _run_twice(train_roma_outdoor, "roma_outdoor",
                      ["--data_root", layouts[0], "--train_resolution", "112",
                       "--eval_every", "4"], tmp_path)
    assert "decoder.conv_refiner.1.out_conv.weight" in blob["model"]


def test_roma_indoor_cli_trains_checkpoints_and_resumes(monkeypatch, tmp_path, layouts):
    _debug_roma(monkeypatch, train_roma_indoor)
    ck = tmp_path / "ck"
    _run_twice(train_roma_indoor, "roma_indoor",
               ["--megadepth_root", layouts[0], "--scannet_root", layouts[1],
                "--train_resolution", "112", "--checkpoint_every", "4"], tmp_path)
    rows = [json.loads(line) for line in open(tmp_path / "logs" / "roma_indoor.jsonl")]
    assert rows == [] and ck.exists()
