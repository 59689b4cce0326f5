"""The port's demos (`roma_torch/demo/`) and export CLI
(`roma_torch/experiments/export_tiny.py`) run end to end on the CPU through
their `main`, on a pair of the rendered two-plane world at 96x128
(`chip_smoke.write_two_plane_scene`), full RoMa shrunk to
`debug_roma_config()` in float32 by replacing the demos' factory; each
writes its files. `chip_smoke.py`'s tail phase runs them on the card at
full width."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
from roma_torch.demo import demo_3D_effect, demo_fundamental, demo_match, demo_match_tiny
from roma_torch.experiments import export_tiny
from roma_torch.models.zoo import debug_roma_config, roma_outdoor


@pytest.fixture(autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def debug_matcher():
    return roma_outdoor(cfg=dataclasses.replace(debug_roma_config(), dtype="float32"),
                        device="cpu")


@pytest.fixture
def pair(tmp_path, monkeypatch, debug_matcher):
    for m in (demo_match, demo_fundamental, demo_3D_effect):
        monkeypatch.setattr(m, "roma_outdoor", lambda device=None: debug_matcher)
    world = cs.write_two_plane_scene(tmp_path, (0, 1), (cs.WORLD_HW, cs.WORLD_HW))
    a, b = (str(tmp_path / p) for p in world["paths"])
    return ["--im_A_path", a, "--im_B_path", b, "--device", "cpu"]


def test_demo_match(pair, tmp_path):
    warp, cert = demo_match.main(pair + ["--save_path", str(tmp_path / "w.jpg")])
    assert warp.shape[-1] == 4 and warp.shape[:2] == cert.shape
    assert (tmp_path / "w.jpg").exists()


def test_demo_match_tiny(pair, tmp_path):
    k_a, k_b = demo_match_tiny.main(pair + ["--save_path", str(tmp_path / "t.jpg")])
    assert k_a.shape == k_b.shape == (2000, 2) and (tmp_path / "t.jpg").exists()
    assert bool(((k_a >= 0) & (k_a <= torch.tensor([608.0, 448.0]))).all())


def test_demo_fundamental(pair, monkeypatch, capsys, debug_matcher):
    # the demo's 10000 balanced samples (a KDE over their candidates) take
    # ~50 s on this CPU; 1000 run the same code
    real = debug_matcher.sample
    monkeypatch.setattr(debug_matcher, "sample",
                        lambda w, c, num, generator=None: real(w, c, min(num, 1000), generator))
    res = demo_fundamental.main(pair)
    assert res is not None and np.shape(res.model) == (3, 3) and np.isfinite(res.model).all()
    assert "F =" in capsys.readouterr().out


def test_demo_3d_effect(pair, tmp_path):
    paths = demo_3D_effect.main(pair + ["--save_path", str(tmp_path / "gif" / "f"),
                                        "--frames", "3"])
    assert len(paths) == 3 and all(__import__("os").path.exists(p) for p in paths)
    from PIL import Image

    h, w = debug_roma_config().upsample_resolution
    assert Image.open(paths[0]).size == (w, h)


def test_export_cli_round_trip(tmp_path, capsys):
    out = tmp_path / "tiny.pt2"
    res = export_tiny.main(["--height", "64", "--width", "64", "--out", str(out), "--check",
                            "--device", "cpu", "--fused-kernel"])
    assert out.read_bytes() == res.serialized and res.flops > 0
    assert "round-trip check passed" in capsys.readouterr().out
