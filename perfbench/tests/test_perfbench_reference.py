"""The plain reference against the port's plain CPU path at small sizes,
and the benchmark's import bans."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from perfbench.core import harness, inputs
from perfbench.core.program import reference_on
from perfbench.reference import sampling
from perfbench.reference.common import Precision
from perfbench.reference.resize import resize_canvases
from perfbench_small import small

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "roma_tpu"}


def dense_pair(name: str, seed: int):
    """The port's dense output (its plain CPU path, float32) and the
    reference's on the same weights and inputs."""
    cell = small(name)
    prog = cell.cfgmod.Program(cell.cfg, cell.traffic, harness.make_weights(cell, seed, "cpu"),
                               "cpu")
    batch = inputs.make_pool(cell.traffic, seed, "cpu")[0]
    out = prog.call(batch, [1] * cell.traffic["pairs"])
    ref = reference_on(cell.cfgmod, cell.cfg, harness.make_weights(cell, seed, "cpu"), "cpu")
    rw, rc = cell.cfgmod.reference_dense(ref, Precision(), batch, "cpu", cell.cfg)
    return out, rw, rc


@pytest.mark.parametrize("name", ["roma-b2-s10k", "tiny-b8-dense"])
def test_reference_matches_the_ports_plain_path(name):
    out, rw, rc = dense_pair(name, 5)
    assert out.warp.shape == rw.shape and out.cert.shape == rc.shape
    d = (out.warp - rw).abs().amax(-1).flatten()
    # float32 on both sides, the same arithmetic in another order
    assert torch.quantile(d, 0.99).item() < 1e-4
    assert (out.cert - rc).abs().mean().item() < 1e-5


def test_sampling_matches_the_ports_with_a_fixed_draw():
    from roma_torch.utils.sampling import sample_matches

    g = torch.Generator().manual_seed(3)
    warp = torch.rand((60, 80, 4), generator=g) * 2 - 1
    cert = torch.rand((60, 80), generator=g)
    got = sample_matches(warp, cert, num=400, sample_thresh=0.05,
                         generator=torch.Generator().manual_seed(9))
    want = sampling.sample(Precision(), warp, cert, 400, 0.05, torch.Generator().manual_seed(9))
    rows = lambda m, c: {tuple(r) for r in torch.cat([m, c[:, None]], 1).tolist()}  # noqa: E731
    assert len(rows(*got) & rows(*want)) >= 399


def test_pos_embed_interpolation_equals_the_ports_matrices():
    from roma_torch.ops.resize import torch_bicubic_resize

    x = torch.randn(1, 8, 37, 37)
    # float64 on the reference's side: F.interpolate's own float32 rounding
    # reaches ~1e-5 of these values, the port's matrices ~6e-7
    want = F.interpolate(x.double(), scale_factor=(40.1 / 37, 40.1 / 37), mode="bicubic",
                         align_corners=False)
    got = torch_bicubic_resize(x.permute(0, 2, 3, 1), (40, 40), scale=(40.1 / 37, 40.1 / 37))
    assert torch.allclose(got.permute(0, 3, 1, 2).double(), want, atol=1e-5)


def test_canvas_resize_is_pillows():
    from PIL import Image

    raw = torch.randint(0, 256, (2, 160, 160, 3), generator=torch.Generator().manual_seed(1),
                        dtype=torch.uint8)
    out = resize_canvases(raw, [(120, 160), (160, 100)], (112, 112))
    for i, (h, w) in enumerate([(120, 160), (160, 100)]):
        pil = Image.fromarray(raw[i, :h, :w].numpy()).resize((112, 112), Image.BICUBIC)
        # Pillow sums in fixed point: within one level of its 8-bit store
        assert np.abs(np.asarray(pil, np.float32) - out[i].numpy()).max() <= 1


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]  # whole top-level names: roma_torch is not roma_tpu
            assert top not in BANNED, f"{f.relative_to(BENCH)} imports {mod}"


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        tops = {m.split(".")[0] for m in _imports(f)}
        assert tops <= {"__future__", "math", "numpy", "torch", "perfbench"}, f
        assert not {m for m in _imports(f) if m.startswith("perfbench.")
                    and not m.startswith("perfbench.reference")}, f


def test_a_run_loads_no_banned_module():
    code = ("import sys, time; sys.path[:0] = ['perfbench/tests', '.'];"
            "from perfbench_small import small; from perfbench.core import harness;"
            "harness.run(small('tiny-b8-dense'), 1, 0.0, False, 'cpu', time.time());"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'roma_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "roma-b2-s10k",
                          "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=BENCH.parent, capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
