"""On the card: each cell runs through the command as the check runs it and
comes out correct, and the control at the cell's own size does not."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import calibrate
from perfbench.core import cells, check

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_cell_runs_correct(card, name):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name,
                          "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["busy_s"] > 0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(card, name):
    cell = cells.load(name)
    row = calibrate.readings(cell, [2 ** 31 + 78], control=True)[0]
    ok, _ = check.verdict([row], cell.limits)
    assert not ok, row
