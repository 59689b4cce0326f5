"""A cell found by name: its entry in BENCHMARK.json, its configuration
(`configs/<config>.json` and the module `configs/<config>.py`), its traffic
(`traffic/<traffic>.json`), its limits (`limits/<cell>.json`), and the
benchmark's per-layer readers (`metrics/<name>.py`) and kernel rooflines
(`rooflines/*.py`)."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location("perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    cfgmod: object
    traffic: dict
    limits: dict
    end_to_end: list     # the BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list      # and with --trace 1


def _reports(metric: dict, cell: str, e2e: set | None = None) -> bool:
    """An end-to-end metric is reported in every cell, or in those its
    `workloads` lists; a per-layer one in those, or else wherever the
    end-to-end metric it moves is."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e is None or metric["moves"] in e2e


def load(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_file.read_text())
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise SystemExit(f"no workload {name!r} in {bench_file}")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, {m["name"] for m in e2e})]
    return Cell(name=name, chips=work["chips"], cfg=cfg,
                cfgmod=load_module(ROOT / conf["file"].replace(".json", ".py")),
                traffic=json.loads((BENCH / "traffic" / f"{work['traffic']}.json").read_text()),
                limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


def metric(name: str):
    """The module of a per-layer metric: `read(r)`, and optionally `note(r)`,
    a line the harness prints before the result."""
    return load_module(BENCH / "metrics" / f"{name}.py")


def reader(name: str):
    return metric(name).read


def rooflines() -> dict:
    return {p.stem: load_module(p) for p in sorted((BENCH / "rooflines").glob("*.py"))}
