"""Each kernel role's least time at the default match's shapes (full RoMa,
2 pairs, 560 -> 864; Tiny RoMa, 8 pairs of 480x640) equals the bound column
of PERF.md's kernel table, and each role's kernel names match the CUDA
sources' kernels."""

import json
import re
from pathlib import Path

import pytest

from perfbench.core import cells
from perfbench.core.peaks import bound_ms

ROOT = Path(__file__).resolve().parents[2]
ROMA = json.loads((ROOT / "perfbench/configs/roma_outdoor.json").read_text())
TINY = json.loads((ROOT / "perfbench/configs/tiny_roma_v1_outdoor.json").read_text())
SOURCES = {"K1_local_corr": "local_corr.cu", "K2_dw_chain": "dw_chain.cu",
           "K3_flash_attn": "flash_attn.cu", "K4_dw_affine_relu": "dw_affine_relu.cu",
           "K7_corr_softmax": "corr_softmax.cu"}


@pytest.mark.parametrize("role,cfg,pairs,launches,ms", [
    ("K1_local_corr", ROMA, 2, 5, 0.140),
    ("K2_dw_chain", ROMA, 2, 2, 0.122),
    ("K3_flash_attn", ROMA, 2, 29, 1.231),
    ("K4_dw_affine_relu", ROMA, 2, 63, 4.166),
    ("K7_corr_softmax", TINY, 8, 1, 0.0473),
])
def test_bound_at_the_default_match(role, cfg, pairs, launches, ms):
    traffic = {"pairs": pairs, "canvas": [480, 640]}
    work = cells.rooflines()[role].launches(cfg, traffic)
    assert len(work) == launches
    assert sum(bound_ms(*w) for w in work) == pytest.approx(ms, abs=5e-4 if ms > 0.1 else 5e-5)


@pytest.mark.parametrize("role", sorted(SOURCES))
def test_kernel_names_match_the_sources(role):
    src = (ROOT / "roma_torch/csrc" / SOURCES[role]).read_text()
    names = set(re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+(\w+)\(", src))
    names |= set(re.findall(r"^(\w+_kernel)\(", src, re.M))
    assert names
    rx = re.compile(cells.rooflines()[role].KERNELS)
    for n in names:
        assert rx.search(f"void (anonymous namespace)::{n}<64>(float const*)"), n
    assert not rx.search("void at::native::vectorized_elementwise_kernel<4>(int)")
