"""Each kernel role's least time at the default match's shapes (full RoMa,
2 pairs, 560 -> 864; Tiny RoMa, 8 pairs of 480x640; the attention
backward at a training step's, 2 pairs at 560) equals the bound column of
PERF.md's kernel table, and each role's kernel names match the CUDA
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
TRAIN = json.loads((ROOT / "perfbench/configs/roma_outdoor_train.json").read_text())
SOURCES = {"K1_local_corr": "local_corr.cu", "K2_dw_chain": "dw_chain.cu",
           "K3_flash_attn": "flash_attn.cu", "K4_dw_affine_relu": "dw_affine_relu.cu",
           "K7_corr_softmax": "corr_softmax.cu", "K8_flash_attn_bwd": "flash_attn_bwd.cu"}


@pytest.mark.parametrize("role,cfg,pairs,launches,ms", [
    ("K1_local_corr", ROMA, 2, 5, 0.140),
    ("K2_dw_chain", ROMA, 2, 2, 0.122),
    ("K3_flash_attn", ROMA, 2, 29, 1.231),
    ("K4_dw_affine_relu", ROMA, 2, 63, 4.166),
    ("K7_corr_softmax", TINY, 8, 1, 0.0473),
    ("K8_flash_attn_bwd", TRAIN, 2, 10, 0.212 + 0.159),
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


def test_the_attention_backward_bound_is_chip_smokes():
    """K8 and K9 a launch at the decoder's (2, 1600, 8, 128): the file's
    bytes, operations and exponentials give `chip_smoke.py`'s bound, and
    a matching cell has no launch of either."""
    import chip_smoke

    B, N, H, d = 2, 1600, 8, 128
    gemm, exps = 2.0 * B * H * N * N * d, float(B * H * N * N)
    elem, side = B * N * H * d * 2, 2 * B * H * N * 4
    want = [chip_smoke.bound((4 + n_out) * elem + side, n_gemm * gemm, exps)[0]
            for n_gemm, n_out in ((4, 2), (3, 1))]
    work = cells.rooflines()["K8_flash_attn_bwd"].launches(TRAIN, {"pairs": 2})
    assert [bound_ms(*w) for w in work] == pytest.approx(want * TRAIN["decoder"]["blocks"])
    assert cells.rooflines()["K8_flash_attn_bwd"].launches(ROMA, {"pairs": 2}) == []
