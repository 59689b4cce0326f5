"""The wrappers' dtype dispatch: every kernel with a float32 entry (local
correlation K1, the chained blocks K2, attention K3 and its backward K8/K9,
the whole block K5) picks its C entry by the input's dtype, bf16 or
float32, through `runtime.entry`, and any other dtype raises instead of
being cast; K1's tile plan sends every float32 tile down the per-pixel
path. The CUDA launches themselves are held against the plain versions by
chip_smoke.py."""

import pytest
import torch

from roma_torch.kernels import attention as at
from roma_torch.kernels import dw_block_mm as k5
from roma_torch.kernels import dw_chain as k2
from roma_torch.kernels import local_corr as k1
from roma_torch.kernels import runtime

ENTRIES = {
    "local_corr": (k1.NAME, k1.ENTRIES, "roma_local_corr", "roma_local_corr_f32"),
    "dw_chain": (k2.NAME, k2.ENTRIES, "roma_dw_block", "roma_dw_block_f32"),
    "flash_attn": (at.NAME, at.FWD_ENTRIES, "roma_flash_attn", "roma_flash_attn_f32"),
    "flash_attn_bwd": (at.BWD_NAME, at.BWD_DTYPES, 0, 1),
    "dw_block_mm": (k5.NAME, k5.ENTRIES, "roma_dw_block_mm", "roma_dw_block_mm_f32"),
}


@pytest.mark.parametrize("kernel", sorted(ENTRIES))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_each_dtype_picks_its_entry(kernel, dtype):
    name, entries, bf16, f32 = ENTRIES[kernel]
    assert runtime.entry(name, entries, dtype) == (bf16 if dtype == torch.bfloat16 else f32)


@pytest.mark.parametrize("kernel", sorted(ENTRIES))
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_dtypes_raise(kernel, dtype):
    name, entries, *_ = ENTRIES[kernel]
    with pytest.raises(TypeError, match=name):
        runtime.entry(name, entries, dtype)


def test_float32_entry_symbols_are_exported():
    """Each float32 symbol is defined by its kernel's source."""
    for kernel, (name, entries, bf16, f32) in ENTRIES.items():
        src = (runtime.CSRC / runtime.SOURCES[name]).read_text()
        for sym in (bf16, f32):
            if isinstance(sym, str):
                assert f"ROMA_EXPORT int {sym}(" in src, (kernel, sym)


@pytest.mark.parametrize("radius", [2, 3, 7])
def test_local_corr_tile_plan_float32_is_per_pixel(radius):
    """The same flow: from r = 5 bf16 puts the tiles whose window box is
    small on the shared path; float32 puts every tile on the per-pixel
    path, at every radius."""
    B, H, W = 1, 24, 40
    g = torch.Generator().manual_seed(radius)
    # a smooth flow close to the identity: small window boxes per tile
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, H), torch.linspace(-1, 1, W), indexing="ij")
    flow = torch.stack([xs, ys], -1)[None] + 0.01 * torch.randn((B, H, W, 2), generator=g)
    bf16 = k1.tile_plan(flow, radius)
    f32 = k1.tile_plan(flow, radius, torch.float32)
    assert not bool(f32.shared.any())
    assert torch.equal(f32.corners, bf16.corners) and torch.equal(f32.union, bf16.union)
    assert bool(bf16.shared.any()) == (radius >= k1.SHARE_MIN_R)


@pytest.mark.parametrize("fn,args", [
    (k2.chain_cuda_nchw, (torch.zeros(1, 8, 4, 4, dtype=torch.float16),) + (None,) * 5),
    (k5.dw5x5_affine_relu_mm_cuda_nchw,
     (torch.zeros(1, 8, 4, 4, dtype=torch.float64),) + (None,) * 5),
    (k1.local_correlation_cuda, (torch.zeros(1, 4, 4, 128, dtype=torch.float16), None, 3, None)),
])
def test_wrappers_refuse_other_dtypes_before_any_launch(fn, args):
    with pytest.raises(TypeError, match="takes"):
        fn(*args)
