"""roma_torch package contract: config defaults equal the JAX package's, the
package never imports JAX or the JAX package, and it imports without a GPU,
nvcc or triton."""

import ast
import dataclasses
import pathlib

import pytest
import torch

import roma_tpu.config as jcfg
import roma_torch.config as tcfg
import roma_torch.models.zoo as tzoo
import roma_tpu.models.zoo as jzoo

REPO = pathlib.Path(__file__).resolve().parents[1]
BANNED = ("jax", "flax", "optax", "roma_tpu")


def _asdict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", ["RomaConfig", "GPConfig"])
def test_config_defaults_equal_jax(name):
    assert _asdict(getattr(tcfg, name)()) == _asdict(getattr(jcfg, name)())


def test_refiner_config_and_presets_equal_jax():
    args = (24, 24, 6)
    assert _asdict(tcfg.RefinerConfig(*args)) == _asdict(jcfg.RefinerConfig(*args))
    assert dict(tcfg.RESOLUTION_PRESETS) == dict(jcfg.RESOLUTION_PRESETS)


def test_debug_config_equals_jax():
    assert _asdict(tzoo.debug_roma_config()) == _asdict(jzoo.debug_roma_config())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_or_jax_package():
    files = sorted((REPO / "roma_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in BANNED, f"{f.relative_to(REPO)} imports {mod}"


def test_cuda_request_without_gpu_raises():
    from roma_torch.device import resolve_device

    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device()


def test_kernel_build_is_lazy_and_named_by_content():
    from roma_torch.kernels import LAUNCHES, reset_launches, runtime

    assert set(runtime.SOURCES) == {"local_corr", "dw_chain", "flash_attn"}
    for name, src in runtime.SOURCES.items():
        assert (runtime.CSRC / src).exists()
        p = runtime.lib_path(name)
        assert p.parent == REPO / "build" / "kernels"
        assert p.name.startswith(f"libroma_{name}-")
    assert "arch=compute_90a,code=sm_90a" in runtime.NVCC_FLAGS
    LAUNCHES["local_corr"] = 3
    reset_launches()
    assert set(LAUNCHES.values()) == {0}
