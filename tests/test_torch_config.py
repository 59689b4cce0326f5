"""roma_torch package contract: config defaults equal the JAX package's, the
package never imports JAX or the JAX package, and it imports without a GPU,
nvcc or triton."""

import ast
import dataclasses
import inspect
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


@pytest.mark.parametrize("name", ["RomaConfig", "GPConfig", "TinyRomaConfig", "TrainConfig",
                                  "LossConfig", "MeshConfig"])
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
    files = sorted((REPO / "roma_torch").rglob("*.py")) + [REPO / "chip_smoke.py",
                                                          REPO / "match_ab.py",
                                                          REPO / "vit_step.py",
                                                          REPO / "span_log.py"]
    assert len(files) > 10
    names = {f.relative_to(REPO).as_posix() for f in files}
    assert {"roma_torch/models/tiny_roma.py", "roma_torch/models/xfeat.py",
            "roma_torch/ops/band_corr.py", "roma_torch/ops/windowed_sample.py",
            "roma_torch/kernels/corr_softmax.py", "roma_torch/kernels/windowed_sample.py",
            "roma_torch/kernels/dw_affine_relu.py", "roma_torch/kernels/dw_block_mm.py",
            "roma_torch/models/api.py", "roma_torch/losses/robust_loss.py",
            "roma_torch/train/train.py", "roma_torch/train/checkpoint.py",
            "roma_torch/train/logging.py", "roma_torch/train/grad_parity.py",
            "roma_torch/utils/geometry.py", "roma_torch/estimation/__init__.py",
            "roma_torch/estimation/ransac.py", "roma_torch/estimation/essential.py",
            "roma_torch/estimation/fivepoint.py", "roma_torch/estimation/fundamental.py",
            "roma_torch/estimation/homography.py", "roma_torch/estimation/native.py",
            "roma_torch/benchmarks/__init__.py", "roma_torch/benchmarks/harness_core.py",
            "roma_torch/benchmarks/pose_backends.py", "roma_torch/benchmarks/megadepth_pose.py",
            "roma_torch/benchmarks/scannet.py", "roma_torch/benchmarks/hpatches.py",
            "roma_torch/benchmarks/dense.py", "roma_torch/experiments/eval_roma_outdoor.py",
            "roma_torch/experiments/eval_tiny_roma_v1_outdoor.py",
            "roma_torch/experiments/match.py", "roma_torch/sfm/__init__.py",
            "roma_torch/sfm/tracks.py", "roma_torch/sfm/pose_graph.py",
            "roma_torch/sfm/metrics.py", "roma_torch/sfm/bundle_adjust.py",
            "roma_torch/sfm/reconstruction.py", "roma_torch/experiments/sfm_reconstruct.py",
            "roma_torch/experiments/sfm_scale.py", "roma_torch/experiments/sfm_study.py",
            "roma_torch/export.py", "roma_torch/utils/profiling.py",
            "roma_torch/models/resnet.py", "roma_torch/experiments/export_tiny.py",
            "roma_torch/demo/demo_match.py", "roma_torch/demo/demo_match_tiny.py",
            "roma_torch/demo/demo_fundamental.py", "roma_torch/demo/demo_3D_effect.py",
            "match_ab.py", "span_log.py"} <= names
    for f in files:
        for mod in _imports(f):
            root = mod.split(".")[0]
            assert root not in BANNED, f"{f.relative_to(REPO)} imports {mod}"


def test_native_estimator_builds_from_the_ports_sources(monkeypatch):
    """The port's native estimator resolves its C++ sources under
    roma_torch/native/ (never the JAX side's native/) and builds into the
    repository's build/native/."""
    from roma_torch.estimation import native

    assert native.NATIVE_DIR == REPO / "roma_torch" / "native"
    assert {"ransac.cpp", "linalg.h", "Makefile"} <= {p.name for p in native.NATIVE_DIR.iterdir()}
    assert native.LIB_PATH == REPO / "build" / "native" / "libransac.so"
    runs = []
    monkeypatch.setattr(native.subprocess, "run", lambda cmd, **kw: runs.append(cmd))
    native._build()
    assert runs == [["make", "-C", str(REPO / "roma_torch" / "native"),
                     f"OUT={REPO / 'build' / 'native'}"]]


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

    assert set(runtime.SOURCES) == {"local_corr", "dw_chain", "flash_attn", "corr_softmax",
                                    "windowed_sample", "dw_affine_relu", "dw_block_mm",
                                    "flash_attn_bwd", "kde"}
    # one counter a kernel: flash_attn_bwd.cu holds K8 and K9
    assert set(LAUNCHES) == set(runtime.SOURCES) - {"flash_attn_bwd"} | {
        "flash_attn_dkv", "flash_attn_dq"}
    for name, src in runtime.SOURCES.items():
        assert (runtime.CSRC / src).exists()
        p = runtime.lib_path(name)
        assert p.parent == REPO / "build" / "kernels"
        assert p.name.startswith(f"libroma_{name}-")
    assert "arch=compute_90a,code=sm_90a" in runtime.NVCC_FLAGS
    LAUNCHES["local_corr"] = 3
    reset_launches()
    assert set(LAUNCHES.values()) == {0}


@pytest.mark.parametrize("header", ["common.cuh", "hopper.cuh", "attn_simple.cuh",
                                    "dw_block_f32.cuh"])
def test_kernel_names_change_with_any_header(tmp_path, monkeypatch, header):
    """A one-byte edit of any shared header renames every kernel's library,
    so no stale build is loaded; so does a change of the compiler flags."""
    import shutil

    from roma_torch.kernels import runtime

    csrc = tmp_path / "csrc"
    shutil.copytree(runtime.CSRC, csrc)
    monkeypatch.setattr(runtime, "CSRC", csrc)
    before = {name: runtime.lib_path(name) for name in runtime.SOURCES}
    path = csrc / header
    data = bytearray(path.read_bytes())
    data[-1] ^= 1
    path.write_bytes(bytes(data))
    after = {name: runtime.lib_path(name) for name in runtime.SOURCES}
    assert all(after[name] != before[name] for name in runtime.SOURCES)
    monkeypatch.setattr(runtime, "NVCC_FLAGS", [*runtime.NVCC_FLAGS, "-DROMA_TEST"])
    assert all(runtime.lib_path(name) != after[name] for name in runtime.SOURCES)


@pytest.mark.parametrize("mode", [False, True, "exact", "fast"])
def test_smooth_warp_gather_reaches_the_scale1_refiner(mode):
    """`roma_outdoor(smooth_warp_gather=...)` builds (no longer raises) and
    hands the mode to every refiner, as the JAX zoo and matcher do; only the
    scale-1 refiner's 9-channel warp passes the windowed gather's C <= 16
    gate."""
    cfg = dataclasses.replace(tzoo.debug_roma_config(), smooth_warp_gather=mode)
    m = tzoo.roma_outdoor(cfg=cfg, device="cpu")
    assert m.cfg.smooth_warp_gather == mode
    assert {r.smooth_warp for r in m.model.decoder.conv_refiner.values()} == {mode}
    assert _asdict(tcfg.RomaConfig(smooth_warp_gather=mode)) == _asdict(
        jcfg.RomaConfig(smooth_warp_gather=mode))
    for fn in (tzoo.roma_outdoor, jzoo.roma_outdoor):
        assert inspect.signature(fn).parameters["smooth_warp_gather"].default is False
