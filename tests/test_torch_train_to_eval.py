"""Train -> eval loop closure through the port, the counterpart of
tests/test_train_to_eval.py: Tiny RoMa trained on the rendered textured
two-plane world must drive the port's Mega-1500 harness (match -> balanced
sampling -> RANSAC -> AUC) to AUC@5 > 0.5, and 0.3 above the untrained
model's. `chip_smoke.train_to_eval` runs it (on the card in chip_smoke.py;
on the CPU here, where it is slow). The world is the JAX test's, pixel for
pixel (`test_rendered_world_is_the_jax_tests`, not slow); the exact warps
between its cameras drive the harness engine to AUC@5 > 0.9."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_train_to_eval as jax_t2e

# ROADMAP C10: the full-RoMa tensor groups whose default init is not JAX's
C10_GROUPS = {
    "encoder.cnn.layers.*.weight",
    "encoder.cnn.layers.*.bias",
    "encoder.dinov2.patch_embed.proj.weight",
    "encoder.dinov2.patch_embed.proj.bias",
    "encoder.dinov2.blocks.*.attn.qkv.weight",
    "encoder.dinov2.blocks.*.attn.qkv.bias",
    "encoder.dinov2.blocks.*.attn.proj.weight",
    "encoder.dinov2.blocks.*.attn.proj.bias",
    "encoder.dinov2.blocks.*.mlp.fc1.weight",
    "encoder.dinov2.blocks.*.mlp.fc1.bias",
    "encoder.dinov2.blocks.*.mlp.fc2.weight",
    "encoder.dinov2.blocks.*.mlp.fc2.bias",
    "decoder.embedding_decoder.blocks.*.attn.qkv.weight",
    "decoder.embedding_decoder.blocks.*.attn.proj.weight",
    "decoder.embedding_decoder.blocks.*.attn.proj.bias",
    "decoder.embedding_decoder.blocks.*.mlp.fc1.weight",
    "decoder.embedding_decoder.blocks.*.mlp.fc1.bias",
    "decoder.embedding_decoder.blocks.*.mlp.fc2.weight",
    "decoder.embedding_decoder.blocks.*.mlp.fc2.bias",
    "decoder.embedding_decoder.to_out.weight",
    "decoder.embedding_decoder.to_out.bias",
    "decoder.gps.*.pos_conv.weight",
    "decoder.gps.*.pos_conv.bias",
    "decoder.proj.*.0.weight",
    "decoder.proj.*.0.bias",
    "decoder.conv_refiner.*.disp_emb.bias",
    "decoder.conv_refiner.*.block1.*.weight",
    "decoder.conv_refiner.*.block1.*.bias",
    "decoder.conv_refiner.*.hidden_blocks.*.0.weight",
    "decoder.conv_refiner.*.hidden_blocks.*.0.bias",
    "decoder.conv_refiner.*.hidden_blocks.*.3.weight",
    "decoder.conv_refiner.*.hidden_blocks.*.3.bias",
    "decoder.conv_refiner.*.out_conv.bias",
    "decoder.conv_refiner.*.out_conv.weight",
}


def test_rendered_world_is_the_jax_tests(tmp_path):
    """chip_smoke's renderer (any size) at the JAX test's 96x128 equals the
    JAX test's renderer bit for bit: images, depths, poses, intrinsics."""
    world = cs.write_two_plane_scene(tmp_path, range(jax_t2e.N_CAMS),
                                     [(jax_t2e.H, jax_t2e.W)] * jax_t2e.N_CAMS)
    rng = np.random.default_rng(3)
    tex_near, tex_far = jax_t2e._smooth_texture(rng), jax_t2e._smooth_texture(rng)
    K = np.array([[jax_t2e.FX, 0, jax_t2e.W / 2], [0, jax_t2e.FX, jax_t2e.H / 2], [0, 0, 1.0]])
    for i in range(jax_t2e.N_CAMS):
        img, depth = jax_t2e._render(jax_t2e._pose(i), K, tex_near, tex_far)
        np.testing.assert_array_equal(world["imgs"][i], img)
        np.testing.assert_array_equal(world["depths"][i], depth)
        np.testing.assert_array_equal(world["poses"][i], jax_t2e._pose(i))
        np.testing.assert_array_equal(world["Ks"][i], K)


def test_exact_warps_drive_the_engine(tmp_path):
    """chip_smoke's oracle phase at a small size on the CPU: the exact
    warps between rendered cameras of two sizes (48x64 and 72x96), through
    the batched engine with the port's device resize: AUC@5 > 0.9, every
    pair matched once."""
    from roma_torch.benchmarks.megadepth_pose import MegaDepthPoseEstimationBenchmark

    torch.set_num_threads(2)
    world = cs.write_two_plane_scene(tmp_path, range(-2, 3), [(48, 64), (72, 96)] * 2 + [(48, 64)])
    exact = [cs.two_plane_warp(world["poses"][i], world["poses"][i + 1]) for i in range(4)]
    oracle = cs.EngineOracle([w for w, _ in exact], [c for _, c in exact], "cpu")
    oracle.cfg = dataclasses.replace(oracle.cfg, coarse_resolution=(28, 28),
                                     upsample_resolution=(56, 56))
    res = MegaDepthPoseEstimationBenchmark(
        data_root=str(tmp_path), scene_names=["scene.npz"], pose_backend="native",
        sample_num=1000, num_ransac_runs=1, batch_size=3, workers=2, device_resize=True,
    ).benchmark(oracle)
    assert oracle.next == 4
    assert res["auc_5"] > 0.9, res


def test_sync_gate_counts_only_the_harness_main_thread():
    """chip_smoke's gate on the eval's host syncs: `record_sync` keys a
    call by its innermost repository line and, off the main thread, the
    thread's name; the gate keeps the harness's main-thread keys only."""
    import threading

    syncs: dict[str, int] = {}

    def warn():  # stands for the warnings machinery between the op and the hook
        cs.record_sync("called a synchronizing CUDA operation", syncs)

    warn()
    worker = threading.Thread(target=lambda: warn(), name="pool_0")
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert len(syncs) == 2 and all(k.startswith("tests/test_torch_train_to_eval.py:")
                                   for k in syncs)
    assert sum(k.endswith(" (pool_0)") for k in syncs) == 1
    fake = {"roma_torch/benchmarks/harness_core.py:300": 1,
            "roma_torch/benchmarks/megadepth_pose.py:150 (ThreadPoolExecutor-1_0)": 5,
            "roma_torch/models/gp.py:30": 4}
    assert cs.harness_main_thread_syncs(fake) == {"roma_torch/benchmarks/harness_core.py:300": 1}


def test_flax_conv_init_is_the_jax_packages():
    """C9: `build_model`'s default initialisation of Tiny RoMa is the JAX
    package's (flax's `nn.Conv` default, through `layers.flax_init_`), per
    tensor: exact zeros where JAX's init has zeros (biases, running means),
    exact ones where it has ones (running variances), and every weight
    drawn from a normal of variance 1 / fan_in truncated at two standard
    deviations of the untruncated normal: no value beyond the truncation,
    and the standard deviation within sampling error (five standard errors)
    of the nominal on both sides and of the JAX draw's. The weights are
    `flax_init_`'s draw after the seed, whatever the constructor drew
    before it."""
    import jax
    import jax.numpy as jnp

    from roma_torch.config import TinyRomaConfig
    from roma_torch.models.port import tiny_state_dict_from_jax
    from roma_torch.models.zoo import build_model
    from roma_tpu.config import TinyRomaConfig as JaxTinyRomaConfig
    from roma_tpu.models.tiny_roma import TinyRoma as JaxTinyRoma

    kw = dict(match_dim=64, fine_match_dim=32, dtype="float32")
    x = jnp.zeros((1, 64, 64, 3))
    variables = JaxTinyRoma(JaxTinyRomaConfig(**kw)).init(jax.random.PRNGKey(0), x, x, train=False)
    ref = tiny_state_dict_from_jax(jax.tree_util.tree_map(np.array, dict(variables)))
    got = build_model(TinyRomaConfig(**kw), seed=0).state_dict()
    assert set(got) == set(ref)
    n_weights = 0
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape and g.dtype == r.dtype, k
        if not r.is_floating_point():
            continue
        if not r.any():
            assert not g.any(), k
        elif bool((r == 1).all()):
            assert bool((g == 1).all()), k
        else:
            assert r.ndim == 4 and k.endswith("weight"), k
            n = r.numel()
            nominal = (1.0 / r[0].numel()) ** 0.5
            se = 5 * (1 / (2 * n)) ** 0.5
            for w in (g, r):
                assert w.abs().max() <= 2 * nominal / 0.87962566103423978 * (1 + 1e-6), k
                assert abs(float(w.std()) / nominal - 1) < se, k
            assert abs(float(g.std()) - float(r.std())) / nominal < 5 * (1 / n) ** 0.5, k
            n_weights += 1
    assert n_weights == sum(k.endswith("weight") and v.ndim == 4 for k, v in ref.items()) > 20

    from roma_torch.models.layers import flax_init_
    from roma_torch.models.tiny_roma import TinyRoma

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(123)  # another construction draw
        other = TinyRoma(TinyRomaConfig(**kw))
        torch.manual_seed(0)
        other = flax_init_(other).state_dict()
    assert all(torch.equal(other[k], got[k]) for k in got), "the init depends on construction"


def init_table(got: dict, ref: dict) -> dict:
    """Per tensor of two freshly initialised state dicts (the port's `got`,
    JAX's `ref`, same names): "zeros", "ones" or the ratio of the port's
    standard deviation to JAX's where they differ by more than sampling
    error (five standard errors); tensors that agree are left out. Names
    are grouped with their layer indices as "*"."""
    import re

    rows: dict = {}
    for k, r in ref.items():
        g = got[k]
        if not r.is_floating_point():
            continue
        kind = lambda t: "zeros" if not t.any() else "ones" if bool((t == 1).all()) else "random"  # noqa: E731
        kg, kr = kind(g), kind(r)
        if kg == kr == "random":
            ratio = float(g.float().std() / r.float().std())
            if abs(ratio - 1) <= 5 * (1 / r.numel()) ** 0.5 + 5 * (1 / (2 * r.numel())) ** 0.5:
                continue
            entry = "std"
        elif kg == kr:
            continue
        else:
            ratio, entry = None, f"{kg} (JAX {kr})"
        group = rows.setdefault(re.sub(r"\.\d+\.", ".*.", k), {})
        group.setdefault(entry, []).append(ratio)
    return {k: "; ".join(e if e != "std" else
                         f"std x{min(r):.3g}-{max(r):.3g} of JAX's ({len(r)} tensors)"
                         for e, r in v.items()) for k, v in rows.items()}


def full_roma_init_table() -> dict:
    """ROADMAP C10: the debug-size full RoMa's `build_model` init against
    the JAX package's `RomaMatcher.init` (same topology as the published
    model, shallow)."""
    import dataclasses

    import jax

    from roma_torch.models.port import state_dict_from_jax
    from roma_torch.models.zoo import build_model, debug_roma_config
    from roma_tpu.models.matcher import RomaMatcher as JaxRomaMatcher
    from roma_tpu.models.zoo import debug_roma_config as jax_debug_config

    jm = JaxRomaMatcher.init(jax.random.PRNGKey(0),
                             dataclasses.replace(jax_debug_config(), dtype="float32"))
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    got = build_model(dataclasses.replace(debug_roma_config(), dtype="float32"), 0).state_dict()
    assert set(got) == set(ref)
    return init_table(got, ref)


def test_full_roma_init_differs_as_c10_records():
    """C10 (open): full RoMa keeps PyTorch's module defaults, which differ
    from the JAX package's initialisers in these tensor groups (ROADMAP
    C10's table, printed by `PYTHONPATH=. python
    tests/test_torch_train_to_eval.py init-table`); Tiny RoMa's default
    differs in none (C9)."""
    table = full_roma_init_table()
    assert set(table) == C10_GROUPS, sorted(set(table) ^ C10_GROUPS)


@pytest.mark.slow
def test_trained_tiny_reaches_auc_through_the_ports_harness(tmp_path):
    torch.set_num_threads(8)
    res = cs.train_to_eval("cpu", tmp_path)
    cs.check_train_to_eval(res)  # raises SmokeFailure below the JAX test's gates
    assert res["auc"]["auc_5"] > 0.5
    assert res["auc"]["auc_5"] > res["auc_init"]["auc_5"] + 0.3


if __name__ == "__main__" and sys.argv[1:] == ["init-table"]:
    import json

    print(json.dumps(full_roma_init_table(), indent=1))
