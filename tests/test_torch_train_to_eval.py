"""Train -> eval loop closure through the port, the counterpart of
tests/test_train_to_eval.py: Tiny RoMa trained on the rendered textured
two-plane world must drive the port's Mega-1500 harness (match -> balanced
sampling -> RANSAC -> AUC) to AUC@5 > 0.5, and 0.3 above the untrained
model's. `chip_smoke.train_to_eval` runs it (on the card in chip_smoke.py;
on the CPU here, where it is slow). The world is the JAX test's, pixel for
pixel (`test_rendered_world_is_the_jax_tests`, not slow); the exact warps
between its cameras drive the harness engine to AUC@5 > 0.9."""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_train_to_eval as jax_t2e


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
    """C9: `flax_conv_init_`, from which train -> eval starts Tiny RoMa,
    draws the convolutions as flax's `nn.Conv` default draws JAX's
    TinyRoma: weights of variance 1 / fan_in truncated at two standard
    deviations of the untruncated normal, zero biases. Standard deviations
    within 5% on every tensor of at least 4096 weights, on both sides."""
    import jax
    import jax.numpy as jnp

    from roma_torch.config import TinyRomaConfig
    from roma_torch.models.layers import flax_conv_init_
    from roma_torch.models.port import tiny_state_dict_from_jax
    from roma_torch.models.zoo import build_model
    from roma_tpu.config import TinyRomaConfig as JaxTinyRomaConfig
    from roma_tpu.models.tiny_roma import TinyRoma as JaxTinyRoma

    kw = dict(match_dim=64, fine_match_dim=32, dtype="float32")
    x = jnp.zeros((1, 64, 64, 3))
    variables = JaxTinyRoma(JaxTinyRomaConfig(**kw)).init(jax.random.PRNGKey(0), x, x, train=False)
    ref = tiny_state_dict_from_jax(jax.tree_util.tree_map(np.array, dict(variables)))
    torch.manual_seed(0)
    got = flax_conv_init_(build_model(TinyRomaConfig(**kw), seed=0)).state_dict()
    assert set(got) == set(ref)
    for k, r in ref.items():
        for w in (got[k], r):
            if k.endswith("bias"):
                assert not w.any(), k
            elif w.ndim == 4:
                nominal = (1.0 / w[0].numel()) ** 0.5
                assert w.abs().max() <= 2 * nominal / 0.87962566103423978 * (1 + 1e-6), k
                if w.numel() >= 4096:
                    assert abs(float(w.std()) / nominal - 1) < 0.05, k


@pytest.mark.slow
def test_trained_tiny_reaches_auc_through_the_ports_harness(tmp_path):
    torch.set_num_threads(8)
    res = cs.train_to_eval("cpu", tmp_path)
    cs.check_train_to_eval(res)  # raises SmokeFailure below the JAX test's gates
    assert res["auc"]["auc_5"] > 0.5
    assert res["auc"]["auc_5"] > res["auc_init"]["auc_5"] + 0.3
