"""The port's harnesses (roma_torch.benchmarks) on synthetic scenes with
exact geometry, against the JAX package's harnesses.

- Oracles in torch tensors (tests/test_benchmarks.py's two-plane warps)
  drive Mega-1500, ScanNet and HPatches to the JAX tests' thresholds; the
  dense harness's EPE/PCK equal JAX's on the same warp.
- Port against JAX, error for error: oracles whose sampling ignores the
  key or generator give the same per-repetition errors (1e-6 degrees, HPatches
  1e-6 of a normalized pixel) with the numpy and native backends, so any
  difference is harness plumbing.
- The engine: batched equals serial; device_resize equals host resize with
  the port's own RomaMatcher resize machinery, each batch padded to its own
  largest image; the union of the shards draws what the full run draws;
  every item is loaded exactly once.
- The whole slice: the debug-size full RoMa in float32 through the batched
  MegaDepth harness, and the keypoints it hands the estimator equal to
  JAX's from the same weights (1e-4 px) when both sample the same indices.

Two torch threads: the test workers share the machine's cores."""

import dataclasses
import os
import threading

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from roma_torch.benchmarks import harness_core
from roma_torch.benchmarks.hpatches import HpatchesHomogBenchmark
from roma_torch.benchmarks.megadepth_pose import (MegaDepthPoseEstimationBenchmark,
                                                  summarize_pose_errors)
from roma_torch.benchmarks.scannet import ScanNetBenchmark
from roma_torch.config import RomaConfig
from roma_torch.models.matcher import RomaMatcher
from roma_torch.utils.geometry import normalized_to_pixel
from roma_torch.utils.sampling import sample_matches
from tests.test_benchmarks import (IMG_H, IMG_W, OracleMatcher, hpatches_dir,  # noqa: F401
                                   make_K, make_pose, mega_scene_dir, scannet_dir,
                                   two_plane_homographies)

ERR_TOL = 1e-6  # degrees (pose) / normalized pixels (HPatches)


@pytest.fixture(autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


class TorchOracle(OracleMatcher):
    """tests/test_benchmarks.py's exact two-plane warps, as torch tensors,
    sampled by the port's balanced sampler with the harness's generator.
    Records every sample it hands out, in call order."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.samples = []

    def match(self, im_a, im_b, batched=False):
        warp, cert = super().match(im_a, im_b, batched)
        return torch.from_numpy(np.array(warp)), torch.from_numpy(np.array(cert))

    def sample(self, warp, certainty, num=5000, generator=None):
        out = sample_matches(warp, certainty, num=num, sample_thresh=self.sample_thresh,
                             generator=generator)
        self.samples.append(out[0].numpy().copy())
        return out

    def to_pixel_coordinates(self, coords, h, w, h2=None, w2=None):
        if coords.shape[-1] == 2:
            return normalized_to_pixel(coords, h, w)
        return normalized_to_pixel(coords[..., :2], h, w), normalized_to_pixel(coords[..., 2:], h2, w2)


def fixed_indices(certainty, num):
    """The same draw on both sides: `num` indices of the certain pixels
    from a generator seeded by nothing but 0."""
    valid = np.flatnonzero(np.asarray(certainty).reshape(-1) > 0.05)
    return valid[np.random.default_rng(0).choice(len(valid), min(num, len(valid)), replace=False)]


class KeylessTorch(TorchOracle):
    def sample(self, warp, certainty, num=5000, generator=None):
        idx = torch.from_numpy(fixed_indices(certainty, num))
        return warp.reshape(-1, 4)[idx], certainty.reshape(-1)[idx]


class KeylessJax(OracleMatcher):
    def sample(self, warp, certainty, num=5000, key=None):
        idx = fixed_indices(certainty, num)
        return jnp.asarray(np.asarray(warp).reshape(-1, 4)[idx]), None


class FastOracle(TorchOracle):
    """TorchOracle wearing the port's RomaMatcher raw-upload machinery
    (build_resize_banks / _prep_raw_impl / match_raw / sample_batched are
    RomaMatcher's own, run on the CPU at small resolutions); records the
    canvases match_raw receives and the bank rows built."""

    host_resize_np = staticmethod(RomaMatcher.host_resize_np)
    _to_device = RomaMatcher._to_device
    _prep_raw_impl = staticmethod(RomaMatcher._prep_raw_impl)
    match_raw = RomaMatcher.match_raw
    sample_batched = RomaMatcher.sample_batched

    def __init__(self, homs):
        super().__init__(homs)
        self.device = torch.device("cpu")
        self.cfg = RomaConfig(coarse_resolution=(56, 56), upsample_resolution=(112, 112))
        self.canvases, self.rows_built = [], []

    def build_resize_banks(self, sizes, bucket):
        self.rows_built += [(s, bucket) for s in sizes]
        return RomaMatcher.build_resize_banks(self, sizes, bucket)

    def match_prepped(self, a, b, a2=None, b2=None):
        assert tuple(a2.shape[1:3]) == tuple(self.cfg.upsample_resolution)
        assert tuple(a.shape[1:3]) == tuple(self.cfg.coarse_resolution)
        outs = [self.match(None, None) for _ in range(a.shape[0])]
        return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


class RecordingFastOracle(FastOracle):
    def match_raw(self, raw, idx, banks):
        self.canvases.append(tuple(raw.shape))
        return RomaMatcher.match_raw(self, raw, idx, banks)


def _homs(n=3):
    return [two_plane_homographies(i) for i in range(n)]


def _mega(root, **kw):
    return MegaDepthPoseEstimationBenchmark(data_root=str(root), scene_names=["scene.npz"],
                                            **{"num_ransac_runs": 2, "sample_num": 1000, **kw})


# ---------------------------------------------------------------------------
# oracle AUCs (the JAX tests' thresholds)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [1, 2])
def test_megadepth_pose_oracle(mega_scene_dir, batch_size):
    res = _mega(mega_scene_dir, pose_backend="native", batch_size=batch_size,
                workers=2).benchmark(TorchOracle(_homs()))
    assert res["auc_5"] > 0.9, res
    assert res["map_5"] == 1.0


def test_megadepth_pose_garbage_matcher(mega_scene_dir):
    res = _mega(mega_scene_dir, pose_backend="numpy", num_ransac_runs=1,
                sample_num=500).benchmark(TorchOracle([(np.eye(3), np.eye(3))] * 3))
    assert res["auc_5"] < 0.5


def test_scannet_oracle_auc_and_corrupted(scannet_dir):
    pairs = _homs()
    order = np.random.default_rng(0).permutation(3)
    kw = dict(data_root=str(scannet_dir), num_ransac_runs=2, sample_num=1000,
              pose_backend="native")
    res = ScanNetBenchmark(**kw).benchmark(
        TorchOracle([pairs[j] for j in order], pixel_offset=0.5))
    assert res["auc_5"] > 0.9, res
    res = ScanNetBenchmark(**kw).benchmark(TorchOracle(pairs * 2, noise=0.04, pixel_offset=0.5))
    assert res["auc_5"] < 0.75, res


@pytest.mark.parametrize("backend", ["cv2", "numpy"])
def test_hpatches_oracle_auc(hpatches_dir, backend):
    if backend == "cv2":
        pytest.importorskip("cv2")
    root, Hs = hpatches_dir
    res = HpatchesHomogBenchmark(str(root), homography_backend=backend, sample_num=500
                                 ).benchmark(TorchOracle([(H, H) for H in Hs], pixel_offset=0.5))
    assert res["hpatches_homog_auc_3"] > 0.9, res


def test_hpatches_corrupted_oracle_fails(hpatches_dir):
    root, Hs = hpatches_dir
    res = HpatchesHomogBenchmark(str(root), sample_num=1500
                                 ).benchmark(TorchOracle([(H, H) for H in Hs], noise=0.05,
                                                         pixel_offset=0.5))
    assert res["hpatches_homog_auc_3"] < 0.75, res


def test_dense_geometric_dist_equals_jax(mega_scene_dir):
    """The dense harness's EPE/PCK through the port's get_gt_warp and
    datasets against JAX's on the same batch and warp (float32 GT warps:
    1e-5 relative), and the whole benchmark's keys on an oracle."""
    from roma_torch.benchmarks.dense import MegadepthDenseBenchmark
    from roma_tpu.benchmarks.dense import MegadepthDenseBenchmark as JDense

    kw = dict(data_root=str(mega_scene_dir), h=IMG_H // 2, w=IMG_W // 2, num_samples=2,
              batch_size=2)
    port, ref = MegadepthDenseBenchmark(**kw), JDense(**kw)
    batch = {k: np.stack([port.dataset[i][k] for i in (0, 1)]) for k in port.dataset[0]}
    jbatch = {k: np.stack([np.asarray(ref.dataset[i][k]) for i in (0, 1)]) for k in batch}
    for k in batch:
        np.testing.assert_array_equal(batch[k], jbatch[k])
    oracle = OracleMatcher([two_plane_homographies(0)], out_hw=(IMG_H // 2, IMG_W // 2))
    warp = np.stack([np.asarray(oracle.match(None, None)[0]) for _ in range(2)])
    args = [batch[k] for k in ("im_A_depth", "im_B_depth", "T_1to2", "K1", "K2")]
    np.testing.assert_allclose(port.geometric_dist(*args, warp), ref.geometric_dist(*args, warp),
                               rtol=1e-5, atol=1e-6)

    class DenseOracle:
        def match(self, im_a, im_b, batched=True):
            assert torch.is_tensor(im_a) and im_a.shape[0] == 2
            return torch.from_numpy(warp), torch.ones(warp.shape[:3])

    res = port.benchmark(DenseOracle())
    assert set(res) == {"epe", "mega_pck_1", "mega_pck_3", "mega_pck_5"}
    assert all(np.isfinite(v) for v in res.values())


# ---------------------------------------------------------------------------
# port against JAX, error for error
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("batch_size", [1, 2])
def test_megadepth_errors_equal_jax(mega_scene_dir, backend, batch_size):
    from roma_tpu.benchmarks.megadepth_pose import MegaDepthPoseEstimationBenchmark as JMega

    kw = dict(data_root=str(mega_scene_dir), scene_names=["scene.npz"], num_ransac_runs=2,
              sample_num=1000, pose_backend=backend, batch_size=batch_size, workers=2)
    got = MegaDepthPoseEstimationBenchmark(**kw).collect_errors(KeylessTorch(_homs()))
    ref = JMega(**kw).collect_errors(KeylessJax(_homs()))
    assert len(got) == len(ref) == 6
    np.testing.assert_allclose(got, ref, rtol=0, atol=ERR_TOL)


@pytest.mark.parametrize("backend", ["numpy", "native"])
def test_scannet_errors_equal_jax(scannet_dir, backend):
    from roma_tpu.benchmarks.scannet import ScanNetBenchmark as JScanNet

    pairs = _homs()
    order = np.random.default_rng(0).permutation(3)
    homs = [pairs[j] for j in order]
    kw = dict(data_root=str(scannet_dir), num_ransac_runs=2, sample_num=1500,
              pose_backend=backend, batch_size=2, workers=2)
    got = ScanNetBenchmark(**kw).collect_errors(KeylessTorch(homs, pixel_offset=0.5))
    ref = JScanNet(**kw).collect_errors(KeylessJax(homs, pixel_offset=0.5))
    assert len(got) == len(ref) == 6
    np.testing.assert_allclose(got, ref, rtol=0, atol=ERR_TOL)


def test_hpatches_dists_equal_jax(hpatches_dir):
    from roma_tpu.benchmarks.hpatches import HpatchesHomogBenchmark as JHpatches

    root, Hs = hpatches_dir
    homs = [(H, H) for H in Hs]
    kw = dict(homography_backend="numpy", sample_num=500, batch_size=2, workers=2)
    got = HpatchesHomogBenchmark(str(root), **kw).collect_dists(KeylessTorch(homs, pixel_offset=0.5))
    ref = JHpatches(str(root), **kw).collect_dists(KeylessJax(homs, pixel_offset=0.5))
    assert len(got) == len(ref) == 5
    np.testing.assert_allclose(got, ref, rtol=0, atol=ERR_TOL)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def test_batched_equals_serial(mega_scene_dir, scannet_dir, hpatches_dir):
    """Per-pair generators and main-thread shuffles: the batched schedule
    (partial final batch included) draws and scores exactly as the serial
    loop, in all three pose/homography harnesses."""
    kw = dict(pose_backend="numpy")
    serial = _mega(mega_scene_dir, **kw).collect_errors(TorchOracle(_homs()))
    batched = _mega(mega_scene_dir, **kw, batch_size=2, workers=2).collect_errors(
        TorchOracle(_homs()))
    np.testing.assert_array_equal(batched, serial)

    order = np.random.default_rng(0).permutation(3)
    homs = [_homs()[j] for j in order]
    skw = dict(data_root=str(scannet_dir), num_ransac_runs=2, sample_num=1500, **kw)
    serial = ScanNetBenchmark(**skw).collect_errors(TorchOracle(homs, pixel_offset=0.5))
    batched = ScanNetBenchmark(**skw, batch_size=2, workers=2).collect_errors(
        TorchOracle(homs, pixel_offset=0.5))
    np.testing.assert_array_equal(batched, serial)

    root, Hs = hpatches_dir
    hkw = dict(homography_backend="numpy", sample_num=500)
    serial = HpatchesHomogBenchmark(str(root), **hkw).collect_dists(
        TorchOracle([(H, H) for H in Hs], pixel_offset=0.5))
    batched = HpatchesHomogBenchmark(str(root), **hkw, batch_size=2, workers=2).collect_dists(
        TorchOracle([(H, H) for H in Hs], pixel_offset=0.5))
    np.testing.assert_array_equal(batched, serial)


MIXED_SIZES = [(240, 320), (200, 300), (240, 320), (180, 330), (200, 300)]


@pytest.fixture(scope="module")
def mixed_scene_dir(tmp_path_factory):
    """A MegaDepth-layout scene whose images come in three sizes, with 7
    pairs over them (a pair list longer than the loader's look-ahead)."""
    root = tmp_path_factory.mktemp("mixed")
    os.makedirs(root / "images")
    rng = np.random.default_rng(2)
    paths = []
    for i, (h, w) in enumerate(MIXED_SIZES):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / f"images/m_{i}.png")
        paths.append(f"images/m_{i}.png")
    pairs = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 2), (1, 3), (4, 0)]
    np.savez(root / "scene.npz",
             pair_infos=np.array([[p, 0.5] for p in pairs], dtype=object),
             intrinsics=np.array([make_K()] * len(MIXED_SIZES)),
             poses=np.array([make_pose(i) for i in range(len(MIXED_SIZES))]),
             image_paths=np.array(paths))
    return root, pairs


def test_device_resize_equals_host_resize(mixed_scene_dir):
    """device_resize=True (original-resolution uint8 canvases + the matrix
    resize of the port's RomaMatcher) drives the same protocol as the
    host-resize batched path: same errors. Each batch's canvas is its own
    largest height and width, and each (size, canvas) bank row is built
    once."""
    root, pairs = mixed_scene_dir
    homs = _homs(len(pairs))
    kw = dict(pose_backend="numpy", batch_size=2, workers=2)
    e_host = _mega(root, **kw).collect_errors(FastOracle(homs))
    oracle = RecordingFastOracle(homs)
    e_dev = _mega(root, **kw, device_resize=True).collect_errors(oracle)
    np.testing.assert_allclose(e_dev, e_host, rtol=0, atol=ERR_TOL)
    assert len(e_dev) == 2 * len(pairs)
    expected = []
    for s in range(0, len(pairs), 2):
        ims = [i for p in pairs[s:s + 2] for i in p]
        hw = [MIXED_SIZES[i] for i in ims]
        expected.append((len(ims), max(h for h, _ in hw), max(w for _, w in hw), 3))
    assert oracle.canvases == expected
    assert len(oracle.rows_built) == len(set(oracle.rows_built))


def test_raw_batches_resize_as_pil(mixed_scene_dir):
    """The real resize behind device_resize: each image of a batch, padded
    into the batch's canvas, comes out of RomaMatcher's matrix resize
    within one uint8 level of PIL's bicubic resize of the image alone."""
    root, pairs = mixed_scene_dir
    oracle = FastOracle(_homs())
    seen = []

    def prepped(a, b, a2=None, b2=None):
        seen.append((a, a2))
        return FastOracle.match_prepped(oracle, a, b, a2, b2)

    oracle.match_prepped = prepped
    _mega(root, pose_backend="numpy", batch_size=2, workers=2, device_resize=True,
          num_ransac_runs=1).collect_errors(oracle)
    from roma_torch.models.matcher import IMAGENET_MEAN, IMAGENET_STD

    a, a2 = seen[0]
    for j, i in enumerate(p[0] for p in pairs[:2]):
        im = Image.open(root / f"images/m_{i}.png")
        for got, hw in ((a[j], (56, 56)), (a2[j], (112, 112))):
            u8 = (got.numpy() * IMAGENET_STD + IMAGENET_MEAN) * 255
            ref = RomaMatcher.host_resize_np(im, *hw).astype(np.float32)
            assert np.abs(u8 - ref).max() <= 1.0 + 1e-3


def test_shards_draw_what_the_full_run_draws(mega_scene_dir):
    """Port of tests/test_distributed_eval.py: the union of two shards
    covers the full run's pairs, each pair sampled exactly as in the full
    run (generators seeded by the pair's global index), and the union's
    summary equals the full run's."""

    def run(shard, batch_size):
        homs = [h for i, h in enumerate(_homs()) if i % shard[1] == shard[0]]
        oracle = TorchOracle(homs)
        errs = _mega(mega_scene_dir, pose_backend="numpy", num_ransac_runs=1, sample_num=500,
                     shard=shard, batch_size=batch_size, workers=2).collect_errors(oracle)
        return errs, oracle.samples

    full, full_samples = run((0, 1), 1)
    (e0, s0), (e1, s1) = run((0, 2), 2), run((1, 2), 1)
    assert len(full) == len(e0) + len(e1) == 3
    for got, ref in zip(s0 + s1, [full_samples[0], full_samples[2], full_samples[1]]):
        np.testing.assert_array_equal(got, ref)
    s_full = summarize_pose_errors(np.asarray(sorted(full)))
    s_merged = summarize_pose_errors(np.asarray(sorted(e0 + e1)))
    np.testing.assert_allclose(s_full["auc_20"], s_merged["auc_20"], atol=0.05)
    assert all(e < 5 for e in e0 + e1)


@pytest.mark.parametrize("oracle_cls,device_resize", [(TorchOracle, False), (FastOracle, False),
                                                      (FastOracle, True)])
def test_every_item_loads_once(mixed_scene_dir, monkeypatch, oracle_cls, device_resize):
    """The loader pool is fed from a watermark: with 7 pairs in batches of
    2 (look-ahead 2 batches), each pair's two images are opened once per
    pair, never again."""
    root, pairs = mixed_scene_dir
    opened: dict[str, int] = {}
    lock = threading.Lock()
    real = harness_core.open_rgb

    def counting(path):
        with lock:
            opened[os.path.basename(path)] = opened.get(os.path.basename(path), 0) + 1
        return real(path)

    monkeypatch.setattr(harness_core, "open_rgb", counting)
    errs = _mega(root, pose_backend="numpy", num_ransac_runs=1, sample_num=300, batch_size=2,
                 workers=3, device_resize=device_resize).collect_errors(oracle_cls(_homs(7)))
    assert len(errs) == len(pairs)
    expected: dict[str, int] = {}
    for p in pairs:
        for i in p:
            expected[f"m_{i}.png"] = expected.get(f"m_{i}.png", 0) + 1
    assert opened == expected


def test_pair_generators_are_per_global_index():
    a = harness_core.pair_generator(0, 5, "cpu")
    b = harness_core.pair_generator(0, 5, "cpu")
    c = harness_core.pair_generator(0, 6, "cpu")
    d = harness_core.pair_generator(1, 5, "cpu")
    x, y, z, w = (torch.rand(4, generator=g) for g in (a, b, c, d))
    assert torch.equal(x, y) and not torch.equal(x, z) and not torch.equal(x, w)


# ---------------------------------------------------------------------------
# the whole slice: debug-size full RoMa, float32, through the harness
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def debug_matchers():
    from roma_tpu.models.matcher import RomaMatcher as JMatcher
    from roma_tpu.models.zoo import debug_roma_config as j_debug_config
    from roma_torch.models.matcher import RomaModel
    from roma_torch.models.port import state_dict_from_jax
    from roma_torch.models.zoo import debug_roma_config

    jm = JMatcher.init(jax.random.PRNGKey(0), dataclasses.replace(j_debug_config(), dtype="float32"))
    variables = jax.tree_util.tree_map(np.asarray, jm.params)
    model = RomaModel(dataclasses.replace(debug_roma_config(), dtype="float32"))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jm, RomaMatcher(model, device="cpu")


class FixedSampling:
    """A matcher with its batched sampling replaced by fixed indices into
    each warp (the same on the JAX and the port side)."""

    def __init__(self, inner, num):
        self._inner, self._num = inner, num

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def sample_batched(self, warps, certs, num, keys):
        w = np.asarray(warps).reshape(len(warps), -1, 4)
        idx = np.random.default_rng(0).choice(w.shape[1], self._num, replace=False)
        return (torch.from_numpy(w[:, idx]) if torch.is_tensor(warps)
                else jnp.asarray(w[:, idx])), None


def _recording(bench):
    kpts = []
    inner = bench.estimate_pose

    def record(k1, k2, K1, K2, thr):
        kpts.append((np.array(k1), np.array(k2)))
        return inner(k1, k2, K1, K2, thr)

    bench.estimate_pose = record
    return kpts


def test_debug_roma_through_the_mega_harness(mega_scene_dir, debug_matchers):
    """The port's debug_roma_config() model in float32 on the CPU through
    the batched MegaDepth harness (its own balanced sampling with per-pair
    generators, device resize): finite errors, one a pair and repetition.
    Then JAX's and the port's harness with the same weights and the same
    sampled indices: the keypoints handed to the estimator agree within
    1e-4 px plus two float32 ulps of the coordinate (both harnesses convert
    float32 matches to pixels of a 1200-px frame, where one ulp is up to
    1.2e-4 px)."""
    from roma_tpu.benchmarks.megadepth_pose import MegaDepthPoseEstimationBenchmark as JMega

    jm, tm = debug_matchers
    errs = _mega(mega_scene_dir, pose_backend="native", batch_size=3, workers=2,
                 device_resize=True, sample_num=500, num_ransac_runs=1).collect_errors(tm)
    assert len(errs) == 3 and np.isfinite(errs).all()

    kw = dict(data_root=str(mega_scene_dir), scene_names=["scene.npz"], num_ransac_runs=1,
              sample_num=400, pose_backend="numpy", batch_size=3, workers=1)
    port, ref = MegaDepthPoseEstimationBenchmark(**kw), JMega(**kw)
    got_k, ref_k = _recording(port), _recording(ref)
    errs = port.collect_errors(FixedSampling(tm, 400))
    ref.collect_errors(FixedSampling(jm, 400))
    assert len(errs) == 3 and np.isfinite(errs).all()
    assert len(got_k) == len(ref_k) == 3
    for (g1, g2), (r1, r2) in zip(got_k, ref_k):
        assert g1.shape == (400, 2) and g1.dtype == r1.dtype == np.float32
        np.testing.assert_allclose(g1, r1, rtol=2 * 2.0 ** -23, atol=1e-4)
        np.testing.assert_allclose(g2, r2, rtol=2 * 2.0 ** -23, atol=1e-4)
