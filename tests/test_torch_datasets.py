"""The port's datasets against the JAX package's, on a synthetic MegaDepth
layout (prep_scene_info .npy, JPEG images, h5 depths) and a synthetic ScanNet
training layout (scannet_indices .npz, scans/scans_train/<scene>/{color,
depth, pose, intrinsic}): scenes, items, `weighted_pair_iterator` batches
for host 0 and 1, `PairLoader` and the augmentations give arrays bit-equal
to the JAX package's for the same seed."""

import os

import cv2
import h5py
import numpy as np
import pytest
from PIL import Image

from roma_tpu.datasets import augment as jaug
from roma_tpu.datasets import loader as jloader
from roma_tpu.datasets.megadepth import MegadepthBuilder as JMega
from roma_tpu.datasets.scannet import ScanNetBuilder as JScan
from roma_torch.datasets import augment as taug
from roma_torch.datasets import loader as tloader
from roma_torch.datasets.megadepth import MegadepthBuilder as TMega
from roma_torch.datasets.scannet import ScanNetBuilder as TScan

IM_H, IM_W = 48, 64
MEGA_SCENES = ("0001.npy", "0002.npy")


def _pose(i: int) -> np.ndarray:
    a = np.deg2rad(3.0 * i)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = [0.4 * i, 0.02 * i, 0.0]
    return T


def _K() -> np.ndarray:
    return np.array([[60.0, 0, IM_W / 2], [0, 60.0, IM_H / 2], [0, 0, 1]])


def make_megadepth_layout(root, n_im: int = 4) -> str:
    """MegaDepth training layout: two scenes of `n_im` images (random JPEGs,
    h5 depths around 5 with a hole) and n_im - 1 pairs each."""
    rng = np.random.default_rng(0)
    os.makedirs(root / "images", exist_ok=True)
    os.makedirs(root / "prep_scene_info", exist_ok=True)
    for s, scene in enumerate(MEGA_SCENES):
        im_paths, depth_paths = [], []
        for i in range(n_im):
            p = f"images/s{s}_im_{i}.jpg"
            Image.fromarray(rng.uniform(0, 255, (IM_H, IM_W, 3)).astype(np.uint8)).save(root / p)
            dp = f"images/s{s}_depth_{i}.h5"
            depth = (5.0 + rng.uniform(-0.5, 0.5, (IM_H, IM_W))).astype(np.float32)
            depth[:4, :8] = 0.0
            with h5py.File(root / dp, "w") as f:
                f.create_dataset("depth", data=depth)
            im_paths.append(p)
            depth_paths.append(dp)
        info = {
            "image_paths": np.array(im_paths), "depth_paths": np.array(depth_paths),
            "intrinsics": np.array([_K()] * n_im), "poses": np.array([_pose(i) for i in range(n_im)]),
            "pairs": np.array([(i, i + 1) for i in range(n_im - 1)]),
            "overlaps": np.array([0.2, 0.5, 0.8][: n_im - 1]),
        }
        np.save(root / "prep_scene_info" / scene, info, allow_pickle=True)
    return str(root)


def make_scannet_layout(root, n_frames: int = 5) -> str:
    """ScanNet training layout: one index file over scene0000_00 with frames
    0, 10, ..., pairs of neighbours plus one pair off the every-10th grid
    (filtered out), JPEG colour, 16-bit depth PNGs in mm, cam2world poses."""
    rng = np.random.default_rng(1)
    scene_dir = root / "scans" / "scans_train" / "scene0000_00"
    for sub in ("color", "depth", "pose", "intrinsic"):
        os.makedirs(scene_dir / sub, exist_ok=True)
    K4 = np.eye(4)
    K4[:3, :3] = _K()
    np.savetxt(scene_dir / "intrinsic" / "intrinsic_color.txt", K4, delimiter=" ")
    stems = [10 * i for i in range(n_frames)]
    for i, stem in enumerate(stems):
        Image.fromarray(rng.uniform(0, 255, (IM_H, IM_W, 3)).astype(np.uint8)).save(
            scene_dir / "color" / f"{stem}.jpg")
        depth = (3000 + rng.integers(-200, 200, (IM_H, IM_W))).astype(np.uint16)
        cv2.imwrite(str(scene_dir / "depth" / f"{stem}.png"), depth)
        np.savetxt(scene_dir / "pose" / f"{stem}.txt", np.linalg.inv(_pose(i)))
    names = [[0, 0, a, b] for a, b in zip(stems[:-1], stems[1:])] + [[0, 0, 5, 15]]
    os.makedirs(root / "scannet_indices", exist_ok=True)
    np.savez(root / "scannet_indices" / "scene0000_00.npz", name=np.array(names),
             score=np.linspace(0.3, 0.7, len(names)))
    return str(root)


@pytest.fixture(scope="module")
def mega_root(tmp_path_factory):
    return make_megadepth_layout(tmp_path_factory.mktemp("megadepth"))


@pytest.fixture(scope="module")
def scannet_root(tmp_path_factory):
    return make_scannet_layout(tmp_path_factory.mktemp("scannet"))


def _equal_items(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


MEGA_KW = [
    dict(min_overlap=0.01),
    dict(min_overlap=0.35, shake_t=8, use_horizontal_flip_aug=True, normalize=True),
    dict(shake_t=4, colorjiggle_params={"brightness": 0.2, "hue": 0.05}),
]


@pytest.mark.parametrize("kw", MEGA_KW)
def test_megadepth_scenes_and_items(mega_root, kw):
    """Scenes (split, overlap filter) and every item of each, the scene
    generators consumed in the same order on both sides."""
    kw = dict(kw, ht=32, wt=40)
    j = JMega(data_root=mega_root).build_scenes(split="train_loftr", **kw)
    t = TMega(data_root=mega_root).build_scenes(split="train_loftr", **kw)
    assert [s.scene_name for s in t] == [s.scene_name for s in j] == list(MEGA_SCENES)
    assert [len(s) for s in t] == [len(s) for s in j]
    assert sum(len(s) for s in t) == (4 if kw.get("min_overlap") == 0.35 else 6)
    for js, ts in zip(j, t):
        for i in range(len(ts)):
            _equal_items(ts[i], js[i])
    np.testing.assert_array_equal(TMega.weight_scenes(t, 0.75), JMega.weight_scenes(j, 0.75))


def test_scannet_scenes_and_items(scannet_root):
    kw = dict(ht=32, wt=40, use_horizontal_flip_aug=True, normalize=True)
    j = JScan(data_root=scannet_root).build_scenes(**kw)
    t = TScan(data_root=scannet_root).build_scenes(**kw)
    assert [len(s) for s in t] == [len(s) for s in j] == [4]
    for i in range(4):
        _equal_items(t[0][i], j[0][i])
    np.testing.assert_array_equal(TScan.weight_scenes(t, 0.75), JScan.weight_scenes(j, 0.75))


@pytest.mark.parametrize("host_id", [0, 1])
def test_weighted_pair_iterator_batches(mega_root, host_id):
    """Three batches of 2 from each side's iterator over the two bands'
    scenes (shake and flip on), seed 3 and this host's stream; the port's
    `PairLoader` (four threads) hands out the same batches in order."""
    kw = dict(split="train_loftr", ht=32, wt=40, shake_t=8, use_horizontal_flip_aug=True)

    def scenes(builder):
        b = builder(data_root=mega_root)
        s = b.build_scenes(min_overlap=0.01, **kw) + b.build_scenes(min_overlap=0.35, **kw)
        return s, b.weight_scenes(s, alpha=0.75)

    jit = jloader.weighted_pair_iterator(*scenes(JMega), 2, seed=3, host_id=host_id)
    tit = tloader.weighted_pair_iterator(*scenes(TMega), 2, seed=3, host_id=host_id)
    lit = tloader.PairLoader(tloader.weighted_pair_iterator(*scenes(TMega), 2, seed=3,
                                                            host_id=host_id),
                             prefetch=2, num_threads=4)
    try:
        for _ in range(3):
            ref = next(jit)
            _equal_items(next(tit), ref)
            _equal_items(next(lit), ref)
    finally:
        lit.close()


def test_pair_loader_order_and_end():
    """Batches leave in the iterator's order whatever the thread count, the
    loader stops where the iterator does, and close() joins its workers."""
    loader = tloader.PairLoader(iter(range(200)), prefetch=3, num_threads=8)
    assert list(loader) == list(range(200))
    loader.close()
    assert not any(t.is_alive() for t in loader._threads)
    endless = tloader.PairLoader(iter(range(10**9)), prefetch=2, num_threads=4)
    assert [next(endless) for _ in range(5)] == list(range(5))
    endless.close()
    assert not any(t.is_alive() for t in endless._threads)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_augmentations(seed):
    """color_jiggle, random_erasing and random_rotation from generators of
    the same seed."""
    rng = np.random.default_rng(seed)
    im = rng.uniform(0, 1, (24, 32, 3)).astype(np.float32)
    depth = rng.uniform(1, 5, (24, 32)).astype(np.float32)
    K = _K()
    jr, tr = np.random.default_rng(seed + 10), np.random.default_rng(seed + 10)
    np.testing.assert_array_equal(taug.color_jiggle(im, tr, hue=0.1), jaug.color_jiggle(im, jr, hue=0.1))
    for a, b in zip(taug.random_erasing(im, depth, tr, p=1.0),
                    jaug.random_erasing(im, depth, jr, p=1.0)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(taug.random_rotation(im, depth, K, tr), jaug.random_rotation(im, depth, K, jr)):
        np.testing.assert_array_equal(a, b)
