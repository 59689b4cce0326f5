"""MegaDepth pair dataset (host-side, numpy/PIL — no torch), a copy of the
JAX package's: the same items for the same seed.

Mirrors the reference dataset contract
(the reference's romatch/datasets/megadepth.py:13-233): scene_info .npy files
under prep_scene_info carrying image/depth paths, intrinsics, world poses,
pairs, overlaps; overlap-interval filtering, pair cap, intrinsic rescale to
the training resolution, random integer "shake" translation compensated in K,
optional horizontal flip flipping K. Items are channels-last numpy arrays
feeding fixed-shape device batches:

  {im_A, im_B: (H, W, 3) float32 [0,1] (or ImageNet-normalized),
   im_A_depth, im_B_depth: (H, W) float32,
   K1, K2: (3, 3), T_1to2: (4, 4)}
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

try:
    import h5py
except Exception:  # pragma: no cover
    h5py = None

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _translate(im: np.ndarray, tx: int, ty: int) -> np.ndarray:
    """Integer-pixel translate with zero padding (torchvision affine parity:
    positive tx shifts content right, positive ty shifts down)."""
    out = np.zeros_like(im)
    h, w = im.shape[:2]
    sy0, sy1 = max(0, -ty), min(h, h - ty)
    dy0, dy1 = max(0, ty), min(h, h + ty)
    sx0, sx1 = max(0, -tx), min(w, w - tx)
    dx0, dx1 = max(0, tx), min(w, w + tx)
    out[dy0:dy1, dx0:dx1] = im[sy0:sy1, sx0:sx1]
    return out


class MegadepthScene:
    def __init__(
        self,
        data_root: str,
        scene_info: dict,
        ht: int = 384,
        wt: int = 512,
        min_overlap: float = 0.0,
        max_overlap: float = 1.0,
        shake_t: int = 0,
        normalize: bool = False,
        max_num_pairs: int = 100_000,
        scene_name: str | None = None,
        use_horizontal_flip_aug: bool = False,
        colorjiggle_params: dict | None = None,
        rng: np.random.Generator | None = None,
    ) -> None:
        self.data_root = data_root
        self.scene_name = scene_name
        self.image_paths = scene_info["image_paths"]
        self.depth_paths = scene_info["depth_paths"]
        self.intrinsics = scene_info["intrinsics"]
        self.poses = scene_info["poses"]
        pairs = np.asarray(scene_info["pairs"])
        overlaps = np.asarray(scene_info["overlaps"])
        keep = (overlaps > min_overlap) & (overlaps < max_overlap)
        self.pairs, self.overlaps = pairs[keep], overlaps[keep]
        self.rng = rng or np.random.default_rng(0)
        if len(self.pairs) > max_num_pairs:
            sel = self.rng.choice(len(self.pairs), max_num_pairs, replace=False)
            self.pairs, self.overlaps = self.pairs[sel], self.overlaps[sel]
        self.ht, self.wt = ht, wt
        self.shake_t = shake_t
        self.normalize = normalize
        self.use_horizontal_flip_aug = use_horizontal_flip_aug
        # photometric jitter (the reference advertises colorjiggle_params
        # but ignores them, utils.py:165-174; here they work)
        self.colorjiggle_params = colorjiggle_params

    def __len__(self) -> int:
        return len(self.pairs)

    def _load_im(self, rel_path: str) -> tuple[np.ndarray, int, int]:
        im = Image.open(os.path.join(self.data_root, rel_path)).convert("RGB")
        w, h = im.size
        im = im.resize((self.wt, self.ht), Image.BICUBIC)
        return np.asarray(im, np.float32) / 255.0, w, h

    def _load_depth(self, rel_path: str) -> np.ndarray:
        with h5py.File(os.path.join(self.data_root, rel_path), "r") as f:
            depth = np.asarray(f["depth"], np.float32)
        # depth resizes bilinearly to the training resolution (reference
        # get_depth_tuple_transform_ops, utils.py:158-162)
        im = Image.fromarray(depth)
        return np.asarray(im.resize((self.wt, self.ht), Image.BILINEAR), np.float32)

    def _scale_K(self, K: np.ndarray, wi: int, hi: int) -> np.ndarray:
        S = np.diag([self.wt / wi, self.ht / hi, 1.0]).astype(np.float64)
        return S @ K

    def __getitem__(self, pair_idx: int) -> dict:
        idx1, idx2 = self.pairs[pair_idx]
        K1 = np.asarray(self.intrinsics[idx1], np.float64).reshape(3, 3).copy()
        K2 = np.asarray(self.intrinsics[idx2], np.float64).reshape(3, 3).copy()
        T1 = np.asarray(self.poses[idx1], np.float64)
        T2 = np.asarray(self.poses[idx2], np.float64)
        T_1to2 = (T2 @ np.linalg.inv(T1))[:4, :4]

        im_A, w1, h1 = self._load_im(self.image_paths[idx1])
        im_B, w2, h2 = self._load_im(self.image_paths[idx2])
        K1 = self._scale_K(K1, w1, h1)
        K2 = self._scale_K(K2, w2, h2)
        depth_A = self._load_depth(self.depth_paths[idx1])
        depth_B = self._load_depth(self.depth_paths[idx2])

        if self.shake_t > 0:
            tx, ty = self.rng.integers(-self.shake_t, self.shake_t + 1, 2)
            im_A = _translate(im_A, tx, ty)
            im_B = _translate(im_B, tx, ty)
            depth_A = _translate(depth_A, tx, ty)
            depth_B = _translate(depth_B, tx, ty)
            K1[:2, 2] += (tx, ty)
            K2[:2, 2] += (tx, ty)

        if self.colorjiggle_params is not None:
            from roma_torch.datasets.augment import color_jiggle

            im_A = color_jiggle(im_A, self.rng, **self.colorjiggle_params)
            im_B = color_jiggle(im_B, self.rng, **self.colorjiggle_params)

        if self.use_horizontal_flip_aug and self.rng.random() > 0.5:
            im_A, im_B = im_A[:, ::-1].copy(), im_B[:, ::-1].copy()
            depth_A, depth_B = depth_A[:, ::-1].copy(), depth_B[:, ::-1].copy()
            flip = np.array([[-1, 0, self.wt], [0, 1, 0], [0, 0, 1.0]])
            K1, K2 = flip @ K1, flip @ K2

        if self.normalize:
            im_A = (im_A - IMAGENET_MEAN) / IMAGENET_STD
            im_B = (im_B - IMAGENET_MEAN) / IMAGENET_STD

        return {
            "im_A": im_A,
            "im_B": im_B,
            "im_A_depth": depth_A,
            "im_B_depth": depth_B,
            "K1": K1.astype(np.float32),
            "K2": K2.astype(np.float32),
            "T_1to2": T_1to2.astype(np.float32),
        }


class MegadepthBuilder:
    """Scene-set builder with the reference's split/ignore lists
    (megadepth.py:183-233)."""

    TEST_SCENES = ["0017.npy", "0004.npy", "0048.npy", "0013.npy"]
    TEST_SCENES_LOFTR = ["0015.npy", "0022.npy"]
    LOFTR_IGNORE = {
        "0121.npy", "0133.npy", "0168.npy", "0178.npy", "0229.npy", "0349.npy",
        "0412.npy", "0430.npy", "0443.npy", "1001.npy", "5014.npy", "5015.npy",
        "5016.npy",
    }
    IMC21_IGNORE = {
        "0008.npy", "0019.npy", "0021.npy", "0024.npy", "0025.npy", "0032.npy",
        "0063.npy", "1589.npy",
    }

    def __init__(self, data_root="data/megadepth", loftr_ignore=True, imc21_ignore=True):
        self.data_root = data_root
        self.scene_info_root = os.path.join(data_root, "prep_scene_info")
        self.all_scenes = (
            os.listdir(self.scene_info_root)
            if os.path.isdir(self.scene_info_root)
            else []
        )
        self.loftr_ignore = loftr_ignore
        self.imc21_ignore = imc21_ignore

    def build_scenes(self, split="train", scene_names=None, **kwargs) -> list[MegadepthScene]:
        if split == "train":
            scene_names = set(self.all_scenes) - set(self.TEST_SCENES)
        elif split == "train_loftr":
            scene_names = set(self.all_scenes) - set(self.TEST_SCENES_LOFTR)
        elif split == "test":
            scene_names = self.TEST_SCENES
        elif split == "test_loftr":
            scene_names = self.TEST_SCENES_LOFTR
        elif split == "custom":
            assert scene_names is not None
        else:
            raise ValueError(f"unknown split {split}")
        scenes = []
        for name in sorted(scene_names):
            if self.loftr_ignore and name in self.LOFTR_IGNORE:
                continue
            if self.imc21_ignore and name in self.IMC21_IGNORE:
                continue
            if not name.endswith(".npy"):
                continue
            info = np.load(
                os.path.join(self.scene_info_root, name), allow_pickle=True
            ).item()
            scenes.append(
                MegadepthScene(self.data_root, info, scene_name=name, **kwargs)
            )
        return scenes

    @staticmethod
    def weight_scenes(scenes: list[MegadepthScene], alpha: float = 0.75) -> np.ndarray:
        """Per-item sampling weights 1/n^alpha (megadepth.py:227-233)."""
        return np.concatenate([np.full(len(s), 1.0 / len(s) ** alpha) for s in scenes])
