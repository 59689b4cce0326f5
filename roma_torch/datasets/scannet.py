"""ScanNet pair dataset (host-side, numpy/PIL/cv2 — no torch), a copy of
the JAX package's: the same items for the same seed.

Mirrors the reference (romatch/datasets/scannet.py:22-160):
pairs from scannet_indices npz's, every-10th-frame filter, 10k pair cap,
depth png / 1000, cam2world pose txt inverted to world2cam. Same item
contract as MegadepthScene.
"""

from __future__ import annotations

import os
import os.path as osp

import numpy as np
from PIL import Image

try:
    import cv2
except Exception:  # pragma: no cover
    cv2 = None

from roma_torch.datasets.megadepth import IMAGENET_MEAN, IMAGENET_STD


class ScanNetScene:
    def __init__(
        self,
        data_root: str,
        scene_info: dict,
        ht: int = 384,
        wt: int = 512,
        shake_t: int = 0,
        normalize: bool = False,
        use_horizontal_flip_aug: bool = False,
        max_num_pairs: int = 10_000,
        rng: np.random.Generator | None = None,
    ) -> None:
        self.scene_root = osp.join(data_root, "scans", "scans_train")
        names = np.asarray(scene_info["name"])
        overlaps = np.asarray(scene_info["score"])
        # only every-10th frames (reference :29-31)
        valid = (names[:, -2:] % 10).sum(axis=-1) == 0
        self.data_names, self.overlaps = names[valid], overlaps[valid]
        self.rng = rng or np.random.default_rng(0)
        if len(self.data_names) > max_num_pairs:
            sel = self.rng.choice(len(self.data_names), max_num_pairs, replace=False)
            self.data_names, self.overlaps = self.data_names[sel], self.overlaps[sel]
        self.ht, self.wt = ht, wt
        self.shake_t = shake_t
        self.normalize = normalize
        self.use_horizontal_flip_aug = use_horizontal_flip_aug

    def __len__(self) -> int:
        return len(self.data_names)

    def _load_im(self, path: str) -> tuple[np.ndarray, int, int]:
        im = Image.open(path).convert("RGB")
        w, h = im.size
        im = im.resize((self.wt, self.ht), Image.BICUBIC)
        return np.asarray(im, np.float32) / 255.0, w, h

    def _load_depth(self, path: str) -> np.ndarray:
        depth = cv2.imread(str(path), cv2.IMREAD_UNCHANGED).astype(np.float32) / 1000.0
        return cv2.resize(depth, (self.wt, self.ht), interpolation=cv2.INTER_LINEAR)

    def __getitem__(self, pair_idx: int) -> dict:
        scene_name, sub, stem1, stem2 = self.data_names[pair_idx]
        scene = f"scene{scene_name:04d}_{sub:02d}"
        scene_dir = osp.join(self.scene_root, scene)
        K = np.loadtxt(
            osp.join(scene_dir, "intrinsic", "intrinsic_color.txt"), delimiter=" "
        )[:3, :3]
        T1 = np.linalg.inv(np.loadtxt(osp.join(scene_dir, "pose", f"{stem1}.txt")))
        T2 = np.linalg.inv(np.loadtxt(osp.join(scene_dir, "pose", f"{stem2}.txt")))
        T_1to2 = (T2 @ np.linalg.inv(T1))[:4, :4]

        im_A, w1, h1 = self._load_im(osp.join(scene_dir, "color", f"{stem1}.jpg"))
        im_B, w2, h2 = self._load_im(osp.join(scene_dir, "color", f"{stem2}.jpg"))
        depth_A = self._load_depth(osp.join(scene_dir, "depth", f"{stem1}.png"))
        depth_B = self._load_depth(osp.join(scene_dir, "depth", f"{stem2}.png"))

        S1 = np.diag([self.wt / w1, self.ht / h1, 1.0])
        S2 = np.diag([self.wt / w2, self.ht / h2, 1.0])
        K1, K2 = S1 @ K, S2 @ K

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


class ScanNetBuilder:
    def __init__(self, data_root: str = "data/scannet") -> None:
        self.data_root = data_root
        self.scene_info_root = os.path.join(data_root, "scannet_indices")
        self.all_scenes = (
            os.listdir(self.scene_info_root)
            if os.path.isdir(self.scene_info_root)
            else []
        )

    def build_scenes(self, split: str = "train", **kwargs) -> list[ScanNetScene]:
        scenes = []
        for name in sorted(self.all_scenes):
            info = np.load(
                os.path.join(self.scene_info_root, name), allow_pickle=True
            )
            scenes.append(ScanNetScene(self.data_root, info, **kwargs))
        return scenes

    @staticmethod
    def weight_scenes(scenes, alpha: float = 0.5) -> np.ndarray:
        return np.concatenate([np.full(len(s), 1.0 / len(s) ** alpha) for s in scenes])
