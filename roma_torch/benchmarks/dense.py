"""MegaDepth dense-warp benchmark (EPE + PCK), the in-training eval hook.

Protocol per the reference (romatch/benchmarks/megadepth_dense_benchmark.py):
batched matching on the test_loftr split at 384x512, GT warp from depth via
warp_kpts, end-point error in pixels and PCK@{1,3,5}px over valid GT.
"""

from __future__ import annotations

import numpy as np
import torch

from roma_torch.benchmarks.harness_core import host_numpy
from roma_torch.datasets.loader import ConcatScenes, collate
from roma_torch.datasets.megadepth import MegadepthBuilder
from roma_torch.utils.geometry import get_gt_warp


class MegadepthDenseBenchmark:
    def __init__(
        self,
        data_root: str = "data/megadepth",
        h: int = 384,
        w: int = 512,
        num_samples: int = 2000,
        batch_size: int = 8,
        seed: int = 0,
    ) -> None:
        mega = MegadepthBuilder(data_root=data_root)
        scenes = mega.build_scenes(split="test_loftr", ht=h, wt=w)
        self.dataset = ConcatScenes(scenes)
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.h, self.w = h, w
        self.seed = seed

    def benchmark(self, matcher, model_name: str | None = None) -> dict:
        rng = np.random.default_rng(self.seed)
        idx = rng.choice(len(self.dataset), self.num_samples, replace=False)
        gd_tot, pck_1_tot, pck_3_tot, pck_5_tot = 0.0, 0.0, 0.0, 0.0
        n_batches = 0
        for i in range(0, len(idx), self.batch_size):
            batch_idx = idx[i : i + self.batch_size]
            if len(batch_idx) < self.batch_size:
                break
            batch = collate([self.dataset[int(j)] for j in batch_idx])
            warp, certainty = matcher.match(
                torch.from_numpy(batch["im_A"]), torch.from_numpy(batch["im_B"]), batched=True
            )
            gd, pck_1, pck_3, pck_5 = self.geometric_dist(
                batch["im_A_depth"], batch["im_B_depth"], batch["T_1to2"],
                batch["K1"], batch["K2"], host_numpy(warp),
            )
            gd_tot += gd
            pck_1_tot += pck_1
            pck_3_tot += pck_3
            pck_5_tot += pck_5
            n_batches += 1
        return {
            "epe": gd_tot / n_batches,
            "mega_pck_1": pck_1_tot / n_batches,
            "mega_pck_3": pck_3_tot / n_batches,
            "mega_pck_5": pck_5_tot / n_batches,
        }

    def geometric_dist(self, depth1, depth2, T_1to2, K1, K2, warp):
        """EPE/PCK at the warp's own resolution.

        `warp` is (B, H, 2W, 4) symmetric or (B, H, W, 4) one-sided; only the
        A->B half is scored, as the reference scores the full matcher's
        symmetric output."""
        B, H, W2, _ = warp.shape
        W = W2 // 2 if W2 == 2 * depth1.shape[2] * H // depth1.shape[1] else W2
        a_to_b = warp[:, :, :W, 2:]
        x2_gt, prob = get_gt_warp(
            *(torch.from_numpy(np.asarray(a)) for a in (depth1, depth2, T_1to2, K1, K2)),
            H=H, W=W,
        )
        x2_gt, prob = x2_gt.numpy(), prob.numpy()
        gd = np.linalg.norm(a_to_b - x2_gt, axis=-1) * (self.w / 2)  # px at warp res
        valid = prob > 0.5
        gd_valid = gd[valid]
        return (
            float(gd_valid.mean()),
            float((gd_valid < 1.0).mean()),
            float((gd_valid < 3.0).mean()),
            float((gd_valid < 5.0).mean()),
        )
