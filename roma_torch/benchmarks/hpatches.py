"""HPatches homography benchmark.

Protocol per the reference (romatch/benchmarks/
hpatches_sequences_homog_benchmark.py): per sequence, match 1.ppm against
2..6.ppm, fit a homography by RANSAC at threshold 3*min(w2,h2)/480 on 5000
sampled matches, score by corner-transfer error normalized by min-dim/480,
AUC@{3,5,10}. HPatches GT homographies use [0, n-1] pixel centers (the 0.5
offset).

`batch_size > 1` runs the batched engine (harness_core.run_batched_eval;
the reference loops pairs serially): the same sampling generators, so the
distances equal the serial protocol's. `device_resize=True` ships
original-resolution uint8 and resizes on the device (PIL parity).
"""

from __future__ import annotations

import os

import numpy as np
from torch.profiler import record_function

from roma_torch.benchmarks.harness_core import (host_numpy, open_rgb, pair_generator,
                                                run_batched_eval)
from roma_torch.estimation.homography import estimate_homography_ransac
from roma_torch.utils.geometry import pose_auc

try:
    import cv2
except ImportError:  # pragma: no cover - host dependent
    cv2 = None

IGNORE_SEQS = {
    "i_contruction", "i_crownnight", "i_dc", "i_pencils", "i_whitebuilding",
    "v_artisans", "v_astronautis", "v_talent",
}
PAIRS_PER_SEQ = 5  # 1.ppm against 2..6.ppm


class HpatchesHomogBenchmark:
    def __init__(
        self,
        dataset_path: str,
        homography_backend: str = "auto",
        sample_num: int = 5000,
        shard: tuple[int, int] = (0, 1),
        batch_size: int = 1,
        workers: int = 8,
        device_resize: bool = False,
    ) -> None:
        self.seqs_path = os.path.join(dataset_path, "hpatches-sequences-release")
        self.seq_names = sorted(os.listdir(self.seqs_path))
        self.use_cv2 = homography_backend == "cv2" or (
            homography_backend == "auto" and cv2 is not None
        )
        self.sample_num = sample_num
        self.shard = shard
        self.batch_size = batch_size
        self.workers = workers
        self.device_resize = device_resize

    def _fit_homography(self, pos_a, pos_b, thresh):
        if self.use_cv2:
            H_pred, _ = cv2.findHomography(
                pos_a, pos_b, method=cv2.RANSAC, confidence=0.99999,
                ransacReprojThreshold=thresh,
            )
            return H_pred
        res = estimate_homography_ransac(pos_a, pos_b, threshold_px=thresh)
        return None if res is None else res.model

    def _pair_list(self) -> list[tuple]:
        """(path_a, path_b, H_gt, index in the unsharded list) in protocol
        order, shard-strided by sequence (the reference iterates sequences;
        a shard owns whole sequences)."""
        items = []
        for seq_idx, seq_name in enumerate(self.seq_names):
            if seq_idx % self.shard[1] != self.shard[0]:
                continue
            for im_idx in range(2, 2 + PAIRS_PER_SEQ):
                items.append((
                    os.path.join(self.seqs_path, seq_name, "1.ppm"),
                    os.path.join(self.seqs_path, seq_name, f"{im_idx}.ppm"),
                    np.loadtxt(os.path.join(self.seqs_path, seq_name, f"H_1_{im_idx}")),
                    seq_idx * PAIRS_PER_SEQ + im_idx - 2,
                ))
        return items

    def _pair_dist(self, sparse, H_gt, sizes) -> float:
        """Fit + corner-transfer distance for one pair. Thread-safe (pure
        numpy + per-call-seeded RANSAC / cv2)."""
        w1, h1, w2, h2 = sizes
        offset = 0.5
        pos_a = np.stack(
            (w1 * (sparse[:, 0] + 1) / 2 - offset,
             h1 * (sparse[:, 1] + 1) / 2 - offset), axis=-1,
        )
        pos_b = np.stack(
            (w2 * (sparse[:, 2] + 1) / 2 - offset,
             h2 * (sparse[:, 3] + 1) / 2 - offset), axis=-1,
        )
        try:
            H_pred = self._fit_homography(pos_a, pos_b, 3 * min(w2, h2) / 480)
        except Exception:  # noqa: BLE001 - protocol: a failed fit scores as the zero homography
            H_pred = None
        if H_pred is None:
            H_pred = np.eye(3) * np.array([0, 0, 1.0])[None]
        corners = np.array(
            [[0, 0, 1], [0, h1 - 1, 1], [w1 - 1, 0, 1], [w1 - 1, h1 - 1, 1]],
            np.float64,
        )
        real = corners @ H_gt.T
        real = real[:, :2] / real[:, 2:]
        pred = corners @ H_pred.T
        pred = pred[:, :2] / np.where(
            np.abs(pred[:, 2:]) < 1e-12, 1e-12, pred[:, 2:]
        )
        return float(
            np.mean(np.linalg.norm(real - pred, axis=1)) / (min(w2, h2) / 480)
        )

    def collect_dists(self, matcher) -> list[float]:
        """Per-pair corner-transfer distances (merge across shards, then
        AUC)."""
        items = self._pair_list()
        if self.batch_size > 1:

            def finish(idx, item, sparse, sizes):
                return (lambda: self._pair_dist(np.asarray(sparse), item[2], sizes)), ()

            return run_batched_eval(
                matcher, items,
                paths=lambda it: (it[0], it[1]),
                finish=finish,
                sample_num=self.sample_num,
                batch_size=self.batch_size,
                workers=self.workers,
                device_resize=self.device_resize,
                global_ids=[it[-1] for it in items],
            )
        homog_dists = []
        for path_a, path_b, H_gt, gid in items:
            im_a, im_b = open_rgb(path_a), open_rgb(path_b)
            # PIL straight to the matcher (host resize, fixed model shapes)
            with record_function("eval.match"):
                warp, certainty = matcher.match(im_a, im_b)
            with record_function("eval.sample"):
                sparse, _ = matcher.sample(warp, certainty, self.sample_num,
                                           generator=pair_generator(0, gid, warp.device))
            homog_dists.append(self._pair_dist(
                host_numpy(sparse), H_gt, (*im_a.size, *im_b.size)
            ))
        return homog_dists

    def benchmark(self, matcher, model_name: str | None = None) -> dict:
        homog_dists = self.collect_dists(matcher)
        thresholds = list(range(1, 11))
        auc = pose_auc(np.array(homog_dists), thresholds)
        return {
            "hpatches_homog_auc_3": auc[2],
            "hpatches_homog_auc_5": auc[4],
            "hpatches_homog_auc_10": auc[9],
        }
