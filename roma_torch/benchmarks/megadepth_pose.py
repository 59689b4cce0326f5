"""MegaDepth-1500 relative-pose benchmark, the north-star metric harness.

Protocol byte-compatible with the reference's
(romatch/benchmarks/megadepth_pose_estimation_benchmark.py): 5 scene npz's,
5000 sampled matches per pair, intrinsics rescaled to max-dim 1200, 5
shuffled RANSAC repetitions at threshold 0.5 / (mean|K1| + mean|K2|), pose
error max(e_t, e_R), AUC@{5,10,20}.

Differences (not protocol-changing):
- the harness owns image IO and hands the matcher PIL images, which it
  resizes on the host to its fixed model resolutions
- `shard=(i, n)` strides the pair list for multi-host evaluation; partial
  results carry raw errors so hosts can be merged before the AUC reduction
- `batch_size > 1` runs the batched engine (harness_core.run_batched_eval):
  pairs stacked on the batch axis through one two-pass match, image loads
  on a prefetching thread pool, the RANSAC repetitions on a worker pool
  overlapped with the next batch's matching. Sampling generators are per
  pair and the shuffle permutations follow the serial order, so batched
  results equal the serial protocol's.
"""

from __future__ import annotations

import os

import numpy as np

from roma_torch.benchmarks.harness_core import (estimate_pose_reps, host_numpy, open_rgb,
                                                pair_generator, run_batched_eval)
from roma_torch.benchmarks.pose_backends import get_pose_backend
from roma_torch.utils.geometry import compute_pose_error, compute_relative_pose, pose_auc
from roma_torch.utils.profiling import span

DEFAULT_SCENES = [
    "0015_0.1_0.3.npz",
    "0015_0.3_0.5.npz",
    "0022_0.1_0.3.npz",
    "0022_0.3_0.5.npz",
    "0022_0.5_0.7.npz",
]
THRESHOLDS = [5, 10, 20]


def summarize_pose_errors(e_pose: np.ndarray) -> dict:
    auc = pose_auc(e_pose, THRESHOLDS)
    acc = {t: float((e_pose < t).mean()) for t in (5, 10, 15, 20)}
    return {
        "auc_5": auc[0],
        "auc_10": auc[1],
        "auc_20": auc[2],
        "map_5": acc[5],
        "map_10": float(np.mean([acc[5], acc[10]])),
        "map_20": float(np.mean([acc[5], acc[10], acc[15], acc[20]])),
    }


class MegaDepthPoseEstimationBenchmark:
    def __init__(
        self,
        data_root: str = "data/megadepth",
        scene_names: list[str] | None = None,
        pose_backend: str = "auto",
        sample_num: int = 5000,
        num_ransac_runs: int = 5,
        test_every: int = 1,
        shard: tuple[int, int] = (0, 1),
        seed: int = 0,
        batch_size: int = 1,
        workers: int = 8,
        device_resize: bool = False,
    ) -> None:
        self.seed = seed
        self.data_root = data_root
        self.scene_names = scene_names or DEFAULT_SCENES
        self.scenes = [
            np.load(os.path.join(data_root, s), allow_pickle=True)
            for s in self.scene_names
        ]
        self.estimate_pose = get_pose_backend(pose_backend)
        self.sample_num = sample_num
        self.num_ransac_runs = num_ransac_runs
        self.test_every = test_every
        self.shard = shard
        self.batch_size = batch_size
        self.workers = workers
        # ship original-resolution uint8 + PIL-parity resize on the device.
        # Off by default: the host-PIL path is the bit-exact protocol
        # reference; the device resize matches it to <= 1 uint8 level.
        self.device_resize = device_resize

    def benchmark(self, matcher, model_name: str | None = None) -> dict:
        errors = self.collect_errors(matcher)
        return summarize_pose_errors(np.asarray(errors))

    def _pair_list(self) -> list[tuple]:
        """Pair metadata in protocol order, shard-strided:
        (path_a, path_b, K1, K2, R, t, index in the unsharded list)."""
        items = []
        pair_counter = 0
        for scene in self.scenes:
            pairs = scene["pair_infos"]
            intrinsics = scene["intrinsics"]
            poses = scene["poses"]
            im_paths = scene["image_paths"]
            for pairind in range(0, len(pairs), self.test_every):
                pair_counter += 1
                if (pair_counter - 1) % self.shard[1] != self.shard[0]:
                    continue
                idx1, idx2 = pairs[pairind][0]
                K1 = np.array(intrinsics[idx1], np.float64).copy()
                K2 = np.array(intrinsics[idx2], np.float64).copy()
                T1 = np.array(poses[idx1])
                T2 = np.array(poses[idx2])
                R, t = compute_relative_pose(
                    T1[:3, :3], T1[:3, 3], T2[:3, :3], T2[:3, 3]
                )
                items.append((
                    os.path.join(self.data_root, im_paths[idx1]),
                    os.path.join(self.data_root, im_paths[idx2]),
                    K1, K2, R, t, pair_counter - 1,
                ))
        return items

    def _rescale(self, K1, K2, w1, h1, w2, h2):
        """K-rescale to max-dim 1200 (paper protocol)."""
        s1, s2 = 1200 / max(w1, h1), 1200 / max(w2, h2)
        K1s, K2s = K1.copy(), K2.copy()
        K1s[:2] *= s1
        K2s[:2] *= s2
        return K1s, K2s, (s1 * w1, s1 * h1, s2 * w2, s2 * h2)

    def _pair_job(self, matcher, item, sparse, sizes, shuffle_rng):
        """Main thread: the pair's K rescale, threshold and shuffle draws
        (shared RNG, protocol order). Returns the job that reads the
        matches, converts them to pixels and runs the repetitions."""
        _pa, _pb, K1, K2, R, t, _gid = item
        K1s, K2s, (w1s, h1s, w2s, h2s) = self._rescale(K1, K2, *sizes)
        norm_threshold = 0.5 / (
            np.mean(np.abs(K1s[:2, :2])) + np.mean(np.abs(K2s[:2, :2]))
        )
        perms = [shuffle_rng.permutation(sparse.shape[0])
                 for _ in range(self.num_ransac_runs)]

        def job():
            sp = np.asarray(sparse)
            kpts1 = np.asarray(matcher.to_pixel_coordinates(sp[:, :2], h1s, w1s))
            kpts2 = np.asarray(matcher.to_pixel_coordinates(sp[:, 2:], h2s, w2s))
            return estimate_pose_reps(
                self.estimate_pose, compute_pose_error, kpts1, kpts2, K1s, K2s,
                R, t, norm_threshold, perms,
            )

        return job

    def collect_errors(self, matcher) -> list[float]:
        """Raw per-repetition pose errors (merge across hosts, then AUC)."""
        items = self._pair_list()
        # seeded shuffle: the reference uses the process-global numpy RNG; a
        # private generator keeps the protocol (distinct shuffles per
        # repetition) while making results order-independent and reproducible
        shuffle_rng = np.random.default_rng(self.seed)
        if self.batch_size > 1:
            per_pair = run_batched_eval(
                matcher, items,
                paths=lambda it: (it[0], it[1]),
                finish=lambda idx, item, sparse, sizes: (
                    self._pair_job(matcher, item, sparse, sizes, shuffle_rng), ()),
                sample_num=self.sample_num,
                batch_size=self.batch_size,
                workers=self.workers,
                device_resize=self.device_resize,
                seed=self.seed,
                global_ids=[it[-1] for it in items],
            )
            return [e for errs in per_pair for e in errs]
        tot_e_pose: list[float] = []
        for item in items:
            im_a, im_b = open_rgb(item[0]), open_rgb(item[1])
            with span("eval.match"):
                warp, certainty = matcher.match(im_a, im_b)
            gen = pair_generator(self.seed, item[-1], warp.device)
            with span("eval.sample"):
                sparse, _ = matcher.sample(warp, certainty, self.sample_num, generator=gen)
            sparse = host_numpy(sparse)
            tot_e_pose.extend(self._pair_job(
                matcher, item, sparse, (*im_a.size, *im_b.size), shuffle_rng)())
        return tot_e_pose
