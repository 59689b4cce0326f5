"""ScanNet-1500 relative-pose benchmark.

Protocol per the reference (romatch/benchmarks/scannet_benchmark.py): pairs
from test.npz, intrinsics from intrinsic_color.txt, K rescaled to min-dim
480, the -0.5 px pixel-center offset convention, 5 shuffled RANSAC runs,
AUC@{5,10,20}.

`batch_size > 1` runs the batched engine (harness_core.run_batched_eval;
the reference loops pairs serially): the same sampling generators and
shuffle order, so the errors equal the serial protocol's.
`device_resize=True` ships original-resolution uint8 and resizes on the
device (PIL parity to <= 1 uint8 level).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from roma_torch.benchmarks.harness_core import (estimate_pose_reps, host_numpy, open_rgb,
                                                pair_generator, run_batched_eval)
from roma_torch.benchmarks.megadepth_pose import summarize_pose_errors
from roma_torch.benchmarks.pose_backends import get_pose_backend
from roma_torch.utils.geometry import compute_pose_error
from roma_torch.utils.profiling import span


class ScanNetBenchmark:
    def __init__(
        self,
        data_root: str = "data/scannet",
        pose_backend: str = "auto",
        sample_num: int = 5000,
        num_ransac_runs: int = 5,
        shard: tuple[int, int] = (0, 1),
        seed: int = 0,
        batch_size: int = 1,
        workers: int = 8,
        device_resize: bool = False,
    ) -> None:
        self.data_root = data_root
        self.estimate_pose = get_pose_backend(pose_backend)
        self.sample_num = sample_num
        self.num_ransac_runs = num_ransac_runs
        self.shard = shard
        self.seed = seed
        self.batch_size = batch_size
        self.workers = workers
        self.device_resize = device_resize

    def benchmark(self, matcher, model_name: str | None = None) -> dict:
        errors = self.collect_errors(matcher)
        return summarize_pose_errors(np.asarray(errors))

    def _pair_list(self) -> list[tuple]:
        """Pair metadata in protocol order (seeded permutation,
        shard-strided): (path_a, path_b, K, R, t, index in the unsharded
        list)."""
        tmp = np.load(osp.join(self.data_root, "test.npz"))
        pairs, rel_pose = tmp["name"], tmp["rel_pose"]
        # private seeded generators (pair order and per-repetition shuffles):
        # the reference uses the process-global numpy RNG, which makes
        # results depend on unrelated callers' RNG consumption
        order = np.random.default_rng(self.seed).permutation(len(pairs))
        items = []
        for n, pairind in enumerate(order):
            if n % self.shard[1] != self.shard[0]:
                continue
            scene = pairs[pairind]
            scene_name = f"scene0{scene[0]}_00"
            scan_dir = osp.join(self.data_root, "scans_test", scene_name)
            T_gt = rel_pose[pairind].reshape(3, 4)
            with open(osp.join(scan_dir, "intrinsic", "intrinsic_color.txt")) as f:
                K = np.stack([np.array([float(i) for i in r.split()])
                              for r in f.read().split("\n") if r])
            items.append((
                osp.join(scan_dir, "color", f"{scene[2]}.jpg"),
                osp.join(scan_dir, "color", f"{scene[3]}.jpg"),
                K, T_gt[:3, :3].copy(), T_gt[:3, 3].copy(), n,
            ))
        return items

    def _finish_args(self, item, sparse, sizes, perms):
        """Pixel conversion (-0.5 offset, min-dim-480 K rescale) + the
        estimator-repetition args for one pair. Pure numpy."""
        _pa, _pb, K, R, t, _gid = item
        w1, h1, w2, h2 = sizes
        s1, s2 = 480 / min(w1, h1), 480 / min(w2, h2)
        w1s, h1s, w2s, h2s = s1 * w1, s1 * h1, s2 * w2, s2 * h2
        K1 = K.copy() * s1
        K2 = K.copy() * s2
        offset = 0.5  # ScanNet GT uses [0, n-1] pixel centers
        kpts1 = np.stack(
            (w1s * (sparse[:, 0] + 1) / 2 - offset,
             h1s * (sparse[:, 1] + 1) / 2 - offset), axis=-1,
        )
        kpts2 = np.stack(
            (w2s * (sparse[:, 2] + 1) / 2 - offset,
             h2s * (sparse[:, 3] + 1) / 2 - offset), axis=-1,
        )
        norm_threshold = 0.5 / (
            np.mean(np.abs(K1[:2, :2])) + np.mean(np.abs(K2[:2, :2]))
        )
        return kpts1, kpts2, K1, K2, R, t, norm_threshold, perms

    def _estimate_reps(self, kpts1, kpts2, K1, K2, R, t, norm_threshold,
                       perms) -> list[float]:
        return estimate_pose_reps(
            self.estimate_pose, compute_pose_error, kpts1, kpts2, K1, K2,
            R, t, norm_threshold, perms,
        )

    def collect_errors(self, matcher) -> list[float]:
        """Raw per-repetition pose errors (merge across hosts, then AUC)."""
        items = self._pair_list()
        shuffle_rng = np.random.default_rng(self.seed + 1)
        if self.batch_size > 1:

            def finish(idx, item, sparse, sizes):
                # shared-RNG draws on the main thread (serial order); the
                # values are read in the job (they may wait on the device)
                perms = [shuffle_rng.permutation(sparse.shape[0])
                         for _ in range(self.num_ransac_runs)]

                def job():
                    return self._estimate_reps(*self._finish_args(
                        item, np.asarray(sparse), sizes, perms
                    ))

                return job, ()

            per_pair = run_batched_eval(
                matcher, items,
                paths=lambda it: (it[0], it[1]),
                finish=finish,
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
            # PIL handed straight to the matcher: the host-side resize keeps
            # the model at its fixed shapes
            with span("eval.match"):
                warp, certainty = matcher.match(im_a, im_b)
            gen = pair_generator(self.seed, item[-1], warp.device)
            with span("eval.sample"):
                sparse, _ = matcher.sample(warp, certainty, self.sample_num, generator=gen)
            sparse = host_numpy(sparse)
            perms = [shuffle_rng.permutation(len(sparse))
                     for _ in range(self.num_ransac_runs)]
            tot_e_pose.extend(self._estimate_reps(*self._finish_args(
                item, sparse, (*im_a.size, *im_b.size), perms
            )))
        return tot_e_pose
