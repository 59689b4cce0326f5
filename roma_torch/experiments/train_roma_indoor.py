"""Train full RoMa indoor: MegaDepth + ScanNet interleaved 1:1.

    python -m roma_torch.experiments.train_roma_indoor [--megadepth_root ...]

Recipe per the reference (roma_indoor.py:220-278): alternate one MegaDepth
batch and one ScanNet batch per optimizer step, both scored by the same
loss settings, one optimizer and schedule. The arguments and defaults are
the JAX package's experiments/train_roma_indoor.py's; it runs on the GPU.
"""

from __future__ import annotations

import argparse
import itertools

from roma_torch.config import RomaConfig, TrainConfig
from roma_torch.datasets.loader import PairLoader, weighted_pair_iterator
from roma_torch.datasets.megadepth import MegadepthBuilder
from roma_torch.datasets.scannet import ScanNetBuilder
from roma_torch.losses.robust_loss import RobustLossConfig, robust_loss
from roma_torch.parallel.mesh import (
    global_batch_from_host_local,
    initialize_distributed,
    make_mesh,
    replicate,
)
from roma_torch.train.checkpoint import CheckPoint
from roma_torch.train.logging import MetricsLogger
from roma_torch.train.train import make_roma_train_state, make_train_step

DEVICE = None  # the GPU


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--megadepth_root", default="data/megadepth")
    p.add_argument("--scannet_root", default="data/scannet")
    p.add_argument("--checkpoint_dir", default="workspace/checkpoints")
    p.add_argument("--log_dir", default="workspace/logs")
    p.add_argument("--train_resolution", type=int, default=560)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--total_samples", type=int, default=8_000_000)
    p.add_argument("--checkpoint_every", type=int, default=25_000)
    args = p.parse_args(argv)

    hw = (args.train_resolution, args.train_resolution)
    proc, nproc = initialize_distributed(DEVICE)  # no-op in one process
    cfg = TrainConfig(batch_size=args.batch_size, steps=args.total_samples)
    mesh = make_mesh(DEVICE)
    name = "roma_indoor"

    state = make_roma_train_state(cfg, roma_cfg=RomaConfig(), seed=cfg.seed, device=DEVICE)
    ckpt = CheckPoint(args.checkpoint_dir, name)
    state = ckpt.load(state)
    state = replicate(state, mesh)

    loss_cfg = RobustLossConfig(
        ce_weight=0.01, alpha=0.5, c=1e-4,
        local_dist={1: 4, 2: 4, 4: 8, 8: 8}, local_largest_scale=8,
    )
    step = make_train_step(loss_fn=robust_loss, loss_cfg=loss_cfg, mesh=mesh)
    logger = MetricsLogger(args.log_dir, name)

    mega = MegadepthBuilder(data_root=args.megadepth_root)
    mega_scenes = mega.build_scenes(
        split="train_loftr", min_overlap=0.01, ht=hw[0], wt=hw[1], shake_t=32,
        use_horizontal_flip_aug=True, normalize=True,
    )
    mega_loader = PairLoader(
        weighted_pair_iterator(
            mega_scenes, mega.weight_scenes(mega_scenes, alpha=0.75),
            cfg.batch_size // nproc, seed=cfg.seed, host_id=proc,
        ),
        prefetch=4, num_threads=4,
    )
    scannet = ScanNetBuilder(data_root=args.scannet_root)
    scan_scenes = scannet.build_scenes(
        ht=hw[0], wt=hw[1], use_horizontal_flip_aug=True, normalize=True
    )
    scan_loader = PairLoader(
        weighted_pair_iterator(
            scan_scenes, scannet.weight_scenes(scan_scenes, alpha=0.75),
            cfg.batch_size // nproc, seed=cfg.seed + 1, host_id=proc,
        ),
        prefetch=4, num_threads=4,
    )

    # 1:1 interleave (reference roma_indoor.py:272-278)
    mixed = itertools.chain.from_iterable(zip(mega_loader, scan_loader))
    next_ckpt = state.step + args.checkpoint_every
    for batch in mixed:
        if state.step >= args.total_samples:
            break
        state, metrics = step(state, global_batch_from_host_local(batch, mesh))
        logger.log(state.step, metrics)
        if state.step >= next_ckpt:
            if proc == 0:
                ckpt.save(state)
            next_ckpt += args.checkpoint_every
            print(f"step {state.step}: checkpointed")
    if proc == 0:
        ckpt.save(state)
    mega_loader.close()
    scan_loader.close()
    logger.close()


if __name__ == "__main__":
    main()
