"""Train full RoMa on MegaDepth (data-parallel on torch.distributed).

    python -m roma_torch.experiments.train_roma_outdoor [--data_root ...]
    torchrun --nproc_per_node N -m roma_torch.experiments.train_roma_outdoor ...

Recipe per the reference: two overlap bands (0.01/0.35) with shake_t=32 +
flip aug, RobustLosses with alpha=0.5, c=1e-4, local_dist {1:4, 2:4, 4:8,
8:8}, AdamW groups (CNN encoder at 5e-6/8 per sample, decoder at 1e-4/8),
grad clip 0.01, milestone decay at 90% of 8M samples. Training runs
single-pass at the coarse resolution (the reference never trains the
upsample pass). The arguments and defaults are the JAX package's
experiments/train_roma_outdoor.py's; it runs on the GPU.
"""

from __future__ import annotations

import argparse

from roma_torch.config import RomaConfig, TrainConfig
from roma_torch.datasets.loader import PairLoader, weighted_pair_iterator
from roma_torch.datasets.megadepth import MegadepthBuilder
from roma_torch.losses.robust_loss import RobustLossConfig, robust_loss
from roma_torch.parallel.mesh import (
    global_batch_from_host_local,
    initialize_distributed,
    make_mesh,
    replicate,
)
from roma_torch.train.checkpoint import CheckPoint
from roma_torch.train.logging import MetricsLogger
from roma_torch.train.train import make_roma_train_state, make_train_step, train_k_steps

DEVICE = None  # the GPU


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default="data/megadepth")
    p.add_argument("--checkpoint_dir", default="workspace/checkpoints")
    p.add_argument("--log_dir", default="workspace/logs")
    p.add_argument("--train_resolution", type=int, default=560)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--total_samples", type=int, default=8_000_000)
    p.add_argument("--eval_every", type=int, default=25_000)
    args = p.parse_args(argv)

    hw = (args.train_resolution, args.train_resolution)
    if hw[0] % 14:
        raise ValueError("--train_resolution must be a multiple of 14 (ViT-L/14 patches)")
    proc, nproc = initialize_distributed(DEVICE)  # no-op in one process
    cfg = TrainConfig(batch_size=args.batch_size, steps=args.total_samples)
    mesh = make_mesh(DEVICE)
    name = "roma_outdoor"

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

    mega = MegadepthBuilder(data_root=args.data_root)
    scenes = mega.build_scenes(
        split="train_loftr", min_overlap=0.01, ht=hw[0], wt=hw[1], shake_t=32,
        use_horizontal_flip_aug=True, normalize=True,
    ) + mega.build_scenes(
        split="train_loftr", min_overlap=0.35, ht=hw[0], wt=hw[1], shake_t=32,
        use_horizontal_flip_aug=True, normalize=True,
    )
    ws = mega.weight_scenes(scenes, alpha=0.75)
    loader = PairLoader(
        weighted_pair_iterator(
            scenes, ws, cfg.batch_size // nproc, seed=cfg.seed, host_id=proc
        ),
        prefetch=4, num_threads=8,
    )

    k = max(1, args.eval_every // cfg.batch_size)
    while state.step < args.total_samples:
        state = train_k_steps(
            state, loader, step, k, logger,
            device_put=lambda b: global_batch_from_host_local(b, mesh),
        )
        if proc == 0:
            ckpt.save(state)
        print(f"step {state.step}: checkpointed")
    loader.close()
    logger.close()


if __name__ == "__main__":
    main()
