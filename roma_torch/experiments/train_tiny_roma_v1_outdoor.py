"""Train Tiny RoMa v1 on MegaDepth (data-parallel on torch.distributed).

    python -m roma_torch.experiments.train_tiny_roma_v1_outdoor [--data_root ...]
    torchrun --nproc_per_node N -m roma_torch.experiments.train_tiny_roma_v1_outdoor ...

Recipe per the reference experiment: MegaDepth train_loftr split at two
overlap bands (0.01 and 0.35), shake_t=32, horizontal-flip aug, 1/n^0.75
scene weighting, AdamW lr 1e-4/8 per sample, grad clip 0.01, milestone decay
at 90% of 8M samples, a checkpoint every 25k samples. bf16, no GradScaler.
The arguments and defaults are the JAX package's
experiments/train_tiny_roma_v1_outdoor.py's; it runs on the GPU, each rank
loading its own rows of the global batch.
"""

from __future__ import annotations

import argparse

import torch

from roma_torch.config import TrainConfig
from roma_torch.datasets.loader import PairLoader, weighted_pair_iterator
from roma_torch.datasets.megadepth import MegadepthBuilder
from roma_torch.losses.robust_loss import RobustLossConfig, tiny_robust_loss
from roma_torch.models.port import load_reference_tiny
from roma_torch.parallel.mesh import (
    global_batch_from_host_local,
    initialize_distributed,
    make_mesh,
    replicate,
)
from roma_torch.train.checkpoint import CheckPoint
from roma_torch.train.logging import MetricsLogger
from roma_torch.train.train import make_tiny_train_state, make_train_step, train_k_steps

RESOLUTIONS = {
    "low": (448, 448), "medium": (560, 560), "high": (672, 672),
    "xfeat": (600, 800), "big": (768, 1024),
}
DEVICE = None  # the GPU
LOSS_CFG = RobustLossConfig(
    ce_weight=0.01, local_dist={4: 4}, alpha={4: 0.15, 8: 0.15},
    c=1e-4, epe_mask_prob_th=0.001,
)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", default="data/megadepth")
    p.add_argument("--checkpoint_dir", default="workspace/checkpoints")
    p.add_argument("--log_dir", default="workspace/logs")
    p.add_argument("--train_resolution", default="big")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--total_samples", type=int, default=8_000_000)
    p.add_argument("--eval_every", type=int, default=25_000)
    p.add_argument("--only_test", action="store_true")
    p.add_argument("--train_fine_matcher", action="store_true",
                   help="staged training: freeze trunk+coarse, train the fine"
                        " matcher only (fork recipe, model_tiny2.py:669-684)")
    p.add_argument("--freeze_xfeat", action="store_true",
                   help="freeze the XFeat trunk, train both matchers")
    p.add_argument("--checkpoint", default=None,
                   help="warm-start from a reference torch .pth")
    args = p.parse_args(argv)

    proc, nproc = initialize_distributed(DEVICE)  # no-op in one process
    h, w = RESOLUTIONS[args.train_resolution]
    h, w = (h // 32) * 32, (w // 32) * 32  # tiny preprocessing contract
    cfg = TrainConfig(batch_size=args.batch_size, steps=args.total_samples)
    mesh = make_mesh(DEVICE)
    name = "tiny_roma_v1_outdoor"

    trainable = ("fine_only" if args.train_fine_matcher
                 else "matchers_only" if args.freeze_xfeat else "all")
    state = make_tiny_train_state(cfg, trainable=trainable, seed=cfg.seed, device=DEVICE)
    if args.checkpoint:
        load_reference_tiny(state.model, torch.load(args.checkpoint, map_location="cpu",
                                                    weights_only=True))
    ckpt = CheckPoint(args.checkpoint_dir, name)
    state = ckpt.load(state)
    state = replicate(state, mesh)

    step = make_train_step(loss_fn=tiny_robust_loss, loss_cfg=LOSS_CFG, mesh=mesh)
    logger = MetricsLogger(args.log_dir, name)

    mega = MegadepthBuilder(data_root=args.data_root)
    scenes = mega.build_scenes(
        split="train_loftr", min_overlap=0.01, ht=h, wt=w, shake_t=32,
        use_horizontal_flip_aug=True,
    ) + mega.build_scenes(
        split="train_loftr", min_overlap=0.35, ht=h, wt=w, shake_t=32,
        use_horizontal_flip_aug=True,
    )
    ws = mega.weight_scenes(scenes, alpha=0.75)
    # each rank loads only its rows of the global batch (the reference's
    # rank-striped sampler, megadepth.py:52-57)
    loader = PairLoader(
        weighted_pair_iterator(
            scenes, ws, cfg.batch_size // nproc, seed=cfg.seed, host_id=proc
        ),
        prefetch=4, num_threads=8,
    )

    k = max(1, args.eval_every // cfg.batch_size)
    while state.step < args.total_samples and not args.only_test:
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
