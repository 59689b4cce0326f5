"""Model factories. No weights ship with the repo, so factories build a
randomly initialised model from a seed (on the CPU, so the same seed gives
the same weights on every device); carried or checkpoint weights load with
``matcher.model.load_state_dict``."""

from __future__ import annotations

import torch

from roma_torch.config import RefinerConfig, RomaConfig
from roma_torch.models.matcher import RomaMatcher, RomaModel


def build_model(cfg: RomaConfig, seed: int = 0) -> RomaModel:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return RomaModel(cfg)


def roma_outdoor(
    coarse_res: int | tuple[int, int] = 560,
    upsample_res: int | tuple[int, int] = 864,
    seed: int = 0,
    device=None,
    cfg: RomaConfig | None = None,
) -> RomaMatcher:
    """Full RoMa at the shipped resolutions (coarse 560, upsample 864).
    `device` defaults to the GPU; `cfg` overrides the whole configuration."""
    if isinstance(coarse_res, int):
        coarse_res = (coarse_res, coarse_res)
    if isinstance(upsample_res, int):
        upsample_res = (upsample_res, upsample_res)
    if cfg is None:
        cfg = RomaConfig(coarse_resolution=coarse_res, upsample_resolution=upsample_res)
    if cfg.coarse_resolution[0] % 14 or cfg.coarse_resolution[1] % 14:
        raise ValueError("coarse resolution must be a multiple of 14 (ViT-L/14 patches)")
    return RomaMatcher(build_model(cfg, seed), device=device)


def debug_roma_config() -> RomaConfig:
    """Scaled-down full RoMa for tests: same topology, tiny depths."""
    return RomaConfig(
        coarse_resolution=(112, 112),
        upsample_resolution=(224, 224),
        dinov2_depth=2,
        num_decoder_blocks=1,
        refiners={
            "16": RefinerConfig(2 * 512 + 128 + 15 * 15, 2 * 512 + 128 + 15 * 15, 128, 7, hidden_blocks=1),
            "8": RefinerConfig(2 * 512 + 64 + 7 * 7, 2 * 512 + 64 + 7 * 7, 64, 3, hidden_blocks=1),
            "4": RefinerConfig(2 * 256 + 32 + 5 * 5, 2 * 256 + 32 + 5 * 5, 32, 2, hidden_blocks=1),
            "2": RefinerConfig(2 * 64 + 16, 128 + 16, 16, None, hidden_blocks=1),
            "1": RefinerConfig(2 * 9 + 6, 24, 6, None, hidden_blocks=1),
        },
    )
