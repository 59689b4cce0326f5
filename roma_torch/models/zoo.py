"""Model factories. No weights ship with the repo, so factories build a
randomly initialised model from a seed (on the CPU, so the same seed gives
the same weights on every device); carried or checkpoint weights load with
``matcher.model.load_state_dict``."""

from __future__ import annotations

import torch

from roma_torch.config import RefinerConfig, RomaConfig, TinyRomaConfig
from roma_torch.models.layers import flax_init_
from roma_torch.models.matcher import RomaMatcher, RomaModel
from roma_torch.models.tiny_roma import TinyRoma, TinyRomaMatcher


def build_model(cfg: RomaConfig | TinyRomaConfig, seed: int = 0) -> RomaModel | TinyRoma:
    """The model of `cfg`, built on the CPU inside `fork_rng` from `seed`,
    from the JAX package's initialisation: every convolution and linear
    layer (depthwise convolutions too, fan-in 25) is `flax_init_`'s draw
    (flax's `nn.Conv` / `nn.Dense` default: truncated lecun_normal weights,
    zero biases) right after `manual_seed(seed)`, whatever the constructor
    drew before it, so those weights depend on the seed and the modules'
    order only. What the constructor draws itself stays as drawn: DINOv2's
    tokens (normal 1e-6 / 0.02, as the JAX package's), the norms and the
    BatchNorm statistics."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = TinyRoma(cfg) if isinstance(cfg, TinyRomaConfig) else RomaModel(cfg)
        torch.manual_seed(seed)
        return flax_init_(model)


def roma_outdoor(
    coarse_res: int | tuple[int, int] = 560,
    upsample_res: int | tuple[int, int] = 864,
    seed: int = 0,
    device=None,
    cfg: RomaConfig | None = None,
    smooth_warp_gather: bool | str = False,
) -> RomaMatcher:
    """Full RoMa at the shipped resolutions (coarse 560, upsample 864).
    `device` defaults to the GPU; `cfg` overrides the whole configuration.
    `smooth_warp_gather` (RomaConfig.smooth_warp_gather): False keeps the
    plain scale-1 warp; True/"exact" takes the windowed kernel when the
    whole batch is window-smooth; "fast" takes it always (window-clamped on
    rough tiles, the mode for trained weights)."""
    if isinstance(coarse_res, int):
        coarse_res = (coarse_res, coarse_res)
    if isinstance(upsample_res, int):
        upsample_res = (upsample_res, upsample_res)
    if cfg is None:
        cfg = RomaConfig(coarse_resolution=coarse_res, upsample_resolution=upsample_res,
                         smooth_warp_gather=smooth_warp_gather)
    if cfg.coarse_resolution[0] % 14 or cfg.coarse_resolution[1] % 14:
        raise ValueError("coarse resolution must be a multiple of 14 (ViT-L/14 patches)")
    return RomaMatcher(build_model(cfg, seed), device=device)


# the same architecture under the reference's indoor factory's name
roma_indoor = roma_outdoor


def tiny_roma_v1_outdoor(seed: int = 0, device=None,
                         cfg: TinyRomaConfig | None = None) -> TinyRomaMatcher:
    """Tiny RoMa v1 (XFeat 64/24, matchers 256/64, 4 blocks each). `device`
    defaults to the GPU; `cfg` overrides the configuration (for instance
    ``TinyRomaConfig(fused_kernel=True)`` for the streaming kernel)."""
    return TinyRomaMatcher(build_model(cfg or TinyRomaConfig(), seed), device=device)


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
