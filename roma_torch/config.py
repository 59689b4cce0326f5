"""Typed configuration for full RoMa and Tiny RoMa v1 (a copy of the JAX
package's dataclasses; the port imports nothing from it). Defaults must stay
equal to the JAX package's, which `tests/test_torch_config.py` asserts."""

from __future__ import annotations

import dataclasses
from typing import Mapping

# (h, w) presets mirroring the reference resolution table
RESOLUTION_PRESETS: Mapping[str, tuple[int, int]] = {
    "low": (448, 448),
    "medium": (560, 560),
    "high": (672, 672),
    "xfeat": (600, 800),
    "big": (768, 1024),
    "upsample": (864, 864),       # full-RoMa second pass
    "upsample_high": (1344, 1344),
    "tiny_bench": (480, 640),
}


@dataclasses.dataclass(frozen=True)
class TinyRomaConfig:
    """Tiny RoMa v1: XFeat backbone + global corr + 2 conv matchers."""
    coarse_dim: int = 64          # XFeat fused feature channels (1/8 scale)
    fine_dim: int = 24            # XFeat block2 channels (1/4 scale)
    match_dim: int = 256          # coarse matcher hidden width
    fine_match_dim: int = 64      # fine matcher hidden width
    num_matcher_blocks: int = 4
    exact_softmax: bool = True    # exact softmax-expectation coarse warp
    faithful_fast_path: bool = False  # with exact_softmax=False: reproduce the
                                  # reference shortcut's index-as-logit and
                                  # shifted-grid quirks bit for bit
    fused_kernel: bool = False    # streaming correlation-softmax kernel: no
                                  # (L0, L1) volume in device memory
    # search-space restriction: "full" global matching, "band" = +-band_radius
    # rows, "row" = same row only
    search_mode: str = "full"
    band_radius: int = 4
    coarse_iters: int = 1         # iterated coarse matcher
    sample_thresh: float = 0.05
    symmetric: bool = False
    dtype: str = "bfloat16"       # compute dtype; params stay float32


@dataclasses.dataclass(frozen=True)
class GPConfig:
    """Gaussian-process coarse matcher."""
    gp_dim: int = 512
    kernel_temperature: float = 0.2
    sigma_noise: float = 0.1
    basis: str = "fourier"


@dataclasses.dataclass(frozen=True)
class RefinerConfig:
    """One ConvRefiner."""
    in_dim: int
    hidden_dim: int
    displacement_emb_dim: int
    local_corr_radius: int | None = None
    kernel_size: int = 5
    hidden_blocks: int = 8
    dw: bool = True


@dataclasses.dataclass(frozen=True)
class RomaConfig:
    """Full RoMa: DINOv2-L coarse + VGG19 fine + GP + transformer decoder +
    coarse-to-fine refiners."""
    coarse_resolution: tuple[int, int] = RESOLUTION_PRESETS["medium"]
    upsample_resolution: tuple[int, int] = RESOLUTION_PRESETS["upsample"]
    upsample_preds: bool = True
    symmetric: bool = True
    attenuate_cert: bool = True
    sample_thresh: float = 0.05
    gp: GPConfig = GPConfig()
    gp_dim: int = 512
    feat_dim: int = 512
    dinov2_depth: int = 24        # ViT-L; tests shrink this for speed
    dinov2_dim: int = 1024
    dinov2_heads: int = 16
    decoder_dim: int = 1024       # gp_dim + feat_dim
    cls_res: int = 64             # 64x64 anchor classification grid
    num_decoder_blocks: int = 5
    decoder_heads: int = 8
    refine_init: float = 4.0      # delta-flow scaling
    disp_emb_gain: float = 40.0 / 32.0  # displacement embedding scale
    # scale-1 warp gather through the windowed kernel: False (plain
    # grid_sample), True/"exact" (kernel only when the whole batch is
    # window-smooth) or "fast" (kernel always, window-clamped on rough tiles)
    smooth_warp_gather: bool | str = False
    # per-scale refiners
    refiners: Mapping[str, RefinerConfig] = dataclasses.field(
        default_factory=lambda: {
            "16": RefinerConfig(2 * 512 + 128 + 15 * 15, 2 * 512 + 128 + 15 * 15, 128, 7),
            "8": RefinerConfig(2 * 512 + 64 + 7 * 7, 2 * 512 + 64 + 7 * 7, 64, 3),
            "4": RefinerConfig(2 * 256 + 32 + 5 * 5, 2 * 256 + 32 + 5 * 5, 32, 2),
            "2": RefinerConfig(2 * 64 + 16, 128 + 16, 16, None),
            "1": RefinerConfig(2 * 9 + 6, 24, 6, None),
        }
    )
    # 1x1 projections per scale: (in, out)
    proj_dims: Mapping[str, tuple[int, int]] = dataclasses.field(
        default_factory=lambda: {
            "16": (1024, 512),
            "8": (512, 512),
            "4": (256, 256),
            "2": (128, 64),
            "1": (64, 9),
        }
    )
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh of the JAX package's data parallelism (kept for the
    defaults of `TrainConfig`; the port's data parallelism is later work)."""
    data: int = -1                # -1: use all devices
    model: int = 1


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8           # global batch
    steps: int = 8_000_000        # counted in samples, like the reference
    lr_encoder: float = 5e-6 / 8
    lr_decoder: float = 1e-4 / 8
    grad_clip: float = 0.01
    milestone_frac: float = 0.9   # MultiStepLR milestone at 90% of schedule
    lr_decay: float = 0.2
    warmup_samples: int = 0       # linear LR warmup (unused by the shipped recipes)
    checkpoint_every: int = 25_000
    seed: int = 0
    mesh: MeshConfig = MeshConfig()


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """RobustLosses settings of the full-RoMa recipe."""
    ce_weight: float = 0.01
    local_dist: Mapping[int, float] = dataclasses.field(
        default_factory=lambda: {1: 4, 2: 4, 4: 8, 8: 8}
    )
    local_largest_scale: int = 8
    alpha: float = 0.5
    c: float = 1e-4
    relative_depth_error_threshold: float = 0.05
