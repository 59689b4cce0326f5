"""Tiny RoMa v1: XFeat trunk + global correlation matcher + conv refiners.

- coarse (1/8): the softmax-expectation warp over the all-pairs correlation
  of the two coarse feature maps (exact, the reference's strided shortcut,
  band/row-restricted, or streamed by the correlation-softmax kernel with
  ``fused_kernel=True``), then a 4-block conv matcher predicting
  (dx, dy, logit) residuals scaled by (2/W, 2/H, 1), optionally iterated;
- fine (1/4): the coarse result upsampled (its gradient stopped: the fine
  stage refines and never backpropagates into the coarse one), then a
  4-block conv matcher with the same residual scheme.

Train mode (``model.train()``, the JAX package's ``train=True``): the
ConvBlocks normalise with batch statistics, the coarse warp is always the
exact expectation over the correlation volume (never the kernel or the
strided shortcut, whatever a gradient needs), and scale 8 also returns
that volume as ``corr_volume`` (None for the band and row search modes)
for the dual-softmax loss.

Module names follow the reference Tiny RoMa state_dict in its trainable
layout (``xfeat.0.*``, ``coarse_matcher.{0..3}.layer.{0,1}``,
``coarse_matcher.4``, same for ``fine_matcher``). Images enter as
(B, H, W, 3) in [0, 1] and flows/certainties leave as (B, h, w, 2|1), as in
the JAX package; features are NCHW in between.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from roma_torch.config import TinyRomaConfig
from roma_torch.device import resolve_device
from roma_torch.kernels import runtime
from roma_torch.kernels.corr_softmax import fused_pos_embed
from roma_torch.models import api
from roma_torch.models.layers import ConvBlock, conv2d
from roma_torch.models.xfeat import XFeatBackbone
from roma_torch.ops.band_corr import banded_pos_embed, row_pos_embed
from roma_torch.ops.corr import coord_grid, corr_volume, pos_embed_expectation, pos_embed_fast
from roma_torch.ops.grid_sample import grid_sample_nchw
from roma_torch.ops.resize import interpolate_bilinear, pad_to_multiple
from roma_torch.utils.geometry import normalized_to_pixel
from roma_torch.utils.sampling import sample_matches

SEARCH_MODES = ("full", "band", "row")


def load_image_pair(path_a, path_b) -> tuple[np.ndarray, np.ndarray]:
    """Two images at A's size rounded down to multiples of 32 (PIL
    bicubic), float32 in [0, 1], (H, W, 3) each."""
    from PIL import Image

    pa = Image.open(path_a).convert("RGB")
    pb = Image.open(path_b).convert("RGB")
    w, h = pa.size
    w, h = max(32, (w // 32) * 32), max(32, (h // 32) * 32)
    a = np.asarray(pa.resize((w, h), Image.BICUBIC), np.float32) / 255.0
    b = np.asarray(pb.resize((w, h), Image.BICUBIC), np.float32) / 255.0
    return a, b


class MatchRefiner(nn.Sequential):
    """N ConvBlocks (3x3) + a float32 1x1 head -> (dx, dy, certainty logit)."""

    def __init__(self, in_dim: int, hidden_dim: int, num_blocks: int = 4,
                 dtype: torch.dtype = torch.bfloat16):
        blocks = [ConvBlock(in_dim if i == 0 else hidden_dim, hidden_dim, dtype=dtype)
                  for i in range(num_blocks)]
        super().__init__(*blocks, nn.Conv2d(hidden_dim, 3, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in list(self)[:-1]:
            x = blk(x)
        return conv2d(self[-1], x.float(), torch.float32)


class TinyRoma(nn.Module):
    """Image pair -> {8: (flow, certainty), 4: (flow, certainty)}."""

    def __init__(self, cfg: TinyRomaConfig = TinyRomaConfig()):
        super().__init__()
        if cfg.search_mode not in SEARCH_MODES:
            raise ValueError(f"search_mode must be one of {SEARCH_MODES}, got {cfg.search_mode!r}")
        self.cfg = cfg
        dt = self.dtype = getattr(torch, cfg.dtype)
        self.xfeat = nn.ModuleList([XFeatBackbone(dtype=dt)])
        self.coarse_matcher = MatchRefiner(2 * cfg.coarse_dim + 2, cfg.match_dim,
                                           cfg.num_matcher_blocks, dtype=dt)
        self.fine_matcher = MatchRefiner(2 * cfg.fine_dim + 2, cfg.fine_match_dim,
                                         cfg.num_matcher_blocks, dtype=dt)
        self.train(False)  # eval until model.train(), as JAX's train=False default

    def coarse_warp(self, f0c: torch.Tensor, f1c: torch.Tensor):
        """Coarse feature maps (B, C, h, w) -> (the softmax-expectation warp
        (B, h, w, 2) float32, the correlation volume (B, h*w, h*w) or None
        where none was built). Train mode takes the volume and the exact
        expectation, as the JAX package does; in eval mode a gradient that
        autograd needs keeps the kernel (which has no backward) off."""
        cfg = self.cfg
        B, _, h8, w8 = f0c.shape
        a = f0c.permute(0, 2, 3, 1)
        b = f1c.permute(0, 2, 3, 1)
        if cfg.search_mode == "row":
            return row_pos_embed(a, b), None
        if cfg.search_mode == "band":
            return banded_pos_embed(a, b, cfg.band_radius), None
        exact = self.training or runtime.grad_needed(f0c, f1c)
        if cfg.fused_kernel and not exact:
            # the features as they are (bf16 from the trunk): the kernel's
            # bf16 entry scores them on the tensor cores
            grid1 = coord_grid(h8, w8, device=f0c.device).reshape(h8 * w8, 2)
            warp = fused_pos_embed(a.reshape(B, h8 * w8, -1).contiguous(),
                                   b.reshape(B, h8 * w8, -1).contiguous(), grid1)
            return warp.reshape(B, h8, w8, 2), None
        cv = corr_volume(a, b)
        if cfg.exact_softmax or exact:
            warp = pos_embed_expectation(cv, (h8, w8))
        else:
            warp = pos_embed_fast(cv, (h8, w8), faithful=cfg.faithful_fast_path)
        return warp.reshape(B, h8, w8, 2), cv

    def forward(self, im_a: torch.Tensor, im_b: torch.Tensor) -> dict[int, dict[str, torch.Tensor]]:
        """(B, H, W, 3) images -> {8: {"flow", "certainty"}, 4: {...}},
        flows (B, h, w, 2) and certainty logits (B, h, w, 1), float32."""
        B, H, W, _ = im_a.shape
        dt = self.dtype
        with record_function("tiny.xfeat"):
            fine, coarse = self.xfeat[0](torch.cat([im_a, im_b], dim=0).permute(0, 3, 1, 2))
        f0c, f1c = coarse[:B], coarse[B:]
        f0f, f1f = fine[:B], fine[B:]

        with record_function("tiny.coarse_warp"):
            coarse_warp, cv = self.coarse_warp(f0c, f1c)
        # residual step: one target-image pixel in normalized units
        to_norm = torch.tensor([2 / W, 2 / H, 1.0]).to(im_a.device, non_blocking=True)
        matches = torch.cat([coarse_warp, torch.zeros_like(coarse_warp[..., :1])], dim=-1)
        with record_function("tiny.coarse_matcher"):
            for _ in range(self.cfg.coarse_iters):
                warp_now = matches[..., :2]
                f1c_warped = grid_sample_nchw(f1c, warp_now)
                coarse_in = torch.cat(
                    [f0c, f1c_warped.to(dt), warp_now.permute(0, 3, 1, 2).to(dt)], dim=1)
                delta = self.coarse_matcher(coarse_in).permute(0, 2, 3, 1)
                matches = matches + delta * to_norm
        corresps = {8: {"flow": matches[..., :2], "certainty": matches[..., 2:]}}
        if self.training:
            corresps[8]["corr_volume"] = cv

        with record_function("tiny.fine_matcher"):
            h4, w4 = f0f.shape[-2:]
            up = interpolate_bilinear(matches, (h4, w4)).detach()
            f1f_warped = grid_sample_nchw(f1f, up[..., :2])
            fine_in = torch.cat(
                [f0f, f1f_warped.to(dt), up[..., :2].permute(0, 3, 1, 2).to(dt)], dim=1)
            fine_matches = up + self.fine_matcher(fine_in).permute(0, 2, 3, 1) * to_norm
        corresps[4] = {"flow": fine_matches[..., :2], "certainty": fine_matches[..., 2:]}
        return corresps


class TinyRomaMatcher:
    """User-facing Tiny RoMa matcher: /32 preprocessing, the forward, a
    dense warp and certainty at the input resolution, balanced sampling,
    and the shared `models/api.py` utilities (one-sided warps)."""

    def __init__(self, model: TinyRoma, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg

    def preprocess(self, im: torch.Tensor) -> torch.Tensor:
        """Bilinear resize (B, H, W, 3) to multiples of 32."""
        return pad_to_multiple(im, 32)

    @torch.inference_mode()
    def forward(self, im_a: torch.Tensor, im_b: torch.Tensor):
        return self.model(self.preprocess(im_a), self.preprocess(im_b))

    def _as_tensor(self, x) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x, np.float32))
        return t.to(self.device).float()

    @torch.inference_mode()
    def match(self, im_a, im_b, batched: bool = False):
        """im_a, im_b: (H, W, 3) or (B, H, W, 3) float [0, 1] (tensor or
        array, same size), image paths, or PIL images. Returns the warp
        (B, H, W, 4) [x_A, y_A, x_B, y_B] normalized and the certainty
        (B, H, W) at the input resolution, from the coarse (1/8) result."""
        from PIL import Image

        if isinstance(im_a, (str, bytes)) or hasattr(im_a, "__fspath__"):
            im_a, im_b = load_image_pair(im_a, im_b)
        if isinstance(im_a, Image.Image):
            im_a, im_b = (np.asarray(im.convert("RGB"), np.float32) / 255.0
                          for im in (im_a, im_b))
        im_a, im_b = self._as_tensor(im_a), self._as_tensor(im_b)
        if im_a.ndim == 3:
            im_a, im_b = im_a[None], im_b[None]
        B, H, W, _ = im_a.shape
        corresps = self.forward(im_a, im_b)
        with record_function("tiny.postprocess"):
            flow = interpolate_bilinear(corresps[8]["flow"], (H, W))
            cert = torch.sigmoid(interpolate_bilinear(corresps[8]["certainty"], (H, W))[..., 0])
            grid = coord_grid(H, W, device=flow.device).expand(B, H, W, 2)
            warp = torch.cat([grid, flow], dim=-1)
        if batched:
            return warp, cert
        return warp[0], cert[0]

    @torch.inference_mode()
    def sample(self, warp, certainty, num: int = 5000,
               generator: torch.Generator | None = None):
        return sample_matches(warp, certainty, num=num,
                              sample_thresh=self.cfg.sample_thresh, generator=generator)

    def to_pixel_coordinates(self, coords, h_a, w_a, h_b=None, w_b=None):
        if coords.shape[-1] == 2:
            return normalized_to_pixel(coords, h_a, w_a)
        return (normalized_to_pixel(coords[..., :2], h_a, w_a),
                normalized_to_pixel(coords[..., 2:], h_b, w_b))

    def match_keypoints(self, x_a, x_b, warp, certainty, **kw):
        return api.match_keypoints(x_a, x_b, warp, certainty,
                                   sample_thresh=self.cfg.sample_thresh, **kw)

    def conf_from_fb_consistency(self, flow_forward, flow_backward, th: float = 2.0):
        return api.conf_from_fb_consistency(flow_forward, flow_backward, th)

    def visualize_warp(self, warp, certainty, im_a, im_b, save_path=None):
        return api.visualize_warp(warp, certainty, im_a, im_b, symmetric=False,
                                  save_path=save_path)
