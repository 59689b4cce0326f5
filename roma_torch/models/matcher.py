"""Full RoMa: DINOv2-L coarse + VGG19 fine encoder, GP + transformer match
decoder, coarse-to-fine ConvRefiners, and the two-pass matcher API.

Module names follow the reference RoMa state_dict (``encoder.cnn``,
``encoder.dinov2``, ``decoder.embedding_decoder``, ``decoder.gps.16``,
``decoder.proj.{s}``, ``decoder.conv_refiner.{s}``). Images enter as
(B, H, W, 3) and flows/certainties leave as (B, H, W, 2|1), as in the JAX
package; features are NCHW in between.

Train mode is PyTorch's ``model.train()``, which stands for the JAX
package's ``train=True``: VGG and the decoder's projections normalise with
batch statistics and move their running statistics, VGG runs under
activation checkpointing (flax's ``nn.remat``), DINOv2 stays frozen
(no_grad, its output detached), the refiners take their training paths,
flow and certainty are detached between scales, and `corresps` also carry
``gm_cls``, ``gm_certainty`` (scale 16), ``flow_pre_delta`` and
``delta_flow`` (every refined scale), as the loss reads them.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from roma_torch.config import RomaConfig
from roma_torch.device import resolve_device
from roma_torch.models import api
from roma_torch.models.dinov2 import DinoViT
from roma_torch.models.gp import GP
from roma_torch.models.layers import batch_norm, batch_norm_train, checkpoint, conv2d
from roma_torch.models.refiner import ConvRefiner
from roma_torch.models.transformer import TransformerDecoder
from roma_torch.models.vgg import VGG19
from roma_torch.ops.corr import coord_grid
from roma_torch.ops.resize import (interpolate_bilinear, pil_bicubic_matrix,
                                   pil_bicubic_resize_device, resize_bicubic)
from roma_torch.utils.geometry import cls_to_flow_refine, normalized_to_pixel
from roma_torch.utils.profiling import span
from roma_torch.utils.sampling import sample_matches

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _dtype(cfg: RomaConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class CNNandDinov2(nn.Module):
    """Feature pyramid: VGG19 {1,2,4,8} + DINOv2 patch tokens at 16.
    ``coarse=False`` (the upsample pass) skips DINOv2."""

    def __init__(self, cfg: RomaConfig):
        super().__init__()
        dt = _dtype(cfg)
        self.cnn = VGG19(dtype=dt)
        self.dinov2 = DinoViT(embed_dim=cfg.dinov2_dim, depth=cfg.dinov2_depth,
                              num_heads=cfg.dinov2_heads, dtype=dt)
        self.train(False)  # eval until model.train(), as JAX's train=False default

    def forward(self, x: torch.Tensor, coarse: bool = True) -> dict[int, torch.Tensor]:
        with span("roma.vgg"):
            if self.training and torch.is_grad_enabled():
                pyramid = checkpoint(self.cnn, x)  # recomputed in backward
            else:
                pyramid = self.cnn(x)
        if coarse:
            # frozen: no graph is recorded and nothing flows back into it
            with span("roma.dinov2"), torch.no_grad():
                pyramid[16] = self.dinov2(x).permute(0, 3, 1, 2).detach()
        return pyramid


class Decoder(nn.Module):
    """Coarse-to-fine decode: GP + transformer at 1/16, refiners down to 1/1."""

    def __init__(self, cfg: RomaConfig):
        super().__init__()
        self.cfg = cfg
        dt = self.dtype = _dtype(cfg)
        self.embedding_decoder = TransformerDecoder(
            hidden_dim=cfg.decoder_dim, out_dim=cfg.cls_res**2 + 1,
            num_blocks=cfg.num_decoder_blocks, num_heads=cfg.decoder_heads, dtype=dt,
        )
        self.gps = nn.ModuleDict({"16": GP(gp_dim=cfg.gp.gp_dim, T=cfg.gp.kernel_temperature,
                                           sigma_noise=cfg.gp.sigma_noise)})
        self.proj = nn.ModuleDict({
            s: nn.Sequential(nn.Conv2d(i, o, 1), nn.BatchNorm2d(o))
            for s, (i, o) in cfg.proj_dims.items()
        })
        self.conv_refiner = nn.ModuleDict({
            s: ConvRefiner(rc.in_dim, rc.hidden_dim, rc.displacement_emb_dim,
                           rc.local_corr_radius, rc.hidden_blocks, rc.kernel_size,
                           cfg.disp_emb_gain, dtype=dt,
                           smooth_warp=cfg.smooth_warp_gather)
            for s, rc in cfg.refiners.items()
        })
        self.train(False)  # eval until model.train(), as JAX's train=False default

    def _proj(self, s: str, x: torch.Tensor) -> torch.Tensor:
        conv, bn = self.proj[s]
        y = conv2d(conv, x, self.dtype)
        if self.training:
            return batch_norm_train(bn, y, 0.9, False).to(y.dtype)
        return batch_norm(bn, y).to(y.dtype)

    def forward(
        self,
        f1: Mapping[int, torch.Tensor],
        f2: Mapping[int, torch.Tensor],
        upsample: bool = False,
        flow: torch.Tensor | None = None,
        certainty: torch.Tensor | None = None,
        scale_factor: float = 1.0,
    ) -> dict[int, dict[str, torch.Tensor]]:
        c = self.cfg
        scales = ["8", "4", "2", "1"] if upsample else ["16", "8", "4", "2", "1"]
        sizes = {s: tuple(f1[s].shape[-2:]) for s in f1}
        # delta-flow normalization uses the FULL-RES dims
        h_full, w_full = sizes[1]
        coarsest = int(scales[0])
        b = f1[coarsest].shape[0]
        h_c, w_c = sizes[coarsest]
        dev = f1[coarsest].device

        if not upsample:
            flow = coord_grid(h_c, w_c, device=dev).expand(b, h_c, w_c, 2)
            certainty = torch.zeros((b, h_c, w_c, 1), dtype=torch.float32, device=dev)
        else:
            flow = interpolate_bilinear(flow, (h_c, w_c))
            certainty = interpolate_bilinear(certainty, (h_c, w_c))

        train = self.training
        corresps: dict[int, dict[str, torch.Tensor]] = {}
        for s in scales:
            ins = int(s)
            out: dict[str, torch.Tensor] = {}
            f1_s = self._proj(s, f1[ins])
            f2_s = self._proj(s, f2[ins])

            if ins == 16:
                a_hw = f1_s.permute(0, 2, 3, 1)
                with span("roma.gp"):
                    gp_posterior = self.gps["16"](a_hw, f2_s.permute(0, 2, 3, 1))
                with span("roma.match_decoder"):
                    gm_cls, certainty = self.embedding_decoder(gp_posterior, a_hw)
                    flow = cls_to_flow_refine(gm_cls)
                if train:
                    out.update(gm_cls=gm_cls, gm_certainty=certainty)

            if s in self.conv_refiner:
                if train:
                    out["flow_pre_delta"] = flow
                with span(f"roma.refiner{s}"):
                    delta_flow, delta_cert = self.conv_refiner[s](
                        f1_s, f2_s, flow, scale_factor=scale_factor
                    )
                if train:
                    out["delta_flow"] = delta_flow
                # displacement in normalized units: ins * delta / (refine_init * full_res)
                disp = ins * torch.stack(
                    [delta_flow[..., 0] / (c.refine_init * w_full),
                     delta_flow[..., 1] / (c.refine_init * h_full)], dim=-1,
                )
                flow = flow + disp
                certainty = certainty + delta_cert

            corresps[ins] = dict(out, flow=flow, certainty=certainty)
            if s != "1":
                nh, nw = sizes[ins // 2]
                # detached between scales, in every mode, as in the JAX package
                flow = interpolate_bilinear(flow, (nh, nw)).detach()
                certainty = interpolate_bilinear(certainty, (nh, nw)).detach()
        return corresps


class RomaModel(nn.Module):
    """Encoder + decoder; one forward = one decode pass at one resolution."""

    def __init__(self, cfg: RomaConfig = RomaConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = CNNandDinov2(cfg)
        self.decoder = Decoder(cfg)
        self.train(False)  # eval until model.train(), as JAX's train=False default

    def encode(self, x: torch.Tensor, coarse: bool = True) -> dict[int, torch.Tensor]:
        """The feature pyramid of (B, 3, H, W) images; `coarse` adds DINOv2's
        scale 16."""
        return self.encoder(x, coarse=coarse)

    def forward(
        self,
        im_a: torch.Tensor,
        im_b: torch.Tensor,
        symmetric: bool = True,
        upsample: bool = False,
        flow: torch.Tensor | None = None,
        certainty: torch.Tensor | None = None,
        scale_factor: float = 1.0,
    ):
        """ImageNet-normalized (B, H, W, 3) images. symmetric: decode A->B
        and B->A in one batch; outputs then have leading dim 2B."""
        B = im_a.shape[0]
        x = torch.cat([im_a, im_b], dim=0).permute(0, 3, 1, 2)
        pyramid = self.encode(x, coarse=not upsample)
        if symmetric:
            f_q = pyramid
            f_s = {k: torch.cat([v[B:], v[:B]], dim=0) for k, v in pyramid.items()}
        else:
            f_q = {k: v[:B] for k, v in pyramid.items()}
            f_s = {k: v[B:] for k, v in pyramid.items()}
        return self.decoder(f_q, f_s, upsample=upsample, flow=flow,
                            certainty=certainty, scale_factor=scale_factor)


class RomaMatcher:
    """User-facing full-RoMa matcher: two-pass coarse -> upsample inference,
    certainty attenuation, symmetric warp assembly, balanced sampling."""

    def __init__(self, model: RomaModel, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg

    # ---- preprocessing
    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               device=self.device)

    def normalize(self, im: torch.Tensor) -> torch.Tensor:
        mean = torch.as_tensor(IMAGENET_MEAN, device=im.device)
        std = torch.as_tensor(IMAGENET_STD, device=im.device)
        return (im - mean) / std

    def _preprocess(self, im_a, im_b, *, hs: int, ws: int):
        if im_a.shape[1:3] == im_b.shape[1:3]:
            x = torch.cat([im_a, im_b], dim=0)
            x = self.normalize(resize_bicubic(x, (hs, ws)))
            B = im_a.shape[0]
            return x[:B], x[B:]
        a = self.normalize(resize_bicubic(im_a, (hs, ws)))
        b = self.normalize(resize_bicubic(im_b, (hs, ws)))
        return a, b

    @staticmethod
    def host_resize_np(pil_im, hs: int, ws: int) -> np.ndarray:
        """Protocol host resize: PIL bicubic -> (hs, ws, 3) uint8."""
        from PIL import Image

        r = pil_im.convert("RGB").resize((ws, hs), Image.BICUBIC)
        return np.array(r, np.uint8)

    def host_prep_np(self, pil_im, hs: int, ws: int) -> np.ndarray:
        """PIL bicubic resize + ImageNet normalisation on the host ->
        (hs, ws, 3) float32."""
        x = self.host_resize_np(pil_im, hs, ws).astype(np.float32) / 255.0
        return (x - IMAGENET_MEAN) / IMAGENET_STD

    def _as_normalized(self, x) -> torch.Tensor:
        x = self._to_device(x)
        if x.dtype == torch.uint8:
            return self.normalize(x.float() / 255.0)
        return x.float()

    # ---- postprocessing
    @staticmethod
    def _postprocess(flow, certainty, cert16, *, hs, ws, symmetric, attenuate):
        """Final-scale outputs -> (warp, certainty)."""
        B = flow.shape[0] // 2 if symmetric else flow.shape[0]
        if attenuate:
            lrc = interpolate_bilinear(cert16, (hs, ws))
            certainty = certainty - 0.5 * lrc * (lrc < 0)
        certainty = torch.sigmoid(certainty[..., 0])
        # zero certainty for out-of-bounds targets, clamp flow
        oob = (flow.abs() > 1).any(dim=-1)
        certainty = torch.where(oob, torch.zeros_like(certainty), certainty)
        flow = flow.clamp(-1, 1)
        grid = coord_grid(hs, ws, device=flow.device).expand(B, hs, ws, 2)
        if symmetric:
            q_warp = torch.cat([grid, flow[:B]], dim=-1)
            s_warp = torch.cat([flow[B:], grid], dim=-1)
            warp = torch.cat([q_warp, s_warp], dim=2)  # side by side in W
            certainty = torch.cat([certainty[:B], certainty[B:]], dim=2)
        else:
            warp = torch.cat([grid, flow], dim=-1)
        return warp, certainty

    # ---- matching
    @torch.inference_mode()
    def match_prepped(self, a, b, a2=None, b2=None):
        """Two-pass match on prepped batches: a/b (B, hc, wc, 3) at the
        coarse resolution, a2/b2 at the upsample resolution (needed iff
        cfg.upsample_preds); ImageNet-normalized float or uint8 [0, 255].
        Returns batched (warp, certainty)."""
        cfg = self.cfg
        hs, ws = cfg.coarse_resolution
        with span("roma.coarse_pass"):
            corresps = self.model(self._as_normalized(a), self._as_normalized(b),
                                  symmetric=cfg.symmetric)
        cert16 = corresps[16]["certainty"] if cfg.attenuate_cert else None
        if cfg.upsample_preds:
            hs, ws = cfg.upsample_resolution
            finest = corresps[1]
            sf = math.sqrt((hs * ws) / (cfg.coarse_resolution[0] * cfg.coarse_resolution[1]))
            with span("roma.upsample_pass"):
                corresps = self.model(
                    self._as_normalized(a2), self._as_normalized(b2),
                    symmetric=cfg.symmetric, upsample=True, flow=finest["flow"],
                    certainty=finest["certainty"], scale_factor=sf,
                )
        if cert16 is None:
            cert16 = torch.zeros_like(corresps[1]["certainty"][:, :1, :1])
        with span("roma.postprocess"):
            return self._postprocess(
                corresps[1]["flow"], corresps[1]["certainty"], cert16, hs=hs, ws=ws,
                symmetric=cfg.symmetric, attenuate=cfg.attenuate_cert,
            )

    @torch.inference_mode()
    def match(self, im_a, im_b, batched: bool = False):
        """im_a, im_b: (H, W, 3) or (B, H, W, 3) float [0, 1] (tensor or
        array), image paths, or PIL images. Returns (warp, certainty):
        symmetric warp (B, hs, 2*ws, 4) and certainty (B, hs, 2*ws) at the
        output resolution (upsample_resolution when two-pass)."""
        from PIL import Image

        with span("roma.match"):
            if isinstance(im_a, (str, bytes)) or hasattr(im_a, "__fspath__"):
                im_a = Image.open(im_a)
                im_b = Image.open(im_b)
            cfg = self.cfg
            hc, wc = cfg.coarse_resolution
            hu, wu = cfg.upsample_resolution
            if isinstance(im_a, Image.Image):
                a, b = (self.host_resize_np(im, hc, wc)[None] for im in (im_a, im_b))
                a2 = b2 = None
                if cfg.upsample_preds:
                    a2, b2 = (self.host_resize_np(im, hu, wu)[None] for im in (im_a, im_b))
            else:
                im_a = self._to_device(im_a).float()
                im_b = self._to_device(im_b).float()
                if im_a.ndim == 3:
                    im_a, im_b = im_a[None], im_b[None]
                with span("roma.preprocess"):
                    a, b = self._preprocess(im_a, im_b, hs=hc, ws=wc)
                    a2 = b2 = None
                    if cfg.upsample_preds:
                        a2, b2 = self._preprocess(im_a, im_b, hs=hu, ws=wu)
            warp, certainty = self.match_prepped(a, b, a2, b2)
        if batched:
            return warp, certainty
        return warp[0], certainty[0]

    # ---- device resize: original-resolution uint8 canvases in, both passes'
    # model-resolution inputs made on the device by PIL-parity matrices
    def build_resize_banks(self, sizes, bucket):
        """Resize matrix banks on the matcher's device. sizes: the unique
        source (h, w); bucket: (Hb, Wb), the padded canvas (>= every source).
        Returns (ry_c, rx_c[, ry_u, rx_u]): bank row i resizes a zero-padded
        (Hb, Wb) canvas holding a sizes[i] image as PIL BICUBIC resizes the
        unpadded image. Build once, reuse for every batch."""
        hb, wb = bucket
        res = [self.cfg.coarse_resolution]
        if self.cfg.upsample_preds:
            res.append(self.cfg.upsample_resolution)
        banks = []
        for ho, wo in res:
            for mats in ([pil_bicubic_matrix(h, ho, hb) for h, _ in sizes],
                         [pil_bicubic_matrix(w, wo, wb) for _, w in sizes]):
                banks.append(torch.from_numpy(np.stack(mats)).to(self.device))
        return tuple(banks)

    @staticmethod
    def _prep_raw_impl(raw, idx, ry_c, rx_c, ry_u=None, rx_u=None, *, up=False):
        """(2B, Hb, Wb, 3) uint8 canvases and their bank rows -> ImageNet-
        normalized model-resolution batches: the coarse one, and with `up`
        also the upsample one."""
        x = raw.float()
        mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
        std = torch.as_tensor(IMAGENET_STD, device=x.device)
        xc = (pil_bicubic_resize_device(x, ry_c[idx], rx_c[idx]) / 255.0 - mean) / std
        if not up:
            return xc
        xu = (pil_bicubic_resize_device(x, ry_u[idx], rx_u[idx]) / 255.0 - mean) / std
        return xc, xu

    @torch.inference_mode()
    def match_raw(self, raw, idx, banks):
        """Batched two-pass match from original-resolution uint8 canvases.
        raw: (2B, Hb, Wb, 3) uint8, zero-padded originals, the B A-images
        over the B B-images; idx: (2B,) bank rows; banks: from
        `build_resize_banks`. Equals `match_prepped` on host PIL resizes up
        to the one-uint8-level parity of the matrix resize."""
        with span("roma.match"):
            raw = self._to_device(raw)
            idx = self._to_device(idx).long()
            B = raw.shape[0] // 2
            up = self.cfg.upsample_preds
            with span("roma.preprocess"):
                prepped = self._prep_raw_impl(raw, idx, *banks, up=up)
            if not up:
                return self.match_prepped(prepped[:B], prepped[B:])
            xc, xu = prepped
            return self.match_prepped(xc[:B], xc[B:], xu[:B], xu[B:])

    @torch.inference_mode()
    def sample(self, warp, certainty, num: int = 10000,
               generator: torch.Generator | None = None):
        return sample_matches(warp, certainty, num=num,
                              sample_thresh=self.cfg.sample_thresh, generator=generator)

    @torch.inference_mode()
    def sample_batched(self, warps, certs, num: int, generators):
        """Per-pair `sample` over the batch axis, pair i with generators[i]:
        (B, ..., 4), (B, ...) -> (B, num, 4), (B, num)."""
        out = [self.sample(w, c, num=num, generator=g)
               for w, c, g in zip(warps, certs, generators, strict=True)]
        return torch.stack([m for m, _ in out]), torch.stack([c for _, c in out])

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
        return api.visualize_warp(warp, certainty, im_a, im_b,
                                  symmetric=self.cfg.symmetric, save_path=save_path)
