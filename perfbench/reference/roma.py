"""Full RoMa (upstream `romatch/models/model_zoo/__init__.py::roma_outdoor`,
arXiv:2305.15404), plain PyTorch, from uint8 canvases to the symmetric
dense warp and certainty of the two-pass matcher.

Modules carry the upstream state-dict names (``encoder.cnn.layers.{i}``,
``encoder.dinov2.*``, ``decoder.embedding_decoder.*``, ``decoder.gps.16``,
``decoder.proj.{s}``, ``decoder.conv_refiner.{s}``); they only hold the
weights, and every forward below is written out with `torch.nn.functional`.
Inference semantics: BatchNorm and LayerNorm on their stored statistics,
exact GELU, no dropout.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from perfbench.reference.common import Precision, attention, bilinear, grid, sample
from perfbench.reference.resize import resize_canvases

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG_STAGES = ((2, 64), (2, 128), (4, 256), (4, 512))


class Gamma(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Attn(nn.Module):
    def __init__(self, dim: int, qkv_bias: bool):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, qkv_bias: bool, layer_scale: bool):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attn(dim, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        if layer_scale:
            self.ls1, self.ls2 = Gamma(dim), Gamma(dim)

    def forward(self, prec: Precision, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        H = self.heads
        h = F.layer_norm(x, (D,), self.norm1.weight, self.norm1.bias, 1e-6)
        qkv = prec.linear(h, self.attn.qkv).reshape(B, N, 3, H, D // H).permute(2, 0, 3, 1, 4)
        a = attention(prec, qkv[0], qkv[1], qkv[2]).transpose(1, 2).reshape(B, N, D)
        a = prec.linear(a, self.attn.proj)
        x = x + (a * self.ls1.gamma if hasattr(self, "ls1") else a)
        h = F.layer_norm(x, (D,), self.norm2.weight, self.norm2.bias, 1e-6)
        h = prec.linear(F.gelu(prec.linear(h, self.mlp.fc1)), self.mlp.fc2)
        return x + (h * self.ls2.gamma if hasattr(self, "ls2") else h)


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class DinoV2(nn.Module):
    """ViT (DINOv2 layout): patch tokens of the last block after the final
    LayerNorm, as a (B, D, H/p, W/p) map."""

    def __init__(self, c: dict):
        super().__init__()
        d = c["dim"]
        self.patch = c["patch"]
        self.n0 = c["pretrain_img_size"] // c["patch"]
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.n0 * self.n0 + 1, d))
        self.patch_embed = PatchEmbed(c["patch"], d)
        self.blocks = nn.ModuleList([Block(d, c["heads"], c["mlp_ratio"], True, c["layer_scale"])
                                     for _ in range(c["depth"])])
        self.norm = nn.LayerNorm(d, eps=1e-6)

    def forward(self, prec: Precision, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        h, w = H // self.patch, W // self.patch
        D, n0 = self.cls_token.shape[-1], self.n0
        t = prec.conv(x, self.patch_embed.proj).flatten(2).transpose(1, 2)
        pos = self.pos_embed[:, 1:].reshape(1, n0, n0, D).permute(0, 3, 1, 2)
        if (h, w) != (n0, n0):
            # upstream DINOv2's interpolate_pos_encoding: the +0.1 offset
            pos = F.interpolate(pos, scale_factor=((h + 0.1) / n0, (w + 0.1) / n0),
                                mode="bicubic", align_corners=False)
        t = t + pos.reshape(1, D, h * w).transpose(1, 2)
        t = torch.cat([(self.cls_token + self.pos_embed[:, :1]).expand(B, 1, D), t], 1)
        for blk in self.blocks:
            t = blk(prec, t)
        t = F.layer_norm(t, (D,), self.norm.weight, self.norm.bias, 1e-6)
        return t[:, 1:].transpose(1, 2).reshape(B, D, h, w)


def bn(x: torch.Tensor, m: nn.BatchNorm2d) -> torch.Tensor:
    return F.batch_norm(x, m.running_mean, m.running_var, m.weight, m.bias, False, 0.0, m.eps)


class VGG(nn.Module):
    """VGG19-BN features[:40]: the activation before each max-pool is the
    pyramid level at scales 1, 2, 4, 8."""

    def __init__(self):
        super().__init__()
        layers, c_in = [], 3
        for n, c in VGG_STAGES:
            for _ in range(n):
                layers += [nn.Conv2d(c_in, c, 3, padding=1), nn.BatchNorm2d(c), nn.ReLU()]
                c_in = c
            layers.append(nn.MaxPool2d(2, 2))
        self.layers = nn.Sequential(*layers)

    def forward(self, prec: Precision, x: torch.Tensor) -> dict[int, torch.Tensor]:
        out, scale = {}, 1
        for layer in self.layers:
            if isinstance(layer, nn.Conv2d):
                x = prec.conv(x, layer)
            elif isinstance(layer, nn.BatchNorm2d):
                x = torch.relu(bn(x, layer))
            elif isinstance(layer, nn.MaxPool2d):
                out[scale] = x
                if scale == 8:
                    break
                x = F.max_pool2d(x, 2, 2)
                scale *= 2
        return out


class Encoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.cnn = VGG()
        self.dinov2 = DinoV2(c["dinov2"])


class GP(nn.Module):
    """Gaussian-process regression of B's embedded coordinates onto A's
    features, cosine kernel, Fourier basis cos(8 pi (W xy + b))."""

    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.pos_conv = nn.Conv2d(2, c["gp_dim"], 1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """(B, C, h, w) projected features of A and B -> (B, h, w, gp_dim)."""
        B, C, h, w = x.shape
        T, sigma = self.c["kernel_temperature"], self.c["sigma_noise"]
        xy = grid(h, w, x.device).reshape(h * w, 2)
        f = torch.cos(8 * math.pi * (xy @ self.pos_conv.weight[:, :, 0, 0].T + self.pos_conv.bias))
        a = F.normalize(x.flatten(2).transpose(1, 2), dim=-1, eps=0.0)
        b = F.normalize(y.flatten(2).transpose(1, 2), dim=-1, eps=0.0)
        k_yy = torch.exp((b @ b.transpose(1, 2) - 1) / T)
        k_xy = torch.exp((a @ b.transpose(1, 2) - 1) / T)
        eye = torch.eye(h * w, device=x.device)
        mu = k_xy @ torch.linalg.solve(k_yy + sigma * eye, f.expand(B, -1, -1))
        return mu.reshape(B, h, w, -1)


class MatchDecoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        d = c["dim"]
        self.heads = c["heads"]
        self.blocks = nn.ModuleList([Block(d, c["heads"], 4.0, False, False)
                                     for _ in range(c["blocks"])])
        self.to_out = nn.Linear(d, c["cls_res"] ** 2 + 1)

    def forward(self, prec: Precision, gp: torch.Tensor, feat: torch.Tensor):
        B, h, w, _ = gp.shape
        t = torch.cat([gp, feat.permute(0, 2, 3, 1)], -1).reshape(B, h * w, -1)
        for blk in self.blocks:
            t = blk(prec, t)
        out = F.linear(t, self.to_out.weight, self.to_out.bias).reshape(B, h, w, -1)
        return out[..., :-1], out[..., -1:]


def anchors(res: int, device) -> torch.Tensor:
    a = (2 * torch.arange(res, device=device, dtype=torch.float64) + 1) / res - 1
    return torch.stack([a[None, :].expand(res, res), a[:, None].expand(res, res)],
                       -1).reshape(-1, 2).float()


def cls_to_flow(cls: torch.Tensor) -> torch.Tensor:
    """The probability-weighted mean of the most likely anchor and its four
    neighbours in the flat anchor index (mode -+ 1, mode -+ res, clamped to
    the index range), as upstream RoMa decodes."""
    C = cls.shape[-1]
    res = round(C ** 0.5)
    p = torch.softmax(cls, -1)
    mode = p.argmax(-1, keepdim=True)
    idx = (mode + torch.tensor([-1, 0, 1, -res, res], device=cls.device)).clamp(0, C - 1)
    pn = torch.gather(p, -1, idx)
    return (pn[..., None] * anchors(res, cls.device)[idx]).sum(-2) / pn.sum(-1, keepdim=True)


class DWBlock(nn.Sequential):
    def __init__(self, c: int, k: int):
        super().__init__(nn.Conv2d(c, c, k, padding=k // 2, groups=c), nn.BatchNorm2d(c),
                         nn.ReLU(), nn.Conv2d(c, c, 1))

    def forward(self, prec: Precision, x: torch.Tensor) -> torch.Tensor:
        return prec.conv(torch.relu(bn(prec.conv(x, self[0]), self[1])), self[3])


class Refiner(nn.Module):
    def __init__(self, r: dict, gain: float):
        super().__init__()
        c = r["hidden_dim"]
        self.r = r
        self.gain = gain
        self.disp_emb = nn.Conv2d(2, r["displacement_emb_dim"], 1)
        self.block1 = DWBlock(c, r["kernel_size"])
        self.hidden_blocks = nn.Sequential(*[DWBlock(c, r["kernel_size"])
                                             for _ in range(r["hidden_blocks"])])
        self.out_conv = nn.Conv2d(c, 3, 1)

    def local_corr(self, prec: Precision, x, y, flow, radius: int) -> torch.Tensor:
        """<x(p) / sqrt(C), y sampled bilinearly at flow(p) + (dx, dy) pixels>
        for dx, dy in [-r, r], row-major over (dy, dx); y is zero outside."""
        B, C, H, W = x.shape
        xs, ys = prec.low(y), prec.low(x) / math.sqrt(C)
        out = []
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                shift = torch.tensor([2.0 * dx / W, 2.0 * dy / H], device=x.device)
                out.append((sample(xs, flow + shift) * ys).sum(1))
        return torch.stack(out, 1)

    def forward(self, prec: Precision, x, y, flow, scale_factor: float):
        B, C, H, W = x.shape
        parts = [x, sample(prec.low(y), flow),
                 prec.conv(self.gain * scale_factor * (flow - grid(H, W, x.device))
                           .permute(0, 3, 1, 2), self.disp_emb)]
        if self.r["local_corr_radius"] is not None:
            parts.append(self.local_corr(prec, x, y, flow, self.r["local_corr_radius"]))
        d = self.block1(prec, torch.cat(parts, 1))
        for blk in self.hidden_blocks:
            d = blk(prec, d)
        out = F.conv2d(d, self.out_conv.weight, self.out_conv.bias).permute(0, 2, 3, 1)
        return out[..., :2], out[..., 2:]


class Decoder(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.embedding_decoder = MatchDecoder(c["decoder"])
        self.gps = nn.ModuleDict({"16": GP(c["gp"])})
        self.proj = nn.ModuleDict({s: nn.Sequential(nn.Conv2d(i, o, 1), nn.BatchNorm2d(o))
                                   for s, (i, o) in c["proj_dims"].items()})
        self.conv_refiner = nn.ModuleDict({s: Refiner(r, c["disp_emb_gain"])
                                           for s, r in c["refiners"].items()})

    def forward(self, prec: Precision, f_a, f_b, flow=None, cert=None, scale_factor=1.0):
        """Coarse to fine over the pyramid's scales (the upsample pass starts
        at 8 from the given flow and certainty); returns the finest flow,
        certainty logits and the scale-16 certainty (or None)."""
        scales = [16, 8, 4, 2, 1] if flow is None else [8, 4, 2, 1]
        H1, W1 = f_a[1].shape[-2:]
        B = f_a[1].shape[0]
        h, w = f_a[scales[0]].shape[-2:]
        cert16 = None
        if flow is None:
            flow = grid(h, w, f_a[1].device).expand(B, h, w, 2)
            cert = torch.zeros(B, h, w, 1, device=flow.device)
        else:
            flow, cert = bilinear(flow, (h, w)), bilinear(cert, (h, w))
        for s in scales:
            conv, norm = self.proj[str(s)]
            pa = bn(prec.conv(f_a[s], conv), norm)
            pb = bn(prec.conv(f_b[s], conv), norm)
            if s == 16:
                post = self.gps["16"](pa, pb)
                cls, cert = self.embedding_decoder(prec, post, pa)
                flow = cls_to_flow(cls)
            d_flow, d_cert = self.conv_refiner[str(s)](prec, pa, pb, flow, scale_factor)
            r0 = self.c["refine_init"]
            flow = flow + s * torch.stack([d_flow[..., 0] / (r0 * W1),
                                           d_flow[..., 1] / (r0 * H1)], -1)
            cert = cert + d_cert
            if s == 16:
                cert16 = cert  # attenuates the output: the refined scale-16 certainty
            if s != 1:
                nh, nw = f_a[s // 2].shape[-2:]
                flow, cert = bilinear(flow, (nh, nw)), bilinear(cert, (nh, nw))
        return flow, cert, cert16


class Roma(nn.Module):
    def __init__(self, c: dict):
        super().__init__()
        self.c = c
        self.encoder = Encoder(c)
        self.decoder = Decoder(c)

    def pyramid(self, prec: Precision, x: torch.Tensor, coarse: bool):
        """VGG's levels and, in the coarse pass, DINOv2's tokens at 16."""
        feats = self.encoder.cnn(prec, x)
        if coarse:
            feats[16] = self.encoder.dinov2(prec, x)
        return feats

    def two_view(self, prec, x_a, x_b, flow=None, cert=None, scale_factor=1.0):
        """One decode pass over both directions (A -> B, then B -> A)."""
        B = x_a.shape[0]
        f = self.pyramid(prec, torch.cat([x_a, x_b]), coarse=flow is None)
        f_b = {s: torch.cat([v[B:], v[:B]]) for s, v in f.items()}
        return self.decoder(prec, f, f_b, flow, cert, scale_factor)

    @torch.no_grad()
    def match(self, prec: Precision, raw: torch.Tensor, sizes) -> tuple[torch.Tensor, torch.Tensor]:
        """raw: (2B, Hc, Wc, 3) uint8 canvases, the B A-images over the B
        B-images, holding images of `sizes`. Returns the warp (B, hu, 2 wu, 4)
        and the certainty (B, hu, 2 wu)."""
        c = self.c
        mean = torch.tensor(IMAGENET_MEAN, device=raw.device)
        std = torch.tensor(IMAGENET_STD, device=raw.device)

        def prep(hw):
            x = (resize_canvases(raw, sizes, hw) / 255.0 - mean) / std
            return x.permute(0, 3, 1, 2)

        B = raw.shape[0] // 2
        (hc, wc), (hu, wu) = c["coarse_resolution"], c["upsample_resolution"]
        xc = prep((hc, wc))
        flow, cert, cert16 = self.two_view(prec, xc[:B], xc[B:])
        del xc
        xu = prep((hu, wu))
        sf = math.sqrt(hu * wu / (hc * wc))
        flow, cert, _ = self.two_view(prec, xu[:B], xu[B:], flow, cert, sf)
        lrc = bilinear(cert16, (hu, wu))
        cert = torch.sigmoid((cert - 0.5 * lrc * (lrc < 0))[..., 0])
        cert = torch.where((flow.abs() > 1).any(-1), 0.0, cert)
        flow = flow.clamp(-1, 1)
        g = grid(hu, wu, raw.device).expand(B, hu, wu, 2)
        warp = torch.cat([torch.cat([g, flow[:B]], -1), torch.cat([flow[B:], g], -1)], 2)
        return warp, torch.cat([cert[:B], cert[B:]], 2)
