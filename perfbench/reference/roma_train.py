"""Full RoMa's training step (upstream `experiments/train_roma_outdoor.py`,
arXiv:2305.15404), plain PyTorch, on the modules of `reference/roma.py`
(the same parameter names): a train-mode forward of one decode pass at the
coarse resolution, A -> B, and the robust loss (`reference/robust_loss.py`).

Train mode as upstream trains: every BatchNorm (VGG, the decoder's
projections, the refiners' blocks) normalises with the statistics of the
batch it is handed (A's and B's features projected apart), with the biased
variance; DINOv2 runs without grad (frozen); no dropout; flow and
certainty are upsampled and detached between scales; the local
correlation reads B's features and the flow detached. The outputs are the
per-scale maps the loss reads: `gm_cls` and `gm_certainty` at 16, `flow`
and `certainty` at 16, 8, 4, 2 and 1, channels-last.

With `checkpoint` set, each VGG stage, each decoder block, each local
correlation and each refiner block is recomputed in the backward
(`torch.utils.checkpoint`, non-reentrant), so that batch 8 at 560^2 fits
in float32; batch statistics depend only on the block's input, so the
recompute sees the same ones. The running statistics are never read or
moved: a training step's loss and gradients do not depend on them.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from perfbench.reference.common import Precision, bilinear, grid, sample
from perfbench.reference.roma import Roma, cls_to_flow


def bn_train(x: torch.Tensor, m: nn.BatchNorm2d) -> torch.Tensor:
    """BatchNorm on the batch's own statistics (biased variance), on a
    contiguous map: cuDNN's training BatchNorm fails on the card
    ("execution failed", a misaligned address) on the channels-last
    projection of DINOv2's strided map."""
    return F.batch_norm(x.contiguous(), None, None, m.weight, m.bias, True, 0.0, m.eps)


class TrainForward:
    """`__call__(im_a, im_b)` -> the loss's per-scale maps, for ImageNet-
    normalised (B, H, W, 3) images, in `prec`."""

    def __init__(self, model: Roma, prec: Precision, checkpoint: bool = True):
        self.model, self.prec, self.ckpt = model, prec, checkpoint

    def _run(self, fn, *args):
        if self.ckpt and torch.is_grad_enabled():
            return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def vgg(self, x: torch.Tensor) -> dict[int, torch.Tensor]:
        """VGG19-BN features[:40], a stage (its convs, BNs and ReLUs) at a
        time; the activation before each max-pool is the level."""
        prec, out, scale, stage = self.prec, {}, 1, []

        def run(x, *layers):
            for conv, norm in zip(layers[::2], layers[1::2]):
                x = torch.relu(bn_train(prec.conv(x, conv), norm))
            return x

        for layer in self.model.encoder.cnn.layers:
            if isinstance(layer, nn.MaxPool2d):
                x = out[scale] = self._run(run, x, *stage)
                if scale == 8:
                    break
                x, scale, stage = F.max_pool2d(x, 2, 2), 2 * scale, []
            elif not isinstance(layer, nn.ReLU):
                stage.append(layer)
        return out

    def match_decoder(self, post: torch.Tensor, feat: torch.Tensor):
        dec = self.model.decoder.embedding_decoder
        B, h, w, _ = post.shape
        t = torch.cat([post, feat.permute(0, 2, 3, 1)], -1).reshape(B, h * w, -1)
        for blk in dec.blocks:
            t = self._run(lambda t, blk=blk: blk(self.prec, t), t)
        out = F.linear(t, dec.to_out.weight, dec.to_out.bias).reshape(B, h, w, -1)
        return out[..., :-1], out[..., -1:]

    def dw_block(self, blk, d: torch.Tensor) -> torch.Tensor:
        prec = self.prec
        return prec.conv(torch.relu(bn_train(prec.conv(d, blk[0]), blk[1])), blk[3])

    def refiner(self, s: str, x, y, flow):
        ref = self.model.decoder.conv_refiner[s]
        prec = self.prec
        B, C, H, W = x.shape
        disp = (flow - grid(H, W, x.device)).permute(0, 3, 1, 2)
        parts = [x, sample(prec.low(y), flow), prec.conv(ref.gain * disp, ref.disp_emb)]
        r = ref.r["local_corr_radius"]
        if r is not None:
            parts.append(self._run(lambda x, y, f: ref.local_corr(prec, x, y, f, r),
                                   x, y.detach(), flow.detach()))
        d = torch.cat(parts, 1)
        for blk in [ref.block1, *ref.hidden_blocks]:
            d = self._run(lambda d, blk=blk: self.dw_block(blk, d), d)
        out = F.conv2d(d, ref.out_conv.weight, ref.out_conv.bias).permute(0, 2, 3, 1)
        return out[..., :2], out[..., 2:]

    def __call__(self, im_a: torch.Tensor, im_b: torch.Tensor) -> dict[int, dict]:
        m, prec = self.model, self.prec
        B = im_a.shape[0]
        x = torch.cat([im_a, im_b]).permute(0, 3, 1, 2).float()
        f = self.vgg(x)
        with torch.no_grad():
            f[16] = m.encoder.dinov2(prec, x)
        dec = m.decoder
        H1, W1 = f[1].shape[-2:]
        r0 = dec.c["refine_init"]
        corresps, flow, cert = {}, None, None
        for s in (16, 8, 4, 2, 1):
            conv, norm = dec.proj[str(s)]
            pa = bn_train(prec.conv(f[s][:B], conv), norm)
            pb = bn_train(prec.conv(f[s][B:], conv), norm)
            out = {}
            if s == 16:
                cls, cert = self.match_decoder(dec.gps["16"](pa, pb), pa)
                flow = cls_to_flow(cls)
                out = {"gm_cls": cls, "gm_certainty": cert}
            d_flow, d_cert = self.refiner(str(s), pa, pb, flow)
            flow = flow + s * torch.stack([d_flow[..., 0] / (r0 * W1),
                                           d_flow[..., 1] / (r0 * H1)], -1)
            cert = cert + d_cert
            corresps[s] = dict(out, flow=flow, certainty=cert)
            if s != 1:
                nh, nw = f[s // 2].shape[-2:]
                flow = bilinear(flow, (nh, nw)).detach()
                cert = bilinear(cert, (nh, nw)).detach()
        return corresps


def conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride, _padding, _dilation,
                        transposed, _output_padding, _groups, output_mask, out_shape=None,
                        **_) -> int:
    """A convolution's backward: each gradient asked for (input, weight)
    costs what the forward costs, 2 N (output positions) (weight's
    elements). FlopCounterMode's own formula counts a grouped
    convolution's weight gradient `groups` times over (as if dense)."""
    pos = math.prod((x_shape if transposed else grad_out_shape)[2:])
    return 2 * x_shape[0] * pos * math.prod(w_shape) * (int(output_mask[0]) + int(output_mask[1]))


def step_flops(cfg: dict, batch_shapes: dict, loss) -> float:
    """FLOPs of one step's forward and backward without recompute, counted
    by FlopCounterMode over the reference on the meta device."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = Roma(cfg)
        batch = {k: torch.zeros(s) for k, s in batch_shapes.items()}
    model.encoder.dinov2.requires_grad_(False)
    mapping = {torch.ops.aten.convolution_backward: conv_backward_flops}
    with FlopCounterMode(display=False, custom_mapping=mapping) as fc:
        out = TrainForward(model, Precision(), checkpoint=False)(batch["im_A"], batch["im_B"])
        total, _ = loss(out, batch)
        total.backward()
    return float(fc.get_total_flops())
