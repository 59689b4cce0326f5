"""ConvRefiner: per-scale warp refinement CNN.

Per scale it warps B's features to A by the current flow, embeds the
displacement from the identity grid (1x1 conv, gain 40/32 * scale_factor),
optionally appends a (2r+1)^2 local correlation around the warp target, runs
block1 + N hidden depthwise-separable blocks (k=5 grouped conv -> BN ->
ReLU -> 1x1 conv, BN folded into a scale/shift at inference), and emits
(delta_flow, delta_certainty) from a float32 1x1 head.

Train mode (``model.train()``, the JAX package's ``train=True``): every
block takes the unfused path, grouped conv -> batch-statistics BN
(momentum 0.99, the running variance unbiased) -> ReLU -> 1x1 conv, each
block under activation checkpointing with its statistics moved once; no
kernel below runs (K4 folds running statistics, so it cannot). The local
correlation's f1 and flow are detached, in either mode, as in the JAX
package.

Kernel gates (every one also requires eval mode and that autograd is not
recording through the kernel, `runtime.grad_needed`, as the JAX package's
gates require `not train`):
- local correlation goes to the local-correlation kernel for r <= 7 and
  C % 128 == 0 (scales 16/8/4), as in the JAX package;
- a narrow stack (hidden_dim < 64, k = 5, input width == hidden_dim: the
  scale-1 refiner) runs as one chain through the fused block kernel, as in
  the JAX package;
- every other block with k = 5 (scales 16/8/4/2) runs its depthwise conv +
  affine + ReLU through the wide-channel depthwise kernel and its 1x1 as a
  plain conv2d. The JAX package calls the same function there but takes
  its Pallas body only for C < 64;
- with `smooth_warp` set (RomaConfig.smooth_warp_gather), the warp of a map
  with <= 16 channels (the scale-1 refiner's 9) goes through the windowed
  warp-gather kernel in "fast" or "exact" mode, as in the JAX package.
The kernel wrappers call their ``roma::`` operators (the plain versions
for CPU tensors); the wide-channel depthwise kernel differentiates through
its plain version.

Features are NCHW inside; flows are (B, H, W, 2) as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from roma_torch.kernels import dw_affine_relu, dw_chain, runtime
from roma_torch.kernels import local_corr as local_corr_kernel
from roma_torch.kernels.windowed_sample import grid_sample_smooth_nchw
from roma_torch.models.layers import batch_norm_train, checkpoint, conv2d
from roma_torch.ops.corr import coord_grid
from roma_torch.ops.grid_sample import grid_sample_nchw
from roma_torch.ops.local_corr import local_correlation


class DWBlock(nn.Sequential):
    """Depthwise-separable block; indices 0/1/3 are the reference's
    conv k5 (groups=C) / BatchNorm / conv 1x1 (2 is the ReLU)."""

    def __init__(self, features: int, kernel_size: int = 5):
        super().__init__(
            nn.Conv2d(features, features, kernel_size, padding=kernel_size // 2,
                      groups=features),
            nn.BatchNorm2d(features),
            nn.ReLU(inplace=True),
            nn.Conv2d(features, features, 1),
        )
        self.train(False)  # eval until model.train(), as JAX's train=False default

    def fused(self, dtype: torch.dtype):
        """Inference-folded tensors: dw kernel (k,k,C) in `dtype`, BN-folded
        scale/shift (C,), 1x1 weights m (C,C) with z[d] = sum_c m[c,d] y[c]
        in `dtype`, bias (C,)."""
        conv, bn, _, conv2 = self
        inv = bn.weight / torch.sqrt(bn.running_var + bn.eps)
        shift = (conv.bias - bn.running_mean) * inv + bn.bias
        w = conv.weight[:, 0].permute(1, 2, 0).to(dtype)
        m = conv2.weight[:, :, 0, 0].T.to(dtype)
        return w, inv, shift, m, conv2.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.training:
            conv, bn, _, conv2 = self
            y = batch_norm_train(bn, conv2d(conv, x, dt), 0.99, True)
            return conv2d(conv2, torch.relu(y).to(dt), dt)
        w, inv, shift, _, _ = self.fused(dt)
        if w.shape[0] == 5:
            y = dw_affine_relu.dw5x5_affine_relu_nchw(x.contiguous(), w.contiguous(), inv, shift)
        else:
            y = dw_affine_relu.dw5x5_affine_relu_plain_nchw(x, w, inv, shift)
        return conv2d(self[3], y, dt)


class ConvRefiner(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int, displacement_emb_dim: int,
                 local_corr_radius: int | None = None, hidden_blocks: int = 8,
                 kernel_size: int = 5, disp_emb_gain: float = 40.0 / 32.0,
                 dtype: torch.dtype = torch.bfloat16, smooth_warp: bool | str = False):
        super().__init__()
        if in_dim != hidden_dim:
            raise ValueError("depthwise block1 needs in_dim == hidden_dim")
        self.hidden_dim = hidden_dim
        self.kernel_size = kernel_size
        self.local_corr_radius = local_corr_radius
        self.disp_emb_gain = disp_emb_gain
        self.dtype = dtype
        self.smooth_warp = smooth_warp
        self.disp_emb = nn.Conv2d(2, displacement_emb_dim, 1)
        self.block1 = DWBlock(hidden_dim, kernel_size)
        self.hidden_blocks = nn.Sequential(
            *[DWBlock(hidden_dim, kernel_size) for _ in range(hidden_blocks)]
        )
        self.out_conv = nn.Conv2d(hidden_dim, 3, 1)
        self.train(False)  # eval until model.train(), as JAX's train=False default

    def blocks(self) -> list[DWBlock]:
        return [self.block1, *self.hidden_blocks]

    def use_chain(self, channels: int) -> bool:
        """The scale-1 gate: narrow stack, k = 5, input width == hidden_dim."""
        return (self.hidden_dim < 64 and channels == self.hidden_dim
                and self.kernel_size == 5)

    def forward(self, x: torch.Tensor, y: torch.Tensor, flow: torch.Tensor,
                scale_factor: float = 1.0):
        """x, y: (B,C,H,W) projected A/B feats; flow (B,H,W,2) normalized.
        Returns (delta_flow (B,H,W,2), delta_certainty (B,H,W,1)) float32."""
        dt = self.dtype
        B, C, H, W = x.shape
        train = self.training
        if self.smooth_warp and not train and not runtime.grad_needed(y, flow):
            mode = "fast" if self.smooth_warp == "fast" else "exact"
            x_hat = grid_sample_smooth_nchw(y, flow, mode).to(dt)
        else:
            x_hat = grid_sample_nchw(y, flow).to(dt)
        grid = coord_grid(H, W, device=x.device)
        disp = (flow - grid).float().permute(0, 3, 1, 2)
        emb = conv2d(self.disp_emb, (self.disp_emb_gain * scale_factor * disp).to(dt), dt)
        parts = [x.to(dt), x_hat, emb]
        r = self.local_corr_radius
        if r is not None:
            f0 = x.to(dt).permute(0, 2, 3, 1).contiguous()
            f1 = y.detach().to(dt).permute(0, 2, 3, 1).contiguous()
            fl = flow.detach().float().contiguous()
            if not train and local_corr_kernel.use_kernel(r, C, f0, f1, fl):
                corr = local_corr_kernel.local_correlation(f0, f1, r, fl)
            else:
                corr = local_correlation(f0, f1, r, fl)
            parts.append(corr.to(dt).permute(0, 3, 1, 2))
        d = torch.cat(parts, dim=1)

        if train:
            for blk in self.blocks():
                d = checkpoint(blk, d) if torch.is_grad_enabled() else blk(d)
        elif self.use_chain(d.shape[1]) and not runtime.grad_needed(
                d, *(p for blk in self.blocks() for p in blk.parameters())):
            cols = [blk.fused(dt) for blk in self.blocks()]
            d = dw_chain.chain_nchw(
                d.contiguous(), *(torch.stack([c[i] for c in cols]).contiguous()
                                  for i in range(5))
            )
        else:
            for blk in self.blocks():
                d = blk(d)
        out = conv2d(self.out_conv, d, torch.float32).permute(0, 2, 3, 1)
        return out[..., :2], out[..., 2:]
