"""DINOv2 ViT-L/14 encoder (frozen coarse-feature backbone), inference path:
patch-embed -> + interpolated pos-embed -> blocks -> final LayerNorm ->
patch tokens as a (B, H/14, W/14, embed_dim) map. Parameter names follow
``dinov2_vitl14`` (cls_token, pos_embed, patch_embed.proj, blocks.{i}, norm).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from roma_torch.models.layers import layer_norm
from roma_torch.models.transformer import Block
from roma_torch.ops.resize import torch_bicubic_resize
from roma_torch.utils.profiling import span


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)


class DinoViT(nn.Module):
    def __init__(self, patch_size: int = 14, embed_dim: int = 1024, depth: int = 24,
                 num_heads: int = 16, pretrain_img_size: int = 518,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.dtype = dtype
        self.n0 = pretrain_img_size // patch_size  # pos-embed grid is 37x37 (+cls)
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 1e-6)
        self.pos_embed = nn.Parameter(torch.randn(1, self.n0 * self.n0 + 1, embed_dim) * 0.02)
        self.blocks = nn.ModuleList([
            Block(embed_dim, num_heads, layer_scale=True, dtype=dtype) for _ in range(depth)
        ])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W), H and W divisible by 14 -> (B, H/14, W/14, embed_dim)."""
        B, _, H, W = x.shape
        p, D, n0, dt = self.patch_size, self.embed_dim, self.n0, self.dtype
        h, w = H // p, W // p
        conv = self.patch_embed.proj
        tokens = F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt), stride=p)
        tokens = tokens.flatten(2).transpose(1, 2)  # (B, h*w, D)

        # bicubic pos-embed resize with the reference's +0.1 scale offset
        patch_pos = self.pos_embed[:, 1:].reshape(1, n0, n0, D)
        if (h, w) != (n0, n0):
            with span("roma.dinov2.pos_embed"):
                patch_pos = torch_bicubic_resize(
                    patch_pos.float(), (h, w), scale=((h + 0.1) / n0, (w + 0.1) / n0)
                )
        tokens = tokens + patch_pos.reshape(1, h * w, D).to(dt)
        cls = (self.cls_token + self.pos_embed[:, :1]).to(dt)
        tokens = torch.cat([cls.expand(B, 1, D), tokens], dim=1)
        for blk in self.blocks:
            tokens = blk(tokens)
        tokens = layer_norm(self.norm, tokens)
        return tokens[:, 1:].to(dt).reshape(B, h, w, D)
