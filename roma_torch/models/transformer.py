"""ViT building blocks and the match decoder, token-major (B, N, C).

`Attention` runs the flash-attention kernel on CUDA tensors
(`roma_torch/kernels/attention.py`) and its plain version on CPU tensors;
where autograd records (the match decoder in training), the kernel also
saves each row's log-sum-exp and the backward runs the dK/dV and dQ
kernels. The views of the fused qkv projection go to the kernels as they
are.
LayerNorms run in float32 (eps 1e-6, as the JAX package's flax default);
GELU is exact. Parameter names follow the reference DINOv2 / RoMa layout
(norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2, ls1.gamma, ls2.gamma).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from roma_torch.kernels.attention import attention
from roma_torch.models.layers import layer_norm, linear


class Attention(nn.Module):
    """Multi-head self-attention with a fused qkv projection."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        H = self.num_heads
        qkv = linear(self.qkv, x, self.dtype).view(B, N, 3, H, C // H)
        out = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return linear(self.proj, out.reshape(B, N, C), self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(linear(self.fc1, x, self.dtype), approximate="none")
        return linear(self.fc2, h, self.dtype)


class LayerScale(nn.Module):
    """Learned per-channel residual scale (DINOv2 init_values=1.0)."""

    def __init__(self, dim: int, init_value: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Block(nn.Module):
    """Pre-norm ViT block: LN -> attn -> (LayerScale) -> + ; LN -> MLP -> (LS) -> +."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_scale: bool = False, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, mlp_ratio, dtype=dtype)
        if layer_scale:
            self.ls1 = LayerScale(dim)
            self.ls2 = LayerScale(dim)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.attn(layer_norm(self.norm1, x).to(self.dtype))
        x = x + self.ls1(h)
        h = self.mlp(layer_norm(self.norm2, x).to(self.dtype))
        return x + self.ls2(h)


class TransformerDecoder(nn.Module):
    """Coarse match decoder: GP posterior + projected features -> tokens ->
    N blocks (qkv_bias=False) -> float32 linear head emitting cls_res^2
    anchor logits + 1 certainty channel."""

    def __init__(self, hidden_dim: int = 1024, out_dim: int = 64 * 64 + 1,
                 num_blocks: int = 5, num_heads: int = 8,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.out_dim = out_dim
        self.dtype = dtype
        self.blocks = nn.Sequential(*[
            Block(hidden_dim, num_heads, qkv_bias=False, dtype=dtype)
            for _ in range(num_blocks)
        ])
        self.to_out = nn.Linear(hidden_dim, out_dim)

    def forward(self, gp_posterior: torch.Tensor, feats: torch.Tensor):
        """(B,H,W,gp_dim), (B,H,W,feat_dim) -> ((B,H,W,out-1), (B,H,W,1))."""
        B, H, W, _ = gp_posterior.shape
        x = torch.cat([gp_posterior.to(self.dtype), feats.to(self.dtype)], dim=-1)
        tokens = self.blocks(x.reshape(B, H * W, self.hidden_dim))
        out = linear(self.to_out, tokens, torch.float32).reshape(B, H, W, self.out_dim)
        return out[..., :-1], out[..., -1:]
