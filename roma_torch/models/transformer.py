"""ViT building blocks and the match decoder, token-major (B, N, C).

`Attention` runs the flash-attention kernel on CUDA tensors
(`roma_torch/kernels/attention.py`) and its plain version on CPU tensors;
where autograd records (the match decoder in training), the kernel also
saves each row's log-sum-exp and the backward runs the dK/dV and dQ
kernels. The views of the fused qkv projection go to the kernels as they
are.
LayerNorms run in float32 (eps 1e-6, as the JAX package's flax default);
GELU is exact. Parameter names follow the reference DINOv2 / RoMa layout
(norm1, attn.qkv, attn.proj, norm2, mlp.fc1, mlp.fc2 or, with
``ffn_layer="swiglu"``, mlp.w12, mlp.w3, ls1.gamma, ls2.gamma; the DINO
head's mlp.{i} and last_layer).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from roma_torch.kernels.attention import attention
from roma_torch.models.layers import flax_init_, layer_norm, linear


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


class SwiGLUFFN(nn.Module):
    """SwiGLU feed-forward: w3(silu(x1) * x2), x1, x2 the halves of w12(x);
    hidden width 2/3 of dim * mlp_ratio rounded up to a multiple of 8."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        hidden = int(dim * mlp_ratio * 2 / 3 + 7) // 8 * 8
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = linear(self.w12, x, self.dtype).chunk(2, dim=-1)
        return linear(self.w3, F.silu(x1) * x2, self.dtype)


def drop_path_mask(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Per-sample keep mask of stochastic depth, shape (B, 1, ..., 1): a
    uniform draw from `generator` below 1 - rate."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    return torch.rand(shape, generator=generator, device=x.device) < 1.0 - rate


def drop_path(x: torch.Tensor, rate: float, training: bool,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Stochastic depth on a residual branch: each sample kept with
    probability 1 - rate and scaled by 1 / (1 - rate), else zeroed. The
    identity when not training or at rate 0; otherwise `generator` (on x's
    device) is required."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("drop_path in training with rate > 0 needs a torch.Generator")
    return torch.where(drop_path_mask(x, rate, generator), x / (1.0 - rate), 0.0)


class DINOHead(nn.Module):
    """DINO projection head: `nlayers` - 1 Linear + exact GELU layers, a
    Linear to the bottleneck, L2 normalisation (eps 1e-12, 1e-6 in
    float16), then the prototypes `last_layer` (out_dim, bottleneck_dim),
    each row normalised to unit norm (weight norm with its gain fixed at
    1). Module names as the reference's (``mlp`` a Linear for one layer,
    else a Sequential with GELUs between); initialised as the JAX
    package's (lecun-normal Linear weights, zero biases, prototypes
    N(0, 0.02^2))."""

    def __init__(self, in_dim: int, out_dim: int, hidden_dim: int = 2048,
                 bottleneck_dim: int = 256, nlayers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        dims = [in_dim] + [hidden_dim] * (nlayers - 1) + [bottleneck_dim]
        layers: list[nn.Module] = []
        for a, b in zip(dims[:-1], dims[1:]):
            layers += [nn.Linear(a, b), nn.GELU()]
        self.mlp = layers[0] if nlayers == 1 else nn.Sequential(*layers[:-1])
        self.last_layer = nn.Linear(bottleneck_dim, out_dim, bias=False)
        flax_init_(self)
        with torch.no_grad():
            self.last_layer.weight.normal_(0.0, 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mlp = self.mlp if isinstance(self.mlp, nn.Sequential) else [self.mlp]
        for m in mlp:
            x = linear(m, x, self.dtype) if isinstance(m, nn.Linear) else F.gelu(x)
        eps = 1e-6 if x.dtype == torch.float16 else 1e-12
        x = x / x.norm(dim=-1, keepdim=True).clamp_min(eps)
        w = self.last_layer.weight
        return F.linear(x, (w / w.norm(dim=1, keepdim=True)).to(x.dtype))


class Block(nn.Module):
    """Pre-norm ViT block: LN -> attn -> (LayerScale) -> + ; LN -> FFN -> (LS) -> +.

    `ffn_layer` "mlp" (fc1, GELU, fc2) or "swiglu" (`SwiGLUFFN`).
    `drop_path_rate` > 0 makes each residual branch stochastic depth in
    train mode (`module.train()`): the generator is a keyword argument of
    the call, ``block(x, generator=g)``, as PyTorch's random functions take
    one; the attention branch's mask is drawn first, then the FFN's, and a
    training call without a generator raises. Eval mode ignores the rate."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 layer_scale: bool = False, qkv_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, ffn_layer: str = "mlp",
                 drop_path_rate: float = 0.0):
        super().__init__()
        if ffn_layer not in ("mlp", "swiglu"):
            raise ValueError(f"ffn_layer {ffn_layer!r}: 'mlp' or 'swiglu'")
        self.dtype = dtype
        self.drop_path_rate = drop_path_rate
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, qkv_bias=qkv_bias, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        ffn = SwiGLUFFN if ffn_layer == "swiglu" else Mlp
        self.mlp = ffn(dim, mlp_ratio, dtype=dtype)
        if layer_scale:
            self.ls1 = LayerScale(dim)
            self.ls2 = LayerScale(dim)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        def residual(h):
            return drop_path(h, self.drop_path_rate, self.training, generator)

        h = self.attn(layer_norm(self.norm1, x).to(self.dtype))
        x = x + residual(self.ls1(h))
        h = self.mlp(layer_norm(self.norm2, x).to(self.dtype))
        return x + residual(self.ls2(h))


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
