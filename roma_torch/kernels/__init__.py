"""Hand-written CUDA kernels for Hopper (sm_90a) and their wrappers.

| kernel          | source                  | replaces (TPU)                                      |
|-----------------|-------------------------|-----------------------------------------------------|
| local_corr      | csrc/local_corr.cu      | ops/pallas/block_gather.py::local_correlation_dma   |
| dw_chain        | csrc/dw_chain.cu        | ops/pallas/depthwise.py::dw5x5_mm_chain             |
| flash_attn      | csrc/flash_attn.cu      | models/transformer.py::_flash_attention             |
| corr_softmax    | csrc/corr_softmax.cu    | ops/pallas/corr_softmax.py::fused_pos_embed         |
| windowed_sample | csrc/windowed_sample.cu | ops/pallas/windowed_sample.py::grid_sample_smooth   |
| dw_affine_relu  | csrc/dw_affine_relu.cu  | ops/pallas/depthwise.py::dw5x5_affine_relu          |
| dw_block_mm     | csrc/dw_block_mm.cu     | ops/pallas/depthwise.py::dw5x5_affine_relu_mm       |
| flash_attn_dkv  | csrc/flash_attn_bwd.cu  | pallas/ops/tpu/flash_attention.py::_flash_attention_bwd_dkv |
| flash_attn_dq   | csrc/flash_attn_bwd.cu  | pallas/ops/tpu/flash_attention.py::_flash_attention_bwd_dq  |

Each forward kernel is an operator ``roma::<name>`` (`runtime.define_op`;
K3 twice, ``flash_attn`` and ``flash_attn_lse``), registered when this
package is imported: the plain PyTorch version for CPU tensors, the kernel
(or an error) for CUDA tensors, the kernel's entry chosen by the input's
dtype (bf16 or float32; `runtime.entry`), a fake implementation for
`torch.export` and a FLOP formula for `FlopCounterMode`. K8 and K9 run
only inside `attention.FlashAttention`'s backward. Building is lazy
(`runtime.load`).
"""

from roma_torch.kernels.runtime import LAUNCHES, reset_launches

# the wrappers register their operators as they are imported
from roma_torch.kernels import (attention, corr_softmax, dw_affine_relu,  # noqa: E402,F401
                                dw_block_mm, dw_chain, local_corr, windowed_sample)

OPS = {
    "local_corr": local_corr.op, "dw_chain": dw_chain.op, "flash_attn": attention.op,
    "flash_attn_lse": attention.op_lse, "corr_softmax": corr_softmax.op,
    "windowed_sample": windowed_sample.op, "dw_affine_relu": dw_affine_relu.op,
    "dw_block_mm": dw_block_mm.op,
}

# each operator's plain version (its CPU implementation)
PLAIN = {
    "local_corr": local_corr.local_correlation_plain, "dw_chain": dw_chain.chain_plain_nchw,
    "flash_attn": attention.attention_plain, "flash_attn_lse": attention.attention_with_lse_plain,
    "corr_softmax": corr_softmax.fused_pos_embed_plain,
    "windowed_sample": windowed_sample.smooth_plain,
    "dw_affine_relu": dw_affine_relu.dw5x5_affine_relu_plain_nchw,
    "dw_block_mm": dw_chain.block_plain_nchw,
}

__all__ = ["LAUNCHES", "OPS", "PLAIN", "reset_launches"]
