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

Each wrapper takes its plain PyTorch version for CPU tensors and launches
its kernel (or raises) for CUDA tensors, choosing the kernel's entry by the
input's dtype (bf16 or float32; `runtime.entry`). Building is lazy
(`runtime.load`).
"""

from roma_torch.kernels.runtime import LAUNCHES, reset_launches

__all__ = ["LAUNCHES", "reset_launches"]
