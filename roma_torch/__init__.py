"""roma_torch: full-RoMa dense matching in PyTorch, with hand-written CUDA
kernels for an NVIDIA Hopper GPU (H100).

The package mirrors the module layout of the JAX reference package
(`config`, `ops`, `models`, `utils`, `kernels`) but shares no code with it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU a CUDA request raises instead of running on the CPU.

Numerics: float32 math stays full float32 on the GPU. Both TF32 switches
are set off here, so the GP's Gram matrices and solve, the fp32 heads and
the fp32 depthwise references do not silently drop to TF32; the bf16 work
runs on the tensor cores either way.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from roma_torch.device import resolve_device  # noqa: E402

__all__ = ["resolve_device"]
