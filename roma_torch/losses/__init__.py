"""Training losses (full RoMa and Tiny RoMa)."""

# `robust_loss` stays the submodule: re-exporting the function under its
# name would shadow the module that `import roma_torch.losses.robust_loss`
# reaches
from roma_torch.losses.robust_loss import RobustLossConfig, tiny_robust_loss

__all__ = ["RobustLossConfig", "tiny_robust_loss"]
