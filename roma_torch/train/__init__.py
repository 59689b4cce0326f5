"""Training: the optimizer step, checkpoints and the metrics log."""

from roma_torch.train.train import TrainState, make_tiny_train_state, make_train_step

__all__ = ["TrainState", "make_tiny_train_state", "make_train_step"]
