"""Training: the optimizer step, checkpoints and the metrics log."""
