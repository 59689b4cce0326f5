"""Tensor ops: grids, sampling, resizing, local correlation."""
