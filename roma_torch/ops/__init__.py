"""Tensor ops: grids, sampling, resizing, local correlation."""

from roma_torch.ops.resize import interpolate_bilinear, interpolate_nearest, resize_bicubic
from roma_torch.ops.grid_sample import grid_sample, grid_sample_nearest
from roma_torch.ops.corr import corr_volume, pos_embed_expectation, pos_embed_fast
from roma_torch.ops.local_corr import local_correlation
