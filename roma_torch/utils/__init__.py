"""Geometry, density estimation and sampling utilities."""

from roma_torch.utils.geometry import (
    angle_error_mat,
    angle_error_vec,
    cls_to_flow,
    cls_to_flow_refine,
    compute_pose_error,
    compute_relative_pose,
    get_grid,
    get_gt_warp,
    normalized_to_pixel,
    pixel_to_normalized,
    pose_auc,
    warp_kpts,
    warp_to_pixel_coordinates,
)
from roma_torch.utils.kde import kde
from roma_torch.utils.sampling import sample_matches
